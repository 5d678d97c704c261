"""The epoch loop of training: data, steps, validation and checkpoints.

Counterpart of cerberusdet_tpu/train/trainer.py (the reference's
cerberusdet/train.py:42-276, trainers/base_trainer.py and
trainers/averaging.py:97-203): per-task augmented loaders, epochs of
MultiTaskTrainer.step over the tasks (with warmup, batch skipping and the
shared-block freeze), a val of the EMA model per task and epoch
(evaluation/val.py:run_task), results.txt, last / best / per-task best
checkpoints in the JAX package's .ckpt.npz format, early stopping, and at the
end strip_checkpoint and a val of the saved checkpoints, fused. A run resumes
from its last.ckpt.npz with the same weights, EMA, momentum and update count,
in either direction between the two packages.

The losses of a step stay on the card and are summed there: the host reads
them once an epoch, so that it does not wait for every step. With use_mesh
(--mesh) the run is data-parallel over the ranks of a process group
(parallel/mesh.py; torchrun starts one process per card, and a process
started alone forms a group of one): each rank loads its own shard of every
train set (data/samplers.py:HostShardSampler) and steps a replica of the
state on it, the one step over the global batch that the JAX package takes
over its mesh (train/step.py). Rank 0 alone validates, writes checkpoints,
logs, plots and the model graph, as the JAX package's process 0 does, and
broadcasts its stop decision and fitness, so that every rank leaves the
epoch loop together. A run that saves writes the model-graph artifacts once
(utils/profiling.py:dump_model_graph: the module tree and the cost of the
eval forward, where the JAX package writes StableHLO text and XLA's cost
analysis). With `plots` a run that saves draws what the JAX package draws
(utils/plots.py): the label statistics at the first epoch, the first 3
batches of each task, the val mosaics, PR curve and confusion matrix of the
final epoch's val.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.data.loaders import InfiniteLoader, create_dataloader
from cerberusdet_tpu_torch.evaluation.metrics import overall_fitness
from cerberusdet_tpu_torch.evaluation.val import eval_flags, run_task, save_val_plots
from cerberusdet_tpu_torch.manager.attempt_load import load_single
from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint, strip_checkpoint
from cerberusdet_tpu_torch.manager.run_manager import RunManager
from cerberusdet_tpu_torch.manager.weights import load_jax_momentum, load_jax_params
from cerberusdet_tpu_torch.parallel.mesh import (
    broadcast_decision,
    broadcast_object,
    group_rank,
    group_size,
    init_distributed,
    rank_device,
    replicate,
)
from cerberusdet_tpu_torch.train.loss import DetectionLoss, scale_loss_gains
from cerberusdet_tpu_torch.train.optim import SGDConfig
from cerberusdet_tpu_torch.train.schedules import EarlyStopping, lr_lambda, warmup_lrs
from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state
from cerberusdet_tpu_torch.utils.hyp import get_hyperparameter, task_hyp_view
from cerberusdet_tpu_torch.utils.profiling import dump_model_graph


@dataclasses.dataclass
class TrainOptions:
    """The train CLI's options (train.py:279-336), the fields and defaults of
    the JAX package's TrainOptions, so that either package resumes the
    other's opt.yaml."""

    cfg: Union[str, dict] = "configs/models/yolov8x.yaml"
    data: Union[str, dict] = ""
    hyp: Union[str, dict] = "configs/hyps/hyp.cerber-default.yaml"
    weights: str = ""                      # pretrained .ckpt.npz or reference .pt
    epochs: int = 100
    batch_size: Union[int, List[int]] = 16  # per task: int or list "4,4,40"
    imgsz: int = 640
    project: str = "runs/train"
    name: str = "exp"
    exist_ok: bool = False
    optimizer: str = "SGD"
    linear_lr: bool = False
    noval: bool = False
    nosave: bool = False
    patience: int = 30
    freeze_shared_till_epoch: int = 0
    skip_batches: bool = False
    balanced_sampler: bool = False
    labels_from_xml: bool = False
    use_multi_labels: bool = False
    use_soft_labels: bool = False
    cache_images: str = ""                 # "" | "ram" | "disk" (the packed memmap)
    augment_device: bool = False           # mosaic / warp / HSV on the card; implies
                                           # cache_images="disk"
    single_cls: bool = False               # train multi-class data as one class
    workers: Optional[int] = None          # loader decode threads (--workers)
    proc_workers: int = 0                  # decode / augment worker processes
    warmup_min_iters: int = 1000           # reference warmup floor (averaging.py:57)
    use_mesh: bool = False                 # data-parallel over the process group (--mesh);
                                           # in TrainOptions so resume restores it
    max_labels: int = 300
    plots: bool = True
    seed: int = 0
    compute_dtype: str = "float32"         # or "bfloat16" over float32 masters
    loss_weights: Optional[Dict[str, float]] = None
    resume: str = ""                       # path to last.ckpt.npz
    mlflow_url: str = ""                   # MLflow tracking server (utils/mlflow_logging.py)
    experiment_name: str = "cerberusdet"


class TrainLoop:
    """Trains on `device` (the card when None; "cpu" runs on the CPU).

    `timings` collects one entry per step: the host's wait for the loaders'
    batches ("data_s") and the host time of the step call ("step_s"), in
    seconds. On the card the step call enqueues the replay of the step's
    CUDA graph (the batches' copies into its static buffers, the scalars,
    the address check, the launch) and returns before the card has
    finished, so "step_s" is that enqueue, and the host assembles the next
    batches while the card runs the step; the first call of a key also runs
    the step eagerly and captures it. On the CPU it is the whole step.

    opt.use_mesh trains data-parallel over the process group, which it
    joins (parallel/mesh.py:init_distributed) unless the process has joined
    one already; `device` then defaults to the card of the process's
    LOCAL_RANK."""

    def __init__(self, opt: TrainOptions, data_dict: Dict[str, Any], hyp: Dict[str, Any],
                 device=None):
        self.opt = opt
        self.hyp = hyp
        self.group = None
        if opt.use_mesh:
            self.group = init_distributed(device=device)
        self.device = rank_device(device) if self.group is not None else resolve_device(device)
        self.is_main = group_rank(self.group) == 0
        if self.group is not None and self.is_main:
            n, cards = group_size(self.group), (torch.cuda.device_count()
                                                if self.device.type == "cuda" else 0)
            print(f"data-parallel over {n} rank{'s' * (n > 1)} "
                  f"({dist.get_backend(self.group)}, this rank on {self.device})", flush=True)
            if n < cards:
                print(f"--mesh: a group of {n} while {cards} cards are visible; start one "
                      f"process per card with torchrun --nproc-per-node {cards}", flush=True)
        if opt.single_cls:
            # the model is built with one class per task (models_manager.py:84-87)
            data_dict = dict(data_dict)
            data_dict["nc"] = [1] * len(data_dict["nc"])
            data_dict["names"] = [n if len(n) == 1 else ["item"] for n in data_dict["names"]]
        # rank 0 names the run directory; the other ranks take that name and
        # write nothing in it
        save_dir = Path(opt.project) / opt.name
        if not self.is_main:
            save_dir = Path(broadcast_object(None, self.group))
        self.manager = RunManager(hyp, data_dict, opt.cfg, save_dir,
                                  exist_ok=opt.exist_ok or not self.is_main,
                                  nosave=opt.nosave or not self.is_main,
                                  mlflow_url=opt.mlflow_url if self.is_main else "",
                                  experiment_name=opt.experiment_name, device=self.device)
        if self.is_main:
            broadcast_object(str(self.manager.save_dir), self.group)
            self.manager.dump_settings(dataclasses.asdict(opt))
        self.task_ids = self.manager.task_ids
        self.model, ckpt_meta = self.manager.load_model(opt.weights or None, seed=opt.seed)
        self.start_epoch = 0
        if not opt.nosave and self.is_main:
            # the reference's TensorBoard add_graph (models_manager.py:412-418)
            dump_model_graph(self.model, self.manager.save_dir, imgsz=opt.imgsz)
        self.timings: List[Dict[str, float]] = []
        self.final_val: Dict[str, Dict[str, Any]] = {}

        bs = opt.batch_size
        self.batch_sizes = list(bs) if isinstance(bs, (list, tuple)) else [bs] * len(self.task_ids)

        self.train_loaders, self.val_loaders, self.datasets = {}, {}, {}
        gs = int(max(self.model.strides))
        for ti, task in enumerate(self.task_ids):
            ds, loader = create_dataloader(
                data_dict["train"][ti], imgsz=opt.imgsz, batch_size=self.batch_sizes[ti],
                stride=gs, hyp=task_hyp_view(hyp, ti, task), augment=True,
                balanced_sampler=opt.balanced_sampler, use_xml=opt.labels_from_xml,
                classnames=data_dict["names"][ti], multi_label=opt.use_multi_labels,
                soft_label=opt.use_soft_labels, max_labels=opt.max_labels, task=task,
                seed=opt.seed, cache_images=opt.cache_images, single_cls=opt.single_cls,
                num_threads=opt.workers, num_workers=opt.proc_workers,
                augment_device=opt.augment_device, device=self.device)
            self.datasets[task] = ds
            self.train_loaders[task] = loader
            _, vloader = create_dataloader(
                data_dict["val"][ti], imgsz=opt.imgsz, batch_size=self.batch_sizes[ti],
                stride=gs, augment=False, shuffle=False, use_xml=opt.labels_from_xml,
                classnames=data_dict["names"][ti], max_labels=opt.max_labels,
                task=f"{task}_val", single_cls=opt.single_cls, num_threads=opt.workers,
                # a run without per-epoch vals validates once, and only rank 0
                # validates: no cache to fill elsewhere
                cache_images=opt.cache_images if not opt.noval and self.is_main else "",
                # rank 0 validates the whole set (the reference's rank-0 val)
                host_sharded=False)
            self.val_loaders[task] = vloader

        # losses with scaled gains (models_manager.fill_tasks_parameters)
        nl = len(self.model.strides)
        self.losses = {}
        for ti, task in enumerate(self.task_ids):
            box_w = get_hyperparameter(hyp, "box", ti, task)
            cls_w = get_hyperparameter(hyp, "cls", ti, task)
            dfl_w = get_hyperparameter(hyp, "dfl", ti, task)
            box_w, cls_w = scale_loss_gains(box_w, cls_w, nl, opt.imgsz)
            self.losses[task] = DetectionLoss(nc=self.manager.nc[ti], strides=self.model.strides,
                                              box_w=box_w, cls_w=cls_w, dfl_w=dfl_w)

        cdtype = torch.bfloat16 if opt.compute_dtype == "bfloat16" else torch.float32
        wd = float(get_hyperparameter(hyp, "weight_decay"))
        sgd_cfg = SGDConfig(weight_decay=wd, name=opt.optimizer)
        self.trainer = MultiTaskTrainer(self.model, self.losses, task_weights=opt.loss_weights,
                                        sgd=sgd_cfg, compute_dtype=cdtype, device=self.device,
                                        group=self.group)
        self.state = init_train_state(self.model, sgd_cfg)

        self.lr0 = float(get_hyperparameter(hyp, "lr0"))
        self.lf = lr_lambda(opt.epochs, float(get_hyperparameter(hyp, "lrf")),
                            cos_lr=not opt.linear_lr)
        self.nb = max(len(ld) for ld in self.train_loaders.values())
        # the reference floors warmup at 1000 iterations (averaging.py:57);
        # warmup_min_iters lowers the floor for small sets
        self.nw = max(round(float(get_hyperparameter(hyp, "warmup_epochs")) * self.nb),
                      opt.warmup_min_iters)
        self.iters_per_task = None
        if opt.skip_batches:
            lens = [len(self.train_loaders[t]) for t in self.task_ids]
            self.iters_per_task = [max(self.nb // n, 1) for n in lens]
        self.stopper = EarlyStopping(opt.patience)
        if opt.resume:
            self._resume(opt.resume)
        elif ckpt_meta:
            self.manager.best_fitness = ckpt_meta.get("best_fitness", 0.0)
        if self.group is not None:
            # after _resume, which makes a new state: every rank steps rank 0's
            replicate(self.state, self.group)

    # ------------------------------------------------------------------
    def _resume(self, path: str):
        """Continue from a last.ckpt.npz of either package: weights, EMA,
        momentum and update count as saved, the epoch after the saved one."""
        ckpt = load_checkpoint(path)
        meta = ckpt["meta"]
        load_jax_params(self.model, ckpt["params"])
        self.state = init_train_state(self.model, self.trainer.sgd)
        if ckpt.get("ema"):
            load_jax_params(self.state.ema, ckpt["ema"])
        n_updates = int(meta.get("n_updates", 0))
        if ckpt.get("opt"):
            self.state.opt_state.momentum_buf = load_jax_momentum(self.model, ckpt["opt"])
            self.state.opt_state.step = n_updates
        self.state.n_updates = n_updates
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.manager.best_fitness = meta.get("best_fitness", 0.0)
        self.manager.best_fitness_per_task.update(meta.get("best_fitness_per_task", {}))

    def _plot_batch(self, task: str, i: int, batch: Dict[str, Any]) -> None:
        """The mosaic of a train batch (trainer.py:264-269 of the JAX
        package), drawn before the step call: the step's replay copies the
        batch into its static buffers, and the images of a device-augmented
        batch exist only on the card, so the images are copied to the host
        here, outside any capture."""
        from cerberusdet_tpu_torch.utils.plots import plot_images

        img = torch.as_tensor(batch["img"]).permute(0, 3, 1, 2)
        plot_images({**batch, "img": img}, self.manager.save_dir / f"train_batch_{task}_{i}.png",
                    names=self.manager.names[self.task_ids.index(task)])

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, np.ndarray]:
        """One epoch of steps; returns {task: mean (box, cls, dfl) loss}."""
        opt = self.opt
        freeze = epoch < opt.freeze_shared_till_epoch
        if not freeze:  # the frozen epochs' captured steps are not replayed again
            self.trainer.drop_programs(freeze_shared=True)
        iters = {t: InfiniteLoader(self.train_loaders[t], epoch=epoch) for t in self.task_ids}
        momentum_h = float(get_hyperparameter(self.hyp, "momentum"))
        mloss: Dict[str, Optional[torch.Tensor]] = {t: None for t in self.task_ids}
        counts = {t: 0 for t in self.task_ids}
        plots = epoch == self.start_epoch and opt.plots and not opt.nosave and self.is_main
        if plots:
            from cerberusdet_tpu_torch.utils.plots import plot_labels

            for ti, t in enumerate(self.task_ids):
                plot_labels(self.datasets[t].labels, self.manager.names[ti],
                            self.manager.save_dir)
        for i in range(self.nb):
            ni = i + self.nb * epoch
            lrs, mom = warmup_lrs(
                ni, self.nw, epoch, self.lr0, self.lf(epoch),
                warmup_bias_lr=float(get_hyperparameter(self.hyp, "warmup_bias_lr")),
                warmup_momentum=float(get_hyperparameter(self.hyp, "warmup_momentum")),
                momentum=momentum_h,
            )
            self._last_lrs = lrs
            active = [t for ti, t in enumerate(self.task_ids)
                      if self.iters_per_task is None or i % self.iters_per_task[ti] == 0]
            if not active:
                continue
            t0 = time.perf_counter()
            batches = {}
            for t in active:
                b = next(iters[t])
                if plots and i < 3:
                    self._plot_batch(t, i, b)
                batches[t] = {k: v for k, v in b.items() if k != "meta"}
            t1 = time.perf_counter()
            self.state, items = self.trainer.step(self.state, batches, lrs, mom,
                                                  freeze_shared=freeze)
            self.timings.append({"epoch": epoch, "data_s": t1 - t0,
                                 "step_s": time.perf_counter() - t1})
            for t in active:
                # summed on the card: a float() here would wait for every step
                it = items[t]
                vec = torch.stack([it.box, it.cls, it.dfl]).detach()
                mloss[t] = vec if mloss[t] is None else mloss[t] + vec
                counts[t] += 1
        out = {t: (mloss[t].cpu().numpy() if mloss[t] is not None else np.zeros(3))
               / max(counts[t], 1) for t in self.task_ids}
        losses_str = "  ".join(f"{t}: box {out[t][0]:.3f} cls {out[t][1]:.3f} "
                               f"dfl {out[t][2]:.3f}" for t in self.task_ids)
        if self.is_main:
            print(f"epoch {epoch + 1}/{self.opt.epochs}  {losses_str}")
        return out

    # ------------------------------------------------------------------
    def val_epoch(self, epoch: int, plots: bool = False) -> float:
        """Per-task val of the EMA model, per-task best checkpoints; returns
        the mean fitness (base_trainer.py:114-194)."""
        draw = plots and not self.opt.nosave
        results_per_task = {}
        with eval_flags():
            for ti, task in enumerate(self.task_ids):
                out = run_task(self.state.ema, task, self.val_loaders[task],
                               nc=self.manager.nc[ti], names=self.manager.names[ti],
                               compute_loss=self.losses[task], plots=plots,
                               plots_dir=self.manager.save_dir if draw else None)
                results_per_task[task] = out["results"][:4]
                self.manager.val_log(task, out["results"], epoch, out["fitness"])
                if out["fitness"] > self.manager.best_fitness_per_task[task]:
                    self.manager.best_fitness_per_task[task] = out["fitness"]
                    self.manager.save_best_task_model(task, self.state, epoch)
                if draw:
                    save_val_plots(out, self.manager.names[ti], self.manager.save_dir, task)
        return overall_fitness(results_per_task)

    # ------------------------------------------------------------------
    def train(self) -> float:
        """The whole run; returns the best fitness (on ranks other than 0,
        the last fitness rank 0 broadcast)."""
        t0 = time.time()
        fi = 0.0
        for epoch in range(self.start_epoch, self.opt.epochs):
            mloss = self.train_epoch(epoch)
            stop = False
            if self.is_main:
                for t in self.task_ids:
                    self.manager.train_log(t, getattr(self, "_last_lrs", [0, 0, 0]), mloss[t],
                                           epoch)
                if not self.opt.noval:
                    final = epoch == self.opt.epochs - 1
                    fi = self.val_epoch(epoch, plots=final and self.opt.plots)
                is_best = fi >= self.manager.best_fitness
                if is_best:
                    self.manager.best_fitness = fi
                self.manager.save_model(self.state, epoch, is_best)
                stop = self.stopper(epoch, fi)
            stop, fi = self._broadcast_decision(stop, fi)
            if stop:
                break
        if self.opt.noval and self.is_main:  # a run without per-epoch vals validates once
            fi = self.val_epoch(self.opt.epochs - 1)
            self.manager.best_fitness = max(self.manager.best_fitness, fi)
        _, fi = self._broadcast_decision(False, fi)
        if not self.is_main:
            return fi
        dt = time.time() - t0
        if not self.opt.nosave and not self.opt.noval:
            self.final_val = self._final_val_on_ckpts()
        if not self.opt.nosave:
            # EMA promoted to params, optimizer state dropped (train.py:260)
            for name in ("last", "best"):
                p = self.manager.wdir / f"{name}.ckpt.npz"
                if p.exists():
                    strip_checkpoint(p)
        self.manager.finalize(self.opt.imgsz)
        print(f"training done in {dt / 3600:.2f}h, best fitness "
              f"{self.manager.best_fitness:.4f}")
        return self.manager.best_fitness

    def _final_val_on_ckpts(self) -> Dict[str, Dict[str, Any]]:
        """Validate the saved checkpoints (last, and best where it exists)
        through load_single, fused and EMA preferred, as a user loads them
        (train.py:233-254). Returns {name: {task: run_task's output}}."""
        out: Dict[str, Dict[str, Any]] = {}
        for name in ("last", "best"):
            p = self.manager.wdir / f"{name}.ckpt.npz"
            if not p.exists():
                continue
            model = load_single(str(p), fuse=True, device=self.device)[0]
            out[name] = {}
            with eval_flags():
                for ti, task in enumerate(self.task_ids):
                    res = run_task(model, task, self.val_loaders[task], nc=self.manager.nc[ti],
                                   names=self.manager.names[ti], verbose=True)
                    out[name][task] = res
                    mp, mr, map50, mAP = res["results"][:4]
                    print(f"final[{name}] {task}: P={mp:.4f} R={mr:.4f} "
                          f"mAP50={map50:.4f} mAP={mAP:.4f}")
            del model
        return out

    def close(self) -> None:
        """Free what the run holds: its captured steps and their graph pool,
        the loaders' worker processes and resident packs, the model, its
        state, losses and datasets, so that a process that runs TrainLoops
        one after another (the evolvers' generations) holds one at a time.
        The loop cannot train after it."""
        self.trainer.release()
        for loader in (*self.train_loaders.values(), *self.val_loaders.values()):
            close = getattr(loader, "close", None)
            if close is not None:
                close()
        self.train_loaders, self.val_loaders, self.datasets = {}, {}, {}
        self.trainer = self.state = self.model = self.losses = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _broadcast_decision(self, stop: bool, fitness: float):
        """Rank 0's (stop, fitness) on every rank (the identity in one
        process): every rank leaves the epoch loop together."""
        return broadcast_decision(stop, fitness, self.group)
