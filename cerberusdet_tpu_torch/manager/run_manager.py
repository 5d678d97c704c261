"""Run lifecycle: data configs, run directories, the model, checkpoints and
logs.

Counterpart of cerberusdet_tpu/manager/run_manager.py (the reference's
cerberusdet/utils/models_manager.py and general.py:596-610): increment_path,
parse_data_config and RunManager (:74-259), which owns the run directory
(hyp.yaml, opt.yaml, weights/), builds or loads the model, writes the
`.ckpt.npz` checkpoints in the JAX package's format (last, best and the
per-task bests) and the per-epoch logs (results.txt in the JAX package's
lines; TensorBoard where torch.utils.tensorboard imports). With `mlflow_url`
the run is also tracked in MLflow (utils/mlflow_logging.py, as the JAX
package's :97-113 and :214-259): the hyps and options at the start, the
losses, learning rates and val metrics per epoch, and at the end
results.txt, the plots and the best checkpoint with its signature.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml

from cerberusdet_tpu_torch.manager.checkpoint import (
    intersect_trees,
    load_checkpoint,
    save_checkpoint,
)
from cerberusdet_tpu_torch.manager.weights import (
    export_jax_momentum,
    export_jax_params,
    load_jax_params,
)
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.utils.checks import apply_path_prefix, check_dataset


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/train/exp -> exp2, exp3, ... (general.py:596-610)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    for n in range(2, 9999):
        p = Path(f"{path}{n}")
        if not p.exists():
            return p
    raise RuntimeError("too many run dirs")


def parse_data_config(data: Any, check: bool = False) -> Dict[str, Any]:
    """Load data.yaml (or take a dict); promote single-task scalars to
    1-element lists (models_manager.py:61-96). With check=True, resolve the
    optional `path` prefix and verify the val paths (utils/checks.py)."""
    if isinstance(data, (str, Path)):
        with open(data) as f:
            d = yaml.safe_load(f)
    else:
        d = dict(data)
    if check:
        d = check_dataset(d)
    elif d.get("path"):
        d = apply_path_prefix(d)  # `path` is config semantics, applied unchecked too
    if not isinstance(d.get("nc"), list):
        d["nc"] = [d["nc"]]
        d["names"] = [d["names"]]
        d["train"] = [d["train"]]
        d["val"] = [d["val"]]
        if d.get("test") is not None:
            d["test"] = [d["test"]]
        d.setdefault("task_ids", ["detect"])
        if not isinstance(d["task_ids"], list):
            d["task_ids"] = [d["task_ids"]]
    n = len(d["task_ids"])
    for key in ("nc", "names", "train", "val"):
        if len(d[key]) != n:
            raise ValueError(f"data config: len({key}) != len(task_ids)")
    for nc, names in zip(d["nc"], d["names"]):
        if len(names) != nc:
            raise ValueError(f"data config: {nc} classes but {len(names)} names")
    return d


class RunManager:
    """Owns the run directory, the model, checkpoints and logs. The model is
    built on `device` (the card when None)."""

    def __init__(self, hyp: Dict[str, Any], data_dict: Dict[str, Any], cfg, save_dir,
                 exist_ok: bool = False, nosave: bool = False, mlflow_url: str = "",
                 experiment_name: str = "cerberusdet", device=None):
        self.hyp = dict(hyp)
        self.data = data_dict
        self.cfg = cfg
        self.device = device
        self.task_ids: List[str] = list(data_dict["task_ids"])
        self.nc: List[int] = list(data_dict["nc"])
        self.names: List[Sequence[str]] = list(data_dict["names"])
        self.nosave = nosave
        self.save_dir = increment_path(save_dir, exist_ok)
        self.wdir = self.save_dir / "weights"
        self.wdir.mkdir(parents=True, exist_ok=True)
        self.results_file = self.save_dir / "results.txt"
        self.best_fitness = 0.0
        self.best_fitness_per_task = {t: 0.0 for t in self.task_ids}
        self._tb = None
        # MLflow (models_manager.py:322-397, train.py:263-273): a no-op logger
        # without mlflow; TensorBoard and results.txt log either way
        self.mlflow = None
        if mlflow_url:
            from cerberusdet_tpu_torch.utils.mlflow_logging import MLFlowLogger

            self.mlflow = MLFlowLogger(experiment_name, self.save_dir.name,
                                       tracking_uri=mlflow_url)

    # ------------------------------------------------------------- setup
    def dump_settings(self, opt: Optional[dict] = None):
        with open(self.save_dir / "hyp.yaml", "w") as f:
            yaml.safe_dump(self.hyp, f, sort_keys=False)
        if opt is not None:
            with open(self.save_dir / "opt.yaml", "w") as f:
                yaml.safe_dump({k: (str(v) if isinstance(v, Path) else v)
                                for k, v in opt.items()}, f, sort_keys=False)
        if self.mlflow:
            self.mlflow.log_params({**self.hyp,
                                    **{f"opt/{k}": v for k, v in (opt or {}).items()}})

    def tb_writer(self):
        """A TensorBoard SummaryWriter on the run directory, or None where
        torch.utils.tensorboard does not import."""
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._tb = False
            else:
                self._tb = SummaryWriter(str(self.save_dir))
        return self._tb or None

    # ------------------------------------------------------------- model
    def load_model(self, pretrained: Optional[str] = None, seed: int = 0,
                   verbose: bool = False):
        """Build the model, initialised from `seed`, and, from a `pretrained`
        .ckpt.npz, holding its `ema` (else `params`) tensors wherever path and
        shape match, or, from a reference .pt, the tensors that
        manager/pt_import.py maps. Returns (model, start_meta)."""
        model = CerberusModel(self.cfg, self.task_ids, self.nc, device=self.device)
        model.init(seed)
        meta: Dict[str, Any] = {}
        if pretrained:
            p = str(pretrained)
            if p.endswith(".pt"):
                from cerberusdet_tpu_torch.manager.pt_import import import_pt

                return import_pt(model, p, verbose=verbose), meta
            ckpt = load_checkpoint(p)
            src = ckpt["ema"] if ckpt.get("ema") else ckpt["params"]
            params, matched, total = intersect_trees(export_jax_params(model), src)
            load_jax_params(model, params)
            if verbose:
                print(f"transferred {matched}/{total} tensors")
            meta = ckpt.get("meta", {})
        return model, meta

    # ----------------------------------------------------------- saving
    def ckpt_meta(self, epoch: int, n_updates: int, extra: Optional[dict] = None):
        meta = {
            "epoch": epoch,
            "n_updates": int(n_updates),
            "task_ids": self.task_ids,
            "nc": self.nc,
            "names": [list(n) for n in self.names],
            "cfg": (self.cfg if isinstance(self.cfg, dict) else str(self.cfg)),
            "hyp": self.hyp,
            "best_fitness": float(self.best_fitness),
            "best_fitness_per_task": {k: float(v) for k, v in
                                      self.best_fitness_per_task.items()},
        }
        if extra:
            meta.update(extra)
        return meta

    def save_model(self, state, epoch: int, is_best: bool):
        """last.ckpt.npz every call, in float32 (the resume artifact: a
        resumed run continues from the exact weights); best.ckpt.npz on a new
        best mean fitness, params and EMA in float16 (base_trainer.py:155-169).
        `state` is train/step.py's TrainState."""
        if self.nosave:
            return
        meta = self.ckpt_meta(epoch, state.n_updates)
        params = export_jax_params(state.model)
        ema = export_jax_params(state.ema)
        opt = export_jax_momentum(state.model, state.opt_state.momentum_buf)
        save_checkpoint(self.wdir / "last.ckpt.npz", params, meta, ema, opt, half=False)
        if is_best:
            save_checkpoint(self.wdir / "best.ckpt.npz", params, meta, ema, opt)

    def save_best_task_model(self, task: str, state, epoch: int):
        if self.nosave:
            return
        meta = self.ckpt_meta(epoch, state.n_updates, {"best_task": task})
        save_checkpoint(self.wdir / f"{task}_best.ckpt.npz", export_jax_params(state.model),
                        meta, export_jax_params(state.ema))

    # ---------------------------------------------------------- logging
    def train_log(self, task: str, lrs, mloss, epoch: int):
        tb = self.tb_writer()
        tags = [f"train/{task}/box_loss", f"train/{task}/cls_loss", f"train/{task}/dfl_loss"]
        if tb:
            for tag, v in zip(tags, mloss):
                tb.add_scalar(tag, float(v), epoch)
            for gi, lr in enumerate(lrs):
                tb.add_scalar(f"x/{task}/lr{gi}", float(lr), epoch)
        if self.mlflow:
            metrics = {t.replace(":", "_"): float(v) for t, v in zip(tags, mloss)}
            metrics.update({f"x/{task}/lr{gi}": float(lr) for gi, lr in enumerate(lrs)})
            self.mlflow.log_metrics(metrics, step=epoch)

    def val_log(self, task: str, results, epoch: int, fitness_val: float):
        mp, mr, map50, mAP = results[:4]
        tb = self.tb_writer()
        if tb:
            for tag, v in [
                (f"metrics/{task}/precision", mp), (f"metrics/{task}/recall", mr),
                (f"metrics/{task}/mAP_0.5", map50), (f"metrics/{task}/mAP_0.5:0.95", mAP),
                (f"metrics/{task}/fitness", fitness_val),
            ]:
                tb.add_scalar(tag, float(v), epoch)
        with open(self.results_file, "a") as f:
            f.write(f"epoch {epoch} task {task} "
                    f"P {mp:.5f} R {mr:.5f} mAP50 {map50:.5f} mAP {mAP:.5f} "
                    f"fitness {fitness_val:.5f}\n")
        if self.mlflow:
            self.mlflow.log_metrics({
                f"metrics/{task}/precision": float(mp),
                f"metrics/{task}/recall": float(mr),
                f"metrics/{task}/mAP_0.5": float(map50),
                f"metrics/{task}/mAP_0.5_0.95": float(mAP),
                f"metrics/{task}/fitness": float(fitness_val),
            }, step=epoch)

    def finalize(self, imgsz: int = 640):
        """End of training: flush and close the TensorBoard writer; with
        MLflow, upload results.txt and the plots and register the best
        checkpoint (else last) with its I/O signature (train.py:263-273)."""
        if self._tb:
            self._tb.close()
        self._tb = None
        if not self.mlflow:
            return
        self.mlflow.log_artifact(self.results_file)
        for png in sorted(Path(self.save_dir).glob("*.png")):
            self.mlflow.log_artifact(png, "plots")
        best = self.wdir / "best.ckpt.npz"
        ckpt = best if best.exists() else self.wdir / "last.ckpt.npz"
        self.mlflow.log_model(ckpt, signature={
            "inputs": f"(B, 3, {imgsz}, {imgsz}) float32 RGB in [0, 1], NCHW",
            "outputs": {t: f"(B, N, 4+{nc}) xywh+scores"
                        for t, nc in zip(self.task_ids, self.nc)},
        })
        self.mlflow.finish()
