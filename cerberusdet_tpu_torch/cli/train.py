"""Training entry point of the port:

    python -m cerberusdet_tpu_torch.cli.train --data data.yaml \
        --cfg configs/models/yolov8x_2task.yaml \
        --hyp configs/hyps/hyp.cerber-voc_obj365.yaml --batch-size 8,8 --bf16

Counterpart of the JAX package's train.py (the reference's
cerberusdet/train.py:279-414), with its flags, defaults and --resume
semantics (a checkpoint path, or `--resume` alone for the newest
last.ckpt.npz under --project by modification time; the run's saved opt.yaml
replaces the command line's flags and the run continues in its own
directory). --platform gives way to --device (the card, "cuda", by default;
"cpu" runs on the CPU), and --compile-cache, an XLA cache, has no
counterpart. --bf16 computes in bfloat16 over float32 master weights.
--augment-device runs the mosaic, warps, HSV jitter and flips on the card
from the packed cache (--cache-images disk, which it implies); --proc-workers
N decodes and augments (or, with --augment-device, plans) in N spawned
worker processes. --evolve N runs N generations of hyperparameter evolution
(evolve/: --evolver yolov5, the genetic evolver, or a Ray Tune searcher)
in <project>/<evolver>_<name>; --mlflow-url tracks the run in MLflow
(utils/mlflow_logging.py). --mesh trains data-parallel, one process per card
(train/trainer.py, parallel/mesh.py): the batch size is each process's, as
each JAX host's is, and the step is the one over all processes' rows:

    torchrun --nproc-per-node 4 -m cerberusdet_tpu_torch.cli.train --mesh \
        --data data.yaml --cfg configs/models/yolov8x_2task.yaml --batch-size 8,8 --bf16

Started without torchrun, --mesh forms a group of one on the card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import yaml

from cerberusdet_tpu_torch import resolve_device


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", default="",
                   help="pretrained .ckpt.npz, or a reference .pt (manager/pt_import.py)")
    p.add_argument("--cfg", default="configs/models/yolov8x.yaml")
    p.add_argument("--data", required=True)
    p.add_argument("--hyp", default="configs/hyps/hyp.cerber-default.yaml")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=str, default="16",
                   help="total batch size, int or per-task list '4,4,40'")
    p.add_argument("--imgsz", "--img-size", type=int, default=640)
    p.add_argument("--project", default="runs/train")
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--optimizer", default="SGD", choices=["SGD", "Adam", "AdamW", "RMSProp"])
    p.add_argument("--linear-lr", action="store_true")
    p.add_argument("--noval", action="store_true")
    p.add_argument("--nosave", action="store_true")
    p.add_argument("--patience", type=int, default=30)
    p.add_argument("--freeze-shared-till-epoch", type=int, default=0)
    p.add_argument("--skip-batches", action="store_true")
    p.add_argument("--balanced-sampler", action="store_true")
    p.add_argument("--labels-from-xml", action="store_true")
    p.add_argument("--use-multi-labels", action="store_true")
    p.add_argument("--use-soft-labels", action="store_true")
    p.add_argument("--cache-images", nargs="?", const="ram", default="",
                   choices=["", "ram", "disk"],
                   help="cache decoded images: ram, or disk (one packed memmap of every "
                        "image decoded and resized, reused across epochs and runs)")
    p.add_argument("--augment-device", action="store_true",
                   help="run mosaic / affine / HSV / flip augmentation on the card; the host "
                        "plans and copies packed-cache tiles (implies --cache-images disk)")
    p.add_argument("--single-cls", action="store_true",
                   help="train multi-class data as single-class")
    p.add_argument("--workers", type=int, default=None,
                   help="dataloader decode threads (reference --workers)")
    p.add_argument("--proc-workers", type=int, default=0,
                   help="decode / augment in N worker processes instead of threads")
    p.add_argument("--sync-bn", action="store_true",
                   help="accepted for parity: under --mesh the BatchNorm statistics are "
                        "those of the global batch by construction (nn/module.py)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute over float32 master weights")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel over the processes torchrun starts, one per card")
    p.add_argument("--resume", nargs="?", const="auto", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-min-iters", type=int, default=1000,
                   help="LR-warmup iteration floor (reference hardcodes 1000, "
                        "averaging.py:57); lower it for small datasets")
    p.add_argument("--mlflow-url", type=str, default="",
                   help="MLflow tracking server (a no-op logger without mlflow)")
    p.add_argument("--experiment-name", type=str, default="cerberusdet")
    p.add_argument("--evolve", type=int, nargs="?", const=300, default=0,
                   help="evolve hyperparameters for N generations")
    p.add_argument("--evolver", type=str, default="yolov5",
                   choices=["yolov5", "random", "ax", "optuna", "bohb", "cfo",
                            "dragonfly", "nevergrad", "skopt", "zoopt"],
                   help="evolution algorithm (train.py:293; the others than yolov5 "
                        "dispatch to the Ray Tune evolver)")
    p.add_argument("--params-to-evolve", type=str, default=None,
                   help="comma-separated hyps to evolve (default: all)")
    p.add_argument("--evolve-per-task", action="store_true",
                   help="accepted for parity (train.py:302; the reference parses but never "
                        "reads it: per-task evolution follows list-valued hyps)")
    p.add_argument("--device", default="cuda", help="'cuda' (the card) or 'cpu'")
    return p.parse_args(argv)


def _batch_size(bs):
    if isinstance(bs, (int, list)):
        return bs
    bs = [int(x) for x in str(bs).split(",")]
    return bs[0] if len(bs) == 1 else bs


def evolver(opt, opt_ns, hyp, data_dict, device, seed=None):
    """The evolver that --evolve asks for (train.py:172-192 of the JAX
    package): the run named {evolver}_{name}, Yolov5Evolver for yolov5,
    RayEvolver with the named searcher for the others."""
    opt.name = f"{opt_ns.evolver}_{opt.name}"
    params = opt_ns.params_to_evolve.split(",") if opt_ns.params_to_evolve else None
    kw = dict(generations=opt_ns.evolve, params_to_evolve=params, device=device)
    if opt_ns.evolver == "yolov5":
        from cerberusdet_tpu_torch.evolve.yolov5_evolver import Yolov5Evolver

        return Yolov5Evolver(opt, hyp, data_dict, seed=seed, **kw)
    from cerberusdet_tpu_torch.evolve.ray_evolver import RayEvolver

    return RayEvolver(opt, hyp, data_dict, searcher=opt_ns.evolver, **kw)


def options(argv=None):
    """The command line as (the parsed flags, TrainOptions, hyp, the data
    config, the device), with --resume's opt.yaml reinstated and the seeds
    set."""
    from cerberusdet_tpu_torch.manager.run_manager import parse_data_config
    from cerberusdet_tpu_torch.train.trainer import TrainOptions
    from cerberusdet_tpu_torch.utils.seeds import init_seeds

    opt_ns = parse_opt(argv)
    device = resolve_device(opt_ns.device)
    resume = opt_ns.resume
    if resume == "auto":
        # newest by modification time, not by name (exp9 > exp10)
        runs = sorted(Path(opt_ns.project).glob("*/weights/last.ckpt.npz"),
                      key=lambda p: p.stat().st_mtime)
        if not runs:
            sys.exit("--resume: no previous run found")
        resume = str(runs[-1])
    if resume:
        # the interrupted run's own settings (train.py:346-356): its opt.yaml
        # replaces the command line's flags, and it resumes in its directory
        run_dir = Path(resume).parent.parent
        opt_yaml = run_dir / "opt.yaml"
        if opt_yaml.exists():
            with open(opt_yaml) as f:
                saved = yaml.safe_load(f) or {}
            for k in ("resume", "project", "name", "exist_ok"):
                saved.pop(k, None)
            for k, v in saved.items():
                if hasattr(opt_ns, k):
                    setattr(opt_ns, k, v)
            opt_ns.bf16 = saved.get("compute_dtype") == "bfloat16"
            opt_ns.mesh = bool(saved.get("use_mesh", opt_ns.mesh))
            opt_ns.project = str(run_dir.parent)
            opt_ns.name = run_dir.name
            opt_ns.exist_ok = True
    init_seeds(opt_ns.seed)
    with open(opt_ns.hyp) as f:
        hyp = yaml.safe_load(f)
    data_dict = parse_data_config(opt_ns.data, check=True)

    opt = TrainOptions(
        cfg=opt_ns.cfg, data=opt_ns.data, hyp=opt_ns.hyp, weights=opt_ns.weights,
        epochs=opt_ns.epochs, batch_size=_batch_size(opt_ns.batch_size), imgsz=opt_ns.imgsz,
        project=opt_ns.project, name=opt_ns.name, exist_ok=opt_ns.exist_ok,
        optimizer=opt_ns.optimizer, linear_lr=opt_ns.linear_lr,
        noval=opt_ns.noval, nosave=opt_ns.nosave, patience=opt_ns.patience,
        freeze_shared_till_epoch=opt_ns.freeze_shared_till_epoch,
        skip_batches=opt_ns.skip_batches, balanced_sampler=opt_ns.balanced_sampler,
        labels_from_xml=opt_ns.labels_from_xml, use_multi_labels=opt_ns.use_multi_labels,
        use_soft_labels=opt_ns.use_soft_labels, cache_images=opt_ns.cache_images,
        augment_device=opt_ns.augment_device, single_cls=opt_ns.single_cls,
        workers=opt_ns.workers, proc_workers=opt_ns.proc_workers,
        warmup_min_iters=opt_ns.warmup_min_iters, use_mesh=opt_ns.mesh,
        seed=opt_ns.seed, resume=resume,
        mlflow_url=opt_ns.mlflow_url, experiment_name=opt_ns.experiment_name,
        compute_dtype="bfloat16" if opt_ns.bf16 else "float32",
    )
    return opt_ns, opt, hyp, data_dict, device


def main(argv=None):
    """Run the training; returns the TrainLoop that ran, or with --evolve
    the evolver."""
    from cerberusdet_tpu_torch.train.trainer import TrainLoop

    opt_ns, opt, hyp, data_dict, device = options(argv)
    if opt_ns.evolve:
        ev = evolver(opt, opt_ns, hyp, data_dict, device)
        ev.run_evolution()
        return ev
    loop = TrainLoop(opt, data_dict, hyp, device=device)
    loop.train()
    return loop


if __name__ == "__main__":
    main()
