"""End-to-end training throughput: the epoch loop, loaders and step together.

The port's counterpart of cerberusdet_tpu/tools/bench_train_e2e.py, mode
"host": train/trainer.py:TrainLoop over bench_loader.make_dataset's seeded
JPEGs (two tasks), host augmentation feeding the step, as cli/train.py runs
it (bf16 compute, --nosave --noval). One epoch warms the loaders and the
kernels; the next is timed, ending in the host read of the epoch's losses.
The decoded images stay in memory (cache_images "ram"), where the JAX tool
packs them into its disk cache, which the port does not have yet. The JAX
tool's "device" mode (augmentation on the accelerator) is not ported yet
(ROADMAP.md queue 1, item 8): --mode device and both raise.

Usage: python -m cerberusdet_tpu_torch.tools.bench_train_e2e
         [--cfg configs/models/yolov8x_2task.yaml] [--imgsz 640] [--batch 8] [--n 128]
Prints one JSON line {"mode", "imgs_per_sec", "sec_per_epoch", "imgs", "imgsz",
"batch", "cfg", "hyp"}.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

DEVICE_MODE = ("--mode device (augmentation on the card) is not ported yet "
               "(ROADMAP.md queue 1, item 8)")


def run_host(args, root: Path):
    import yaml

    from cerberusdet_tpu_torch.train.trainer import TrainLoop, TrainOptions

    with open(args.hyp) as f:
        hyp = yaml.safe_load(f)
    data = {
        "train": [str(root / t / "images" / "train") for t in ("t1", "t2")],
        "val": [str(root / t / "images" / "train") for t in ("t1", "t2")],
        "nc": [20, 19], "names": [[str(i) for i in range(20)], [str(i) for i in range(19)]],
        "task_ids": ["t1", "t2"],
    }
    opt = TrainOptions(
        cfg=args.cfg, epochs=3, batch_size=args.batch, imgsz=args.imgsz,
        project=str(root / "runs"), name="bench", exist_ok=True,
        noval=True, nosave=True, plots=False, seed=0, cache_images="ram",
        compute_dtype="bfloat16", max_labels=args.max_labels, workers=args.workers,
    )
    loop = TrainLoop(opt, data, hyp, device=args.device)
    loop.train_epoch(0)  # warm: loaders, caches, kernels
    n_img = sum(len(loop.datasets[t]) // b * b for t, b in zip(loop.task_ids, loop.batch_sizes))
    t0 = time.perf_counter()
    loop.train_epoch(1)  # ends in the host read of the epoch's losses
    dt = time.perf_counter() - t0
    out = {"mode": "host", "imgs_per_sec": round(n_img / dt, 1),
           "sec_per_epoch": round(dt, 2), "imgs": n_img, "imgsz": args.imgsz,
           "batch": args.batch, "cfg": args.cfg, "hyp": args.hyp}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    p.add_argument("--hyp", default="configs/hyps/hyp.cerber-default.yaml")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=128, help="images per task")
    p.add_argument("--max-labels", type=int, default=60)
    p.add_argument("--workers", type=int, default=None, help="decode threads a task")
    p.add_argument("--mode", choices=["host", "device", "both"], default="host")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.mode != "host":
        raise NotImplementedError(DEVICE_MODE)

    from cerberusdet_tpu_torch.tools.bench_loader import make_dataset

    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        for t in ("t1", "t2"):
            make_dataset(root / t, args.n, args.imgsz)
        return run_host(args, root)


if __name__ == "__main__":
    main()
