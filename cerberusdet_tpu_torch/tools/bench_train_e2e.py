"""End-to-end training throughput: the epoch loop, loaders and step together,
host cv2 augmentation against augmentation on the card.

The port's counterpart of cerberusdet_tpu/tools/bench_train_e2e.py:
train/trainer.py:TrainLoop over bench_loader.make_dataset's seeded JPEGs
(two tasks) from the packed disk cache, as cli/train.py runs it (bf16
compute, --nosave --noval, the step replayed as a captured CUDA graph on the
card). Mode "host" augments on the loaders' threads; mode "device" plans on
the host and augments on the card (data/device_augment.py; the hyp picks the
warp route: the default hyps the einsum warp, the rotating voc_obj365 ones
the 3-pass affine warp). One epoch warms the loaders, the kernels and the
captured step; the next is timed, ending in the host read of the epoch's
losses.

Usage: python -m cerberusdet_tpu_torch.tools.bench_train_e2e
         [--cfg configs/models/yolov8x_2task.yaml] [--imgsz 640] [--batch 8] [--n 128]
         [--mode host|device|both] [--hyp ...] [--device cpu]
Prints one JSON line {"mode", "imgs_per_sec", "sec_per_epoch", "imgs", "imgsz",
"batch", "cfg", "hyp"} per mode.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path


def run_mode(device_aug: bool, args, root: Path):
    """One mode over the two tasks' sets under `root`. Returns (the JSON
    line's dict, the TrainLoop, which holds the model: drop it)."""
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
        noval=True, nosave=True, plots=False, seed=0, cache_images="disk",
        augment_device=device_aug, compute_dtype="bfloat16", max_labels=args.max_labels,
        workers=args.workers,
    )
    loop = TrainLoop(opt, data, hyp, device=args.device)
    loop.train_epoch(0)  # warm: loaders, packs, kernels, the captured step
    n_img = sum(len(loop.datasets[t]) // b * b for t, b in zip(loop.task_ids, loop.batch_sizes))
    t0 = time.perf_counter()
    loop.train_epoch(1)  # ends in the host read of the epoch's losses
    dt = time.perf_counter() - t0
    out = {"mode": "device" if device_aug else "host", "imgs_per_sec": round(n_img / dt, 1),
           "sec_per_epoch": round(dt, 2), "imgs": n_img, "imgsz": args.imgsz,
           "batch": args.batch, "cfg": args.cfg, "hyp": args.hyp}
    print(json.dumps(out), flush=True)
    return out, loop


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", default="configs/models/yolov8x_2task.yaml")
    p.add_argument("--hyp", default="configs/hyps/hyp.cerber-default.yaml",
                   help="rotating hyps (voc_obj365) take the 3-pass affine device warp")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--n", type=int, default=128, help="images per task")
    p.add_argument("--max-labels", type=int, default=60)
    p.add_argument("--workers", type=int, default=None, help="decode threads a task")
    p.add_argument("--mode", choices=["host", "device", "both"], default="both")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the last mode's JSON line's dict."""
    from cerberusdet_tpu_torch.tools.bench_loader import make_dataset

    args = parse_opt(argv)
    modes = {"host": [False], "device": [True], "both": [False, True]}[args.mode]
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        for t in ("t1", "t2"):
            make_dataset(root / t, args.n, args.imgsz)
        for device_aug in modes:
            out, loop = run_mode(device_aug, args, root)
            for loader in loop.train_loaders.values():
                loader.close()
            del loop
    return out


if __name__ == "__main__":
    main()
