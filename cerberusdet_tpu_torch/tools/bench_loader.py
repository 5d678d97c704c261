"""Input-pipeline throughput micro-benchmark.

The port's counterpart of cerberusdet_tpu/tools/bench_loader.py: host-side
images a second through the training data path of data/loaders.py (JPEG
decode -> mosaic / mixup / affine / HSV augmentation -> letterbox -> padded
collate), so that the loader's rate can be set beside the step's. The
JAX tool's worker processes (--proc-workers), packed disk cache
(--cache-images disk) and device augmentation (--device-augment) are not
ported yet and raise, as the port's loaders do (ROADMAP.md queue 1, items 2
and 8).

Usage:
    python -m cerberusdet_tpu_torch.tools.bench_loader [--imgsz 640] [--n 256]
        [--threads N] [--no-aug] [--batch 32] [--src-size 1920] [--fast-decode on|off|auto]
Prints one JSON line {"imgs_per_sec", "threads", "augment", "imgsz", "src_size",
"fast_decode", "cache_images", "device_augment"}.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import cv2
import numpy as np

AUG_HYP = dict(
    mosaic=1.0, mixup=0.1, degrees=0.0, translate=0.1, scale=0.5, shear=0.0,
    perspective=0.0, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, flipud=0.0, fliplr=0.5,
)


def make_dataset(root: Path, n_images: int, size: int) -> str:
    """n_images seeded noise JPEGs (noise compresses poorly: a realistic
    decode cost) of size x size under root/images/train, two labels each.
    Returns the image directory."""
    img_dir = root / "images" / "train"
    lb_dir = root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lb_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(n_images):
        im = rng.integers(0, 255, (size, size, 3), np.uint8)
        cv2.imwrite(str(img_dir / f"{i}.jpg"), im, [cv2.IMWRITE_JPEG_QUALITY, 90])
        (lb_dir / f"{i}.txt").write_text("0 0.5 0.5 0.4 0.4\n1 0.3 0.3 0.2 0.2")
    return str(img_dir)


def run(imgsz: int, n: int, threads, augment: bool, batch: int = 32, src_size: int = 0,
        fast_decode=None, num_workers: int = 0, cache_images="",
        augment_device: bool = False) -> float:
    """Images a second over n images after one warm batch."""
    from cerberusdet_tpu_torch.data.loaders import create_dataloader

    with tempfile.TemporaryDirectory() as td:
        path = make_dataset(Path(td), min(n, 128), src_size or imgsz)
        _, loader = create_dataloader(
            path, imgsz=imgsz, batch_size=batch, augment=augment,
            hyp=AUG_HYP if augment else None, task="bench", seed=0,
            host_sharded=False, num_threads=threads, fast_decode=fast_decode,
            num_workers=num_workers, cache_images=cache_images,
            augment_device=augment_device)
        it = iter(loader)
        next(it)  # warm the pipeline (thread pool, cv2, the native decoder's build)
        seen = 0
        t0 = time.perf_counter()
        while seen < n:
            try:
                b = next(it)
            except StopIteration:
                it = iter(loader)
                b = next(it)
            seen += len(b["img"])
        dt = time.perf_counter() - t0
        it.close()  # stop the prefetch thread before the directory goes
    return seen / dt


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--n", type=int, default=256)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--no-aug", action="store_true")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--src-size", type=int, default=0,
                   help="source JPEG long side (default: imgsz); set larger (e.g. 1920) to "
                        "exercise the native DCT-scaled decode")
    p.add_argument("--fast-decode", choices=["auto", "on", "off"], default="auto",
                   help="native DCT-scaled JPEG decode: auto = dataset default (on when "
                        "augmenting), on/off = force")
    p.add_argument("--cache-images", default="", choices=["", "ram", "disk"],
                   help="decoded-image cache mode (disk is not ported yet)")
    p.add_argument("--proc-workers", type=int, default=0,
                   help="worker processes (not ported yet)")
    p.add_argument("--device-augment", action="store_true",
                   help="augmentation on the card (not ported yet)")
    args = p.parse_args(argv)
    fast = {"auto": None, "on": True, "off": False}[args.fast_decode]
    rate = run(args.imgsz, args.n, args.threads, not args.no_aug, batch=args.batch,
               src_size=args.src_size,
               fast_decode=fast, num_workers=args.proc_workers,
               cache_images=args.cache_images, augment_device=args.device_augment)
    print(json.dumps({
        "imgs_per_sec": round(rate, 1),
        "threads": args.threads or "auto",
        "augment": not args.no_aug,
        "imgsz": args.imgsz,
        "src_size": args.src_size or args.imgsz,
        "fast_decode": args.fast_decode,
        "cache_images": args.cache_images,
        "device_augment": args.device_augment,
    }))
    return rate


if __name__ == "__main__":
    main()
