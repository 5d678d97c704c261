"""Generate a tiny synthetic 2-task detection dataset + data.yaml — the
quickstart/demo input (also the shape of every integration test's data).

The port's own copy of cerberusdet_tpu/tools/make_synthetic_data.py (numpy
and cv2 only): the same arguments write the same files, byte for byte.

Usage:
    python -m cerberusdet_tpu_torch.tools.make_synthetic_data --out DIR \
        [--n 16] [--imgsz 160]

Images contain colored rectangles on noise; labels are their true boxes, so
a short training run genuinely learns and val/detect show real detections.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def make_task(root: Path, task: str, nc: int, n: int, size: int, seed: int):
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        img_dir = root / task / "images" / split
        lb_dir = root / task / "labels" / split
        img_dir.mkdir(parents=True, exist_ok=True)
        lb_dir.mkdir(parents=True, exist_ok=True)
        for i in range(n):
            im = rng.integers(0, 80, (size, size, 3), np.uint8)
            lines = []
            for _ in range(int(rng.integers(1, 4))):
                c = int(rng.integers(0, nc))
                w, h = rng.uniform(0.2, 0.4, 2)
                x = rng.uniform(w / 2, 1 - w / 2)
                y = rng.uniform(h / 2, 1 - h / 2)
                x1, y1 = int((x - w / 2) * size), int((y - h / 2) * size)
                x2, y2 = int((x + w / 2) * size), int((y + h / 2) * size)
                # BGR (cv2's channel order): red / green / blue
                color = [(64, 64, 255), (64, 255, 64), (255, 64, 64)][c % 3]
                cv2.rectangle(im, (x1, y1), (x2, y2), color, -1)
                lines.append(f"{c} {x:.4f} {y:.4f} {w:.4f} {h:.4f}")
            cv2.imwrite(str(img_dir / f"{i:03d}.jpg"), im)
            (lb_dir / f"{i:03d}.txt").write_text("\n".join(lines))
    return [str(root / task / "images" / s) for s in ("train", "val")]


def main(argv=None):
    import yaml

    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=16, help="images per task/split")
    p.add_argument("--imgsz", type=int, default=160)
    args = p.parse_args(argv)

    root = Path(args.out)
    t1_train, t1_val = make_task(root, "shapes_a", 2, args.n, args.imgsz, 0)
    t2_train, t2_val = make_task(root, "shapes_b", 3, args.n, args.imgsz, 1)
    data = {
        "train": [t1_train, t2_train],
        "val": [t1_val, t2_val],
        "nc": [2, 3],
        "names": [["red", "green"], ["red", "green", "blue"]],
        "task_ids": ["shapes_a", "shapes_b"],
    }
    data_yaml = root / "data.yaml"
    data_yaml.write_text(yaml.safe_dump(data, sort_keys=False))
    print(f"wrote {data_yaml}")
    return str(data_yaml)


if __name__ == "__main__":
    main()
