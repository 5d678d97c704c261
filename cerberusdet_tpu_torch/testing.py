"""Inputs that hold the NMS kernel against its plain version, shared by the
tests and chip_smoke.py. numpy only; every case is made from a seed."""

from __future__ import annotations

import numpy as np


def random_candidates(B: int, K: int, seed: int = 0, zeros_from=None, classes: int = 0):
    """Random xyxy boxes (B, K, 4) and scores (B, K) in float32. Scores are
    rounded to 2 decimals (many exact ties); scores from `zeros_from` on are
    0 (invalid). With `classes`, boxes are offset by cls * 4096 as
    ops/nms.py does for class-aware NMS."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(50, 600, (B, K, 2))
    wh = rng.uniform(10, 80, (B, K, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    if classes:
        boxes = boxes + rng.integers(0, classes, (B, K, 1)) * 4096.0
    scores = np.round(rng.uniform(0, 1, (B, K)), 2)
    if zeros_from is not None:
        scores[:, zeros_from:] = 0.0
    return boxes.astype(np.float32), scores.astype(np.float32)


def _iou_f32(a, b):
    """IoU of one pick `a` and boxes `b` in float32, in the NMS loop's order."""
    f = np.float32
    iw = np.maximum(np.minimum(a[2], b[..., 2]) - np.maximum(a[0], b[..., 0]), f(0))
    ih = np.maximum(np.minimum(a[3], b[..., 3]) - np.maximum(a[1], b[..., 1]), f(0))
    inter = iw * ih
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + f(1e-7))


def boundary_candidates(thr: float, n: int = 16, seed: int = 0):
    """n images of two boxes, a pick A (score 0.9) and a box B (score 0.5)
    whose float32 IoU with A is within one ulp of float32(thr): half of them
    just above it (B is suppressed), half at or just below (B is kept).
    Returns (boxes (n, 2, 4), scores (n, 2), iou (n,)) in float32."""
    f = np.float32
    t = f(thr)
    ulp = np.spacing(t)
    rng = np.random.default_rng(seed)
    above, below = [], []
    while len(above) < n // 2 or len(below) < n - n // 2:
        x, y = rng.uniform(0, 20, 2)
        w, h = rng.uniform(8, 30, 2)
        a = np.array([x, y, x + w, y + h], f)
        w32, h32 = a[2] - a[0], a[3] - a[1]
        # shift B right by dx so that (w - dx) h / (2wh - (w - dx) h) = thr
        dx = w32 - thr * 2 * w32 * h32 / (1 + thr) / h32
        bx1 = [f(a[0] + dx)]
        for _ in range(8):
            bx1.append(np.nextafter(bx1[-1], f(1e9)))
            bx1.insert(0, np.nextafter(bx1[0], f(-1e9)))
        for x1 in bx1:
            b = np.array([x1, a[1], x1 + w32, a[3]], f)
            iou = _iou_f32(a, b)
            if t < iou <= t + ulp and len(above) < n // 2:
                above.append((a, b, iou))
            elif t - ulp <= iou <= t and len(below) < n - n // 2:
                below.append((a, b, iou))
    rows = above + below
    boxes = np.stack([np.stack([a, b]) for a, b, _ in rows])
    scores = np.tile(np.array([0.9, 0.5], f), (len(rows), 1))
    return boxes, scores, np.array([r[2] for r in rows], f)
