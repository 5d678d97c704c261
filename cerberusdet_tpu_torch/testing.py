"""Inputs that hold the kernels against their plain versions, seeded train
batches, seeded val sets and a BatchNorm calibration for seeded models,
shared by the tests and chip_smoke.py. numpy; cv2 and torch only inside the
helpers that write images or touch a model. Every case is made from a seed."""

from __future__ import annotations

import numpy as np


def random_candidates(B: int, K: int, seed: int = 0, zeros_from=None, classes: int = 0,
                      low: float = 0.0, size=(10, 80)):
    """Random xyxy boxes (B, K, 4), side lengths uniform in `size`, and
    scores (B, K) in float32. Scores are uniform in [low, 1) rounded to 2
    decimals (many exact ties; with low < 0 some negative and some -0.0);
    scores from `zeros_from` on are min(score, 0): 0, or negative where low
    < 0 drew them so. With `classes`, boxes are offset by cls * 4096 as
    ops/nms.py does for class-aware NMS."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(50, 600, (B, K, 2))
    wh = rng.uniform(*size, (B, K, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    if classes:
        boxes = boxes + rng.integers(0, classes, (B, K, 1)) * 4096.0
    scores = np.round(rng.uniform(low, 1, (B, K)), 2)
    if zeros_from is not None:
        scores[:, zeros_from:] = np.minimum(scores[:, zeros_from:], 0.0)
    return boxes.astype(np.float32), scores.astype(np.float32)


def duplicate_candidates(B: int, K: int, seed: int = 0):
    """random_candidates in which every box appears three times, at scattered
    indices, with one score for its copies: the lowest-index copy must win
    and suppress the others."""
    boxes, scores = random_candidates(B, -(-K // 3), seed)
    order = np.random.default_rng(seed + 1).permutation(3 * boxes.shape[1])[:K]
    src = order % boxes.shape[1]
    return np.ascontiguousarray(boxes[:, src]), np.ascontiguousarray(scores[:, src])


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


def tal_scene(seed: int, B: int = 2, N: int = 256, NC: int = 7, M: int = 12,
              dense: bool = False, empty_first: bool = False):
    """A TAL assigner input, the scenes of tests/test_tal_pallas.py: random
    anchors and predicted boxes, valid gts first in each row. dense puts
    overlapping gts around one region (anchors claimed by several gts);
    empty_first leaves image 0 without gts. Returns (pd_scores (B, N, NC),
    pd_bboxes (B, N, 4), anc (N, 2), gt_labels (B, M) int64, gt_bboxes
    (B, M, 4), mask_gt (B, M) bool), float32."""
    rng = np.random.default_rng(seed)
    pd_scores = rng.uniform(0, 1, (B, N, NC)).astype(np.float32)
    anc = rng.uniform(0, 64, (N, 2)).astype(np.float32)
    wh = rng.uniform(2, 20, (B, N, 2)).astype(np.float32)
    pd_bboxes = np.concatenate([anc[None] - wh / 2, anc[None] + wh / 2], -1)
    gt_bboxes = np.zeros((B, M, 4), np.float32)
    gt_labels = np.zeros((B, M), np.int64)
    mask_gt = np.zeros((B, M), bool)
    for b in range(B):
        if empty_first and b == 0:
            continue
        n_gt = int(rng.integers(M // 2, M)) if dense else int(rng.integers(3, M))
        for m in range(n_gt):
            if dense:
                cx, cy = rng.uniform(24, 40, 2)
                w, h = rng.uniform(20, 40, 2)
            else:
                cx, cy = rng.uniform(8, 56, 2)
                w, h = rng.uniform(6, 30, 2)
            gt_bboxes[b, m] = [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]
            gt_labels[b, m] = rng.integers(0, NC)
            mask_gt[b, m] = True
    return pd_scores, pd_bboxes, anc, gt_labels, gt_bboxes, mask_gt


def crowded_tal_scene(seed: int, B: int = 2, NC: int = 7, M: int = 72):
    """A TAL input whose anchors are mostly claimed by several gts: one block
    of the kernel's anchors (a 16 x 16 grid of stride 4, N = 256) under M -
    8 valid gts of side 12-20 spread over the field, with predicted boxes of
    that size around each anchor, so that each gt's top-10 is the anchors
    around it and neighbouring gts share them. The last 8 rows are invalid.
    Returns the arrays of tal_scene."""
    rng = np.random.default_rng(seed)
    g = (np.arange(16, dtype=np.float32) + 0.5) * 4
    gy, gx = np.meshgrid(g, g, indexing="ij")
    anc = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    N = anc.shape[0]
    pd_scores = rng.uniform(0, 1, (B, N, NC)).astype(np.float32)
    wh = rng.uniform(12, 20, (B, N, 2))
    ctr = anc[None] + rng.uniform(-2, 2, (B, N, 2))
    pd_bboxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    c = rng.uniform(4, 60, (B, M, 2))
    s = rng.uniform(12, 20, (B, M, 2))
    gt_bboxes = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    gt_labels = rng.integers(0, NC, (B, M)).astype(np.int64)
    mask_gt = np.arange(M)[None].repeat(B, 0) < M - 8
    return pd_scores, pd_bboxes, anc, gt_labels, gt_bboxes, mask_gt


def sparse_tal_scene(seed: int, B: int = 2, N: int = 333, NC: int = 7, M: int = 12):
    """tal_scene at an N that need not be a multiple of 32 or of a kernel
    block, with gt 0 of each image valid and shrunk to a 5 x 5 box around
    anchor 0, so that its row holds fewer than 10 anchors: its top-10 ends
    in zeros outside it, which select as -1. Returns the arrays of
    tal_scene."""
    scene = tal_scene(seed, B=B, N=N, NC=NC, M=M)
    cx, cy = scene[2][0]
    scene[4][:, 0] = [cx - 2.5, cy - 2.5, cx + 2.5, cy + 2.5]
    scene[5][:, 0] = True
    return scene


def norm_scene(seed: int, B: int, N: int, M: int, nc: int, fg_share: float = 0.3):
    """tal_norm's inputs as tal_assign writes them: tgt (B, N) int64 in
    [0, M), fg (B, N) bool (about fg_share of the anchors; 0 for an
    all-background batch), labels (B, N) int64 in [0, nc), align (B, N)
    float32 and pos (B, M, 2) float32 (each gt's max align and max CIoU),
    all >= 0, with exact zeros among them."""
    rng = np.random.default_rng(seed)
    tgt = rng.integers(0, M, (B, N)).astype(np.int64)
    fg = rng.uniform(0, 1, (B, N)) < fg_share
    labels = rng.integers(0, nc, (B, N)).astype(np.int64)
    align = rng.uniform(0, 1, (B, N)).astype(np.float32)
    align[rng.uniform(0, 1, (B, N)) < 0.1] = 0.0
    pos = rng.uniform(0, 1, (B, M, 2)).astype(np.float32)
    pos[..., 0] = np.maximum(pos[..., 0], 0.05)
    pos[:, 0, 1] = 0.0
    return tgt, fg, labels, align, pos


def tied_tal_scene(seed: int, B: int = 2, side: int = 24, NC: int = 5, M: int = 10):
    """A TAL input with many exactly tied metrics: anchors on a side x side
    grid of stride 4; large gts, so that each holds dozens of anchors; the
    predicted boxes of 85% of the anchors lie far from every gt (CIoU
    clipped to 0) and half of the scores are exactly 0, so most of each
    gt's top-10 are ties at 0 that only the lowest index decides. Every
    other gt starts at the grid's first row, so that some of those zeros lie
    inside it and become positives. Valid gts are not a prefix of the row,
    and invalid rows hold boxes of their own."""
    rng = np.random.default_rng(seed)
    g = (np.arange(side, dtype=np.float32) + 0.5) * 4
    gy, gx = np.meshgrid(g, g, indexing="ij")
    anc = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)
    N = anc.shape[0]
    pd_scores = rng.uniform(0, 1, (B, N, NC)).astype(np.float32)
    pd_scores[rng.uniform(0, 1, (B, N, NC)) < 0.5] = 0.0
    wh = rng.uniform(4, 24, (B, N, 2)).astype(np.float32)
    ctr = np.broadcast_to(anc[None], (B, N, 2)).copy()
    far = rng.uniform(0, 1, (B, N)) < 0.85
    ctr[far] += 10 * side * 4
    pd_bboxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    c = rng.uniform(8, side * 4 - 8, (B, M, 2))
    s = rng.uniform(16, side * 2, (B, M, 2))
    gt_bboxes = np.concatenate([c - s / 2, c + s / 2], -1).astype(np.float32)
    # every other gt starts at the grid's first row, near its first column:
    # its top-10 then reaches zeros inside it before zeros elsewhere
    x1y1 = np.stack([rng.uniform(0, 20, (B, M)), rng.uniform(-4, 1, (B, M))], -1)
    top = np.concatenate([x1y1, x1y1 + s], -1).astype(np.float32)
    gt_bboxes[:, ::2] = top[:, ::2]
    gt_labels = rng.integers(-1, NC + 1, (B, M)).astype(np.int64)  # clipped to [0, NC-1]
    mask_gt = rng.uniform(0, 1, (B, M)) < 0.6
    mask_gt[:, 1] = True
    mask_gt[:, 0] = False
    return pd_scores, pd_bboxes, anc, gt_labels, gt_bboxes, mask_gt


def train_batches(tasks, ncs, batch: int, imgsz: int, max_labels: int, n_real: int,
                  seed: int = 0):
    """Seeded train batches {task: {'img', 'cls', 'bboxes', 'mask', 'prob'}}:
    uniform images, max_labels gt rows of which the first n_real are valid,
    xywh boxes uniform in [0.2, 0.6] (cerberusdet_tpu/tools/
    bench_train_step.py:make_batches)."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, nc in zip(tasks, ncs):
        out[t] = {
            "img": rng.uniform(0, 1, (batch, imgsz, imgsz, 3)).astype(np.float32),
            "cls": rng.integers(0, nc, (batch, max_labels)).astype(np.int32),
            "bboxes": rng.uniform(0.2, 0.6, (batch, max_labels, 4)).astype(np.float32),
            "mask": (np.arange(max_labels)[None] < n_real).repeat(batch, 0),
            "prob": np.ones((batch, max_labels), np.float32),
        }
    return out


def write_val_set(root, n: int, sizes, seed: int = 0, n_labels: int = 0, nc: int = 1):
    """Write n JPEG images under root/images/val, their native sizes (w, h)
    cycling through `sizes`: 15 x 20 uniform noise upsampled (bicubic) with 6
    flat rectangles over it. With n_labels, each image gets a txt label file
    under root/labels/val of n_labels rows "cls cx cy w h", classes in
    [0, nc), boxes inside the image. Returns the image directory."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images", "val")
    lb_dir = os.path.join(root, "labels", "val")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(n):
        w, h = sizes[i % len(sizes)]
        im = cv2.resize(rng.integers(0, 256, (15, 20, 3), dtype=np.uint8), (w, h),
                        interpolation=cv2.INTER_CUBIC)
        for _ in range(6):
            rw, rh = int(rng.integers(w // 16, w // 3)), int(rng.integers(h // 16, h // 3))
            x1, y1 = int(rng.integers(0, w - rw)), int(rng.integers(0, h - rh))
            im[y1:y1 + rh, x1:x1 + rw] = rng.integers(0, 256, 3)
        cv2.imwrite(os.path.join(img_dir, f"{i:04d}.jpg"), im, [cv2.IMWRITE_JPEG_QUALITY, 90])
        if n_labels:
            os.makedirs(lb_dir, exist_ok=True)
            wh = rng.uniform(0.05, 0.5, (n_labels, 2))
            c = wh / 2 + rng.uniform(0, 1, (n_labels, 2)) * (1 - wh)
            cls = rng.integers(0, nc, n_labels)
            with open(os.path.join(lb_dir, f"{i:04d}.txt"), "w") as f:
                f.writelines(f"{k} {x:.6f} {y:.6f} {bw:.6f} {bh:.6f}\n"
                             for k, (x, y), (bw, bh) in zip(cls, c, wh))
    return img_dir


def write_labels(dets) -> int:
    """Write the txt labels of the images in `dets` ({image path: (n, 6)
    [x1, y1, x2, y2, conf, cls] in the image's native pixels}, as
    evaluation/val.py:run_task returns them): a row "cls cx cy w h"
    (normalised) for each box at least 1 px wide and high. Returns the rows
    written."""
    import os

    import cv2

    n = 0
    for path, det in dets.items():
        h, w = cv2.imread(path).shape[:2]
        rows = [(int(c), (x1 + x2) / 2 / w, (y1 + y2) / 2 / h, (x2 - x1) / w, (y2 - y1) / h)
                for x1, y1, x2, y2, _, c in det if x2 - x1 > 1 and y2 - y1 > 1]
        lb = path.replace(f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}")
        os.makedirs(os.path.dirname(lb), exist_ok=True)
        with open(lb.rsplit(".", 1)[0] + ".txt", "w") as f:
            f.writelines(f"{c} {x:.6f} {y:.6f} {bw:.6f} {bh:.6f}\n" for c, x, y, bw, bh in rows)
        n += len(rows)
    return n


def calibrate_bn(model, x) -> None:
    """Set every BatchNorm's running statistics of the (unfused) port model to
    the batch statistics of its input in one eval forward of x (B, 3, H, W),
    in place. A random init alone lets the activations of the deep nets
    vanish (~1e-7 at the Detect towers of yolov8n and yolov8x), so that
    every anchor scores the prior bias whatever the image; with statistics
    from a batch each layer's input is normalised as in training, and the
    predictions depend on the image."""
    import torch

    from cerberusdet_tpu_torch.nn.module import BatchNorm

    def take_stats(bn, args):
        mean, var, _ = bn.batch_stats(args[0])
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)

    hooks = [m.register_forward_pre_hook(take_stats) for m in model.modules()
             if isinstance(m, BatchNorm)]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)


# A 2-task model config that uses every block of the main layer registry
# (DWConv, C2, C3, SPP, Focus and GhostConv beside Conv, C2f, Upsample and
# Concat), the heads at strides 8 / 16 / 32, the neck split after its second
# layer; yolov8n's multiples. Write it with yaml.safe_dump.
ZOO_CFG = {
    "depth_multiple": 0.33,
    "width_multiple": 0.25,
    "backbone": [
        [-1, 1, "Focus", [64, 3]],               # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],            # 1  P2/4
        [-1, 1, "C3", [128]],                    # 2
        [-1, 1, "GhostConv", [256, 3, 2]],       # 3  P3/8
        [-1, 2, "C2", [256]],                    # 4
        [-1, 1, "DWConv", [512, 3, 2]],          # 5  P4/16
        [-1, 1, "C3", [512]],                    # 6
        [-1, 1, "Conv", [512, 3, 2]],            # 7  P5/32
        [-1, 1, "SPP", [512, [5, 9, 13]]],       # 8
    ],
    "neck": [
        [8, 1, "nn.Upsample", [None, 2, "nearest"]],   # 9
        [[-1, 6], 1, "Concat", [1]],                   # 10
        [-1, 1, "C2", [256, False]],                   # 11
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],  # 12
        [[-1, 4], 1, "Concat", [1]],                   # 13
        [-1, 1, "C3", [256, False]],                   # 14  P3 out
        [-1, 1, "DWConv", [256, 3, 2]],                # 15
        [[-1, 11], 1, "Concat", [1]],                  # 16
        [-1, 1, "C2f", [256]],                         # 17  P4 out
        [-1, 1, "GhostConv", [512, 3, 2]],             # 18
        [[-1, 8], 1, "Concat", [1]],                   # 19
        [-1, 1, "C3", [512, False]],                   # 20  P5 out
    ],
    "head": [[[14, 17, 20], 1, "Detect", []]],
    "cerber": [[2, [[13], [14]]]],
}

# A 2-task model config that uses the four blocks of the second registry
# that the JAX parser builds from yaml (BottleneckCSP, C3TR, CrossConv,
# GhostBottleneck; the other eight are modules for Python only), the heads
# at strides 8 / 16 / 32, the neck split after its second layer; yolov8n's
# multiples. Write it with yaml.safe_dump.
BLOCKS_CFG = {
    "depth_multiple": 0.33,
    "width_multiple": 0.25,
    "backbone": [
        [-1, 1, "Conv", [64, 3, 2]],                       # 0  P1/2
        [-1, 1, "Conv", [128, 3, 2]],                      # 1  P2/4
        [-1, 3, "BottleneckCSP", [128]],                   # 2
        [-1, 1, "Conv", [256, 3, 2]],                      # 3  P3/8
        [-1, 1, "GhostBottleneck", [256, 3, 1]],           # 4
        [-1, 1, "Conv", [512, 3, 2]],                      # 5  P4/16
        [-1, 1, "CrossConv", [512, 3, 1, 1, 1.0, True]],   # 6
        [-1, 1, "Conv", [512, 3, 2]],                      # 7  P5/32
        [-1, 1, "C3TR", [512]],                            # 8
    ],
    "neck": [
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],      # 9
        [[-1, 6], 1, "Concat", [1]],                       # 10
        [-1, 1, "BottleneckCSP", [256, False]],            # 11
        [-1, 1, "nn.Upsample", [None, 2, "nearest"]],      # 12
        [[-1, 4], 1, "Concat", [1]],                       # 13
        [-1, 1, "CrossConv", [256, 3, 1]],                 # 14  P3 out
        [-1, 1, "Conv", [256, 3, 2]],                      # 15
        [[-1, 11], 1, "Concat", [1]],                      # 16
        [-1, 1, "GhostBottleneck", [512, 3, 1]],           # 17  P4 out
        [-1, 1, "Conv", [512, 3, 2]],                      # 18
        [[-1, 8], 1, "Concat", [1]],                       # 19
        [-1, 1, "C3TR", [512, False]],                     # 20  P5 out
    ],
    "head": [[[14, 17, 20], 1, "Detect", []]],
    "cerber": [[2, [[13], [14]]]],
}
