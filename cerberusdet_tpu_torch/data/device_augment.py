"""Augmentation on the card: the training side's mosaic, warps, mixup, blurs,
grayscale, HSV jitter and flips as tensor operations over a batch, fed by the
packed disk cache's tiles.

Counterpart of cerberusdet_tpu/data/device_augment.py, with the same split:

  host    plan_sample() replays the dataset's random.Random(hash((seed,
          epoch, index))) stream and draws the same mosaic layout, warp
          matrix, mixup weight, pixel-op kernels, HSV gains and flips as
          DetectionDataset.__getitem__, and computes the labels with the same
          numpy code: labels equal the host pipeline's bit for bit. It
          touches no pixel; the pack's hw tables give every image's size.
  host    collate_device() stacks the plans of a batch and either copies the
          (4, or 8 with mixup) source tiles of each sample out of the pack
          (the shipped form) or lists their pack rows (the resident form,
          where the whole pack lives on the device).
  device  make_augment_fn() builds the function that turns a batch of plans
          into (B, S, S, 3) uint8 images, on the device of its inputs.

Where the JAX package vmaps one sample's program over the batch, every
function here takes the batch on its leading axis. Three routes warp the
mosaic canvas, as in the JAX package: `_warp` (a bilinear gather at four
corners a pixel, any matrix), `_warp_mm` (an axis-aligned warp as two
einsums a tile, the default hyps) and `_warp_affine3` (a rotating or
shearing affine warp as `_warp_mm` on a padded grid and two bounded shear
passes, the paper's hyps). What equals what (tests/test_torch_device_augment.py):
  * labels: the host pipeline's, bit for bit;
  * integer-translation warps: the host cv2 pixels, bit for bit;
  * every route against the JAX package's: at most 2 levels on fewer than 1%
    of pixels (float association and rounding-boundary flips);
  * the resident form equals the shipped form bit for bit.
Blur and median (p 0.1 each) run as one-sample variants that the loader
patches into the batch (data/loaders.py), as in the JAX package.

Requires cache_images="disk" (the dataset's packed cache).
"""

from __future__ import annotations

import contextlib
import math
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List

import numpy as np
import torch

from cerberusdet_tpu_torch.data.augment import build_perspective_matrix, warp_targets
from cerberusdet_tpu_torch.data.dataset import (
    DetectionDataset,
    mosaic_layout,
    xywhn2xyxy_np,
    xyxy2xywhn_np,
)
from cerberusdet_tpu_torch.ops.letterbox import letterbox_params

PAD = 114.0


# --------------------------------------------------------------------- plan
@dataclass
class SamplePlan:
    """Everything the device side needs for one sample (no pixels)."""

    tile_idx: np.ndarray   # (n_slots,) int32 pack rows, -1 = unused
    regions: np.ndarray    # (2, 4, 4) f32 canvas rects [x1, y1, x2, y2)
    offs: np.ndarray       # (2, 4, 2) f32 canvas->tile offsets (padw, padh)
    minv: np.ndarray       # (2, 3, 3) f32 output->canvas inverse warps
    minv0: np.ndarray      # (2, 3, 3) f32 axis-aligned part of minv = D.Shx.Shy
    shear: np.ndarray      # (2, 2) f32 (hx, hy) shear coefficients per warp
    mix_r: float           # mixup blend weight (1.0 = no mixup)
    hsv_mult: np.ndarray   # (3,) f32 h/s/v gain multipliers
    hsv_on: bool
    gray: bool
    blur_k: int            # box-blur kernel (0 = off)
    median_k: int          # median-blur kernel (0 = off)
    flipud: bool
    fliplr: bool
    labels: np.ndarray     # (n, 6) final [cls, prob, cx, cy, w, h] normalized
    meta: dict = field(default_factory=dict)

    @property
    def blurred(self) -> bool:
        return bool(self.blur_k or self.median_k)


def _decompose_affine(minv: np.ndarray):
    """Factor an affine inverse warp minv = M0 @ Shx @ Shy, with M0
    axis-aligned (diagonal + translation), Shx = [[1, h], [0, 1]] and Shy =
    [[1, 0], [g, 1]] (an LDU factorisation of the 2x2 block). Returns (minv0
    (3, 3) f32, (h, g) f32); a perspective or degenerate matrix returns
    (minv, zeros)."""
    a, b = float(minv[0, 0]), float(minv[0, 1])
    c, d = float(minv[1, 0]), float(minv[1, 1])
    det = a * d - b * c
    if (abs(minv[2, 0]) > 1e-12 or abs(minv[2, 1]) > 1e-12
            or abs(d) < 1e-8 or abs(det) < 1e-10):
        return minv.astype(np.float32), np.zeros(2, np.float32)
    g = c / d
    d1 = det / d
    h = b / d1
    m0 = np.array([[d1, 0, minv[0, 2]], [0, d, minv[1, 2]], [0, 0, 1]], np.float32)
    return m0, np.array([h, g], np.float32)


def required_shear_pad(hyp: dict, imgsz: int) -> int:
    """The padding K of the 3-pass affine warp: a bound on the shear passes'
    shift. For minv = (1/s) R(-theta) Sh^-1 (perspective 0) the decomposed
    |h|, |g| are bounded by b = (tan|theta|max + tan|alpha|max) / (1 - tan^2),
    and the x-shear pass runs on the K-padded rows, so K >= (b * imgsz + 1)
    / (1 - b). Returns 0 for an axis-aligned hyp (no shear passes) and for
    b >= 0.5 (no reasonable K: the gather route takes those)."""
    deg = float(hyp.get("degrees", 0.0))
    sh = float(hyp.get("shear", 0.0))
    if not (deg or sh):
        return 0
    t = math.tan(math.radians(min(abs(deg), 44.0))) + math.tan(math.radians(min(abs(sh), 44.0)))
    bound = t / max(1.0 - t * t, 0.5)
    if bound >= 0.5:
        return 0
    return int(math.ceil((bound * imgsz + 1.0) / (1.0 - bound))) + 2


def affine3_pad(hyp: dict, imgsz: int) -> int:
    """The K with which the loader runs a hyp's warps as the 3-pass affine
    warp, or 0 where another route takes them: perspective (the gather
    warp), axis-aligned hyps (the matmul warp) and a K past imgsz / 4."""
    if hyp.get("perspective", 0):
        return 0
    pad = required_shear_pad(hyp, imgsz)
    return pad if pad <= imgsz // 4 else 0


def _plan_mosaic_warp(ds: DetectionDataset, index: int, rng):
    """One mosaic and its perspective warp, drawing from rng as
    DetectionDataset.load_mosaic does. Returns (labels_px, tile_idx4,
    regions, offs, minv)."""
    s = ds.imgsz
    hyp = ds.hyp
    yc, xc, indices = ds.draw_mosaic_layout(index, rng)
    _, _, hw = ds._pack
    placements = mosaic_layout(s, yc, xc, [(int(hw[i, 0]), int(hw[i, 1])) for i in indices])
    labels4 = ds.mosaic_labels(indices, placements)
    M, sc, width, height = build_perspective_matrix(
        (2 * s, 2 * s), degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"], perspective=hyp["perspective"],
        border=ds.mosaic_border, scaleup=float(hyp.get("scaleup", 0.0)), rng=rng)
    labels = warp_targets(labels4, M, sc, width, height, hyp["perspective"])
    regions = np.zeros((4, 4), np.float32)
    offs = np.zeros((4, 2), np.float32)
    for t, ((x1a, y1a, x2a, y2a), (x1b, y1b, _, _), _) in enumerate(placements):
        regions[t] = (x1a, y1a, x2a, y2a)
        offs[t] = (x1a - x1b, y1a - y1b)
    minv = np.linalg.inv(M).astype(np.float32)
    return labels, np.asarray(indices, np.int32), regions, offs, minv


def _plan_letterbox_warp(ds: DetectionDataset, index: int, rng):
    """The branch without mosaic: letterbox and random_perspective as one
    warp of the source tile. A pack tile's long side is imgsz already, so the
    letterbox is an integer translation, folded into the inverse warp (a
    ratio other than 1 with cv2's pixel-centre convention src = (dst + 0.5)
    / r - 0.5)."""
    s = ds.imgsz
    hyp = ds.hyp
    _, hw0, hw = ds._pack
    h, w = int(hw[index, 0]), int(hw[index, 1])
    h0, w0 = int(hw0[index, 0]), int(hw0[index, 1])
    ratio, new_unpad, (dw, dh) = letterbox_params((h, w), (s, s), auto=False,
                                                  scaleup=ds.augment)
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    labels = ds.labels[index].copy()
    if len(labels):
        labels[:, 2:6] = xywhn2xyxy_np(labels[:, 2:6], ratio[0] * w, ratio[1] * h, dw, dh)
    M, sc, width, height = build_perspective_matrix(
        (s, s), degrees=hyp["degrees"], translate=hyp["translate"],
        scale=hyp["scale"], shear=hyp["shear"], perspective=hyp["perspective"],
        border=(0, 0), scaleup=float(hyp.get("scaleup", 0.0)), rng=rng)
    labels = warp_targets(labels, M, sc, width, height, hyp["perspective"])
    nw, nh = new_unpad
    rx, ry = w / max(nw, 1), h / max(nh, 1)
    linv = np.array([[rx, 0, (0.5 - left) * rx - 0.5],
                     [0, ry, (0.5 - top) * ry - 0.5],
                     [0, 0, 1]], np.float64)
    minv = (linv @ np.linalg.inv(M)).astype(np.float32)
    regions = np.zeros((4, 4), np.float32)
    offs = np.zeros((4, 2), np.float32)
    regions[0] = (0, 0, w, h)
    tile_idx = np.array([index, -1, -1, -1], np.int32)
    shapes = ((h0, w0), ((h / h0 * ratio[0], w / w0 * ratio[1]), (dw, dh)))
    return labels, tile_idx, regions, offs, minv, (h0, w0), shapes


def plan_sample(ds: DetectionDataset, index: int) -> SamplePlan:
    """The plan of item `index`: the draws and the label arithmetic of
    DetectionDataset.__getitem__, in the same order, without pixels."""
    if ds._pack is None:
        raise RuntimeError("augment_device requires cache_images='disk' (the packed memmap)")
    if not ds.augment:
        # __getitem__ augments nothing without augment: a plan would warp and flip
        raise RuntimeError("augment_device requires an augment=True dataset")
    index = int(ds.indices[index])
    rng = random.Random(hash((ds.seed, ds.epoch, index)))
    hyp = ds.hyp
    s = ds.imgsz
    n_slots = 8 if hyp["mixup"] > 0 else 4
    tile_idx = np.full(n_slots, -1, np.int32)
    regions = np.zeros((2, 4, 4), np.float32)
    offs = np.zeros((2, 4, 2), np.float32)
    minv = np.stack([np.eye(3, dtype=np.float32)] * 2)
    mix_r = 1.0
    if rng.random() < hyp["mosaic"]:
        labels, tile_idx[:4], regions[0], offs[0], minv[0] = _plan_mosaic_warp(ds, index, rng)
        meta = {"path": ds.img_files[index], "ori_shape": (s, s), "shapes": None}
        if rng.random() < hyp["mixup"]:
            idx2 = rng.randint(0, ds.n - 1)
            labels2, tile_idx[4:8], regions[1], offs[1], minv[1] = _plan_mosaic_warp(
                ds, idx2, rng)
            mix_r = rng.betavariate(32.0, 32.0)
            labels = np.concatenate((labels, labels2), 0)
    else:
        labels, tile_idx[:4], regions[0], offs[0], minv[0], ori, shapes = \
            _plan_letterbox_warp(ds, index, rng)
        meta = {"path": ds.img_files[index], "ori_shape": ori, "shapes": shapes}

    nl = len(labels)
    if nl:
        labels[:, 2:6] = xyxy2xywhn_np(labels[:, 2:6], w=s, h=s, clip=True, eps=1e-3)
    # PixelAugment's draws, in its order
    p = ds._pixel_aug
    blur_k = median_k = 0
    if rng.random() < p.p_blur:
        blur_k = rng.choice((3, 5, 7))
    if rng.random() < p.p_median:
        median_k = rng.choice((3, 5, 7))
    gray = rng.random() < p.p_gray
    hsv_on = bool(hyp["hsv_h"] or hyp["hsv_s"] or hyp["hsv_v"])
    hsv_mult = np.ones(3, np.float32)
    if hsv_on:
        u = np.array([rng.uniform(-1, 1) for _ in range(3)])
        hsv_mult = (u * [hyp["hsv_h"], hyp["hsv_s"], hyp["hsv_v"]] + 1).astype(np.float32)
    flipud = rng.random() < hyp["flipud"]
    if flipud and nl:
        labels[:, 3] = 1 - labels[:, 3]
    fliplr = rng.random() < hyp["fliplr"]
    if fliplr and nl:
        labels[:, 2] = 1 - labels[:, 2]
    minv0 = np.stack([np.eye(3, dtype=np.float32)] * 2)
    shear = np.zeros((2, 2), np.float32)
    # (the JAX package asks required_shear_pad here, which ignores perspective,
    # and so refuses every plan of a rotating hyp with perspective, whose
    # warps its loader gives the gather route)
    needs_3pass = affine3_pad(hyp, s) > 0
    for k in range(2):
        minv0[k], shear[k] = _decompose_affine(minv[k])
        # a failed decomposition returns (minv, 0): the 3-pass warp would drop
        # minv's off-diagonal terms and warp this sample wrongly
        if needs_3pass and abs(minv0[k][0, 1]) + abs(minv0[k][1, 0]) > 1e-6:
            raise RuntimeError(f"affine decomposition failed for a plan on the 3-pass shear "
                               f"path (minv={minv[k].tolist()})")
    return SamplePlan(tile_idx=tile_idx, regions=regions, offs=offs, minv=minv, minv0=minv0,
                      shear=shear, mix_r=float(mix_r), hsv_mult=hsv_mult, hsv_on=hsv_on,
                      gray=gray, blur_k=blur_k, median_k=median_k, flipud=flipud,
                      fliplr=fliplr, labels=labels.astype(np.float32), meta=meta)


# ------------------------------------------------------------------ collate
def collate_device(ds: DetectionDataset, plans: List[SamplePlan], max_labels: int = 300,
                   pool=None, as_indices: bool = False) -> Dict[str, Any]:
    """Plans -> a batch dict of numpy arrays: the padded labels, 'aug' (the
    plans' warp, blend and pixel fields stacked), 'meta', 'pixel_ops' ([(row,
    blur_k, median_k)] of the rows that draw a blur, when any does), and
    'tiles' (B, n_slots, S, S, 3) uint8 copied out of the pack (on `pool`'s
    threads when given; numpy copies release the GIL) or, as_indices,
    'tile_idx' (B, n_slots) int32 pack rows for a pack on the device."""
    from cerberusdet_tpu_torch.data.loaders import pad_labels

    b = len(plans)
    s = ds.imgsz
    n_slots = len(plans[0].tile_idx)
    out = {"aug": {
        "regions": np.stack([p.regions for p in plans]),
        "offs": np.stack([p.offs for p in plans]),
        "minv": np.stack([p.minv for p in plans]),
        "minv0": np.stack([p.minv0 for p in plans]),
        "shear": np.stack([p.shear for p in plans]),
        "mix_r": np.asarray([p.mix_r for p in plans], np.float32),
        "hsv_mult": np.stack([p.hsv_mult for p in plans]),
        "hsv_on": np.asarray([p.hsv_on for p in plans]),
        "gray": np.asarray([p.gray for p in plans]),
        "flipud": np.asarray([p.flipud for p in plans]),
        "fliplr": np.asarray([p.fliplr for p in plans]),
    }, "meta": [p.meta for p in plans], **pad_labels([p.labels for p in plans], max_labels)}
    ops = [(i, p.blur_k, p.median_k) for i, p in enumerate(plans) if p.blurred]
    if ops:
        out["pixel_ops"] = ops
    if as_indices:
        out["tile_idx"] = np.stack([p.tile_idx for p in plans])
        return out
    pack_arr = ds._pack[0]
    tiles = np.zeros((b, n_slots, s, s, 3), np.uint8)

    def fill(i):
        for j, idx in enumerate(plans[i].tile_idx):
            if idx >= 0:
                tiles[i, j] = pack_arr[idx]

    if pool is not None:
        list(pool.map(fill, range(b)))
    else:
        for i in range(b):
            fill(i)
    out["tiles"] = tiles
    return out


# ------------------------------------------------------------------- device
def _grid(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device)


def _resolve(src, tile_ids, regions, offs, cx, cy):
    """The mosaic canvas at integer coordinates: each point looked up in the
    4 disjoint tile regions of its sample, else the 114 border.

    src (N, S, S, 3) uint8: the whole pack, or every sample's shipped tiles;
    tile_ids (B, 4) rows of src per region; regions (B, 4, 4); offs (B, 4,
    2); cx, cy (B, H, W) int32. Returns (B, H, W, 3) float32."""
    S = src.shape[1]
    cxf = cx.float()[:, None]
    cyf = cy.float()[:, None]
    r = regions[..., None, None]  # (B, 4, 4, 1, 1)
    inside = ((cxf >= r[:, :, 0]) & (cxf < r[:, :, 2])
              & (cyf >= r[:, :, 1]) & (cyf < r[:, :, 3]))  # (B, 4, H, W)
    b = torch.arange(cx.shape[0], device=cx.device)[:, None, None]
    tid = inside.to(torch.uint8).argmax(1)  # the first region that holds the point
    off = offs[b, tid]  # (B, H, W, 2)
    tx = (cx - off[..., 0].int()).clamp(0, S - 1)
    ty = (cy - off[..., 1].int()).clamp(0, S - 1)
    row = tile_ids.long().clamp(0, src.shape[0] - 1)[b, tid]
    # the uint8 source is read as it is and converted after the gather
    val = src[row, ty, tx].float()
    return torch.where(inside.any(1)[..., None], val, PAD)


def _warp(src, tile_ids, regions, offs, minv, out_hw):
    """Inverse-warp bilinear resample, out(x, y) = canvas(minv @ (x, y, 1)):
    cv2.warpAffine / warpPerspective with the 114 border. minv (B, 3, 3)."""
    H, W = out_hw
    xs = _grid(W, minv)[None, None, :]
    ys = _grid(H, minv)[None, :, None]
    m = minv[..., None, None]  # (B, 3, 3, 1, 1)
    den = m[:, 2, 0] * xs + m[:, 2, 1] * ys + m[:, 2, 2]
    cx = (m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]) / den
    cy = (m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]) / den
    x0 = torch.floor(cx)
    y0 = torch.floor(cy)
    fx = (cx - x0)[..., None]
    fy = (cy - y0)[..., None]
    x0i = x0.int()
    y0i = y0.int()
    p00 = _resolve(src, tile_ids, regions, offs, x0i, y0i)
    p10 = _resolve(src, tile_ids, regions, offs, x0i + 1, y0i)
    p01 = _resolve(src, tile_ids, regions, offs, x0i, y0i + 1)
    p11 = _resolve(src, tile_ids, regions, offs, x0i + 1, y0i + 1)
    top = p00 + (p10 - p00) * fx
    bot = p01 + (p11 - p01) * fx
    return top + (bot - top) * fy


def _remainder(x, y: float):
    """x mod y with y's sign, computed as the JAX package computes it."""
    m = torch.fmod(x, y)
    return torch.where((m != 0) & (m < 0), m + y, m)


def _hsv_jitter(g, mult):
    """HSV gain jitter in float on cv2's uint8 HSV scale (H in [0, 180), S
    and V in [0, 255]); approximates augmentations.py:43-56's integer LUTs.
    g (B, H, W, 3); mult (B, 3)."""
    mult = mult[:, None, None]
    r, gc, b = g[..., 0], g[..., 1], g[..., 2]
    mx = torch.maximum(torch.maximum(r, gc), b)
    mn = torch.minimum(torch.minimum(r, gc), b)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, 1.0)
    h6 = torch.where(mx == r, _remainder((gc - b) / safe, 6.0),
                     torch.where(mx == gc, (b - r) / safe + 2.0, (r - gc) / safe + 4.0))
    h = torch.where(diff > 0, h6 * 30.0, 0.0)
    sat = torch.where(mx > 0, diff / torch.where(mx > 0, mx, 1.0) * 255.0, 0.0)
    v = mx
    h = _remainder(h * mult[..., 0], 180.0)
    sat = torch.clamp(sat * mult[..., 1], 0, 255.0)
    v = torch.clamp(v * mult[..., 2], 0, 255.0)
    h6 = h / 30.0
    i = torch.floor(h6)
    f = h6 - i
    sn = sat / 255.0
    p = v * (1 - sn)
    q = v * (1 - sn * f)
    t = v * (1 - sn * (1 - f))
    i = torch.remainder(i.int(), 6)

    def select(choices, default):
        out = default
        for k in range(4, -1, -1):  # the first sector that matches wins
            out = torch.where(i == k, choices[k], out)
        return out

    rgb = torch.stack([select([v, q, p, p, t], v), select([t, v, v, q, p], p),
                       select([p, p, t, v, v], q)], dim=-1)
    return torch.round(rgb)


def _axis_matrices(minv_row, regions, offs, S_out, S, axis, origin=0):
    """The (B, 4, S_out, S) bilinear sampling matrices of one output axis of
    an axis-aligned warp: output row y samples canvas coordinate c = a y + b,
    with at most 2 nonzero weights (at floor(c) and floor(c) + 1), each
    masked by tile t's interval on this axis and shifted by its offset.

    minv_row (B, 3): the axis' row of the inverse warp; regions (B, 4, 2) the
    [lo, hi) interval of each tile; offs (B, 4). origin > 0 evaluates on the
    grid y in [-origin, S_out - origin), subtracted from the integer grid so
    that the overlapping coordinates round as the unshifted grid's."""
    y = _grid(S_out, minv_row) - float(origin)
    c = minv_row[:, axis, None] * y + minv_row[:, 2, None]  # (B, S_out)
    c0 = torch.floor(c)
    w1 = c - c0
    w0 = 1.0 - w1
    c0i = c0.int()
    j = torch.arange(S, dtype=torch.int32, device=c.device)
    lo = regions[:, :, 0, None]  # (B, 4, 1)
    hi = regions[:, :, 1, None]
    off = offs[:, :, None].int()  # (B, 4, 1)
    M = torch.zeros((c.shape[0], 4, S_out, S), dtype=torch.float32, device=c.device)
    for d, w in ((0, w0), (1, w1)):
        v = c0i + d  # (B, S_out)
        vf = v[:, None].float()
        inb = (vf >= lo) & (vf < hi)  # (B, 4, S_out)
        eq = (v[:, None, :, None] - off[..., None]) == j  # (B, 4, S_out, S)
        M = M + w[:, None, :, None] * (eq & inb[..., None])
    return M


@contextlib.contextmanager
def _float32_matmul():
    """Full float32 products whatever the process set (TF32 would move the
    matmul warp off the gather warp's pixels)."""
    was = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(was)


def _warp_mm(src, tile_ids, regions, offs, minv, out_hw, origin=0):
    """An axis-aligned inverse warp as two einsums a tile: out = sum_t Y_t @
    tile_t @ X_t^T + 114 (1 - sum_t ycov_t (x) xcov_t). Equal to _warp for
    integer translations, with the same corner and region semantics."""
    H, W = out_hw
    S = src.shape[1]
    Y = _axis_matrices(minv[:, 1], regions[:, :, [1, 3]], offs[:, :, 1], H, S, axis=1,
                       origin=origin)
    X = _axis_matrices(minv[:, 0], regions[:, :, [0, 2]], offs[:, :, 0], W, S, axis=0,
                       origin=origin)
    tiles = src[tile_ids.long().clamp(0, src.shape[0] - 1)].float()  # (B, 4, S, S, 3)
    with _float32_matmul():
        G = torch.einsum("btos,btsjc->btojc", Y, tiles)  # contract tile rows
        out = torch.einsum("btpj,btojc->bopc", X, G)  # contract tile columns
        cov = torch.einsum("bto,btp->bop", Y.sum(-1), X.sum(-1))
    return out + PAD * (1.0 - cov)[..., None]


def _hat_weights(pos, K):
    """Bilinear hat weights of positions over the shift range [0, 2K]:
    (B, L) -> (B, L, 2K + 1)."""
    d = _grid(2 * K + 1, pos)
    return torch.clamp(1.0 - torch.abs(pos[..., None] - d), min=0.0)


def _warp_affine3(src, tile_ids, regions, offs, minv0, shear, out_hw, K):
    """A general affine inverse warp in three passes without a gather, from
    minv = M0 @ Shx @ Shy (_decompose_affine):
      A: I0 = canvas o M0 on a K-padded grid (_warp_mm with origin K);
      B: the x-shear I1[r, x] = I0[r, x + K + h (r - K)], a fractional shift
         a row bounded by K, as a sum of 2K + 1 column slices weighted by
         bilinear hats;
      C: the y-shear out[y, x] = I1[y + K + g x, x], with row slices.
    Three bilinear resamples where cv2 makes one: a few levels from cv2 on
    general warps; h == g == 0 gives pass A's slices exactly. K must satisfy
    |h| (H + K) <= K - 1 and |g| W <= K - 1 (required_shear_pad)."""
    H, W = out_hw
    Hp, Wp = H + 2 * K, W + 2 * K
    I0 = _warp_mm(src, tile_ids, regions, offs, minv0, (Hp, Wp), origin=K)
    h, g = shear[:, 0, None], shear[:, 1, None]
    wB = _hat_weights(K + h * (_grid(Hp, I0) - K), K)  # (B, Hp, 2K+1)
    I1 = torch.zeros((I0.shape[0], Hp, W, I0.shape[-1]), dtype=I0.dtype, device=I0.device)
    for d in range(2 * K + 1):
        I1 = I1 + wB[:, :, d, None, None] * I0[:, :, d:d + W]
    wC = _hat_weights(K + g * _grid(W, I0), K)  # (B, W, 2K+1)
    out = torch.zeros((I0.shape[0], H, W, I0.shape[-1]), dtype=I0.dtype, device=I0.device)
    for d in range(2 * K + 1):
        out = out + wC[:, None, :, d, None] * I1[:, d:d + H]
    return out


def _reflect_101(n: int, r: int, device) -> torch.Tensor:
    """Indices of a length-n axis padded by r a side with cv2's
    BORDER_REFLECT_101 (the edge is not repeated)."""
    i = torch.arange(-r, n + r, device=device).abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _box_blur(g, k):
    """cv2.blur: a k x k normalised box filter with BORDER_REFLECT_101,
    separable as sums of row and column slices. g (B, H, W, 3) of integral
    floats; the caller rounds."""
    r = k // 2
    H, W = g.shape[1:3]
    ph = g[:, :, _reflect_101(W, r, g.device)]
    gx = sum(ph[:, :, d:d + W] for d in range(k))
    pv = gx[:, _reflect_101(H, r, g.device)]
    return sum(pv[:, d:d + H] for d in range(k)) * (1.0 / (k * k))


def _median_blur(g, k):
    """cv2.medianBlur: the exact k x k window median (k odd: the middle
    order statistic) with BORDER_REPLICATE. g (B, H, W, 3)."""
    r = k // 2
    H, W = g.shape[1:3]
    rows = torch.arange(-r, H + r, device=g.device).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=g.device).clamp(0, W - 1)
    p = g[:, rows][:, :, cols]
    stack = torch.stack([p[:, dy:dy + H, dx:dx + W] for dy in range(k) for dx in range(k)],
                        dim=-1)
    return torch.sort(stack, dim=-1).values[..., (k * k) // 2]


def make_augment_fn(imgsz: int, n_slots: int, resident: bool = False,
                    axis_aligned: bool = False, shear_pad: int = 0, pixel_ops=(0, 0)):
    """The batch augmentation, on the device of its inputs.

    resident=False: (tiles (B, n_slots, S, S, 3) uint8, aug) -> (B, S, S, 3)
        uint8, the tiles shipped with each batch.
    resident=True: (pack (N, S, S, 3) uint8, tile_idx (B, n_slots) int32,
        aug): the whole pack lives on the device and a batch brings its rows.
    aug: collate_device's 'aug' dict as tensors on that device.
    axis_aligned=True: the warps have no rotation, shear or perspective
        (degrees == shear == perspective == 0, YOLOv8's defaults): the
        bilinear resample is separable and runs as einsums (_warp_mm).
    shear_pad=K > 0: rotating or shearing hyps with perspective 0 (the
        paper's voc_obj365 recipe) run the 3-pass affine warp
        (_warp_affine3); K = required_shear_pad(hyp, imgsz).
    Otherwise the gather warp (_warp) takes any matrix.
    pixel_ops=(blur_k, median_k): box blur and median blur applied between
        mixup and grayscale, where the host's PixelAugment applies them; the
        loader runs them as one-sample variants for the rows that draw them.
    """
    if shear_pad > 0:
        def warp(src, tid, reg, off, mv, mv0, sh, hw):
            return _warp_affine3(src, tid, reg, off, mv0, sh, hw, shear_pad)
    elif axis_aligned:
        def warp(src, tid, reg, off, mv, mv0, sh, hw):
            return _warp_mm(src, tid, reg, off, mv, hw)
    else:
        def warp(src, tid, reg, off, mv, mv0, sh, hw):
            return _warp(src, tid, reg, off, mv, hw)

    def each(flag):
        return flag[:, None, None, None]

    def augment(src, tile_idx, aug):
        def warp_group(k):
            return torch.round(warp(src, tile_idx[:, 4 * k:4 * k + 4], aug["regions"][:, k],
                                    aug["offs"][:, k], aug["minv"][:, k], aug["minv0"][:, k],
                                    aug["shear"][:, k], (imgsz, imgsz)))

        # cv2's warps round to uint8 before any later stage computes
        g = warp_group(0)
        if n_slots == 8:
            mix_r = each(aug["mix_r"])
            # the host's mixup: (im * r + im2 * (1 - r)).astype(uint8)
            g = torch.floor(g * mix_r + warp_group(1) * (1.0 - mix_r))
        if pixel_ops[0]:
            g = torch.round(_box_blur(g, pixel_ops[0]))
        if pixel_ops[1]:
            g = _median_blur(g, pixel_ops[1])
        lum = torch.round(0.299 * g[..., 0] + 0.587 * g[..., 1] + 0.114 * g[..., 2])
        g = torch.where(each(aug["gray"]), lum[..., None].expand_as(g), g)
        g = torch.where(each(aug["hsv_on"]), _hsv_jitter(g, aug["hsv_mult"]), g)
        g = torch.where(each(aug["flipud"]), g.flip(1), g)
        g = torch.where(each(aug["fliplr"]), g.flip(2), g)
        return torch.clamp(g, 0, 255).to(torch.uint8)

    if resident:
        return augment

    def augment_shipped(tiles, aug):
        b, s = tiles.shape[0], tiles.shape[2]
        rows = (torch.arange(b, device=tiles.device)[:, None] * n_slots
                + torch.arange(n_slots, device=tiles.device))
        return augment(tiles.reshape(b * n_slots, s, s, 3), rows, aug)

    return augment_shipped
