"""Host-side image-space augmentation (numpy and cv2, on the loader's threads).

The port's copy of cerberusdet_tpu/data/augment.py:26-218 (the reference's
cerberusdet/data/augmentations.py: HSV LUT :43-56, random_perspective
:92-186, box_candidates :197-202, mixup :189-194), bit for bit: the same
draws from the same `rng` give the same pixels and labels. The card gets the
augmented uint8 batch.

Determinism: every stochastic function takes an explicit `rng` (a
random.Random; the global module by default). The dataset derives one per
(seed, epoch, index), so augmentation does not depend on how the loader's
threads are scheduled.
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import cv2
import numpy as np


class PixelAugment:
    """Low-probability pixel-level augmentation: blur / median-blur / grayscale.

    Behavioral parity target: cerberusdet/data/augmentations.py:11-40 — the
    reference wraps albumentations: A.Blur(p=0.1), A.MedianBlur(p=0.1),
    A.ToGray(p=0.01) (augmentations.py:21); albumentations is not in this
    image, so the same transforms are applied with cv2 directly. Kernel draw:
    albumentations 1.0.3 (the reference's pinned minimum, checks.py
    check_version) draws Blur/MedianBlur ksize from
    np.arange(blur_limit[0], blur_limit[1]+1, 2) with blur_limit=(3, 7) —
    odd {3, 5, 7} only — which (3, 5, 7) matches.
    """

    def __init__(self, p_blur: float = 0.1, p_median: float = 0.1,
                 p_gray: float = 0.01):
        self.p_blur, self.p_median, self.p_gray = p_blur, p_median, p_gray

    def __call__(self, im: np.ndarray, rng=random) -> np.ndarray:
        if rng.random() < self.p_blur:
            k = rng.choice((3, 5, 7))
            im = cv2.blur(im, (k, k))
        if rng.random() < self.p_median:
            im = cv2.medianBlur(im, rng.choice((3, 5, 7)))
        if rng.random() < self.p_gray:
            gray = cv2.cvtColor(im, cv2.COLOR_RGB2GRAY)
            im = cv2.cvtColor(gray, cv2.COLOR_GRAY2RGB)
        return im


def augment_hsv(im: np.ndarray, hgain: float = 0.5, sgain: float = 0.5,
                vgain: float = 0.5, rng=random):
    """In-place HSV jitter via LUTs (RGB in, RGB out)."""
    if hgain or sgain or vgain:
        u = np.array([rng.uniform(-1, 1) for _ in range(3)])
        r = u * [hgain, sgain, vgain] + 1
        hsv = cv2.cvtColor(im, cv2.COLOR_RGB2HSV)
        x = np.arange(0, 256, dtype=r.dtype)
        lut_hue = ((x * r[0]) % 180).astype(im.dtype)
        lut_sat = np.clip(x * r[1], 0, 255).astype(im.dtype)
        lut_val = np.clip(x * r[2], 0, 255).astype(im.dtype)
        # one 3-channel LUT call == per-channel split/LUT/merge, minus the
        # two extra full-image copies
        lut3 = np.stack([lut_hue, lut_sat, lut_val], -1).reshape(1, 256, 3)
        cv2.cvtColor(cv2.LUT(hsv, lut3), cv2.COLOR_HSV2RGB, dst=im)
    return im


def box_candidates(box1: np.ndarray, box2: np.ndarray, wh_thr: float = 2,
                   ar_thr: float = 100, area_thr: float = 0.1, eps: float = 1e-16):
    """Keep boxes that survived an affine warp: min size, aspect, area ratio."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def build_perspective_matrix(
    im_shape: Tuple[int, int],
    degrees: float = 10,
    translate: float = 0.1,
    scale: float = 0.1,
    shear: float = 10,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
    scaleup: float = 0.0,
    rng=random,
):
    """Draw the random warp parameters and compose the 3x3 matrix M.

    Split out of `random_perspective`, as in the JAX package, whose device
    augmentation draws the same matrix from the same rng stream.

    `scaleup` is a FLOAT hyp with the reference's exact branch structure
    (augmentations.py:122-133): scaleup==0 -> s ~ U(1-scale, 1+scale)
    (symmetric, one draw); scaleup>0 -> an extra coin flip, 50% the same
    symmetric draw, 50% s ~ U(1.09, 1+scaleup). The draw COUNT differs by
    branch.

    im_shape: (h, w) of the input canvas. Returns (M, s, width, height)
    where (width, height) is the output size and s the drawn scale."""
    height = im_shape[0] + border[0] * 2
    width = im_shape[1] + border[1] * 2

    # Center
    C = np.eye(3)
    C[0, 2] = -im_shape[1] / 2
    C[1, 2] = -im_shape[0] / 2
    # Perspective
    P = np.eye(3)
    P[2, 0] = rng.uniform(-perspective, perspective)
    P[2, 1] = rng.uniform(-perspective, perspective)
    # Rotation and Scale
    R = np.eye(3)
    a = rng.uniform(-degrees, degrees)
    if not scaleup:
        s = rng.uniform(1 - scale, 1 + scale)
    elif rng.random() < 0.5:
        s = rng.uniform(1 - scale, 1 + scale)
    else:
        s = rng.uniform(1.09, 1 + scaleup)
    R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
    # Shear
    S = np.eye(3)
    S[0, 1] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    S[1, 0] = math.tan(rng.uniform(-shear, shear) * math.pi / 180)
    # Translation
    T = np.eye(3)
    T[0, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * width
    T[1, 2] = rng.uniform(0.5 - translate, 0.5 + translate) * height

    M = T @ S @ R @ P @ C
    return M, s, width, height


def warp_targets(targets: np.ndarray, M: np.ndarray, s: float, width: int,
                 height: int, perspective: float = 0.0) -> np.ndarray:
    """Apply warp M to (n, 6) [cls, prob, x1, y1, x2, y2] boxes and filter
    the survivors (the label half of `random_perspective`)."""
    n = len(targets)
    if not n:
        return targets
    xy = np.ones((n * 4, 3))
    xy[:, :2] = targets[:, [2, 3, 4, 5, 2, 5, 4, 3]].reshape(n * 4, 2)  # corners
    xy = xy @ M.T
    xy = (xy[:, :2] / xy[:, 2:3] if perspective else xy[:, :2]).reshape(n, 8)
    x = xy[:, [0, 2, 4, 6]]
    y = xy[:, [1, 3, 5, 7]]
    new = np.concatenate((x.min(1), y.min(1), x.max(1), y.max(1))).reshape(4, n).T
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    keep = box_candidates(box1=targets[:, 2:6].T * s, box2=new.T, area_thr=0.1)
    targets = targets[keep]
    targets[:, 2:6] = new[keep]
    return targets


def random_perspective(
    im: np.ndarray,
    targets: np.ndarray = None,
    degrees: float = 10,
    translate: float = 0.1,
    scale: float = 0.1,
    shear: float = 10,
    perspective: float = 0.0,
    border: Tuple[int, int] = (0, 0),
    scaleup: float = 0.0,
    rng=random,
):
    """Random affine/perspective warp of image + labels.

    targets: (n, 6) rows [cls, prob, x1, y1, x2, y2] in pixels.
    Returns (im, targets) with filtered surviving boxes.
    """
    if targets is None:
        targets = np.zeros((0, 6), np.float32)
    M, s, width, height = build_perspective_matrix(
        im.shape[:2], degrees, translate, scale, shear, perspective, border,
        scaleup, rng)
    if (border[0] != 0) or (border[1] != 0) or (M != np.eye(3)).any():
        if perspective:
            im = cv2.warpPerspective(im, M, dsize=(width, height), borderValue=(114, 114, 114))
        else:
            im = cv2.warpAffine(im, M[:2], dsize=(width, height), borderValue=(114, 114, 114))

    targets = warp_targets(targets, M, s, width, height, perspective)
    return im, targets


def mixup(im: np.ndarray, labels: np.ndarray, im2: np.ndarray,
          labels2: np.ndarray, rng=random):
    """Blend two mosaics with a beta(32, 32) ratio (augmentations.py:189-194)."""
    r = rng.betavariate(32.0, 32.0)
    im = (im * r + im2 * (1 - r)).astype(np.uint8)
    labels = np.concatenate((labels, labels2), 0)
    return im, labels


def flip_lr(im: np.ndarray, boxes_xywhn: np.ndarray):
    """boxes_xywhn: (n, 4) normalized [cx, cy, w, h]."""
    im = np.fliplr(im)  # view; the dataset's final ascontiguousarray copies once
    if len(boxes_xywhn):
        boxes_xywhn[:, 0] = 1 - boxes_xywhn[:, 0]
    return im, boxes_xywhn


def flip_ud(im: np.ndarray, boxes_xywhn: np.ndarray):
    """boxes_xywhn: (n, 4) normalized [cx, cy, w, h]."""
    im = np.flipud(im)  # view; copied once at the dataset boundary
    if len(boxes_xywhn):
        boxes_xywhn[:, 1] = 1 - boxes_xywhn[:, 1]
    return im, boxes_xywhn
