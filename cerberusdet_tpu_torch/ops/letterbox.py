"""Letterbox (aspect-preserving resize + gray padding), host path.

Counterpart of cerberusdet_tpu/ops/letterbox.py (letterbox_params and the cv2
host path). The batched device path is infer/preprocessor.py. cv2 is imported
only when the host path runs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PAD_VALUE = 114


def letterbox_params(shape: Tuple[int, int], new_shape: Tuple[int, int],
                     auto: bool = False, scale_fill: bool = False,
                     scaleup: bool = True, stride: int = 32):
    """(ratio, unpadded (w, h), (dw, dh)) for letterboxing `shape` (h, w)
    into `new_shape` (h, w); `auto` pads only to stride multiples."""
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))  # (w, h)
    dw, dh = new_shape[1] - new_unpad[0], new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        new_unpad = (new_shape[1], new_shape[0])
        r = (new_shape[1] / shape[1], new_shape[0] / shape[0])
        return r, new_unpad, (0.0, 0.0)
    return (r, r), new_unpad, (dw / 2, dh / 2)


def letterbox_host(im: np.ndarray, new_shape=(640, 640), color=(PAD_VALUE,) * 3,
                   auto: bool = False, scale_fill: bool = False, scaleup: bool = True,
                   stride: int = 32):
    """cv2 letterbox of one HWC uint8 image. Returns (image, ratio, (dw, dh));
    the pad is split with round(x - 0.1) / round(x + 0.1) as in the reference."""
    import cv2

    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    shape = im.shape[:2]
    ratio, new_unpad, (dw, dh) = letterbox_params(shape, new_shape, auto, scale_fill,
                                                  scaleup, stride)
    if shape[::-1] != new_unpad:
        im = cv2.resize(im, new_unpad, interpolation=cv2.INTER_LINEAR)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    im = cv2.copyMakeBorder(im, top, bottom, left, right, cv2.BORDER_CONSTANT, value=color)
    return im, ratio, (dw, dh)
