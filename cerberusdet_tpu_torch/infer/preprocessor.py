"""Preprocessing: BGR uint8 images -> letterboxed NHWC float batch in [0, 1].

Counterpart of cerberusdet_tpu/infer/preprocessor.py. Uniform-shape inputs
(video frames, batched serving) are letterboxed on the device in one pass:
BGR -> RGB, a bilinear resize with half-pixel centres that antialiases when it
shrinks (F.interpolate(antialias=True), what jax.image.resize "linear" does),
the gray pad, and /255. Ragged inputs take the per-image cv2 host path.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_host, letterbox_params


class CerberusPreprocessor:
    def __init__(self, img_size: Union[int, Tuple[int, int]] = 640, stride: int = 32,
                 auto: bool = False, device=None):
        self.img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.stride = stride
        self.auto = auto
        self.device = resolve_device(device)

    def preprocess(self, images: Sequence[np.ndarray]):
        """images: list of HWC BGR uint8 arrays. Returns (batch (B, H, W, 3)
        float32 RGB in [0, 1], original_shapes [(h, w), ...]): a tensor on the
        device for uniform shapes, a numpy array from the host path otherwise."""
        shapes = [im.shape[:2] for im in images]
        if not self.auto and len(set(shapes)) == 1:
            return self.preprocess_device(np.stack(images))
        return self.preprocess_host(images)

    def preprocess_host(self, images: Sequence[np.ndarray]):
        """Per-image cv2 letterbox (the reference's exact arithmetic)."""
        out: List[np.ndarray] = []
        shapes: List[Tuple[int, int]] = []
        for im in images:
            shapes.append(im.shape[:2])
            lb, _, _ = letterbox_host(im, self.img_size, auto=self.auto, stride=self.stride)
            out.append(lb[..., ::-1])  # BGR -> RGB
        batch = np.ascontiguousarray(np.stack(out)).astype(np.float32) / 255.0
        return batch, shapes

    def preprocess_device(self, images: np.ndarray):
        """images: (B, H, W, 3) uint8 BGR. Returns (batch (B, th, tw, 3)
        float32 RGB in [0, 1] on the device, original_shapes)."""
        b, h, w, _ = images.shape
        th, tw = self.img_size
        _, (nw, nh), (dw, dh) = letterbox_params((h, w), (th, tw))
        top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        x = x.flip(-1).permute(0, 3, 1, 2).float()            # BGR -> RGB, NCHW
        x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                          antialias=True)
        out = torch.full((b, 3, th, tw), float(PAD_VALUE), device=self.device)
        out[:, :, top:top + nh, left:left + nw] = x
        return (out / 255.0).permute(0, 2, 3, 1).contiguous(), [(h, w)] * b
