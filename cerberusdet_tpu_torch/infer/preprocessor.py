"""Preprocessing: BGR uint8 images -> letterboxed NHWC float batch in [0, 1].

Counterpart of cerberusdet_tpu/infer/preprocessor.py. Uniform-shape inputs
(video frames, batched serving) are letterboxed on the device in one pass:
BGR -> RGB, a bilinear resize with half-pixel centres that antialiases when it
shrinks (F.interpolate(antialias=True), what jax.image.resize "linear" does),
the gray pad, and /255. On the card that pass is one captured CUDA graph per
source shape and batch size (infer/graphs.py), as the JAX package compiles
one program per source shape. Ragged inputs, and source shapes beyond the
first MAX_DEVICE_SHAPES, take the per-image cv2 host path.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch import resolve_device
from cerberusdet_tpu_torch.infer.graphs import CapturedProgram
from cerberusdet_tpu_torch.ops.letterbox import PAD_VALUE, letterbox_host, letterbox_params
from cerberusdet_tpu_torch.utils import tracing

# a device letterbox for at most this many distinct source shapes; beyond
# that (a folder of arbitrary photos) the host path is cheaper than a new
# program per shape
MAX_DEVICE_SHAPES = 4


class CerberusPreprocessor:
    def __init__(self, img_size: Union[int, Tuple[int, int]] = 640, stride: int = 32,
                 auto: bool = False, device=None, prefer_device: bool = True):
        self.img_size = (img_size, img_size) if isinstance(img_size, int) else tuple(img_size)
        self.stride = stride
        self.auto = auto
        self.prefer_device = prefer_device
        self.device = resolve_device(device)
        self._device_fns: Dict[Tuple[int, int], Callable] = {}
        # on the card: one graph per (h, w, batch), all in one memory pool
        self._programs: Dict[Tuple[int, int, int], CapturedProgram] = {}
        self._pool = None
        self._lock = threading.Lock()

    def preprocess(self, images: Sequence[np.ndarray]):
        """images: list of HWC BGR uint8 arrays. Returns (batch (B, H, W, 3)
        float32 RGB in [0, 1], original_shapes [(h, w), ...]): a tensor on the
        device for uniform shapes while at most MAX_DEVICE_SHAPES source
        shapes have a device letterbox (and prefer_device, without auto), a
        numpy array from the host path otherwise."""
        with tracing.span("preprocess", len(images)):
            shapes = [im.shape[:2] for im in images]
            if (self.prefer_device and not self.auto and len(set(shapes)) == 1
                    and (shapes[0] in self._device_fns
                         or len(self._device_fns) < MAX_DEVICE_SHAPES)):
                with tracing.span("stack"):
                    stacked = np.stack(images)
                return self.preprocess_device(stacked)
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
        float32 RGB in [0, 1] on the device, original_shapes): a new tensor
        each call."""
        b, h, w, _ = images.shape
        fn = self._device_fn(h, w)
        x = torch.from_numpy(np.ascontiguousarray(images))
        if self.device.type != "cuda":
            return fn(x.to(self.device)), [(h, w)] * b
        with self._lock:
            prog = self._programs.get((h, w, b))
            if prog is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                prog = CapturedProgram(fn, x, self.device, self._pool)
                self._programs[(h, w, b)] = prog
            out = prog.run(x).clone()
        return out, [(h, w)] * b

    def _device_fn(self, h: int, w: int):
        """The letterbox of (B, h, w, 3) uint8 device tensors (cached per
        source shape)."""
        key = (h, w)
        fn = self._device_fns.get(key)
        if fn is not None:
            return fn
        th, tw = self.img_size
        _, (nw, nh), (dw, dh) = letterbox_params((h, w), (th, tw))
        top, left = int(round(dh - 0.1)), int(round(dw - 0.1))

        def run(imgs: torch.Tensor) -> torch.Tensor:
            x = imgs.flip(-1).permute(0, 3, 1, 2).float()        # BGR -> RGB, NCHW
            x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False,
                              antialias=True)
            out = torch.full((imgs.shape[0], 3, th, tw), float(PAD_VALUE), device=imgs.device)
            out[:, :, top:top + nh, left:left + nw] = x
            return (out / 255.0).permute(0, 2, 3, 1).contiguous()

        self._device_fns[key] = run
        return run
