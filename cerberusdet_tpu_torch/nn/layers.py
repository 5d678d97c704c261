"""YOLOv8 layers of the flagship configs, as NCHW nn.Modules.

Counterpart of cerberusdet_tpu/nn/layers.py, restricted to the layers that
configs/models/yolov8{n,x}*.yaml use: Conv, PlainConv, Seq, Bottleneck, C2f,
SPPF, Concat, Upsample and Detect. Parameter names follow the JAX tree
(Conv: `w` + `bn`, `w` + `b` once fused, or `w_q`, `s_w`, `s_x`, `b` once
quantized; Detect: `box{i}`/`cls{i}`, each a
Seq with children 0/1/2), so a JAX tree maps onto `state_dict` key by key
(manager/weights.py). The rest of the layer zoo is a later slice.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from cerberusdet_tpu_torch.nn.module import (
    BatchNorm,
    autopad,
    conv2d_int8,
    fuse_conv_bn,
    kaiming_uniform_,
    silu,
    uniform_,
)
from cerberusdet_tpu_torch.ops.anchors import dfl_expectation, dist2bbox, make_anchors
from cerberusdet_tpu_torch.ops.conv_int8_cuda import padded_channels


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU; after `fuse()`, Conv2d with bias + SiLU;
    after `to_int8()`, the int8 conv of the PTQ layout (quant/ptq.py).

    The int8 form holds buffers `w_q` (int8, the kernel's layout,
    ops/conv_int8_cuda.py:pack_weight) and `s_w` (Co,), `s_x` () and `b`
    (Co,) in float32, which stay float32 when the module is cast (`_apply`),
    as the JAX package keeps its params, and `compute_like`, an empty tensor
    whose dtype follows the casts: the compute dtype. It takes an int8 input as
    already quantized and returns the compute dtype, as the JAX package's
    Conv returns ctx.dtype. `use_kernel` is handed to
    conv2d_int8 (None: the kernel on the card; False: the plain version).
    While `tap` is a dict, the forward records max |x| of a float input
    there under `tap_key` (PTQ calibration, quant/ptq.py:calibrate_amax);
    an int8 input is already quantized and is not recorded."""

    INT8_F32 = ("s_w", "s_x", "b")
    use_kernel = None
    tap = None
    tap_key = None

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, d=1, act=True):
        super().__init__()
        self.c1, self.c2, self.g, self.d, self.act = c1, c2, g, d, act
        kh, kw = _pair(k)
        self.k = (kh, kw)
        self.s = _pair(s)
        self.p = _pair(autopad((kh, kw), p, d))
        self.w = nn.Parameter(torch.empty(c2, c1 // g, kh, kw))
        self.bn = BatchNorm(c2)

    def reset(self, gen: torch.Generator) -> None:
        kaiming_uniform_(self.w, self.w[0].numel(), gen)
        self.bn.reset()

    @property
    def int8(self) -> bool:
        return "w_q" in self._buffers

    def forward(self, x):
        """The compute dtype is a float x's: the weight is cast to it and the
        output cast back to it (float32 master weights in training; a no-op
        on a model cast as a whole, as for serving). An int8 x (int8 form
        only) carries none: the output takes `compute_like`'s."""
        if self.tap is not None and x.dtype != torch.int8:
            self.tap[self.tap_key] = x.float().abs().max()
        if self.int8:
            out_dtype = self.compute_like.dtype if x.dtype == torch.int8 else x.dtype
            return conv2d_int8(x, self._buffers, self.s, self.p, act=self.act,
                               out_dtype=out_dtype, use_kernel=self.use_kernel)
        bn = getattr(self, "bn", None)
        if bn is None:
            y = F.conv2d(x, self.w, self.b, self.s, self.p, self.d, self.g)
        else:
            y = bn(F.conv2d(x, self.w.to(x.dtype), None, self.s, self.p, self.d, self.g))
        return (silu(y) if self.act else y).to(x.dtype)

    @torch.no_grad()
    def fuse(self) -> None:
        """Fold the BatchNorm into `w` and a new bias `b`."""
        if not hasattr(self, "bn"):
            return
        w, b = fuse_conv_bn(self.w, self.bn)
        del self.bn
        self.w.copy_(w)
        self.b = nn.Parameter(b)

    @torch.no_grad()
    def to_int8(self) -> None:
        """Replace the fused `w` and `b` by zeroed int8-form buffers on the
        same device, to be filled by quantize_params or a weight load."""
        if self.int8:
            return
        if hasattr(self, "bn") or self.g != 1 or self.d != 1:
            raise ValueError("only a fused Conv with groups 1 and dilation 1 has an int8 form")
        dev, dtype = self.w.device, self.w.dtype
        kh, kw = self.k
        del self.w, self.b
        self.register_buffer("w_q", torch.zeros((self.c2, kh, kw, padded_channels(self.c1)),
                                                dtype=torch.int8, device=dev))
        self.register_buffer("s_w", torch.zeros(self.c2, device=dev))
        self.register_buffer("s_x", torch.zeros((), device=dev))
        self.register_buffer("b", torch.zeros(self.c2, device=dev))
        self.register_buffer("compute_like", torch.empty(0, dtype=dtype, device=dev),
                             persistent=False)

    def _apply(self, fn, recurse=True):
        """Casts leave the int8 form's float32 buffers float32: they go
        through `fn` viewed as int32, which a cast does not touch and a move
        moves."""
        if not self.int8:
            return super()._apply(fn, recurse)
        keep = {n: self._buffers[n] for n in self.INT8_F32}
        super()._apply(fn, recurse)
        for n, t in keep.items():
            self._buffers[n] = fn(t.view(torch.int32)).view(torch.float32)
        return self


class PlainConv(nn.Module):
    """Bare Conv2d with bias (the last 1x1 of each Detect tower)."""

    def __init__(self, c1, c2, k=1, s=1, p=None):
        super().__init__()
        self.c2 = c2
        self.s, self.p = _pair(s), _pair(autopad(k, p))
        self.w = nn.Parameter(torch.empty(c2, c1, k, k))
        self.b = nn.Parameter(torch.empty(c2))

    def reset(self, gen: torch.Generator) -> None:
        fan_in = self.w[0].numel()
        kaiming_uniform_(self.w, fan_in, gen)
        bound = 1.0 / math.sqrt(fan_in)
        uniform_(self.b, -bound, bound, gen)

    def forward(self, x):
        """The compute dtype is x's, as in Conv. With float32 master weights
        and a lower compute dtype, the bias is added to the conv's output
        in float32 and the sum cast back, as the JAX layer does."""
        if self.w.dtype == x.dtype:
            return F.conv2d(x, self.w, self.b, self.s, self.p)
        y = F.conv2d(x, self.w.to(x.dtype), None, self.s, self.p)
        return (y + self.b[:, None, None]).to(x.dtype)


class Seq(nn.Sequential):
    """Sequential container; children named '0', '1', ... as in the JAX tree."""

    def __init__(self, *layers):
        super().__init__(*layers)
        self.c2 = layers[-1].c2


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2
        self.c2 = c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """CSP bottleneck with 2 convs, the main YOLOv8 block. The split and the
    concat are on channels, dim 1 in NCHW."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))
        self.c2 = c2

    def forward(self, x):
        y = self.cv1(x)
        ys = [y[:, : self.c], y[:, self.c:]]
        for b in self.m:
            ys.append(b(ys[-1]))
        return self.cv2(torch.cat(ys, dim=1))


class SPPF(nn.Module):
    """Fast SPP: three chained k-pools, padded with -inf."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k
        self.c2 = c2

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, self.k, 1, self.k // 2)
        y2 = F.max_pool2d(y1, self.k, 1, self.k // 2)
        y3 = F.max_pool2d(y2, self.k, 1, self.k // 2)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


class Concat(nn.Module):
    """Concatenate NCHW tensors on `dimension` (1 = channels)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dim = dimension
        self.c2 = 0  # filled by the config parser

    def forward(self, xs):
        return torch.cat(xs, dim=self.dim)


class Upsample(nn.Module):
    """Nearest-neighbour integer upsample."""

    def __init__(self, size=None, scale_factor: int = 2, mode: str = "nearest"):
        super().__init__()
        if size is not None or mode != "nearest":
            raise ValueError("only integer nearest upsample is supported")
        self.f = int(scale_factor)
        self.c2 = 0

    def forward(self, x):
        return x.repeat_interleave(self.f, dim=2).repeat_interleave(self.f, dim=3)


class Detect(nn.Module):
    """YOLOv8 anchor-free decoupled head. forward(xs) -> (preds, feats) in
    eval mode, feats alone in training mode: feats are the per-level
    (B, 4*reg_max + nc, H, W) maps; preds is (B, N, 4 + nc) float32, xywh
    boxes in input pixels + sigmoid scores, with the N anchors flattened
    level-major, then row-major over (h, w)."""

    def __init__(self, nc: int, ch: Sequence[int] = ()):
        super().__init__()
        self.nc = nc
        self.reg_max = 16
        self.no = nc + self.reg_max * 4
        self.nl = len(ch)
        c2 = max(16, ch[0] // 4, self.reg_max * 4)
        # the reference's cls width (yolo.py:79), not ultralytics' min(nc, 100)
        c3 = max(ch[0], nc)
        for i, c in enumerate(ch):
            self.add_module(f"box{i}", Seq(Conv(c, c2, 3), Conv(c2, c2, 3),
                                           PlainConv(c2, 4 * self.reg_max, 1)))
            self.add_module(f"cls{i}", Seq(Conv(c, c3, 3), Conv(c3, c3, 3),
                                           PlainConv(c3, nc, 1)))
        self.stride: Tuple[float, ...] = tuple(2 ** (3 + i) for i in range(self.nl))
        self.c2 = self.no

    @torch.no_grad()
    def bias_init(self) -> None:
        """Prior-aware bias init of the last conv of each tower."""
        for i, s in enumerate(self.stride):
            getattr(self, f"box{i}")[2].b.fill_(1.0)
            getattr(self, f"cls{i}")[2].b.fill_(math.log(5 / self.nc / (640 / s) ** 2))

    def forward(self, xs: List[torch.Tensor]):
        feats = [torch.cat([getattr(self, f"box{i}")(x), getattr(self, f"cls{i}")(x)], 1)
                 for i, x in enumerate(xs)]
        if self.training:
            return feats
        return self.decode(feats), feats

    def decode(self, feats: List[torch.Tensor]):
        """Flatten levels and decode boxes; float32 as in the JAX package."""
        shapes = [(f.shape[2], f.shape[3]) for f in feats]
        anchors, strides = make_anchors(shapes, self.stride, device=feats[0].device)
        b = feats[0].shape[0]
        flat = torch.cat([f.reshape(b, self.no, -1) for f in feats], 2).transpose(1, 2)
        distri, cls = flat[..., : 4 * self.reg_max], flat[..., 4 * self.reg_max:]
        dist = dfl_expectation(distri.float(), self.reg_max)
        boxes = dist2bbox(dist, anchors[None], xywh=True) * strides[None]
        return torch.cat([boxes, torch.sigmoid(cls.float())], dim=-1)


# Registry used by the model-config interpreter (models/config.py).
LAYERS = {
    "Conv": Conv,
    "Bottleneck": Bottleneck,
    "C2f": C2f,
    "SPPF": SPPF,
    "Concat": Concat,
    "nn.Upsample": Upsample,
    "Upsample": Upsample,
    "Detect": Detect,
}
