"""The layer zoo of the JAX package, as NCHW nn.Modules.

Counterpart of cerberusdet_tpu/nn/layers.py: Conv, DWConv, PlainConv, Seq,
Bottleneck, C2, C2f, C3, SPP, SPPF, Focus, GhostConv, Concat, Upsample and
Detect (its main registry), then the blocks of its second registry
(BottleneckCSP, TransformerLayer, TransformerBlock, C3TR, C3SPP, CrossConv,
GhostBottleneck, MixConv2d, Contract, Expand, ImplicitA, ImplicitM) with
their helpers (Identity, BareConv, BN, Linear, MultiheadAttention).
Parameter names follow the JAX tree (Conv: `w` + `bn`, `w` + `b` once
fused, or `w_q`, `s_w`, `s_x`, `b` once quantized; Detect: `box{i}`/
`cls{i}`, each a Seq with children 0/1/2; Linear: `w` (c1, c2), JAX's
layout), so a JAX tree maps onto `state_dict` key by key
(manager/weights.py). The layers whose `reset(gen)` draws their
parameters from a seed are listed in SEEDED.

int8 serving (quant/ptq.py) annotates blocks with float32 scalar buffers:
`q_out` (the JAX tree's `__q_out__`) on a block whose output every consumer
quantizes with that scale, and `q_in` on a Concat or Upsample whose inputs
are quantized before the data movement. The blocks with a quantized Conv
after a concat (C2, C2f, C3, SPP, SPPF) quantize the concat's inputs to that
Conv's scale, as the JAX blocks do, so the concats and SPP pools move int8.
quantize_act commutes exactly with the concats, the nearest upsample and
max pooling, so the values the quantized Convs see are bit for bit those of
the unannotated graph.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cerberusdet_tpu_torch.nn.module import (
    BatchNorm,
    _pair,
    autopad,
    conv2d,
    conv2d_int8,
    fuse_conv_bn,
    kaiming_uniform_,
    quantize_act,
    silu,
    uniform_,
)
from cerberusdet_tpu_torch.ops.anchors import dfl_expectation, dist2bbox, make_anchors
from cerberusdet_tpu_torch.ops.conv_int8_cuda import (
    int8_sums_fit,
    padded_channels,
    quant_cat_s8,
    s8_kernel_takes,
)
from cerberusdet_tpu_torch.parallel import spatial

# the int8 placement annotations: buffer name -> the JAX tree's leaf name
ACT_QUANT = {"q_out": "__q_out__", "q_in": "q_in"}


class Block(nn.Module):
    """Base of the layers: the buffers named in F32 (an int8 Conv's scales and
    bias, the int8 annotations) stay float32 when the module is cast, as the
    JAX package keeps them: they go through `_apply`'s fn viewed as int32,
    which a cast does not touch and a move moves. A scale cast to bfloat16
    would be another scale."""

    F32 = ("s_w", "s_x", "b", "q_out", "q_in")

    def act_quant(self, name: str) -> Optional[torch.Tensor]:
        """The annotation `name` ("q_out" or "q_in"), None when absent."""
        return self._buffers.get(name)

    def annotate(self, name: str, scale: torch.Tensor) -> None:
        """Set the annotation `name` to `scale`, a float32 scalar tensor on
        the block's device (registered when absent)."""
        if name not in ACT_QUANT:
            raise KeyError(f"unknown int8 annotation {name!r}")
        self.register_buffer(name, scale.detach().reshape(()).to(torch.float32).clone())

    def clear_act_quant(self) -> None:
        for name in ACT_QUANT:
            self._buffers.pop(name, None)

    def _apply(self, fn, recurse=True):
        keep = {n: self._buffers[n] for n in self.F32 if self._buffers.get(n) is not None}
        super()._apply(fn, recurse)
        for n, t in keep.items():
            self._buffers[n] = fn(t.view(torch.int32)).view(torch.float32)
        return self


class Conv(Block):
    """Conv2d + BatchNorm + SiLU; after `fuse()`, Conv2d with bias + SiLU;
    after `to_int8()`, the int8 conv of the PTQ layout (quant/ptq.py).

    The int8 form holds buffers `w_q` (int8, the kernel's layout,
    ops/conv_int8_cuda.py:pack_weight) and `s_w` (Co,), `s_x` () and `b`
    (Co,) in float32, which stay float32 when the module is cast (Block),
    and `compute_like`, an empty tensor whose dtype follows the casts: the
    compute dtype. It takes an int8 input as already quantized and returns
    the compute dtype, as the JAX package's Conv returns ctx.dtype; with
    `q_out` it returns that output quantized to int8 (conv2d_int8 does it in
    the kernel's epilogue). `use_kernel` is handed to conv2d_int8 (None: the
    kernel on the card; False: the plain version). While `tap` is a dict,
    the forward records max |x| of a float input there under `tap_key` (PTQ
    calibration, quant/ptq.py:calibrate_amax); an int8 input is already
    quantized and is not recorded."""

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

    @property
    def s8_kernel(self) -> bool:
        """Whether the int8 form runs on conv_s8 (its shape class), rather
        than on the exact integer route of the other shapes."""
        return s8_kernel_takes(self.k, self.s, self.p, self.g, self.d)

    def forward(self, x, q_out: Optional[torch.Tensor] = None):
        """The compute dtype is a float x's: the weight is cast to it and the
        output cast back to it (float32 master weights in training; a no-op
        on a model cast as a whole, as for serving). An int8 x (int8 form
        only) carries none: the output takes `compute_like`'s. q_out (None:
        the Conv's own annotation) quantizes the output with that scale."""
        if q_out is None:
            q_out = self._buffers.get("q_out")
        if self.tap is not None and x.dtype != torch.int8:
            self.tap[self.tap_key] = x.float().abs().max()
        if self.int8:
            out_dtype = self.compute_like.dtype if x.dtype == torch.int8 else x.dtype
            return conv2d_int8(x, self._buffers, self.s, self.p, act=self.act,
                               out_dtype=out_dtype, use_kernel=self.use_kernel, groups=self.g,
                               dilation=self.d, q_out=q_out)
        bn = getattr(self, "bn", None)
        if bn is None:
            y = conv2d(x, self.w, self.b, self.s, self.p, self.d, self.g)
            y = silu(y) if self.act else y
        else:
            y = bn(conv2d(x, self.w.to(x.dtype), None, self.s, self.p, self.d, self.g), self.act)
        y = y.to(x.dtype)
        return y if q_out is None else quantize_act(y, q_out)

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
        same device, to be filled by quantize_params or a weight load. The
        int8 sums must be exact in int32 (ops/conv_int8_cuda.py:int8_sums_fit);
        a larger conv is refused."""
        if self.int8:
            return
        if hasattr(self, "bn"):
            raise ValueError("only a fused Conv has an int8 form")
        kh, kw = self.k
        if not int8_sums_fit(kh, kw, self.c1 // self.g):
            raise ValueError(f"an int8 {kh}x{kw} conv over {self.c1 // self.g} channels a "
                             f"group can sum past 2^31: its int32 sums are not exact")
        dev, dtype = self.w.device, self.w.dtype
        del self.w, self.b
        self.register_buffer("w_q", torch.zeros(
            (self.c2, kh, kw, padded_channels(self.c1 // self.g)), dtype=torch.int8, device=dev))
        self.register_buffer("s_w", torch.zeros(self.c2, device=dev))
        self.register_buffer("s_x", torch.zeros((), device=dev))
        self.register_buffer("b", torch.zeros(self.c2, device=dev))
        self.register_buffer("compute_like", torch.empty(0, dtype=dtype, device=dev),
                             persistent=False)


class DWConv(Conv):
    """Depthwise conv: groups gcd(c1, c2) (common.py:11 of the reference)."""

    def __init__(self, c1, c2, k=1, s=1, act=True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), act=act)


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
        self.c2 = layers[-1].c2 if layers else 0


class Bottleneck(Block):
    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2
        self.c2 = c2

    def forward(self, x, q_out: Optional[torch.Tensor] = None):
        """q_out quantizes the output with that scale (in cv2's epilogue
        where there is no shortcut)."""
        if not self.add:
            return self.cv2(self.cv1(x), q_out=q_out)
        y = x + self.cv2(self.cv1(x))
        return y if q_out is None else quantize_act(y, q_out)


def _s_x(conv: Conv) -> Optional[torch.Tensor]:
    """An int8 Conv's input scale, None for a float Conv."""
    return conv.s_x if conv.int8 else None


def _cat(xs, q: Optional[torch.Tensor]) -> torch.Tensor:
    """torch.cat of xs on channels; with q, each quantized with it first
    (one quant_s8 a tensor into its slice of the int8 result)."""
    return torch.cat(xs, dim=1) if q is None else quant_cat_s8(xs, q)


class C2f(Block):
    """CSP bottleneck with 2 convs, the main YOLOv8 block. The split and the
    concat are on channels, dim 1 in NCHW. With an int8 cv2 the chunks are
    quantized to its scale before the concat (the last bottleneck's in its
    own cv2's epilogue where it has no shortcut)."""

    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0) for _ in range(n))
        self.c2 = c2

    def forward(self, x):
        q = _s_x(self.cv2)
        y = self.cv1(x)
        ys = [y[:, : self.c], y[:, self.c:]]
        for i, b in enumerate(self.m):
            ys.append(b(ys[-1], q_out=q if i == len(self.m) - 1 else None))
        return self.cv2(_cat(ys, q), q_out=self.act_quant("q_out"))


class C2(Block):
    """CSP bottleneck with 2 convs (common.py:154-171 of the reference)."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1, 1)
        self.cv2 = Conv(2 * self.c, c2, 1)
        self.m = Seq(*[Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=1.0)
                       for _ in range(n)])
        self.c2 = c2

    def forward(self, x):
        y = self.cv1(x)
        a, b = y[:, : self.c], y[:, self.c:]
        a = self.m(a)
        return self.cv2(_cat([a, b], _s_x(self.cv2)), q_out=self.act_quant("q_out"))


class C3(Block):
    """CSP bottleneck with 3 convs (common.py:139-151 of the reference). With
    an int8 cv3, cv2 requantizes to its scale in its epilogue (its output
    feeds the concat alone) and the bottlenecks' output is quantized."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c1, c_, 1, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = Seq(*[Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)])
        self.c2 = c2

    def forward(self, x):
        q = _s_x(self.cv3)
        a = self.m(self.cv1(x))
        b = self.cv2(x, q_out=q)
        return self.cv3(_cat([a, b], q), q_out=self.act_quant("q_out"))


def max_pool(x: torch.Tensor, k: int, s: int = 1, p: Optional[int] = None) -> torch.Tensor:
    """k x k max pool, padding k // 2, the padding never chosen (-inf for a
    float x, the dtype's minimum for an int8 one in the JAX package: every
    window holds an input). An int8 x on the card pools in bfloat16, which
    holds every int8 value exactly, and is cast back: torch's CUDA max pool
    has no int8 form. The CPU pools int8 as it is. Under a spatial mesh
    (parallel/spatial.py) x is this rank's rows: it takes its halo rows (an
    int8 x as int8), with the padding value beyond the image."""
    p = k // 2 if p is None else p
    fill = torch.iinfo(x.dtype).min if x.dtype == torch.int8 else -math.inf
    x, pad, _ = spatial.frame(x, k, s, p, fill)
    if x.dtype == torch.int8 and x.device.type == "cuda":
        return F.max_pool2d(x.to(torch.bfloat16), k, s, pad).to(torch.int8)
    return F.max_pool2d(x, k, s, pad)


class SPP(Block):
    """Spatial pyramid pooling (common.py:216-227 of the reference). With an
    int8 cv2, cv1 requantizes to its scale in its epilogue and the pools and
    the concat run on int8."""

    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * (len(k) + 1), c2, 1, 1)
        self.k = tuple(k)
        self.c2 = c2

    def forward(self, x):
        x = self.cv1(x, q_out=_s_x(self.cv2))
        ys = [x] + [max_pool(x, k) for k in self.k]
        return self.cv2(torch.cat(ys, dim=1), q_out=self.act_quant("q_out"))


class SPPF(Block):
    """Fast SPP: three chained k-pools. With an int8 cv2, cv1 requantizes to
    its scale in its epilogue and the pools and the concat run on int8."""

    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv(c_ * 4, c2, 1, 1)
        self.k = k
        self.c2 = c2

    def forward(self, x):
        x = self.cv1(x, q_out=_s_x(self.cv2))
        y1 = max_pool(x, self.k)
        y2 = max_pool(y1, self.k)
        y3 = max_pool(y2, self.k)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1), q_out=self.act_quant("q_out"))


class Focus(Block):
    """Space-to-depth stem (common.py:248-257 of the reference)."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act=True):
        super().__init__()
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act)
        self.c2 = c2

    def forward(self, x):
        y = torch.cat([x[:, :, ::2, ::2], x[:, :, 1::2, ::2], x[:, :, ::2, 1::2],
                       x[:, :, 1::2, 1::2]], dim=1)
        return self.conv(y)


class GhostConv(Block):
    """Ghost convolution (experimental.py:29-41 of the reference): a conv to
    half the channels, then a 5x5 depthwise conv of that half beside it."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, None, g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, None, c_, act=act)
        self.c2 = c2

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], dim=1)


class Concat(Block):
    """Concatenate NCHW tensors on `dimension` (1 = channels); with `q_in`,
    each input quantized first."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dim = dimension
        self.c2 = 0  # filled by the config parser

    def forward(self, xs):
        q = self.act_quant("q_in")
        if q is None:
            return torch.cat(xs, dim=self.dim)
        if self.dim == 1:
            return _cat(xs, q)
        return torch.cat([quantize_act(x, q) for x in xs], dim=self.dim)


class Upsample(Block):
    """Nearest-neighbour integer upsample; with `q_in`, the input quantized
    before it is replicated."""

    def __init__(self, size=None, scale_factor: int = 2, mode: str = "nearest"):
        super().__init__()
        if size is not None or mode != "nearest":
            raise ValueError("only integer nearest upsample is supported")
        self.f = int(scale_factor)
        self.c2 = 0

    def forward(self, x):
        q = self.act_quant("q_in")
        if q is not None:
            x = quantize_act(x, q)
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
        feats = [spatial.gather_rows(f) for f in feats]  # the whole map under a spatial mesh
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


class Identity(nn.Module):
    def forward(self, x):
        return x


class BareConv(nn.Module):
    """Conv2d without bias, BatchNorm or activation (BottleneckCSP's cv2 /
    cv3, MixConv2d's members). It stays float in an int8 model, as the JAX
    package's PTQ quantizes only Conv."""

    def __init__(self, c1, c2, k=1, s=1, p=None, g=1):
        super().__init__()
        self.c2, self.g = c2, g
        self.s, self.p = _pair(s), _pair(autopad(k, p))
        self.w = nn.Parameter(torch.empty(c2, c1 // g, *_pair(k)))

    def reset(self, gen: torch.Generator) -> None:
        kaiming_uniform_(self.w, self.w[0].numel(), gen)

    def forward(self, x):
        return conv2d(x, self.w.to(x.dtype), None, self.s, self.p, 1, self.g).to(x.dtype)


class BN(nn.Module):
    """Standalone BatchNorm + LeakyReLU(0.1), in float32 whatever the
    compute dtype (float64 included, as the JAX layer casts), cast back."""

    def __init__(self, c, leaky: float = 0.1):
        super().__init__()
        self.c2, self.leaky = c, leaky
        self.bn = BatchNorm(c)

    def reset(self, gen: torch.Generator) -> None:
        self.bn.reset()

    def forward(self, x):
        return F.leaky_relu(self.bn(x.float()), self.leaky).to(x.dtype)


class BottleneckCSP(Block):
    """CSP bottleneck (common.py:120-136 of the reference): cv1 -> m -> cv3
    beside cv2, BatchNorm + LeakyReLU on the concat, cv4."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = BareConv(c1, c_, 1, 1)
        self.cv3 = BareConv(c_, c_, 1, 1)
        self.cv4 = Conv(2 * c_, c2, 1, 1)
        self.bn = BN(2 * c_)
        self.m = Seq(*[Bottleneck(c_, c_, shortcut, g, e=1.0) for _ in range(n)])
        self.c2 = c2

    def forward(self, x):
        y1 = self.cv3(self.m(self.cv1(x)))
        return self.cv4(self.bn(torch.cat([y1, self.cv2(x)], dim=1)))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w on the compute dtype's values (x's), summed in float32 or
    wider: the JAX package's dot with preferred_element_type float32 (a
    product of two bfloat16 values is exact in float32)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    return torch.matmul(x.to(acc), w.to(x.dtype).to(acc))


class Linear(nn.Module):
    """x @ w (+ b) on the last axis, w (c1, c2) as the JAX package keeps it
    (the transpose of nn.Linear's), the sum cast to the compute dtype."""

    def __init__(self, c1, c2, bias: bool = True):
        super().__init__()
        self.c1, self.c2 = c1, c2
        self.w = nn.Parameter(torch.empty(c1, c2))
        self.b = nn.Parameter(torch.empty(c2)) if bias else None

    def reset(self, gen: torch.Generator) -> None:
        kaiming_uniform_(self.w, self.c1, gen)
        if self.b is not None:
            bound = 1.0 / math.sqrt(self.c1)
            uniform_(self.b, -bound, bound, gen)

    def forward(self, x):
        y = _mm(x, self.w)
        return (y if self.b is None else y + self.b).to(x.dtype)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's self / cross attention on (B, N, C), in
    the JAX layer's order: the in-projections summed in float32 (or wider),
    scaled dot products, softmax, the weighted values, the out-projection,
    cast to the compute dtype. in_w (3C, C) and out_w (C, C) are (out, in)."""

    def __init__(self, c, num_heads):
        super().__init__()
        assert c % num_heads == 0
        self.c2, self.h = c, num_heads
        self.in_w = nn.Parameter(torch.empty(3 * c, c))
        self.in_b = nn.Parameter(torch.empty(3 * c))
        self.out_w = nn.Parameter(torch.empty(c, c))
        self.out_b = nn.Parameter(torch.empty(c))

    def reset(self, gen: torch.Generator) -> None:
        kaiming_uniform_(self.in_w, self.c2, gen)
        kaiming_uniform_(self.out_w, self.c2, gen)
        with torch.no_grad():
            self.in_b.zero_()
            self.out_b.zero_()

    def forward(self, qkv):
        q, k, v = qkv
        c, h = self.c2, self.h
        d = c // h
        dtype = q.dtype
        q, k, v = (_mm(t, self.in_w[i * c:(i + 1) * c].T) + self.in_b[i * c:(i + 1) * c]
                   for i, t in enumerate((q, k, v)))
        b, n, _ = q.shape

        def heads(t):  # (B, h, N, d)
            return t.reshape(b, n, h, d).transpose(1, 2)

        scores = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(d)
        out = torch.matmul(torch.softmax(scores, dim=-1), heads(v))
        out = out.transpose(1, 2).reshape(b, n, c)
        return (_mm(out, self.out_w.T) + self.out_b).to(dtype)


class TransformerLayer(nn.Module):
    """LayerNorm-free transformer layer (common.py:71-86 of the reference),
    on (B, N, C)."""

    def __init__(self, c, num_heads):
        super().__init__()
        self.c2 = c
        self.q = Linear(c, c, bias=False)
        self.k = Linear(c, c, bias=False)
        self.v = Linear(c, c, bias=False)
        self.ma = MultiheadAttention(c, num_heads)
        self.fc1 = Linear(c, c, bias=False)
        self.fc2 = Linear(c, c, bias=False)

    def forward(self, x):
        x = self.ma((self.q(x), self.k(x), self.v(x))) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(Block):
    """ViT-style block over the flattened positions, row-major (common.py:
    89-104 of the reference). It attends over every position: under a
    spatial mesh (parallel/spatial.py) it gathers the whole map, runs on it
    and keeps this rank's rows, as GSPMD computes it."""

    def __init__(self, c1, c2, num_heads, num_layers):
        super().__init__()
        self.conv = Conv(c1, c2) if c1 != c2 else None
        self.linear = Linear(c2, c2)  # learnable position embedding
        self.tr = nn.ModuleList(TransformerLayer(c2, num_heads) for _ in range(num_layers))
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        x = spatial.gather_rows(x)
        b, c, h, w = x.shape
        seq = x.flatten(2).transpose(1, 2)
        seq = seq + self.linear(seq)
        for t in self.tr:
            seq = t(seq)
        return spatial.own_rows(seq.transpose(1, 2).reshape(b, c, h, w))


class C3TR(C3):
    """C3 with a TransformerBlock inner (common.py:200-205 of the reference);
    a C3 to propagate_act_quant and last_conv, as in the JAX package."""

    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = TransformerBlock(c_, c_, 4, n)


class C3SPP(C3):
    """C3 with an SPP inner (common.py:208-213 of the reference); a C3 to
    propagate_act_quant and last_conv, as in the JAX package."""

    def __init__(self, c1, c2, k=(5, 9, 13), n=1, shortcut=True, g=1, e=0.5):
        super().__init__(c1, c2, n, shortcut, g, e)
        c_ = int(c2 * e)
        self.m = SPP(c_, c_, k)


class CrossConv(Block):
    """Cross-convolution downsample (experimental.py:15-27 of the
    reference): a (1, k) conv, then a (k, 1) one. In int8 both sum on the
    exact integer route (not conv_s8's shapes)."""

    def __init__(self, c1, c2, k=3, s=1, g=1, e=1.0, shortcut=False):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, (1, k), (1, s))
        self.cv2 = Conv(c_, c2, (k, 1), (s, 1), g=g)
        self.add = shortcut and c1 == c2
        self.c2 = c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class GhostBottleneck(Block):
    """Ghost bottleneck (experimental.py:42-57 of the reference)."""

    def __init__(self, c1, c2, k=3, s=1):
        super().__init__()
        c_ = c2 // 2
        self.conv = Seq(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else Identity(),
            GhostConv(c_, c2, 1, 1, act=False),
        )
        self.shortcut = (Seq(DWConv(c1, c1, k, s, act=False), Conv(c1, c2, 1, 1, act=False))
                         if s == 2 else Identity())
        self.c2 = c2

    def forward(self, x):
        return self.conv(x) + self.shortcut(x)


class MixConv2d(Block):
    """Mixed depthwise conv, equal-channel split (experimental.py:60-81 of
    the reference): a BareConv per kernel size over all of x's channels,
    each to its share of c2, concatenated, BatchNorm + LeakyReLU, plus x."""

    def __init__(self, c1, c2, k=(1, 3), s=1, equal_ch=True):
        super().__init__()
        groups = len(k)
        if not equal_ch:
            raise NotImplementedError("equal-weight split not supported")
        i = np.floor(np.linspace(0, groups - 1e-6, c2))
        c_ = [int((i == g).sum()) for g in range(groups)]
        self.m = nn.ModuleList(BareConv(c1, c_[g], k[g], s, k[g] // 2) for g in range(groups))
        self.bn = BN(c2)
        self.c2 = c2

    def forward(self, x):
        return x + self.bn(torch.cat([m(x) for m in self.m], dim=1))


class Contract(Block):
    """Space to channels: (B, C, H, W) -> (B, C*s*s, H/s, W/s) in the
    reference's order (common.py:260-270)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain
        self.c2 = 0

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(b, c * s * s, h // s, w // s)


class Expand(Block):
    """Channels to space, the inverse of Contract (common.py:273-285 of the
    reference)."""

    def __init__(self, gain: int = 2):
        super().__init__()
        self.gain = gain
        self.c2 = 0

    def forward(self, x):
        b, c, h, w = x.shape
        s = self.gain
        x = x.reshape(b, s, s, c // s ** 2, h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(b, c // s ** 2, h * s, w * s)


class ImplicitA(Block):
    """Additive implicit knowledge (yoloR, common.py:17-28 of the
    reference): x + implicit, implicit (1, C, 1, 1)."""

    def __init__(self, channel):
        super().__init__()
        self.c2 = channel
        self.implicit = nn.Parameter(torch.empty(1, channel, 1, 1))

    def reset(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.implicit.copy_(0.02 * torch.randn(self.implicit.shape, generator=gen))

    def forward(self, x):
        return x + self.implicit.to(x.dtype)


class ImplicitM(Block):
    """Multiplicative implicit knowledge (yoloR, common.py:31-39 of the
    reference): x * implicit, implicit (1, C, 1, 1)."""

    def __init__(self, channel):
        super().__init__()
        self.c2 = channel
        self.implicit = nn.Parameter(torch.empty(1, channel, 1, 1))

    def reset(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.implicit.copy_(1.0 + 0.02 * torch.randn(self.implicit.shape, generator=gen))

    def forward(self, x):
        return x * self.implicit.to(x.dtype)


# the layers whose reset(gen) draws their parameters (CerberusModel.init)
SEEDED = (Conv, PlainConv, BareConv, BN, Linear, MultiheadAttention, ImplicitA, ImplicitM)


def last_conv(block: nn.Module) -> Optional[Conv]:
    """The Conv whose output is a block's output (a Conv or DWConv block
    itself; cv2 of C2, C2f, SPP and SPPF; cv3 of C3, C3TR and C3SPP); None
    for the others."""
    if isinstance(block, Conv):
        return block
    if isinstance(block, (C2, C2f, SPP, SPPF)):
        return block.cv2
    if isinstance(block, C3):
        return block.cv3
    return None


# Registry used by the model-config interpreter (models/config.py): the JAX
# package's main LAYERS (cerberusdet_tpu/nn/layers.py:454-469).
LAYERS = {
    "Conv": Conv,
    "DWConv": DWConv,
    "Bottleneck": Bottleneck,
    "C2": C2,
    "C2f": C2f,
    "C3": C3,
    "SPP": SPP,
    "SPPF": SPPF,
    "Focus": Focus,
    "GhostConv": GhostConv,
    "Concat": Concat,
    "nn.Upsample": Upsample,
    "Upsample": Upsample,
    "Detect": Detect,
}

# its second registry (cerberusdet_tpu/nn/layers.py:811-824)
LAYERS.update({
    "BottleneckCSP": BottleneckCSP,
    "C3TR": C3TR,
    "C3SPP": C3SPP,
    "CrossConv": CrossConv,
    "GhostBottleneck": GhostBottleneck,
    "MixConv2d": MixConv2d,
    "Contract": Contract,
    "Expand": Expand,
    "TransformerLayer": TransformerLayer,
    "TransformerBlock": TransformerBlock,
    "ImplicitA": ImplicitA,
    "ImplicitM": ImplicitM,
})
