"""NN core of the port: padding rule, init, BatchNorm, conv+BN fold.

Counterpart of cerberusdet_tpu/nn/module.py. Layout is NCHW / OIHW; the
int8 conv's weights are in the layout its kernel reads
(ops/conv_int8_cuda.py:pack_weight), and its activations are packed NHWC
int8 on the way in (ops/conv_int8_cuda.py:quant_pack_s8).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from cerberusdet_tpu_torch.ops.conv_int8_cuda import (
    conv_epilogue,
    conv_s8,
    conv_s8_plain,
    conv_sums_s8,
    quant_pack_s8,
    quant_pack_s8_plain,
    quant_s8,
    quant_s8_plain,
    s8_kernel_takes,
)
from cerberusdet_tpu_torch.parallel.mesh import all_reduce_sum, group_size

BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k, p=None, d: int = 1):
    """'same'-ish padding used throughout YOLO configs; int or (kh, kw)."""
    if p is not None:
        return p
    if isinstance(k, (tuple, list)):
        return tuple(autopad(x, None, d) for x in k)
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2


def silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def uniform_(t: torch.Tensor, lo: float, hi: float, gen: torch.Generator) -> torch.Tensor:
    """Fill `t` from U(lo, hi) drawn from the CPU generator `gen`, so that a
    seed gives the same weights on every device."""
    draw = torch.rand(t.shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo
    with torch.no_grad():
        t.copy_(draw)
    return t


def kaiming_uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator,
                     a: float = math.sqrt(5)) -> torch.Tensor:
    """torch-default kaiming-uniform over fan-in (module.py:114-125 of the
    JAX package draws from the same distribution)."""
    gain = math.sqrt(2.0 / (1 + a * a))
    bound = gain * math.sqrt(3.0 / fan_in)
    return uniform_(t, -bound, bound, gen)


class BatchNorm(nn.Module):
    """BatchNorm over channels (dim 1), cerberusdet_tpu/nn/module.py:batch_norm.

    y = x * inv + shift with inv = rsqrt(var + eps) * weight and
    shift = bias - mean * inv, the factors applied in the activation's dtype.
    In eval mode, or when `frozen`, mean and var are the running statistics.
    In training mode they are the batch mean and biased variance over N, H, W,
    computed in float32 whatever the activation dtype, weighted per image by
    `img_mask` (B,) when it is set. The running statistics then take the raw
    batch statistics (unbiased variance) in place:
    running = (1 - BN_MOMENTUM) * running + BN_MOMENTUM * batch. The JAX step
    collects them and folds them after the optimizer, task by task; folding
    during each task's forward is the same, because a training forward never
    reads the running statistics of a block that is not frozen.
    CerberusModel.forward sets `frozen`, `img_mask` and `group` for each block
    it runs. With `group` (a torch.distributed process group: data
    parallelism, parallel/mesh.py) the statistics are those of the global
    batch over its ranks, as JAX's BatchNorm takes them over a mesh: the
    weighted sums (and the valid-row count with img_mask), then the centred
    squares, each summed over the ranks by a differentiable all-reduce, so
    that each rank's gradient through the global mean and variance carries
    every rank's loss.
    """

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.frozen = False
        self.img_mask = None
        self.group = None

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def scale_shift(self, mean=None, var=None):
        mean = self.running_mean if mean is None else mean
        var = self.running_var if var is None else var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return inv, self.bias - mean * inv

    def batch_stats(self, x):
        """(mean, biased var, unbiased var) over N, H, W, in float32: the
        (weighted) sums, then the centred squares, each summed over the
        ranks of `group` when it is set."""
        xf = x.float()
        hw = x.shape[2] * x.shape[3]
        w = None if self.img_mask is None else self.img_mask.float().reshape(-1, 1, 1, 1)

        def total(t):  # over N, H, W, weighted by img_mask, and over the ranks
            s = (t if w is None else t * w).sum((0, 2, 3))
            return s if self.group is None else all_reduce_sum(s, self.group)

        if w is None:
            n = x.shape[0] * hw * group_size(self.group)
            bessel = n / max(n - 1, 1)
        else:
            rows = self.img_mask.float().sum()
            if self.group is not None:
                rows = all_reduce_sum(rows, self.group)
            n = rows.clamp(min=1.0) * hw
            bessel = n / (n - 1.0).clamp(min=1.0)
        mean = total(xf) / n
        var = total((xf - mean[:, None, None]).square()) / n
        return mean, var, var * bessel

    def forward(self, x):
        if self.training and not self.frozen:
            mean, var, unbiased = self.batch_stats(x)
            with torch.no_grad():
                self.running_mean.copy_((1 - BN_MOMENTUM) * self.running_mean
                                        + BN_MOMENTUM * mean)
                self.running_var.copy_((1 - BN_MOMENTUM) * self.running_var
                                       + BN_MOMENTUM * unbiased)
            inv, shift = self.scale_shift(mean, var)
        else:
            inv, shift = self.scale_shift()
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def fuse_conv_bn(w: torch.Tensor, bn: BatchNorm):
    """Fold BN into an OIHW conv weight; returns (weight, bias)."""
    inv, shift = bn.scale_shift()
    return w * inv[:, None, None, None], shift


def quantize_act(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Per-tensor symmetric int8 activation quantization:
    clip(round(x * (1 / s_x)), -127, 127), with the reciprocal in float32
    and round half to even, as the JAX package's quantize_act. int8 input
    passes through. An NCHW tensor on the card is quantized by one kernel
    (ops/conv_int8_cuda.py:quant_s8), which gives these codes."""
    if x.dtype == torch.int8:
        return x
    return quant_s8(x, s_x) if x.device.type == "cuda" else quant_s8_plain(x, s_x)


def conv2d_int8(x: torch.Tensor, p, stride=1, padding=None, act: bool = False,
                out_dtype: torch.dtype = torch.float32,
                use_kernel: Optional[bool] = None, groups: int = 1, dilation=1,
                q_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized inference conv, NCHW in and out: x quantized per tensor
    with p["s_x"] (quantize_act's arithmetic; int8 x is taken as already
    quantized, as the JAX package's conv2d_int8 takes it), the int32 sums of
    the int8 conv against p["w_q"] (pack_weight's layout), then float32
    acc * (s_x * s_w) + b. With the defaults that float32 is the result (the
    JAX package's conv2d_int8); act applies SiLU to it in float32 and
    out_dtype casts it, which the kernel does in its epilogue. With q_out
    (a float32 scalar tensor) the result is int8:
    quantize_act(silu(y).to(out_dtype), q_out), which is the JAX package's
    Conv (its output cast to the compute dtype) followed by a block's
    __q_out__ quantize (cerberusdet_tpu/models/cerberus.py); the kernel
    requantizes in its epilogue (the bf16-rounded y for a bf16 out_dtype).

    p: {"w_q" int8 (Co, kh, kw, Cg16), "s_w" (Co,) f32, "s_x" () f32, "b" (Co,)
    f32}, Cg16 the group's channels padded to 16; x float32, bfloat16 or
    int8. The shapes conv_s8 takes (ops/conv_int8_cuda.py:s8_kernel_takes)
    go through quant_pack_s8 and conv_s8, two CUDA kernels for a tensor on
    the card and their plain versions on the CPU; use_kernel=False forces
    the plain versions (a test hook). Other shapes (groups, other kernel
    sizes, dilation) sum exactly in conv_sums_s8 on either device."""
    w_q = p["w_q"]
    kh, kw = w_q.shape[1], w_q.shape[2]
    pad = autopad((kh, kw), padding, dilation)
    q_dtype = torch.bfloat16 if out_dtype == torch.bfloat16 else torch.float32
    kernel_out = out_dtype if out_dtype == torch.bfloat16 else torch.float32
    if q_out is not None:
        kernel_out = torch.int8
    if not s8_kernel_takes((kh, kw), stride, pad, groups, dilation):
        if x.dtype not in (torch.float32, torch.bfloat16, torch.int8):
            raise TypeError(f"conv2d_int8 takes float32, bfloat16 or int8 activations, "
                            f"not {x.dtype}")
        acc = conv_sums_s8(quantize_act(x, p["s_x"]), w_q, stride, pad, dilation, groups)
        y = conv_epilogue(acc, p["s_x"], p["s_w"], p["b"], act, kernel_out, q_out, q_dtype)
        return y if q_out is not None else y.to(out_dtype)
    s, pad = (_single(stride, "stride"), _single(pad, "padding"))
    if use_kernel is False:
        pack, conv = quant_pack_s8_plain, conv_s8_plain
    else:  # the kernels on the card, the plain versions on the CPU
        pack, conv = quant_pack_s8, conv_s8
    xq = pack(x, p["s_x"], w_q.shape[3])
    if q_out is not None:
        return conv(xq, w_q, p["s_x"], p["s_w"], p["b"], s, pad, act, torch.int8, q_out,
                    q_dtype=q_dtype)
    y = conv(xq, w_q, p["s_x"], p["s_w"], p["b"], s, pad, act, kernel_out)
    return y.to(out_dtype)


def _single(v, what: str) -> int:
    """An int or a square (v, v) pair as one int."""
    if isinstance(v, int):
        return v
    if len(v) != 2 or v[0] != v[1]:
        raise ValueError(f"int8 conv takes a square {what}, got {v}")
    return int(v[0])
