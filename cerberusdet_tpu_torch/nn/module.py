"""NN core of the port: padding rule, init, eval-mode BatchNorm, conv+BN fold.

Counterpart of cerberusdet_tpu/nn/module.py. Layout is NCHW / OIHW. Only the
inference side is ported: BatchNorm runs from its running statistics
(training-mode BN and the int8 path are later slices of the port).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

BN_EPS = 1e-3


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
    """Eval-mode BatchNorm over channels (dim 1): y = x * inv + shift with
    inv = rsqrt(var + eps) * weight and shift = bias - mean * inv, the order
    of cerberusdet_tpu/nn/module.py:batch_norm. The factors are applied in
    the activation's dtype, as there."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def scale_shift(self):
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return inv, self.bias - self.running_mean * inv

    def forward(self, x):
        inv, shift = self.scale_shift()
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def fuse_conv_bn(w: torch.Tensor, bn: BatchNorm):
    """Fold BN into an OIHW conv weight; returns (weight, bias)."""
    inv, shift = bn.scale_shift()
    return w * inv[:, None, None, None], shift
