"""NN core of the port: padding rule, init, BatchNorm, conv+BN fold.

Counterpart of cerberusdet_tpu/nn/module.py. Layout is NCHW / OIHW. The int8
path is a later slice of the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

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
    CerberusModel.forward sets `frozen` and `img_mask` for each block it runs.
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
        """(mean, biased var, unbiased var) over N, H, W, in float32."""
        xf = x.float()
        dims = (0, 2, 3)
        if self.img_mask is None:
            mean = xf.mean(dims)
            var = (xf - mean[:, None, None]).square().mean(dims)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            return mean, var, var * (n / max(n - 1, 1))
        w = self.img_mask.float().reshape(-1, 1, 1, 1)
        n = self.img_mask.float().sum().clamp(min=1.0) * (x.shape[2] * x.shape[3])
        mean = (xf * w).sum(dims) / n
        var = ((xf - mean[:, None, None]).square() * w).sum(dims) / n
        return mean, var, var * (n / (n - 1.0).clamp(min=1.0))

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
