"""Optimizer with YOLO's three parameter groups, gradient clipping and EMA.

Counterpart of cerberusdet_tpu/train/optim.py: group 0 = conv weights (`w`,
weight decay), group 1 = BatchNorm scales (`bn.weight`), group 2 = biases
(`b`, `bn.bias`); running statistics are not optimised. SGD (nesterov by
default), Adam, AdamW and RMSProp with the JAX package's update formulas;
per-step learning rates (3,) and momentum; clip_by_global_norm; the ramped
EMA d0 * (1 - exp(-n / 2000)) over parameters and BatchNorm buffers.

Updates are in place, on lists of tensors through torch's multi-tensor
(`_foreach`) operations, one call per group and operation. The caller
passes only the parameters to update: a parameter left out gets no decay and
no momentum. The per-step scalars (lrs, momentum, Adam's bias corrections,
the EMA decay) reach the operations as tensors on the device
(`sgd_apply`, `ema_apply`), so that a captured step (train/step.py) reads
the values each replay is given; `sgd_update` and `ema_update` take them as
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

N_GROUPS = 3  # 0: decayed weights, 1: bn scale, 2: biases


def param_group(name: str) -> int:
    """Optimizer group of a state_dict key of the port's modules; -1 for
    BatchNorm running statistics."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("running_mean", "running_var"):
        return -1
    if leaf in ("b", "bias"):
        return 2
    if leaf == "weight":  # the port's only `weight` is a BatchNorm scale
        return 1
    return 0


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    weight_decay: float = 5e-4
    nesterov: bool = True
    name: str = "SGD"  # SGD | Adam | AdamW | RMSProp
    beta2: float = 0.999
    eps: float = 1e-8


@dataclasses.dataclass
class OptState:
    momentum_buf: Dict[str, torch.Tensor]
    step: int = 0
    second_moment: Optional[Dict[str, torch.Tensor]] = None


def sgd_init(params: Dict[str, torch.Tensor], cfg: SGDConfig = SGDConfig()) -> OptState:
    """Zero buffers for every parameter of {name: tensor}."""
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    second = ({k: torch.zeros_like(p) for k, p in params.items()}
              if cfg.name in ("Adam", "AdamW", "RMSProp") else None)
    return OptState(momentum_buf=zeros, step=0, second_moment=second)


def _f32(x) -> float:
    return float(np.float32(x))


# the per-step scalars of sgd_apply, in this order (update_scalars)
LR, NEG_LR, LR_WD = 0, 3, 6   # (3,) each: lr, -lr, lr * weight_decay per group
MU, ONE_MINUS_MU, BC1, BC2 = 9, 10, 11, 12
N_UPDATE_SCALARS = 13
N_EMA_SCALARS = 2  # ema_scalars: decay, 1 - decay


def update_scalars(cfg: SGDConfig, lrs: Sequence[float], momentum: float,
                   step: int) -> np.ndarray:
    """The scalars of optimizer step `step` (1-based), float32, at the
    indices above: the per-group lrs, their negations, lr * weight_decay,
    momentum, 1 - momentum and Adam's bias corrections 1 - mu^t and
    1 - beta2^t. lrs and momentum are taken as float32, as the JAX step
    takes them."""
    lr = [_f32(v) for v in lrs]
    mu = _f32(momentum)
    t = np.float32(step)
    wd = np.float32(cfg.weight_decay)
    return np.array([*lr, *(-v for v in lr), *(_f32(v * wd) for v in lr), mu,
                     _f32(1 - np.float32(mu)), _f32(1.0 - np.float32(mu) ** t),
                     _f32(1.0 - np.float32(cfg.beta2) ** t)], np.float32)


def _scalars_like(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(values).to(device=like.device, dtype=like.dtype)


def _add_scaled(xs: List[torch.Tensor], ys: List[torch.Tensor], s: torch.Tensor,
                inplace: bool = False) -> List[torch.Tensor]:
    """xs + s * ys for a 0-d tensor s (in place with inplace): a multi-tensor
    product, then a multi-tensor sum."""
    fn = torch._foreach_add_ if inplace else torch._foreach_add
    return fn(xs, torch._foreach_mul(ys, s))


@torch.no_grad()
def sgd_update(cfg: SGDConfig, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: OptState, lrs: Sequence[float],
               momentum: float) -> None:
    """Advance state.step and update `params` (and `state`) in place from
    `grads` by sgd_apply, with lrs (3,) and momentum given as numbers."""
    state.step += 1
    if params:
        sc = _scalars_like(update_scalars(cfg, lrs, momentum, state.step),
                           next(iter(params.values())))
        sgd_apply(cfg, params, grads, state, sc)


@torch.no_grad()
def sgd_apply(cfg: SGDConfig, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: OptState, sc: torch.Tensor) -> None:
    """Update `params` (and `state`'s buffers) in place from `grads`, both
    keyed by state_dict name; only the names in `params` move. sc: the step's
    update_scalars as a tensor on the parameters' device, read by the
    multi-tensor operations where they run, so that a captured step reads
    each replay's values. state.step is not touched. The formulas, per group g:

      SGD:     buf = mu * buf + g' (g' = g + wd * p for group 0);
               p -= lr[g] * (g' + mu * buf if nesterov else buf)
      Adam:    g' as SGD; bias-corrected moments, beta1 = momentum
      AdamW:   decoupled decay: p -= lr[g] * wd * p (old p) after the step
      RMSProp: v = 0.99 v + 0.01 g'^2; buf = mu * buf + g' / (sqrt(v) + eps);
               p -= lr[g] * buf"""
    wd = cfg.weight_decay
    mu = sc[MU]
    for g in range(N_GROUPS):
        names = [k for k in params if param_group(k) == g]
        if not names:
            continue
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        bufs = [state.momentum_buf[k] for k in names]
        coupled = cfg.name != "AdamW"
        ge = torch._foreach_add(gs, ps, alpha=wd) if (g == 0 and wd and coupled) else gs
        if cfg.name == "SGD":
            torch._foreach_mul_(bufs, mu)
            torch._foreach_add_(bufs, ge)
            d = _add_scaled(ge, bufs, mu) if cfg.nesterov else bufs
            _add_scaled(ps, d, sc[NEG_LR + g], inplace=True)
        elif cfg.name in ("Adam", "AdamW"):
            vs = [state.second_moment[k] for k in names]
            torch._foreach_mul_(bufs, mu)
            _add_scaled(bufs, ge, sc[ONE_MINUS_MU], inplace=True)
            torch._foreach_mul_(vs, cfg.beta2)
            torch._foreach_add_(vs, torch._foreach_mul(ge, ge), alpha=1 - cfg.beta2)
            decay = torch._foreach_mul(ps, sc[LR_WD + g]) \
                if (not coupled and g == 0 and wd) else None
            den = torch._foreach_sqrt(torch._foreach_div(vs, sc[BC2]))
            torch._foreach_add_(den, cfg.eps)
            num = torch._foreach_mul(torch._foreach_div(bufs, sc[BC1]), sc[LR + g])
            torch._foreach_sub_(ps, torch._foreach_div(num, den))
            if decay is not None:
                torch._foreach_sub_(ps, decay)
        elif cfg.name == "RMSProp":
            vs = [state.second_moment[k] for k in names]
            torch._foreach_mul_(vs, 0.99)
            torch._foreach_add_(vs, torch._foreach_mul(ge, ge), alpha=1 - 0.99)
            den = torch._foreach_sqrt(vs)
            torch._foreach_add_(den, cfg.eps)
            torch._foreach_mul_(bufs, mu)
            torch._foreach_add_(bufs, torch._foreach_div(ge, den))
            _add_scaled(ps, bufs, sc[NEG_LR + g], inplace=True)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float = 10.0) -> None:
    """Scale `grads` in place by min(1, max_norm / (norm + 1e-6)), the norm
    over all of them taken in float32."""
    if not grads:
        return
    norms = torch._foreach_norm([g.float() for g in grads])
    gnorm = torch.linalg.vector_norm(torch.stack(norms))
    torch._foreach_mul_(grads, (max_norm / (gnorm + 1e-6)).clamp(max=1.0))


def ema_decay(updates: int, d0: float = 0.9999, tau: float = 2000.0) -> float:
    """Ramped decay d0 * (1 - exp(-updates / tau)), in float32."""
    u = np.float32(updates)
    return _f32(np.float32(d0) * (np.float32(1.0) - np.exp(-u / np.float32(tau))))


def ema_scalars(updates: int, d0: float = 0.9999) -> np.ndarray:
    """(decay, 1 - decay) after `updates` optimizer steps, float32."""
    d = ema_decay(updates, d0)
    return np.array([d, _f32(1.0 - np.float32(d))], np.float32)


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], updates: int,
               d0: float = 0.9999) -> None:
    """ema = d * ema + (1 - d) * params, in place, tensor by tensor, with the
    decay of `updates` optimizer steps (ema_apply)."""
    ema = list(ema)
    if ema:
        ema_apply(ema, params, _scalars_like(ema_scalars(updates, d0), ema[0]))


@torch.no_grad()
def ema_apply(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
              sc: torch.Tensor) -> None:
    """ema = sc[0] * ema + sc[1] * params, in place; sc = ema_scalars as a
    tensor on the tensors' device."""
    ema, params = list(ema), list(params)
    torch._foreach_mul_(ema, sc[0])
    _add_scaled(ema, params, sc[1], inplace=True)
