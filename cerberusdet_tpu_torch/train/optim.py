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
no momentum.
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


@torch.no_grad()
def sgd_update(cfg: SGDConfig, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state: OptState, lrs: Sequence[float],
               momentum: float) -> None:
    """Update `params` (and `state`) in place from `grads`, both keyed by
    state_dict name; only the names in `params` move. The formulas, per group g:

      SGD:     buf = mu * buf + g' (g' = g + wd * p for group 0);
               p -= lr[g] * (g' + mu * buf if nesterov else buf)
      Adam:    g' as SGD; bias-corrected moments, beta1 = momentum
      AdamW:   decoupled decay: p -= lr[g] * wd * p (old p) after the step
      RMSProp: v = 0.99 v + 0.01 g'^2; buf = mu * buf + g' / (sqrt(v) + eps);
               p -= lr[g] * buf
    lrs and momentum are taken as float32, as the JAX step takes them."""
    lrs = [_f32(v) for v in lrs]
    mu = _f32(momentum)
    state.step += 1
    wd = cfg.weight_decay
    for g in range(N_GROUPS):
        names = [k for k in params if param_group(k) == g]
        if not names:
            continue
        ps = [params[k] for k in names]
        gs = [grads[k] for k in names]
        bufs = [state.momentum_buf[k] for k in names]
        lr = lrs[g]
        coupled = cfg.name != "AdamW"
        ge = torch._foreach_add(gs, ps, alpha=wd) if (g == 0 and wd and coupled) else gs
        if cfg.name == "SGD":
            torch._foreach_mul_(bufs, mu)
            torch._foreach_add_(bufs, ge)
            d = torch._foreach_add(ge, bufs, alpha=mu) if cfg.nesterov else bufs
            torch._foreach_add_(ps, d, alpha=-lr)
        elif cfg.name in ("Adam", "AdamW"):
            vs = [state.second_moment[k] for k in names]
            t = np.float32(state.step)
            bc1 = _f32(1.0 - np.float32(mu) ** t)
            bc2 = _f32(1.0 - np.float32(cfg.beta2) ** t)
            torch._foreach_mul_(bufs, mu)
            torch._foreach_add_(bufs, ge, alpha=_f32(1 - np.float32(mu)))
            torch._foreach_mul_(vs, cfg.beta2)
            torch._foreach_add_(vs, torch._foreach_mul(ge, ge), alpha=1 - cfg.beta2)
            decay = torch._foreach_mul(ps, _f32(lr * np.float32(wd))) \
                if (not coupled and g == 0 and wd) else None
            den = torch._foreach_sqrt(torch._foreach_div(vs, bc2))
            torch._foreach_add_(den, cfg.eps)
            num = torch._foreach_mul(torch._foreach_div(bufs, bc1), lr)
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
            torch._foreach_add_(ps, bufs, alpha=-lr)
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


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor], updates: int,
               d0: float = 0.9999) -> None:
    """ema = d * ema + (1 - d) * params, in place, tensor by tensor."""
    d = ema_decay(updates, d0)
    ema, params = list(ema), list(params)
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=_f32(1.0 - np.float32(d)))
