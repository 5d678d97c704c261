"""LR schedules + warmup, host-side (values fed into each train step).

The port's own copy of cerberusdet_tpu/train/schedules.py. Behavioral parity
targets: cerberusdet/utils/general.py:211-213 (one_cycle),
cerberusdet/trainers/averaging.py:272-284 (cosine/linear LambdaLR),
cerberusdet/trainers/base_trainer.py:100-112 (per-group linear warmup with
bias group starting at warmup_bias_lr and momentum ramping from
warmup_momentum), cerberusdet/utils/torch_utils.py:257-279 (EarlyStopping).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100):
    """Sinusoidal ramp y1 -> y2 over `steps` (general.py:211-213)."""
    return lambda x: ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1


def lr_lambda(epochs: int, lrf: float, cos_lr: bool = True):
    if cos_lr:
        return one_cycle(1.0, lrf, epochs)
    return lambda x: (1 - x / epochs) * (1.0 - lrf) + lrf


def warmup_lrs(
    ni: int,
    nw: int,
    epoch_frac: float,
    lr0: float,
    lf_value: float,
    warmup_bias_lr: float = 0.1,
    warmup_momentum: float = 0.8,
    momentum: float = 0.937,
) -> Tuple[np.ndarray, float]:
    """Per-iteration (lrs (3,), momentum) during/after warmup.

    ni: global iteration; nw: warmup iterations; lf_value: schedule multiplier
    for the current epoch; groups: [0]=decay weights, [1]=bn scale, [2]=biases.
    """
    base = lr0 * lf_value
    if ni >= nw:
        return np.array([base, base, base], np.float32), momentum
    xi = [0, nw]
    lr_w = float(np.interp(ni, xi, [0.0, base]))
    lr_b = float(np.interp(ni, xi, [warmup_bias_lr, base]))
    mom = float(np.interp(ni, xi, [warmup_momentum, momentum]))
    return np.array([lr_w, lr_w, lr_b], np.float32), mom


class EarlyStopping:
    """Stop when mean fitness hasn't improved for `patience` epochs."""

    def __init__(self, patience: int = 30):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        stop = (epoch - self.best_epoch) >= self.patience
        return stop
