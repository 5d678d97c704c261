"""The YOLOv8 family: Conv, C2f, SPPF, Upsample and Concat rows, CerberusDet's
branches after each `cerber` split, one decoupled Detect head a task. What
the harness asks of a family (core.py) points at the plain reference and the
counts written for it."""

from __future__ import annotations

from typing import Sequence

import torch

from benchmark import weights
from benchmark.reference.model import Reference, param_shapes
from benchmark.reference.train import TrainReference
from benchmark.work import convs

__all__ = ["convs", "param_shapes", "make_weights", "Reference", "TrainReference"]


def make_weights(cfg: dict, tasks: Sequence[str], ncs: Sequence[int], gen: torch.Generator,
                 calib: torch.Tensor, served=None):
    """weights.make_weights over this family's parameters and reference."""
    return weights.make_weights(param_shapes(cfg, tasks, ncs),
                                lambda w: Reference(cfg, tasks, ncs, w, torch.float32),
                                gen, calib, served)
