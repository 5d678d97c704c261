"""Checkpoint loading for evaluation and inference.

Counterpart of load_single in cerberusdet_tpu/manager/attempt_load.py:20-50
(the reference's attempt_load, cerberusdet/models/experimental.py:84-139) for
the .ckpt.npz files either package writes: the model is built from the
checkpoint's own cfg, task ids and class counts, takes its `ema` tree when it
holds one (else `params`), and is fused. Not ported yet: .pt weights
(pt_import, ROADMAP.md queue 1, item 5), MLflow `models:/` URIs (item 9) and
the Ensemble of several checkpoints (item 9).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint
from cerberusdet_tpu_torch.manager.weights import load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel


def load_single(weights: str, cfg: Optional[str] = None, fuse: bool = True,
                device=None) -> Tuple[CerberusModel, Dict[str, Any]]:
    """Load one .ckpt.npz -> (model, meta): the port's CerberusModel on
    `device` (the card when None) in float32, holding the checkpoint's EMA
    weights where it has them, fused when `fuse`. `cfg` overrides the
    checkpoint's model config."""
    if weights.startswith("models:/"):
        raise NotImplementedError("MLflow model URIs are not ported yet "
                                  "(ROADMAP.md queue 1, item 9)")
    if weights.endswith(".pt"):
        raise NotImplementedError(".pt weights need pt_import, not ported yet "
                                  "(ROADMAP.md queue 1, item 5)")
    ckpt = load_checkpoint(weights)
    meta = ckpt["meta"]
    model = CerberusModel(cfg or meta["cfg"], meta["task_ids"], meta["nc"], device=device)
    load_jax_params(model, ckpt["ema"] if ckpt.get("ema") else ckpt["params"])
    if fuse:
        model.fuse()
    return model, meta
