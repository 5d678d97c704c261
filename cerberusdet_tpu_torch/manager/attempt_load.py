"""Checkpoint loading for evaluation and inference.

Counterpart of load_single in cerberusdet_tpu/manager/attempt_load.py:20-50
(the reference's attempt_load, cerberusdet/models/experimental.py:84-139):
a .ckpt.npz that either package writes builds the model from its own cfg,
task ids and class counts and takes its `ema` tree when it holds one (else
`params`); a reference .pt needs the model config and the data's task ids
and class counts (manager/pt_import.py). The model is fused. Not ported yet:
MLflow `models:/` URIs (ROADMAP.md queue 1, item 9) and the Ensemble of
several checkpoints (item 9).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint
from cerberusdet_tpu_torch.manager.weights import load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel


def load_single(weights: str, cfg: Optional[str] = None,
                task_ids: Optional[Sequence[str]] = None,
                nc: Optional[Sequence[int]] = None, fuse: bool = True,
                device=None) -> Tuple[CerberusModel, Dict[str, Any]]:
    """Load one checkpoint -> (model, meta): the port's CerberusModel on
    `device` (the card when None) in float32, fused when `fuse`. A .ckpt.npz
    carries its own cfg and task metadata (`cfg` overrides its model
    config) and gives its EMA weights where it has them; a .pt needs `cfg`,
    `task_ids` and `nc`."""
    if weights.startswith("models:/"):
        raise NotImplementedError("MLflow model URIs are not ported yet "
                                  "(ROADMAP.md queue 1, item 9)")
    if weights.endswith(".pt"):
        if not cfg or not task_ids or nc is None:
            raise ValueError(
                ".pt weights carry no architecture metadata — pass the model "
                "config (--cfg) and the data yaml (--data) so task_ids/nc are "
                "known")
        from cerberusdet_tpu_torch.manager.pt_import import import_pt

        model = import_pt(CerberusModel(cfg, task_ids, nc, device=device).init(0), weights)
        meta: Dict[str, Any] = {"task_ids": list(task_ids), "nc": list(nc)}
    else:
        ckpt = load_checkpoint(weights)
        meta = ckpt["meta"]
        model = CerberusModel(cfg or meta["cfg"], meta["task_ids"], meta["nc"], device=device)
        load_jax_params(model, ckpt["ema"] if ckpt.get("ema") else ckpt["params"])
    if fuse:
        model.fuse()
    return model, meta
