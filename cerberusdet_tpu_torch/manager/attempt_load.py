"""Checkpoint loading for evaluation and inference, with model ensembling.

Counterpart of cerberusdet_tpu/manager/attempt_load.py (the reference's
attempt_load and Ensemble, cerberusdet/models/experimental.py:84-139):
a checkpoint that either package writes (a .ckpt.npz, or an orbax
directory, manager/checkpoint.py) builds the model from its own cfg, task
ids and class counts and takes its `ema` tree when it holds one (else
`params`); a reference .pt needs the model config and the data's task ids
and class counts (manager/pt_import.py); an MLflow `models:/` URI is
downloaded first (utils/mlflow_logging.py). The model is fused. Several
weights load as an Ensemble, whose eval forward concatenates the members'
candidates for one NMS.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

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
        from cerberusdet_tpu_torch.utils.mlflow_logging import attempt_mlflow_download

        weights = attempt_mlflow_download(weights)
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


class Ensemble(torch.nn.Module):
    """Loaded models over the SAME tasks. The eval forward returns {task:
    (B, N_1 + N_2 + ..., 4 + nc)}: the members' decoded candidates
    concatenated on the anchor axis, in member order, for one NMS per task
    (experimental.py:84-97). On the NMS kernel's route
    (ops/nms.py:non_max_suppression) the candidates per image are capped at
    its MAX_K of 16384, as the JAX package's Pallas route caps them: two
    members at 640 px give 16800 anchors, of which the 16384 with the
    highest scores are kept. The members stay separate modules: each keeps
    its own weights, dtype and int8 form."""

    def __init__(self, members: Sequence[torch.nn.Module]):
        super().__init__()
        if not members:
            raise ValueError("empty ensemble")
        self.members = torch.nn.ModuleList(members)
        self.task_ids = list(members[0].task_ids)
        self.strides = members[0].strides

    def forward(self, img: torch.Tensor, tasks: Optional[Sequence[str]] = None
                ) -> Dict[str, torch.Tensor]:
        preds: Dict[str, List[torch.Tensor]] = {}
        for model in self.members:
            for t, (pred, _feats) in model(img, tasks=tasks).items():
                preds.setdefault(t, []).append(pred)
        return {t: torch.cat(ps, dim=1) for t, ps in preds.items()}


def attempt_load(weights: Union[str, Sequence[str]], cfg: Optional[str] = None,
                 task_ids: Optional[Sequence[str]] = None,
                 nc: Optional[Sequence[int]] = None, fuse: bool = True, device=None):
    """One checkpoint -> (model, meta); several -> (Ensemble, meta of the
    last). Models on `device` (the card when None), in float32."""
    if isinstance(weights, (list, tuple)) and len(weights) > 1:
        members, meta = [], {}
        for w in weights:
            model, meta = load_single(w, cfg, task_ids, nc, fuse, device)
            members.append(model)
        return Ensemble(members), meta
    w = weights[0] if isinstance(weights, (list, tuple)) else weights
    return load_single(w, cfg, task_ids, nc, fuse, device)
