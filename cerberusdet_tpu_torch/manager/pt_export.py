"""Export the port's model to the reference's torch state-dict format.

Counterpart of cerberusdet_tpu/manager/pt_export.py, the inverse of
manager/pt_import.py: the model's weights become a `blocks.N.*` state dict in
the reference's CerberusDet layout: backbone as `blocks.0.model.<i>.*`, neck
layers as `blocks.<i>.*` (with clone blocks at the reference's
post-`sequential_split` indices when the model has a cerber schedule: the
released checkpoints' layout, cerberus.py:704-737), heads as
`blocks.<n_neck+1+ti>.*`, Detect towers as `cv2/cv3`, conv weights OIHW. The
weights are read through the JAX-layout tree of manager/weights.py (as the
import writes them), so the port writes what the JAX package writes for the
same parameters.

export -> import_state_dict reproduces the model's weights bit for bit, and
the reference's own model loads the dict with strict=True.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from cerberusdet_tpu_torch.manager.pt_import import (
    TORCH_BN,
    simulate_ref_split_chains,
    uid_tasks,
)
from cerberusdet_tpu_torch.manager.weights import export_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel


def _conv_w_inv(t: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW."""
    return np.ascontiguousarray(np.transpose(np.asarray(t), (3, 2, 0, 1)))


def _emit_block(my_params: Dict[str, Any], prefix: str,
                out: Dict[str, np.ndarray]) -> int:
    """Inverse of pt_import._map_block: write one block's tensors under the
    torch key `prefix`. Returns the number of tensors written."""
    n = 0
    keys = set(my_params.keys())
    if keys == {"w", "bn"}:  # Conv (conv.weight + bn.*)
        out[f"{prefix}.conv.weight"] = _conv_w_inv(my_params["w"])
        n += 1
        for mine, theirs in TORCH_BN.items():
            out[f"{prefix}.bn.{theirs}"] = np.asarray(my_params["bn"][mine])
            n += 1
        # torch BN tracks update counts; the reference's ckpts carry it
        out[f"{prefix}.bn.num_batches_tracked"] = np.asarray(0, np.int64)
        return n
    if keys == {"w", "b"}:  # bare Conv2d
        out[f"{prefix}.weight"] = _conv_w_inv(my_params["w"])
        out[f"{prefix}.bias"] = np.asarray(my_params["b"])
        return n + 2
    for k, sub in my_params.items():
        if not isinstance(sub, dict):
            continue
        if k.startswith("box"):
            tprefix = f"{prefix}.cv2.{k[3:]}"
        elif k.startswith("cls"):
            tprefix = f"{prefix}.cv3.{k[3:]}"
        else:
            tprefix = f"{prefix}.{k}"
        n += _emit_block(sub, tprefix, out)
    return n


def export_state_dict(model: CerberusModel) -> Dict[str, np.ndarray]:
    """The (unfused) port model's weights as the reference's state dict of
    numpy arrays (split layout when the config has a cerber schedule)."""
    n_backbone = model.n_backbone
    n_neck = model.n_neck
    n_tasks = len(model.task_ids)
    chains = (simulate_ref_split_chains(model.parsed.cerber, n_neck, n_tasks)
              if model.parsed.cerber else None)
    params = export_jax_params(model)
    uid_task = uid_tasks(model)

    sd: Dict[str, np.ndarray] = {}
    for uid, node_idx in model.block_nodes.items():
        block = params.get(uid)
        if not block:
            continue  # parameterless node (Upsample/Concat)
        if node_idx < n_backbone:
            prefix = f"blocks.0.model.{node_idx}"
        else:
            c = node_idx - n_backbone + 1
            ref_idx = chains[uid_task[uid]][c - 1] if chains else c
            prefix = f"blocks.{ref_idx}"
        _emit_block(block, prefix, sd)
    for ti, t in enumerate(model.task_ids):
        prefix = f"blocks.{n_neck + 1 + ti}"
        _emit_block(params[model.head_uid(t)], prefix, sd)
        # the reference Detect carries the fixed DFL projection conv as a
        # state-dict entry (yolo.py:48-55): arange(reg_max) as (1, 16, 1, 1)
        sd[f"{prefix}.dfl.conv.weight"] = (
            np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1))
    return sd


def export_pt(model: CerberusModel, path) -> None:
    """Write a torch-loadable .pt holding the BARE state dict: the form the
    reference's from_ckpt consumes directly (convert_to_cerber.py:12-36,
    models_manager.py:155-174) and the importer round-trips."""
    import torch

    sd = export_state_dict(model)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, str(path))
