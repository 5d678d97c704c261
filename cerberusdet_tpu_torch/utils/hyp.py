"""Per-task hyperparameter addressing: scalar | N-task list | '{task}_{name}'.

The port's copy of cerberusdet_tpu/utils/hyp.py:13-49 (the reference's
cerberusdet/utils/torch_utils.py:319-370 get_hyperparameter /
set_hyperparameter and cerberusdet/data/datasets.py:106-127).
"""

from __future__ import annotations

from typing import Any, Dict, Optional


def get_hyperparameter(hyp: Dict[str, Any], name: str, task_idx: Optional[int] = None,
                       task: Optional[str] = None):
    if task is not None and f"{task}_{name}" in hyp:
        return hyp[f"{task}_{name}"]
    if name not in hyp:
        raise KeyError(f"hyperparameter {name!r} not found")
    v = hyp[name]
    if isinstance(v, (list, tuple)):
        if task_idx is None:
            raise ValueError(f"hyp {name!r} is per-task; task_idx required")
        return v[task_idx]
    return v


def set_hyperparameter(hyp: Dict[str, Any], name: str, value,
                       task_idx: Optional[int] = None, task: Optional[str] = None):
    if task is not None and f"{task}_{name}" in hyp:
        hyp[f"{task}_{name}"] = value
        return
    v = hyp.get(name)
    if isinstance(v, list) and task_idx is not None:
        v[task_idx] = value
        return
    hyp[name] = value


def task_hyp_view(hyp: Dict[str, Any], task_idx: int, task: str) -> Dict[str, Any]:
    """Flatten to plain scalars for one task (the dataset's copy)."""
    out = {}
    for k, v in hyp.items():
        if "_" in k and k.split("_", 1)[0] == task:
            out[k.split("_", 1)[1]] = v
        elif isinstance(v, (list, tuple)):
            out[k] = v[task_idx]
        else:
            out[k] = v
    return out
