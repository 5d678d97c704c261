"""Run directories and data configs.

Counterpart of increment_path and parse_data_config in
cerberusdet_tpu/manager/run_manager.py:23-72 (the reference's
models_manager.py:61-96 and general.py:596-610). The run manager itself
(checkpoint cadence, logging) comes with the trainer (ROADMAP.md queue 1,
item 5).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict

import yaml

from cerberusdet_tpu_torch.utils.checks import apply_path_prefix, check_dataset


def increment_path(path, exist_ok: bool = False) -> Path:
    """runs/train/exp -> exp2, exp3, ... (general.py:596-610)."""
    path = Path(path)
    if not path.exists() or exist_ok:
        return path
    for n in range(2, 9999):
        p = Path(f"{path}{n}")
        if not p.exists():
            return p
    raise RuntimeError("too many run dirs")


def parse_data_config(data: Any, check: bool = False) -> Dict[str, Any]:
    """Load data.yaml (or take a dict); promote single-task scalars to
    1-element lists (models_manager.py:61-96). With check=True, resolve the
    optional `path` prefix and verify the val paths (utils/checks.py)."""
    if isinstance(data, (str, Path)):
        with open(data) as f:
            d = yaml.safe_load(f)
    else:
        d = dict(data)
    if check:
        d = check_dataset(d)
    elif d.get("path"):
        d = apply_path_prefix(d)  # `path` is config semantics, applied unchecked too
    if not isinstance(d.get("nc"), list):
        d["nc"] = [d["nc"]]
        d["names"] = [d["names"]]
        d["train"] = [d["train"]]
        d["val"] = [d["val"]]
        if d.get("test") is not None:
            d["test"] = [d["test"]]
        d.setdefault("task_ids", ["detect"])
        if not isinstance(d["task_ids"], list):
            d["task_ids"] = [d["task_ids"]]
    n = len(d["task_ids"])
    for key in ("nc", "names", "train", "val"):
        if len(d[key]) != n:
            raise ValueError(f"data config: len({key}) != len(task_ids)")
    for nc, names in zip(d["nc"], d["names"]):
        if len(names) != nc:
            raise ValueError(f"data config: {nc} classes but {len(names)} names")
    return d
