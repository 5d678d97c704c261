"""Dataset config checks.

Counterpart of apply_path_prefix and the path check of check_dataset in
cerberusdet_tpu/utils/checks.py:235-304 (the reference's general.py:130-170),
without the download stanza: a missing val path raises and names it.
"""

from __future__ import annotations

from pathlib import Path


def apply_path_prefix(data: dict) -> dict:
    """Resolve the optional `path` key onto train/val/test entries
    (general.py:131-137). Path(prefix) / absolute-path == absolute-path, so
    repeated application never double-prepends."""
    path = Path(data.get("path", ""))
    if str(path) not in ("", "."):
        for k in ("train", "val", "test"):
            if data.get(k):
                data[k] = (str(path / data[k]) if isinstance(data[k], str)
                           else [str(path / x) for x in data[k]])
    return data


def check_dataset(data: dict) -> dict:
    """Resolve the optional `path` prefix, default `names`, and verify that
    the val paths exist (general.py:130-170); a missing one raises
    FileNotFoundError naming it. The yaml's `download` stanza is not run:
    the port downloads nothing. Missing train paths only warn, since a
    standalone val needs none."""
    data = apply_path_prefix(data)
    if "nc" not in data:
        raise ValueError("Dataset 'nc' key missing.")
    if "names" not in data:
        nc = data["nc"]
        data["names"] = ([[str(i) for i in range(n)] for n in nc] if isinstance(nc, list)
                         else [str(i) for i in range(nc)])
    train, val = data.get("train"), data.get("val")
    if isinstance(train, list) and isinstance(val, list) and len(train) != len(val):
        raise ValueError("data config: train and val list different numbers of tasks")
    if val:
        missing = [str(Path(x).resolve()) for x in (val if isinstance(val, list) else [val])
                   if not Path(x).resolve().exists()]
        if missing:
            raise FileNotFoundError(f"Dataset not found, nonexistent paths: {missing}")
    if train:
        bad = [str(p) for p in (train if isinstance(train, list) else [train])
               if not Path(p).resolve().exists()]
        if bad:
            print(f"WARNING: train paths do not exist: {bad}")
    return data
