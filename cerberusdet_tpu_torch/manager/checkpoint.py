"""Reader of the `.ckpt.npz` checkpoints that the JAX package writes.

A numpy-only copy of the npz branch of cerberusdet_tpu/manager/checkpoint.py:
one .npz holding `params/...`, `ema/...`, `opt/...` arrays under '/'-joined
tree paths, and the JSON metadata under `__meta__`. float16 arrays are upcast
to float32, as there.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np

SEP = "/"


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def load_checkpoint(path) -> Dict[str, Any]:
    """Returns {'params', 'ema', 'opt', 'meta'} ('ema'/'opt' may be None)."""
    groups: Dict[str, Dict[str, np.ndarray]] = {"params": {}, "ema": {}, "opt": {}}
    meta: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key == "__meta__":
                meta = json.loads(bytes(data[key]).decode())
                continue
            head, rest = key.split(SEP, 1)
            v = data[key]
            if v.dtype == np.float16:
                v = v.astype(np.float32)
            groups[head][rest] = v
    return {name: (unflatten_tree(g) if g else None) for name, g in groups.items()} | {
        "meta": meta}
