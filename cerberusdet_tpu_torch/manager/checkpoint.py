"""The `.ckpt.npz` checkpoints of the JAX package: writer and reader.

A numpy-only copy of the npz branch of cerberusdet_tpu/manager/checkpoint.py
(save_checkpoint :44-81, load_checkpoint): one .npz holding `params/...`,
`ema/...` and `opt/...` arrays under '/'-joined tree paths, and the JSON
metadata under `__meta__`. save_checkpoint writes float32 leaves of params
and ema as float16 (half=True) and the optimizer state as it is; the reader
upcasts float16 to float32. Files move between the two packages both ways.
strip_checkpoint and intersect_trees are copies of :107-130.

A path not ending in .npz is an orbax checkpoint directory, as the JAX
package dispatches (is_orbax_path): load_checkpoint reads one that its
save_checkpoint_orbax wrote (:141-204) through tensorstore, imported when
one is read (orbax imports jax; tensorstore does not), and returns the .npz
contract. The port does not write them: a directory that orbax restores
carries orbax's own metadata, written only by orbax.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

SEP = "/"


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def save_checkpoint(path, params: Dict[str, Any], meta: Dict[str, Any],
                    ema_params: Optional[Dict[str, Any]] = None,
                    opt_momentum: Optional[Dict[str, Any]] = None,
                    half: bool = True) -> None:
    """Write `params` (a JAX-layout tree of numpy arrays, e.g.
    manager/weights.py:export_jax_params) with its JSON-serialisable `meta`
    (cfg, task_ids, nc, names, epoch, ...) to the .npz file `path`."""
    if is_orbax_path(path):
        raise ValueError(f"{path}: the port writes .npz checkpoints only; an orbax "
                         "directory needs orbax's own metadata, which only orbax (a jax "
                         "package) writes, and the port reads such directories only")
    arrays: Dict[str, np.ndarray] = {}

    def cast(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        return x.astype(np.float16) if (half and x.dtype == np.float32) else x

    for k, v in flatten_tree(params).items():
        arrays[f"params{SEP}{k}"] = cast(v)
    if ema_params is not None:
        for k, v in flatten_tree(ema_params).items():
            arrays[f"ema{SEP}{k}"] = cast(v)
    if opt_momentum is not None:
        for k, v in flatten_tree(opt_momentum).items():
            arrays[f"opt{SEP}{k}"] = np.asarray(v)  # optimizer state stays as it is
    arrays["__meta__"] = np.frombuffer(json.dumps(meta, default=float).encode(), dtype=np.uint8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def is_orbax_path(path) -> bool:
    return not str(path).endswith(".npz")


def load_checkpoint(path) -> Dict[str, Any]:
    """Returns {'params', 'ema', 'opt', 'meta'} ('ema'/'opt' may be None),
    from a .npz file or an orbax directory."""
    if is_orbax_path(path):
        return load_checkpoint_orbax(path)
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


def strip_checkpoint(path, out_path=None) -> None:
    """Finalise a training checkpoint: promote its EMA to params and drop the
    optimizer state (general.py:557-578); float32 leaves are written as
    float16."""
    ckpt = load_checkpoint(path)
    params = ckpt["ema"] if ckpt["ema"] is not None else ckpt["params"]
    meta = dict(ckpt["meta"])
    meta["stripped"] = True
    save_checkpoint(out_path or path, params, meta, ema_params=None, opt_momentum=None)


def intersect_trees(dst: Dict[str, Any], src: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], int, int]:
    """Copy src leaves into dst where path and shape match (ckpt_utils.py:5-8),
    cast to dst's dtype. Returns (merged, n_matched, n_total_dst)."""
    dst_flat = flatten_tree(dst)
    src_flat = flatten_tree(src)
    matched = 0
    out = dict(dst_flat)
    for k, v in dst_flat.items():
        s = src_flat.get(k)
        if s is not None and tuple(s.shape) == tuple(np.shape(v)):
            out[k] = s.astype(np.asarray(v).dtype)
            matched += 1
    return unflatten_tree(out), matched, len(dst_flat)


def load_checkpoint_orbax(path) -> Dict[str, Any]:
    """Read an orbax directory that the JAX package's save_checkpoint_orbax
    wrote (one zarr array per leaf in an OCDBT key-value store; the tree's
    key paths in its _METADATA; `meta_json` the metadata's JSON bytes) and
    return the .npz contract, float16 leaves of params and ema upcast to
    float32. Needs tensorstore."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"{path}: an orbax checkpoint directory is read through "
                          "tensorstore, which is not installed") from e
    path = Path(path).resolve()
    with open(path / "_METADATA") as f:
        layout = json.load(f)
    kvstore = ({"driver": "ocdbt", "base": f"file://{path}"} if layout.get("use_ocdbt", True)
               else {"driver": "file", "path": f"{path}/"})
    driver = "zarr3" if layout.get("use_zarr3") else "zarr"
    leaves = [[k["key"] for k in entry["key_metadata"]]
              for entry in layout["tree_metadata"].values()]
    stores = [ts.open({"driver": driver, "kvstore": kvstore, "path": ".".join(keys)},
                      open=True, read=True) for keys in leaves]
    reads = [s.result().read() for s in stores]
    tree: Dict[str, Any] = {}
    for keys, r in zip(leaves, reads):
        v = np.asarray(r.result())
        if keys[0] in ("params", "ema") and v.dtype == np.float16:
            v = v.astype(np.float32)
        d = tree
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    meta = json.loads(bytes(np.asarray(tree.pop("meta_json"), np.uint8)).decode())
    return {"params": tree.get("params"), "ema": tree.get("ema") or None,
            "opt": unflatten_tree(tree["opt"]) if tree.get("opt") else None, "meta": meta}
