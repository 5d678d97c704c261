"""Importer for reference PyTorch checkpoints into the port's model.

Counterpart of cerberusdet_tpu/manager/pt_import.py, whose parity target is
cerberusdet/utils/ckpt_utils.py:11-90 (dict_to_cerber: 'model.N.*' yolo keys
-> cerber blocks; backbone collapses; head keys duplicated to every task
head) and convert_to_cerber.py.

Supported sources:
  * plain YOLOv8 state_dicts ('model.N.<sub>.weight', ultralytics layout),
  * unsplit CerberusDet state_dicts ('blocks.M.*' + 'heads.<task>.*'),
  * split CerberusDet state_dicts (clone blocks appended after the heads:
    the released checkpoints' layout),
  * any of these under a 'model.' wrapper ('model.model.N.*'),
  * torch .pt files whose checkpoint dict has 'model'/'ema' entries holding
    either a state_dict OR a whole pickled nn.Module: the reference pickles
    module objects (models_manager.py:303-305, experimental.py:112-122).
    Module pickles are loaded with a SHIM unpickler: unknown classes
    (cerberusdet.*, ultralytics.*, ...) deserialize into inert attribute
    holders, and the state dict is re-collected by walking the module graph's
    _parameters/_buffers/_modules; no reference code is imported or run.

Route: the reference keys are mapped onto the JAX package's parameter tree
(the tree of manager/weights.py, which keeps the port's state_dict names, with
conv weights OIHW -> HWIO), by the JAX importer's own walk, and that tree is
loaded with load_jax_params. So the port imports exactly what the JAX package
imports from the same file, and the one key bridge (manager/weights.py) stays
the only place that knows the port's names. Leaves that a file lacks keep
the model's own values. Branched clones receive the same source weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel, _head_id_to_task

TORCH_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


class _ShimObject:
    """Inert stand-in for classes whose code is unavailable at unpickle time
    (the reference's cerberusdet.* module classes). Captures attribute state;
    exposes nothing else."""

    def __init__(self, *a, **k):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):  # (dict_state, slots_state)
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)


# torch's own tensor-rebuild machinery and stdlib containers must resolve
# for real; everything else becomes a shim.
_SAFE_PICKLE_ROOTS = (
    "torch", "collections", "numpy", "builtins", "copyreg", "pathlib",
    "argparse", "functools",
)


def _shim_unpickle_torch(path):
    """torch.load with a pickle module whose Unpickler shims unknown classes,
    so module-pickled checkpoints deserialize without their source code."""
    import pickle
    import types

    import torch

    class ShimUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.split(".")[0] in _SAFE_PICKLE_ROOTS:
                return super().find_class(module, name)
            return type(name, (_ShimObject,), {"__module__": module})

    def shim_load(f, **kw):
        kw.pop("encoding", None)
        return ShimUnpickler(f).load()

    shim_pickle = types.SimpleNamespace(
        Unpickler=ShimUnpickler, load=shim_load, __name__="shim_pickle"
    )
    try:
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=shim_pickle)
    except Exception as e:
        raise ValueError(f"{path} is not a readable torch checkpoint: {e}") from e


def _collect_module_state(obj, prefix: str = "") -> Dict[str, Any]:
    """Re-implementation of nn.Module.state_dict() over a shim-unpickled
    module graph: walk _parameters/_buffers/_modules recursively."""
    out: Dict[str, Any] = {}
    d = getattr(obj, "__dict__", {})
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            out[prefix + name] = p
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None:
            out[prefix + name] = b
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            out.update(_collect_module_state(m, f"{prefix}{name}."))
    return out


def _is_module_graph(obj) -> bool:
    d = getattr(obj, "__dict__", None)
    return isinstance(d, dict) and ("_modules" in d or "_parameters" in d)


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """Load a .pt and extract a flat {key: float32 ndarray} state dict. Picks
    'ema' over 'model' like attempt_load (experimental.py:99-139). Reads with
    torch.load(weights_only=True) first and takes the shim unpickler only
    when that refuses the file (module-pickled reference checkpoints)."""
    import torch

    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        ckpt = _shim_unpickle_torch(path)

    def extract(obj):
        if obj is None:
            return None
        if hasattr(obj, "state_dict") and callable(getattr(obj, "state_dict")):
            return obj.state_dict()
        if _is_module_graph(obj):
            return _collect_module_state(obj)
        if isinstance(obj, dict) and obj and all(
            hasattr(v, "shape") for v in obj.values()
        ):
            return obj
        return None

    sd = None
    if isinstance(ckpt, dict):
        for key in ("ema", "model"):
            sd = extract(ckpt.get(key))
            if sd:
                break
        if sd is None:
            sd = extract(ckpt)  # bare state dict
    else:
        sd = extract(ckpt)
    if sd is None:
        raise ValueError(f"cannot extract a state_dict from {path}")

    def to_np(v):
        if hasattr(v, "detach"):
            return v.detach().float().numpy()
        return np.asarray(v, np.float32)

    return {k: to_np(v) for k, v in sd.items()}


def _conv_w(t: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO (the JAX tree's layout; load_jax_params turns it back)."""
    return np.transpose(t, (2, 3, 1, 0))


def _map_block(my_params: Dict[str, Any], prefix: str,
               src: Dict[str, np.ndarray], out: Dict[str, Any]) -> int:
    """Recursively translate one block's params from torch keys rooted at
    `prefix`. Returns number of leaves filled."""
    n = 0
    keys = set(my_params.keys())
    if keys == {"w", "bn"}:  # Conv (conv.weight + bn.*)
        w = src.get(f"{prefix}.conv.weight")
        if w is not None:
            out["w"] = _conv_w(w)
            n += 1
        bn_out = dict(my_params["bn"])
        for mine, theirs in TORCH_BN.items():
            v = src.get(f"{prefix}.bn.{theirs}")
            if v is not None:
                bn_out[mine] = v
                n += 1
        out["bn"] = bn_out
        return n
    if keys == {"w", "b"}:  # PlainConv (bare Conv2d)
        w = src.get(f"{prefix}.weight")
        b = src.get(f"{prefix}.bias")
        if w is not None:
            out["w"] = _conv_w(w)
            n += 1
        if b is not None:
            out["b"] = b
            n += 1
        return n
    for k, sub in my_params.items():
        if not isinstance(sub, dict):
            continue
        if k.startswith("box"):
            tprefix = f"{prefix}.cv2.{k[3:]}"  # Detect box tower -> cv2.<level>
        elif k.startswith("cls"):
            tprefix = f"{prefix}.cv3.{k[3:]}"  # Detect cls tower -> cv3.<level>
        else:
            tprefix = f"{prefix}.{k}"
        child: Dict[str, Any] = dict(sub)
        n += _map_block(sub, tprefix, src, child)
        out[k] = child
    return n


def simulate_ref_split_chains(cerber, n_neck: int, n_tasks: int):
    """Reproduce the reference's block-index assignment after
    sequential_split (cerberus.py:704-737 / create_nested_branch:461-633).

    At each split [k, groups], the FIRST group keeps its current blocks;
    every subsequent group receives clones of layers k+1..n_neck appended at
    the END of the block list, in original layer order. Heads sit at
    n_neck+1..n_neck+T before any clones.

    Returns {task_idx: [ref_block_index for cerber layer 1..n_neck]}.
    """
    chains = {t: list(range(1, n_neck + 1)) for t in range(n_tasks)}
    next_id = n_neck + n_tasks + 1
    for k, groups in (cerber or []):
        for gi, g in enumerate(groups):
            if gi == 0:
                continue  # first group keeps its existing blocks
            new_ids = {}
            for c in range(int(k) + 1, n_neck + 1):
                new_ids[c] = next_id
                next_id += 1
            for head in g:
                t = _head_id_to_task(head, n_neck, n_tasks)
                for c in range(int(k) + 1, n_neck + 1):
                    chains[t][c - 1] = new_ids[c]
    return chains


def uid_tasks(model: CerberusModel) -> Dict[str, int]:
    """uid -> the index of a task whose chain uses it (for per-branch sourcing)."""
    uid_task: Dict[str, int] = {}
    for (ti, _), uid in model._task_node_uid.items():
        uid_task.setdefault(uid, ti)
    return uid_task


def import_state_dict(model: CerberusModel, sd: Dict[str, np.ndarray],
                      verbose: bool = False) -> CerberusModel:
    """Fill the (unfused) port model in place with the weights of a torch
    state dict and return it. Handles 'model.N.*' (yolo), unsplit cerber
    ('blocks.N.*' with heads as trailing blocks) AND split cerber layouts
    (clone blocks appended after the heads: the released checkpoints'
    format; the model's cerber schedule must match the checkpoint's)."""
    # normalize key prefixes: strip a leading 'model.' wrapper ('model.model.N')
    if any(k.startswith("model.model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    is_yolo = any(k.startswith("model.") for k in sd)
    is_cerber = any(k.startswith("blocks.") for k in sd)
    n_backbone = model.n_backbone
    n_neck = model.n_neck
    n_tasks = len(model.task_ids)

    # split checkpoint: any param block index beyond the heads' slots
    chains = None
    if is_cerber:
        max_idx = max((int(k.split(".")[1]) for k in sd if k.startswith("blocks.")),
                      default=0)
        if max_idx > n_neck + n_tasks:
            if not model.parsed.cerber:
                raise ValueError(
                    "checkpoint is a SPLIT CerberusDet model but the model "
                    "config has no cerber schedule — build the model from the "
                    "matching config")
            chains = simulate_ref_split_chains(model.parsed.cerber, n_neck, n_tasks)

    params = export_jax_params(model)
    uid_task = uid_tasks(model)
    out = dict(params)
    total = 0
    for uid, node_idx in model.block_nodes.items():
        if uid not in params:
            continue  # parameterless node (Upsample, Concat)
        if is_yolo:
            prefix = f"model.{node_idx}"
        elif is_cerber:
            if node_idx < n_backbone:
                prefix = f"blocks.0.model.{node_idx}"
            else:
                c = node_idx - n_backbone + 1
                ref_idx = chains[uid_task[uid]][c - 1] if chains else c
                prefix = f"blocks.{ref_idx}"
        else:
            raise ValueError("unrecognized state dict layout")
        child = dict(out[uid])
        total += _map_block(params[uid], prefix, sd, child)
        out[uid] = child
    # heads: yolo ckpt has one Detect at model.<last> (duplicated to every
    # task); unsplit cerber state dicts store heads as blocks.{n_neck+1+ti}
    last_idx = len(model.parsed.nodes)
    for ti, t in enumerate(model.task_ids):
        huid = model.head_uid(t)
        if is_yolo:
            prefix = f"model.{last_idx}"
        elif f"heads.{t}.cv2.0.0.conv.weight" in sd:
            prefix = f"heads.{t}"
        else:
            prefix = f"blocks.{n_neck + 1 + ti}"
        child = dict(out[huid])
        total += _map_block(params[huid], prefix, sd, child)
        out[huid] = child
    load_jax_params(model, out)
    if verbose:
        print(f"imported {total} tensors from torch state dict")
    return model


def import_pt(model: CerberusModel, path, verbose: bool = False) -> CerberusModel:
    """import_state_dict of the .pt file `path`."""
    return import_state_dict(model, load_torch_state_dict(path), verbose)
