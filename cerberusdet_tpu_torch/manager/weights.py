"""Weight bridge between a JAX parameter tree of numpy arrays and the port's
modules, both ways.

The JAX package keeps parameters as nested dicts keyed by block uid
(cerberusdet_tpu/models/cerberus.py), NHWC/HWIO. The port's state_dict has
the same nesting (nn/layers.py keeps the JAX names), so the mapping is by key:
  <uid>/.../w          -> blocks.<uid>. ... .w   (HWIO -> OIHW for 4-D)
  <uid>/.../b          -> ... .b
  <uid>/.../bn/scale   -> ... .bn.weight
  <uid>/.../bn/bias    -> ... .bn.bias
  <uid>/.../bn/mean    -> ... .bn.running_mean (buffer)
  <uid>/.../bn/var     -> ... .bn.running_var  (buffer)
  <uid>/.../implicit   -> ... .implicit (ImplicitA / ImplicitM: (1, 1, 1, C)
                                         NHWC -> (1, C, 1, 1))
A Linear's `w` is (c1, c2) in both, MultiheadAttention's in_w / out_w
(out, in) in both, and a BareConv's `w` is a 4-D `w` without `b`.
A fused tree ({w, b} convs, no Conv with `bn`; the standalone BN of
BottleneckCSP and MixConv2d stays, as the JAX package's fuse leaves it)
fuses the model first.
A quantized tree (quant/ptq.py) holds {w_q, s_w, s_x, b} for an int8 Conv:
  <uid>/.../w_q        -> ... .w_q  (HWIO int8 -> the kernel's packed layout,
                                     ops/conv_int8_cuda.py:pack_weight)
  <uid>/.../s_w, s_x   -> ... .s_w, .s_x  (float32; s_x 0-d)
and turns those Convs into their int8 form first. Its int8 annotations
(the JAX package's propagate_act_quant, run by quantize_params with model=):
  <uid>/__q_out__      -> blocks.<uid>.q_out  (float32 0-d buffer)
  <uid>/q_in           -> blocks.<uid>.q_in   (Concat / Upsample)
replace the model's own (nn/layers.py:Block), so that a propagated tree
loads and exports back bit for bit.
Parameterless blocks (Upsample, Concat) may be absent from the tree.
export_jax_tree / export_jax_params go the other way, so that a state trained
by the port can be held against the JAX package's and checkpoints move both
ways. export_jax_momentum / load_jax_momentum carry the optimizer's momentum
across the two formats: the JAX package keeps a momentum tree shaped like
the parameter tree (zeros at the BatchNorm statistics) in a checkpoint's
`opt` group (cerberusdet_tpu/train/trainer.py:210-229), the port a buffer
per parameter name (train/step.py, train/optim.py:OptState).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from cerberusdet_tpu_torch.models.cerberus import module_key
from cerberusdet_tpu_torch.nn.layers import ACT_QUANT
from cerberusdet_tpu_torch.ops.conv_int8_cuda import pack_weight, unpack_weight

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BN_BACK = {v: k for k, v in _BN.items()}
_ACT_QUANT_TORCH = {v: k for k, v in ACT_QUANT.items()}  # JAX leaf -> buffer name


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            yield from _leaves(v, path)
        else:
            yield path, v


def _torch_key(path: Tuple[str, ...]) -> str:
    rest = list(path)
    rest[-1] = _ACT_QUANT_TORCH.get(rest[-1], rest[-1])
    if len(rest) >= 2 and rest[-2] == "bn":
        if rest[-1] not in _BN:
            raise KeyError(f"unknown BatchNorm leaf {'/'.join(path)}")
        rest[-1] = _BN[rest[-1]]
    return ".".join(rest)


def _torch_arrays(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A JAX tree's leaves keyed as the port's state_dict, in its layouts."""
    src: Dict[str, np.ndarray] = {}
    for path, v in _leaves(tree):
        a = np.asarray(v)
        if path[-1] == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif path[-1] == "implicit":
            a = a.transpose(0, 3, 1, 2)  # NHWC -> NCHW
        elif path[-1] == "w_q":
            a = pack_weight(torch.from_numpy(np.array(a, np.int8))).numpy()
        src[_torch_key(path)] = a
    return src


def _has_bn(tree: Mapping[str, Any]) -> bool:
    """Whether a Conv of the tree holds its BatchNorm (a {w, bn} node, the
    nodes the JAX package's fuse folds)."""
    if not isinstance(tree, Mapping):
        return False
    return set(tree) == {"w", "bn"} or any(_has_bn(v) for v in tree.values())


@torch.no_grad()
def load_jax_tree(module: torch.nn.Module, tree: Mapping[str, Any]) -> torch.nn.Module:
    """Copy a JAX parameter tree into `module` (any layer of nn/layers.py, or
    a container of them keyed as the tree is) in place and return it.
    Raises KeyError on a missing or an extra key, ValueError on a shape
    mismatch. Values are cast to each parameter's dtype and device."""
    state = module.state_dict()
    src = _torch_arrays(tree)
    missing = sorted(set(state) - set(src))
    extra = sorted(set(src) - set(state))
    if missing or extra:
        raise KeyError(f"parameter trees differ: missing {missing[:8]} "
                       f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
    for k, a in src.items():
        dst = state[k]
        if tuple(dst.shape) != a.shape:
            raise ValueError(f"{k}: shape {a.shape} does not fit {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(a)))  # a writable copy
    return module


@torch.no_grad()
def load_jax_params(model, tree: Mapping[str, Any]):
    """Copy a JAX CerberusModel parameter tree (keyed by block uid) into the
    port's CerberusModel `model` in place and return it; fuses the model
    first when the tree is fused, and turns the Convs that the tree holds in
    int8 into their int8 form; its int8 annotations replace the model's.
    Errors as `load_jax_tree`."""
    if not _has_bn(tree) and not model.fused:
        model.fuse()
    for uid in model.block_nodes:
        model.block(uid).clear_act_quant()
    device = next(model.parameters()).device
    for path, _ in _leaves(tree):
        if path[-1] == "w_q":
            model.block(path[0]).get_submodule(".".join(path[1:-1])).to_int8()
        elif path[-1] in _ACT_QUANT_TORCH and len(path) == 2:
            model.block(path[0]).annotate(_ACT_QUANT_TORCH[path[-1]],
                                          torch.zeros((), device=device))
    load_jax_tree(model.blocks, {module_key(uid): sub for uid, sub in tree.items()})
    return model


@torch.no_grad()
def export_jax_tree(module: torch.nn.Module,
                    values: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The inverse of load_jax_tree: `module`'s parameters and buffers as a
    nested dict of numpy arrays in the JAX layout (OIHW -> HWIO; BatchNorm
    weight/bias/running_mean/running_var -> scale/bias/mean/var; an int8
    Conv's packed w_q -> HWIO int8). With `values` ({state_dict key:
    tensor}), those tensors take the place of the module's, and zeros that
    of every key `values` lacks."""
    tree: Dict[str, Any] = {}
    for key, t in module.state_dict().items():
        if values is not None:
            t = values[key] if key in values else torch.zeros_like(t)
        path = key.split(".")
        if len(path) >= 2 and path[-2] == "bn":
            path[-1] = _BN_BACK[path[-1]]
        a = t.detach().cpu().numpy()
        if path[-1] == "w" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif path[-1] == "implicit":
            a = a.transpose(0, 2, 3, 1)  # NCHW -> NHWC
        elif path[-1] == "w_q":
            conv = module.get_submodule(".".join(path[:-1]))
            a = unpack_weight(t.detach().cpu(), conv.c1 // conv.g).numpy()
        elif path[-1] in ACT_QUANT:
            path[-1] = ACT_QUANT[path[-1]]
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.array(a, order="C")  # keeps a 0-d s_x 0-d
    return tree


def _by_uid(model, by_key: Dict[str, Any]) -> Dict[str, Any]:
    uids = list(model.block_nodes) + [model.head_uid(t) for t in model.task_ids]
    return {uid: by_key[module_key(uid)] for uid in uids if module_key(uid) in by_key}


def export_jax_params(model) -> Dict[str, Any]:
    """The port's CerberusModel as a JAX CerberusModel parameter tree keyed by
    block uid (parameterless blocks left out); load_jax_params reads it."""
    return _by_uid(model, export_jax_tree(model.blocks))


def export_jax_momentum(model, momentum_buf: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's momentum buffers ({parameter name: tensor} of `model`, as
    OptState.momentum_buf keeps them) as the JAX package's momentum tree:
    the layout of export_jax_params(model), zeros at the BatchNorm
    statistics and at any parameter without a buffer."""
    n = len("blocks.")
    bufs = {name[n:]: b for name, b in momentum_buf.items() if name.startswith("blocks.")}
    return _by_uid(model, export_jax_tree(model.blocks, values=bufs))


@torch.no_grad()
def load_jax_momentum(model, tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The inverse of export_jax_momentum: a JAX momentum tree as {parameter
    name: tensor} for every parameter of `model`, each on its parameter's
    device and in its dtype. Its entries at the BatchNorm statistics are
    dropped. Raises KeyError on a parameter without a buffer, ValueError on
    a shape mismatch."""
    arrays = _torch_arrays({module_key(uid): sub for uid, sub in tree.items()})
    out: Dict[str, torch.Tensor] = {}
    for name, p in model.named_parameters():
        key = name[len("blocks."):]
        if key not in arrays:
            raise KeyError(f"the momentum tree has no buffer for {name}")
        a = arrays[key]
        if tuple(p.shape) != a.shape:
            raise ValueError(f"{name}: momentum shape {a.shape} does not fit {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(a)).to(device=p.device, dtype=p.dtype)
    return out
