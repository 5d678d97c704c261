"""Post-training int8 quantization for serving.

Counterpart of cerberusdet_tpu/quant/ptq.py, with the same scheme:
  * weights: per-output-channel symmetric int8 from the FUSED float32
    weights, s_w = max |w| / 127 over (kh, kw, Ci) (1.0 where that is 0);
  * activations: per-tensor symmetric int8, s_x = amax / 127, amax the max
    |input| of each Conv over the calibration batches;
  * the conv sums int32 and dequantizes into the bias add
    (nn/module.py:conv2d_int8);
  * with propagate=True (the JAX package's quantize_params(..., model=)),
    propagate_act_quant moves each activation quantize to the tensor's
    producer, so int8 crosses the blocks, the concats and the upsamples.
Convs are named by the JAX package's path tuples, (uid,) for a Conv block
and (uid, "m", "0", "cv1") etc. inside one, so amax dicts and quantized
trees of the two packages compare key for key. PlainConv (the Detect
towers' last 1x1) is never quantized.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cerberusdet_tpu_torch.nn import layers as L
from cerberusdet_tpu_torch.nn.layers import ACT_QUANT, Conv
from cerberusdet_tpu_torch.ops.conv_int8_cuda import pack_weight

Path = Tuple[str, ...]


def conv_layers(model) -> Iterator[Tuple[Path, Conv]]:
    """(JAX path, Conv) for every Conv of a CerberusModel, blocks in uid order."""
    uids = list(model.block_nodes) + [model.head_uid(t) for t in model.task_ids]
    for uid in uids:
        for name, m in model.block(uid).named_modules():
            if isinstance(m, Conv):
                yield (uid,) + (tuple(name.split(".")) if name else ()), m


def fused_conv_weights(model) -> Dict[Path, Tuple[torch.Tensor, torch.Tensor]]:
    """{path: (w OIHW, b)} float32 copies of the fused Convs' weights: what
    quantize_params reads, taken before a cast to the compute dtype."""
    return {path: (m.w.detach().float().clone(), m.b.detach().float().clone())
            for path, m in conv_layers(model) if not m.int8}


@torch.no_grad()
def calibrate_amax(model, batches: Sequence, dtype: Optional[torch.dtype] = None
                   ) -> Dict[Path, float]:
    """Run calibration batches ((B, H, W, 3) in [0, 1], numpy or tensors)
    through the fused model in `dtype` (the model's own when None), and
    return {conv path: max |input|} over the batches as host floats. The
    model must be float: where it holds int8 annotations (propagate_act_quant)
    or int8 Convs (whose blocks quantize before their concats), Convs would
    see int8 inputs, which record nothing, so it is refused."""
    convs = list(conv_layers(model))
    if act_quant_annotations(model) or any(m.int8 for _, m in convs):
        raise ValueError("calibrate_amax takes a float model: this one holds int8 Convs or "
                         "int8 annotations, whose int8 inputs would record nothing")
    ref = next(model.parameters())
    dtype = ref.dtype if dtype is None else dtype
    taps: Dict[Path, torch.Tensor] = {}
    amax: Dict[Path, float] = {}
    try:
        for path, m in convs:
            m.tap, m.tap_key = taps, path
        for b in batches:
            taps.clear()
            x = torch.as_tensor(b, device=ref.device).permute(0, 3, 1, 2).to(dtype)
            model(x)
            keys = sorted(taps)
            vals = torch.stack([taps[k] for k in keys]).cpu().tolist()  # one copy
            for k, v in zip(keys, vals):
                amax[k] = max(amax.get(k, 0.0), float(v))
    finally:
        for _, m in convs:
            m.tap = m.tap_key = None
    return amax


def select_all(path: Path, w: torch.Tensor) -> bool:
    return True


def select_deep(min_cin: int = 256) -> Callable[[Path, torch.Tensor], bool]:
    """Quantize only convs with at least `min_cin` input channels (w is
    OIHW: c_in is w.shape[1])."""

    def f(path: Path, w) -> bool:
        return w.shape[1] >= min_cin

    return f


@torch.no_grad()
def quantize_params(model, amax: Dict[Path, float], select: Optional[Callable] = None,
                    weights: Optional[Dict[Path, Tuple[torch.Tensor, torch.Tensor]]] = None,
                    propagate: bool = False):
    """Turn the selected fused Convs of `model` into their int8 form, in
    place; returns the model. Only Convs whose path is in `amax` with a
    positive value are candidates. `weights` is fused_conv_weights(model)
    taken before a cast (the model's own weights, as float32, when None).
    The arithmetic is the JAX package's, in numpy float32, so w_q, s_w and
    s_x come out bit for bit the same. The model's int8 annotations are
    cleared; with `propagate` (the JAX package's model= argument, which
    every int8 caller passes) propagate_act_quant then annotates it anew."""
    if select is None:
        select = select_deep()
    clear_act_quant(model)
    host_sx: Dict[Path, float] = {}
    for path, m in conv_layers(model):
        a = amax.get(path)
        if m.int8 or a is None or a <= 0.0:
            continue
        w, b = weights[path] if weights is not None else (m.w.detach(), m.b.detach())
        if not select(path, w):
            continue
        w = w.cpu().float().numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
        s_w = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
        s_w = np.where(s_w == 0.0, 1.0, s_w).astype(np.float32)
        w_q = np.clip(np.round(w / s_w), -127, 127).astype(np.int8)
        b = b.float().clone()
        m.to_int8()
        m.w_q.copy_(pack_weight(torch.from_numpy(w_q)))
        m.s_w.copy_(torch.from_numpy(s_w))
        host_sx[path] = float(np.float32(a / 127.0))
        m.s_x.fill_(host_sx[path])
        m.b.copy_(b)
    if propagate:
        propagate_act_quant(model, host_sx)
    return model


def act_quant_annotations(model) -> Dict[Tuple[str, str], float]:
    """{(uid, "q_out" | "q_in"): scale} of a CerberusModel's blocks."""
    out = {}
    for uid in model.block_nodes:
        block = model.block(uid)
        for name in ACT_QUANT:
            t = block._buffers.get(name)
            if t is not None:
                out[(uid, name)] = float(t)
    return out


def clear_act_quant(model) -> None:
    """Remove every int8 annotation of a CerberusModel's blocks."""
    for uid in model.block_nodes:
        model.block(uid).clear_act_quant()


@torch.no_grad()
def propagate_act_quant(model, host_sx: Optional[Dict[Path, float]] = None) -> None:
    """Annotate a quantized CerberusModel so that each activation is
    quantized once, at its producer (cerberusdet_tpu/quant/ptq.py:114-209,
    case for case). A per-tensor scale belongs to the tensor: every int8 Conv
    that reads it calibrated the same s_x. Going through the plan in reverse
    topological order, each block's output takes the set of scales its
    consumers need: a Conv or DWConv its s_x (None when it is float); C2f,
    C2, SPP and SPPF their cv1's; C3 its cv1's where cv2's is the same; a
    Detect head, at input i, box{i}/0's where cls{i}/0's is the same float;
    a Concat or Upsample what its own consumers resolved to. Where the set
    is one scale, a Concat or Upsample gets `q_in` and a Conv, DWConv, C2f,
    C2, C3, SPP or SPPF `q_out` (float32 scalar buffers, nn/layers.py:Block).
    The quantized Convs then see the same codes as before, bit for bit.

    host_sx: {conv path: s_x} as host floats (read from the model's int8
    Convs when None)."""
    if host_sx is None:
        host_sx = {path: float(m.s_x) for path, m in conv_layers(model) if m.int8}
    else:  # the Convs already int8 before this call take part too
        host_sx = {**{path: float(m.s_x) for path, m in conv_layers(model)
                      if m.int8 and path not in host_sx}, **host_sx}

    steps = model.plan()
    consumers: Dict[str, list] = {}
    for s in steps:
        for u in s.in_uids:
            consumers.setdefault(u, []).append((s, s.in_uids.index(u)))

    def entry_scale(step, pos):
        if step.task is not None:
            sb = host_sx.get((step.uid, f"box{pos}", "0"))
            sc = host_sx.get((step.uid, f"cls{pos}", "0"))
            return sb if sb is not None and sb == sc else None
        layer = model.block(step.uid)
        if type(layer) in (L.Conv, L.DWConv):
            return host_sx.get((step.uid,))
        if isinstance(layer, (L.C2f, L.C2, L.SPP, L.SPPF)):
            return host_sx.get((step.uid, "cv1"))
        if isinstance(layer, L.C3):
            s1 = host_sx.get((step.uid, "cv1"))
            s2 = host_sx.get((step.uid, "cv2"))
            return s1 if s1 is not None and s1 == s2 else None
        if isinstance(layer, (L.Concat, L.Upsample)):
            return resolved.get(step.uid)  # already resolved (reverse order)
        return None

    resolved: Dict[str, Optional[float]] = {}
    for s in reversed(steps):
        if s.task is not None:
            continue
        needs = {entry_scale(c, pos) for c, pos in consumers.get(s.uid, [])}
        resolved[s.uid] = needs.pop() if len(needs) == 1 else None

    dev = next(model.parameters()).device  # the Detect towers' PlainConvs stay float
    for s in steps:
        scale = resolved.get(s.uid) if s.task is None else None
        if scale is None:
            continue
        layer = model.block(s.uid)
        if isinstance(layer, (L.Concat, L.Upsample)):
            name = "q_in"
        elif isinstance(layer, (L.Conv, L.DWConv, L.C2f, L.C2, L.C3, L.SPP, L.SPPF)):
            name = "q_out"
        else:
            continue
        layer.annotate(name, torch.tensor(scale, dtype=torch.float32, device=dev))
