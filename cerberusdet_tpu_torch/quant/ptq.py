"""Post-training int8 quantization for serving.

Counterpart of cerberusdet_tpu/quant/ptq.py:33-111, with the same scheme:
  * weights: per-output-channel symmetric int8 from the FUSED float32
    weights, s_w = max |w| / 127 over (kh, kw, Ci) (1.0 where that is 0);
  * activations: per-tensor symmetric int8, s_x = amax / 127, amax the max
    |input| of each Conv over the calibration batches;
  * the conv sums int32 and dequantizes into the bias add
    (nn/module.py:conv2d_int8).
Convs are named by the JAX package's path tuples, (uid,) for a Conv block
and (uid, "m", "0", "cv1") etc. inside one, so amax dicts and quantized
trees of the two packages compare key for key. PlainConv (the Detect
towers' last 1x1) is never quantized. The JAX package's propagate_act_quant
is not part of the port: it only moves where the same quantize runs.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from cerberusdet_tpu_torch.nn.layers import Conv
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
    return {conv path: max |input|} over the batches as host floats."""
    convs = list(conv_layers(model))
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
                    weights: Optional[Dict[Path, Tuple[torch.Tensor, torch.Tensor]]] = None):
    """Turn the selected fused Convs of `model` into their int8 form, in
    place; returns the model. Only Convs whose path is in `amax` with a
    positive value are candidates. `weights` is fused_conv_weights(model)
    taken before a cast (the model's own weights, as float32, when None).
    The arithmetic is the JAX package's, in numpy float32, so w_q, s_w and
    s_x come out bit for bit the same."""
    if select is None:
        select = select_deep()
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
        m.s_x.fill_(float(np.float32(a / 127.0)))
        m.b.copy_(b)
    return model
