"""int8 convolution: the plain PyTorch version and its CUDA kernel for Hopper.

The kernel (csrc/conv_int8.cu, `conv_s8`) replaces
cerberusdet_tpu/ops/conv_int8_pallas.py:_conv_kernel and serves every
quantized Conv of the int8 serving path: k in {1, 3}, stride in {1, 2},
padding k // 2, groups 1, dilation 1. It sums s8 x s8 products in int32 and
runs the epilogue in float32: y = acc * scale + bias, SiLU when `act`, then
float32, bfloat16 or a requantize to int8; or the raw int32 sums. PyTorch has
no int8 convolution on CUDA, and a float32 one is not exact at these depths
(a 3x3 conv over 640 channels sums 5,760 products of up to 127^2).

On this card it is bound by operations (2 * MACs against the int8
tensor-core peak), not bytes; this first version uses __dp4a on the CUDA
cores, a 64 x 64 output tile per block with its input patch in shared
memory (see the source's note). Weights are read in a layout prepared once
(`pack_weight`): (k, k, ceil(Ci/4), Co, 4) int8, four input channels to a
32-bit word. Activations are the port's NCHW tensors.

`conv_s8` launches the kernel for tensors on the card (or raises) and runs
`conv_s8_plain` for tensors on the CPU; its attribute `launches` counts the
kernel launches. The kernel is built with nvcc at first use
(ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "conv_int8.cu"

# output type -> the kernel's mode (int32 is the raw sums, no epilogue)
_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}


def pack_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """(k, k, Ci, Co) int8 HWIO -> the kernel's (k, k, ceil(Ci/4), Co, 4),
    zero beyond Ci."""
    kh, kw, ci, co = w_hwio.shape
    c4 = (ci + 3) // 4
    padded = torch.zeros((kh, kw, 4 * c4, co), dtype=torch.int8, device=w_hwio.device)
    padded[:, :, :ci] = w_hwio
    return padded.reshape(kh, kw, c4, 4, co).permute(0, 1, 2, 4, 3).contiguous()


def unpack_weight(w_packed: torch.Tensor, ci: int) -> torch.Tensor:
    """The inverse of pack_weight: (k, k, C4, Co, 4) -> (k, k, ci, Co) HWIO."""
    kh, kw, c4, co, _ = w_packed.shape
    return w_packed.permute(0, 1, 2, 4, 3).reshape(kh, kw, 4 * c4, co)[:, :, :ci]


def requant_inverse(q_scale) -> float:
    """1 / q_scale in float32, the factor both versions multiply by."""
    return float(np.float32(1.0) / np.float32(float(q_scale)))


def _check_shape_class(k: int, stride: int, pad: int) -> None:
    if k not in (1, 3) or stride not in (1, 2) or pad != k // 2:
        raise ValueError(f"conv_s8 takes k in (1, 3), stride in (1, 2) and padding k // 2; "
                         f"got k={k} stride={stride} padding={pad}")


def conv_s8_plain(xq: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
                  bias: torch.Tensor, stride: int, pad: int, act: bool,
                  out_dtype: torch.dtype, q_scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops; the plain version.

    xq (B, Ci, H, W) int8; w_packed from pack_weight; scale, bias (Co,)
    float32. The int32 sums come from F.conv2d in float64 of the int8 values,
    which is exact: every partial sum is an integer far below 2^53 (the
    rounding removes the last-bit error a transform-based algorithm may
    leave). The epilogue runs in the kernel's order: acc.float() * scale,
    + bias, F.silu when act, then the cast to out_dtype; int8 output is
    clip(round(y * (1 / q_scale)), -127, 127). int32 returns the sums."""
    _check_shape_class(w_packed.shape[0], stride, pad)
    w = unpack_weight(w_packed, xq.shape[1]).permute(3, 2, 0, 1).to(torch.float64)
    acc = torch.round(F.conv2d(xq.to(torch.float64), w, None, stride, pad)).to(torch.int32)
    if out_dtype == torch.int32:
        return acc
    y = acc.float() * scale[:, None, None]
    y = y + bias[:, None, None]
    if act:
        y = F.silu(y)
    if out_dtype == torch.int8:
        inv = torch.tensor(requant_inverse(q_scale), dtype=torch.float32, device=y.device)
        return torch.clamp(torch.round(y * inv), -127.0, 127.0).to(torch.int8)
    return y.to(out_dtype)


def build(verbose: bool = False):
    """Compile csrc/conv_int8.cu (once) and return the library's path."""
    return cuda_build.build(SOURCE, verbose)


_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p,
                                                          ctypes.c_void_p]


def conv_s8(xq: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor, stride: int, pad: int, act: bool = False,
            out_dtype: torch.dtype = torch.float32,
            q_scale: Optional[float] = None) -> torch.Tensor:
    """The int8 conv through the CUDA kernel for tensors on the card; the
    plain `conv_s8_plain` for tensors on the CPU. Same contract as
    `conv_s8_plain`; out_dtype is int32, float32, bfloat16 or int8, and
    q_scale is required for int8. On the card every input must be contiguous: xq int8,
    w_packed int8 of pack_weight's shape for xq's Ci, scale and bias float32
    (Co,)."""
    tensors = (xq, w_packed, scale, bias)
    if all(t.device.type == "cpu" for t in tensors):
        return conv_s8_plain(xq, w_packed, scale, bias, stride, pad, act, out_dtype, q_scale)
    dev = xq.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"conv_s8 needs all tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if out_dtype not in _MODES:
        raise TypeError(f"conv_s8 writes {tuple(_MODES)}, not {out_dtype}")
    if out_dtype == torch.int8 and q_scale is None:
        raise ValueError("conv_s8: int8 output needs q_scale")
    if xq.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise TypeError(f"conv_s8 takes int8 x and weights, got {xq.dtype}/{w_packed.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"conv_s8 takes float32 scale and bias, got {scale.dtype}/{bias.dtype}")
    if xq.dim() != 4 or w_packed.dim() != 5:
        raise ValueError(f"conv_s8 shapes: x {tuple(xq.shape)} must be (B, Ci, H, W) and "
                         f"w {tuple(w_packed.shape)} (k, k, C4, Co, 4)")
    b, ci, h, w = xq.shape
    k, kw, c4, co, four = w_packed.shape
    if k != kw or four != 4 or c4 != (ci + 3) // 4:
        raise ValueError(f"conv_s8: weights {tuple(w_packed.shape)} do not fit Ci={ci}")
    if scale.shape != (co,) or bias.shape != (co,):
        raise ValueError(f"conv_s8: scale {tuple(scale.shape)} and bias {tuple(bias.shape)} "
                         f"must be ({co},)")
    _check_shape_class(k, stride, pad)
    if not all(t.is_contiguous() for t in tensors) or w_packed.data_ptr() % 4:
        raise ValueError("conv_s8 needs contiguous inputs and 4-byte aligned weights")
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    if b * ho * wo >= 2 ** 31:
        raise ValueError(f"conv_s8: B * Ho * Wo = {b * ho * wo} does not fit an int")
    fn = cuda_build.load(SOURCE, "cerberus_conv_s8", _ARGTYPES)
    out = torch.empty((b, co, ho, wo), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    inv = requant_inverse(q_scale) if out_dtype == torch.int8 else 1.0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xq.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                 b, ci, h, w, co, k, stride, pad, int(bool(act)), _MODES[out_dtype], inv,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv_s8 kernel launch failed: CUDA error {err}")
    conv_s8.launches += 1
    return out


conv_s8.launches = 0
