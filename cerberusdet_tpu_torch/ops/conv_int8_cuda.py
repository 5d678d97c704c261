"""int8 convolution: two CUDA kernels for Hopper and their plain PyTorch versions.

A quantized Conv on the card is two launches (csrc/conv_int8.cu):

- `quant_pack_s8` quantizes the NCHW float32 / bfloat16 activations per
  tensor (clip(rint(x * (1 / s_x)), -127, 127), as nn/module.py's and the
  JAX package's quantize_act) and writes them NHWC int8 with the
  channels zero-padded to Ci16 = ceil(Ci / 16) * 16. int8 activations are
  already quantized (quantize_act passes them through): they are packed
  unscaled. It is bound by bytes: 16-byte loads along each plane, a
  transpose in registers, one 16-byte store of 16 channels a pixel
  (`pack_vectorized` tells the kernel whether every plane takes 16-byte
  loads).
- `conv_s8` replaces cerberusdet_tpu/ops/conv_int8_pallas.py:_conv_kernel and
  serves every quantized Conv of the int8 serving path: k in {1, 3}, stride in
  {1, 2}, padding k // 2, groups 1, dilation 1. It is an implicit GEMM (M =
  B * Ho * Wo pixels, N = Co, K = k * k * Ci16) on the int8 tensor cores
  (wgmma m64nNk32 s8 from shared memory, a 4-stage cp.async ring), bound by
  operations. It sums s8 x s8 in int32 and runs the epilogue in float32:
  y = acc * (s_x * s_w) + bias, SiLU when `act`, then float32, bfloat16 or a
  requantize to int8 (of y itself, the Pallas kernel's q_out, or of y
  rounded to bfloat16, the value a bf16 serving graph hands to the next
  block's quantize); or the raw int32 sums. The output is NCHW. PyTorch has
  no int8 convolution on CUDA, and a float32 one is not exact at these depths
  (a 3x3 conv over 640 channels sums 5,760 products of up to 127^2).

`quant_s8` quantizes an NCHW tensor into int8 NCHW, with the same codes as
quant_pack_s8 (int8 input copied), into a new tensor or a channel slice of
the int8 concat buffer its consumer reads (`quant_cat_s8`): the activations
that int8 carries between the blocks and no conv epilogue quantizes (the
concats' float inputs, the shortcut sums), one launch each, where the JAX
package's quantize fuses into XLA's producers. It is bound by bytes: 16-byte
loads along each plane, one store of the run's codes.

The quantized convs that conv_s8 does not take (groups > 1, a kernel other
than 1 or 3, dilation, other strides or paddings: DWConv, GhostConv's 5x5
depthwise half) sum in `conv_sums_s8`, F.conv2d in float64 of the int8
values on either device, which is exact, and fit int32 while k_h * k_w *
(Ci / groups) * 127^2 < 2^31 (`int8_sums_fit`); then they take the same
epilogue (`conv_epilogue`). The JAX package computes them with XLA's
integer convolution, not with Pallas.

Weights are packed once at quantize time (`pack_weight`): (Co, k, k, Ci16)
int8, the reduction index (dy, dx, ci) contiguous for each output channel.

Each wrapper checks its inputs, then launches its kernel for tensors on the
card (or raises) and runs its plain version for tensors on the CPU; its
attribute `launches` counts the kernel launches. The kernels are built with
nvcc at first use (ops/cuda_build.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "conv_int8.cu"

# output type -> the kernel's mode (int32 is the raw sums, no epilogue); an
# int8 output is mode 3 when y is requantized as it is, 4 when y is first
# rounded to bfloat16 (_REQUANT_MODES, by q_dtype)
_MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}
_REQUANT_MODES = {torch.float32: 3, torch.bfloat16: 4}
# activation type -> quant_pack_s8's dtype code (int8: already quantized)
_ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the conv kernel's block tiles (BM, BN), in the order conv_tile prefers them
TILES = ((128, 160), (128, 80), (64, 160), (64, 80))


def padded_channels(ci: int) -> int:
    """Ci16: ci rounded up to a multiple of 16, the channel count of the
    packed activations and weights."""
    return -(-ci // 16) * 16


def pack_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """(k, k, Ci, Co) int8 HWIO -> the kernel's (Co, k, k, Ci16), zero beyond Ci."""
    kh, kw, ci, co = w_hwio.shape
    out = torch.zeros((co, kh, kw, padded_channels(ci)), dtype=torch.int8, device=w_hwio.device)
    out[..., :ci] = w_hwio.permute(3, 0, 1, 2)
    return out


def unpack_weight(w_packed: torch.Tensor, ci: int) -> torch.Tensor:
    """The inverse of pack_weight: (Co, k, k, Ci16) -> (k, k, ci, Co) HWIO."""
    return w_packed[..., :ci].permute(1, 2, 3, 0)


def int8_sums_fit(kh: int, kw: int, ci_per_group: int) -> bool:
    """Whether the int32 sums of an int8 conv are exact at any input: the
    largest, k_h * k_w * (Ci / groups) products of 127^2, below 2^31."""
    return kh * kw * ci_per_group * 127 * 127 < 2 ** 31


def s8_kernel_takes(k, stride, pad, groups: int = 1, dilation: int = 1) -> bool:
    """Whether conv_s8 takes a conv of this shape: a square 1x1 or 3x3
    kernel, one stride of 1 or 2, padding k // 2 on both axes, groups 1 and
    dilation 1. k, stride and pad are ints or (h, w) pairs."""
    def pair(v):
        return (v, v) if isinstance(v, int) else tuple(v)

    (kh, kw), (sh, sw), (ph, pw) = pair(k), pair(stride), pair(pad)
    return (kh == kw and kh in (1, 3) and sh == sw and sh in (1, 2) and ph == pw == kh // 2
            and groups == 1 and pair(dilation) == (1, 1))


def conv_tile(m: int, co: int, sms: int):
    """(BM, BN), the conv kernel's block tile for M output pixels and Co
    channels on a card of `sms` SMs: the first of TILES whose grid gives
    every SM a block, else 64x80 (the most blocks); BN 160 only where Co is
    a multiple of 160. Measured at every conv shape of the flagship's
    batch-1 and batch-8 forwards on an H100 (tools/bench_conv_int8.py), this
    picks the fastest tile or one within a few percent of it."""
    for bm, bn in TILES:
        if (bn == 80 or co % 160 == 0) and -(-m // bm) * -(-co // bn) >= sms:
            return bm, bn
    return TILES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_scalar(s_x: torch.Tensor, what: str) -> None:
    if s_x.dtype != torch.float32 or s_x.numel() != 1:
        raise TypeError(f"{what}: s_x must be one float32 value, got {s_x.dtype} "
                        f"{tuple(s_x.shape)}")


def _check_act_dtype(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _ACT_DTYPES:
        raise TypeError(f"{what} takes {tuple(_ACT_DTYPES)} activations, not {x.dtype}")


def _one_device(what: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when all lie on one CUDA
    device; raises otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} needs all tensors on the CPU or on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return False


# ------------------------------------------------------------ quant_pack_s8


def quant_pack_s8_plain(x: torch.Tensor, s_x: torch.Tensor, ci16: int) -> torch.Tensor:
    """The quant_pack_s8 kernel's function in PyTorch ops; the plain version.

    x (B, C, H, W) float32, bfloat16 or int8; returns (B, H, W, ci16) int8,
    zero beyond C: clip(round(x * (1 / s_x)), -127, 127) with the reciprocal
    in float32 and round half to even (nn/module.py:quantize_act's codes),
    channels last. int8 x is already quantized and is packed as it is."""
    _check_act_dtype(x, "quant_pack_s8_plain")
    q = x if x.dtype == torch.int8 else quant_s8_plain(x, s_x)
    return F.pad(q.permute(0, 2, 3, 1), (0, ci16 - x.shape[1])).contiguous()


def pack_vectorized(base_bytes: int, sb: int, sc: int, itemsize: int) -> bool:
    """Whether every plane of an NCHW input starts at a multiple of 16
    bytes (the data at byte address base_bytes, images sb and channels sc
    elements apart), so that quant_pack_s8 reads whole runs with 16-byte
    loads; otherwise, and at the ragged end of each plane, it reads element
    by element."""
    return base_bytes % 16 == 0 and (sb * itemsize) % 16 == 0 and (sc * itemsize) % 16 == 0


_QP_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 2
                + [ctypes.c_void_p, ctypes.c_void_p])


def quant_pack_s8(x: torch.Tensor, s_x: torch.Tensor, ci16: int) -> torch.Tensor:
    """x (B, C, H, W) float32, bfloat16 or int8 (already quantized, packed
    unscaled) -> (B, H, W, ci16) int8 through
    the CUDA kernel for tensors on the card; `quant_pack_s8_plain` for
    tensors on the CPU. The pixels of each (H, W) plane of x must lie at one
    stride in row-major order, as in a contiguous NCHW tensor, a channel
    slice of one, or a channels-last view; s_x is one float32 value on x's
    device; ci16 a multiple of 16, at least C."""
    on_cpu = _one_device("quant_pack_s8", x, s_x)
    _check_act_dtype(x, "quant_pack_s8")
    _check_scalar(s_x, "quant_pack_s8")
    if x.dim() != 4:
        raise ValueError(f"quant_pack_s8: x {tuple(x.shape)} must be (B, C, H, W)")
    b, c, h, w = x.shape
    if ci16 % 16 or ci16 < c:
        raise ValueError(f"quant_pack_s8: ci16={ci16} must be a multiple of 16 and >= C={c}")
    sp = x.stride(3) if w > 1 else x.stride(2)  # between neighbouring pixels of a plane
    if h > 1 and w > 1 and x.stride(2) != w * x.stride(3):
        raise ValueError(f"quant_pack_s8: the pixels of an (H, W) plane of x must lie at one "
                         f"stride, got strides {x.stride()}")
    if on_cpu:
        return quant_pack_s8_plain(x, s_x, ci16)
    out = torch.empty((b, h, w, ci16), dtype=torch.int8, device=x.device)
    if out.numel() == 0:
        return out
    fn = cuda_build.load(SOURCE, "cerberus_quant_pack_s8", _QP_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        vec = pack_vectorized(x.data_ptr(), x.stride(0), x.stride(1), x.element_size())
        err = fn(x.data_ptr(), _ACT_DTYPES[x.dtype], s_x.data_ptr(), b, c, h, w,
                 x.stride(0), x.stride(1), sp, ci16, int(vec), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quant_pack_s8 kernel launch failed: CUDA error {err}")
    quant_pack_s8.launches += 1
    return out


quant_pack_s8.launches = 0


# ----------------------------------------------------------------- quant_s8


def quant_s8_plain(x: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """The quant_s8 kernel's function in PyTorch ops; the plain version, and
    the arithmetic of every activation quantize of the port (nn/module.py:
    quantize_act): clip(round(x * (1 / s_x)), -127, 127) with the
    reciprocal in float32 and round half to even, as int8; int8 x as it is."""
    if x.dtype == torch.int8:
        return x
    inv_sx = 1.0 / s_x.reshape(())
    return torch.clamp(torch.round(x.float() * inv_sx), -127.0, 127.0).to(torch.int8)


_QS_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 4
                + [ctypes.c_longlong] * 3 + [ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])


def _pixel_stride(t: torch.Tensor) -> Optional[int]:
    """The stride between neighbouring pixels of t's (H, W) planes where they
    lie in row-major order at one stride, else None."""
    h, w = t.shape[2], t.shape[3]
    sp = t.stride(3) if w > 1 else t.stride(2) if h > 1 else 1
    return sp if h == 1 or w == 1 or t.stride(2) == w * t.stride(3) else None


def quant_s8(x: torch.Tensor, s_x: torch.Tensor, out: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """x (B, C, H, W) float32, bfloat16 or int8 (copied as it is) -> int8
    (B, C, H, W) through the CUDA kernel for tensors on the card;
    `quant_s8_plain` for tensors on the CPU. out: where to write, an int8
    tensor of x's shape (e.g. a channel slice of a concat buffer); a new
    contiguous one when None; it is returned. The pixels of each (H, W) plane
    of x lie at one stride in row-major order (a contiguous NCHW tensor, a
    channel slice of one, a channels-last view), those of out at stride 1;
    s_x is one float32 value on x's device; B and C at most 65535."""
    tensors = (x, s_x) + (() if out is None else (out,))
    on_cpu = _one_device("quant_s8", *tensors)
    _check_act_dtype(x, "quant_s8")
    _check_scalar(s_x, "quant_s8")
    sp = _pixel_stride(x) if x.dim() == 4 else None
    if sp is None:
        raise ValueError(f"quant_s8: x {tuple(x.shape)} strides {x.stride()} must be (B, C, H, "
                         f"W) with the pixels of a plane at one stride")
    if out is not None and (out.dtype != torch.int8 or out.shape != x.shape
                            or _pixel_stride(out) != 1):
        raise ValueError(f"quant_s8: out must be int8 of x's shape {tuple(x.shape)} with its "
                         f"planes at stride 1, got {out.dtype} {tuple(out.shape)} "
                         f"{out.stride()}")
    b, c, h, w = x.shape
    if b > 65535 or c > 65535:
        raise ValueError(f"quant_s8: B {b} and C {c} must be at most 65535")
    if on_cpu:
        q = quant_s8_plain(x, s_x)
        return q if out is None else out.copy_(q)
    if out is None:
        out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    fn = cuda_build.load(SOURCE, "cerberus_quant_s8", _QS_ARGTYPES)
    v = 16 // x.element_size()
    vec = sp == 1 and pack_vectorized(x.data_ptr(), x.stride(0), x.stride(1),
                                      x.element_size())
    vec_out = out.data_ptr() % v == 0 and out.stride(0) % v == 0 and out.stride(1) % v == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), _ACT_DTYPES[x.dtype], s_x.data_ptr(), b, c, h, w, x.stride(0),
                 x.stride(1), sp, int(vec), out.data_ptr(), out.stride(0), out.stride(1),
                 int(vec_out), stream)
    if err != 0:
        raise RuntimeError(f"quant_s8 kernel launch failed: CUDA error {err}")
    quant_s8.launches += 1
    return out


quant_s8.launches = 0


def quant_cat_s8(xs, s_x: torch.Tensor) -> torch.Tensor:
    """torch.cat of the NCHW tensors xs on channels, each quantized with s_x
    (int8 ones as they are): one quant_s8 a tensor, each writing its channel
    slice of the int8 result."""
    b, _, h, w = xs[0].shape
    out = torch.empty((b, sum(t.shape[1] for t in xs), h, w), dtype=torch.int8,
                      device=xs[0].device)
    c0 = 0
    for t in xs:
        quant_s8(t, s_x, out[:, c0: c0 + t.shape[1]])
        c0 += t.shape[1]
    return out


# ------------------------------------------------------------------ conv_s8


def _check_shape_class(k: int, stride: int, pad: int) -> None:
    if k not in (1, 3) or stride not in (1, 2) or pad != k // 2:
        raise ValueError(f"conv_s8 takes k in (1, 3), stride in (1, 2) and padding k // 2; "
                         f"got k={k} stride={stride} padding={pad}")


def conv_epilogue(acc: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
                  bias: torch.Tensor, act: bool, out_dtype: torch.dtype, q_scale=None,
                  q_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 conv's epilogue on the int32 sums acc (B, Co, Ho, Wo), in the
    kernel's order: acc.float() * (s_x * s_w), + bias, F.silu when act, then
    the cast to out_dtype. An int8 output is clip(round(v * (1 / q_scale)),
    -127, 127) with v = y (q_dtype float32) or y rounded to bfloat16
    (q_dtype bfloat16), the reciprocal in float32; q_scale is a float32
    scalar tensor on acc's device. int32 returns the sums."""
    if out_dtype == torch.int32:
        return acc
    scale = s_x.reshape(()) * s_w
    y = acc.float() * scale[:, None, None]
    y = y + bias[:, None, None]
    if act:
        y = F.silu(y)
    if out_dtype == torch.int8:
        inv = 1.0 / q_scale.reshape(())
        v = y.to(torch.bfloat16).float() if q_dtype == torch.bfloat16 else y
        return torch.clamp(torch.round(v * inv), -127.0, 127.0).to(torch.int8)
    return y.to(out_dtype)


def conv_s8_plain(xq: torch.Tensor, w_packed: torch.Tensor, s_x: torch.Tensor,
                  s_w: torch.Tensor, bias: torch.Tensor, stride: int, pad: int, act: bool,
                  out_dtype: torch.dtype, q_scale=None,
                  q_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The conv_s8 kernel's function in PyTorch ops; the plain version.

    xq (B, H, W, Ci16) int8 (quant_pack_s8's layout); w_packed (Co, k, k,
    Ci16) from pack_weight; s_x one float32 value; s_w, bias (Co,) float32.
    Returns (B, Co, Ho, Wo): the int32 sums of `conv_sums_s8`, then
    `conv_epilogue`."""
    _check_shape_class(w_packed.shape[1], stride, pad)
    acc = conv_sums_s8(xq.permute(0, 3, 1, 2), w_packed, stride, pad)
    return conv_epilogue(acc, s_x, s_w, bias, act, out_dtype, q_scale, q_dtype)


def conv_sums_s8(xq: torch.Tensor, w_packed: torch.Tensor, stride=1, pad=0, dilation=1,
                 groups: int = 1) -> torch.Tensor:
    """The int32 sums of an int8 conv of any shape, in PyTorch ops on either
    device: xq (B, Ci or Ci16, H, W) int8 NCHW (a view will do), w_packed
    (Co, kh, kw, Cg16) as pack_weight lays out (kh, kw, Ci / groups, Co)
    HWIO. F.conv2d in float64 of the int8 values is exact: every partial
    sum is an integer far below 2^53, and the rounding removes the last-bit
    error a transform-based algorithm may leave. The int32 cast is exact
    where int8_sums_fit; stride, pad and dilation are ints or (h, w) pairs."""
    cg = xq.shape[1] // groups
    xd = xq.to(torch.float64)
    wd = w_packed[..., :cg].permute(0, 3, 1, 2).to(torch.float64)
    return torch.round(F.conv2d(xd, wd, None, stride, pad, dilation, groups)).to(torch.int32)


def build(verbose: bool = False):
    """Compile csrc/conv_int8.cu (once) and return the library's path."""
    return cuda_build.build(SOURCE, verbose)


_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 10
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def conv_s8(xq: torch.Tensor, w_packed: torch.Tensor, s_x: torch.Tensor, s_w: torch.Tensor,
            bias: torch.Tensor, stride: int, pad: int, act: bool = False,
            out_dtype: torch.dtype = torch.float32, q_scale=None,
            tile: Optional[Tuple[int, int]] = None,
            q_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 conv through the CUDA kernel for tensors on the card; the
    plain `conv_s8_plain` for tensors on the CPU. Same contract as
    `conv_s8_plain`; out_dtype is int32, float32, bfloat16 or int8. int8
    needs q_scale, a float32 scalar tensor on the inputs' device (read by
    the kernel there, so a capture holds no host value), and
    requantizes y as it is (q_dtype float32, mode 3) or rounded to bfloat16
    first (q_dtype bfloat16, mode 4). xq and w_packed are contiguous int8 in
    the layouts of quant_pack_s8 and pack_weight with the same Ci16, s_x one
    float32 value, s_w and bias float32 (Co,). tile, one of TILES, sets the
    kernel's block tile (for timing each one); None lets conv_tile choose."""
    tensors = (xq, w_packed, s_x, s_w, bias)
    requant = out_dtype == torch.int8
    if requant and q_scale is None:
        raise ValueError("conv_s8: int8 output needs q_scale")
    if requant and not torch.is_tensor(q_scale):
        raise TypeError(f"conv_s8: q_scale must be a float32 scalar tensor, got "
                        f"{type(q_scale).__name__}")
    on_cpu = _one_device("conv_s8", *tensors, *((q_scale,) if requant else ()))
    if out_dtype not in _MODES:
        raise TypeError(f"conv_s8 writes {tuple(_MODES)}, not {out_dtype}")
    if q_dtype not in _REQUANT_MODES:
        raise TypeError(f"conv_s8 requantizes y in {tuple(_REQUANT_MODES)}, not {q_dtype}")
    if requant:
        _check_scalar(q_scale, "conv_s8 q_scale")
    if xq.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise TypeError(f"conv_s8 takes int8 x and weights, got {xq.dtype}/{w_packed.dtype}")
    _check_scalar(s_x, "conv_s8")
    if s_w.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"conv_s8 takes float32 s_w and bias, got {s_w.dtype}/{bias.dtype}")
    if xq.dim() != 4 or w_packed.dim() != 4:
        raise ValueError(f"conv_s8 shapes: x {tuple(xq.shape)} must be (B, H, W, Ci16) and "
                         f"w {tuple(w_packed.shape)} (Co, k, k, Ci16)")
    b, h, w, ci16 = xq.shape
    co, k, kw, wci = w_packed.shape
    if k != kw or wci != ci16 or ci16 % 16:
        raise ValueError(f"conv_s8: weights {tuple(w_packed.shape)} do not fit x "
                         f"{tuple(xq.shape)} (Ci16 a multiple of 16 in both)")
    if s_w.shape != (co,) or bias.shape != (co,):
        raise ValueError(f"conv_s8: s_w {tuple(s_w.shape)} and bias {tuple(bias.shape)} "
                         f"must be ({co},)")
    _check_shape_class(k, stride, pad)
    if tile is not None and tuple(tile) not in TILES:
        raise ValueError(f"conv_s8: tile {tile} is not one of {TILES}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv_s8 needs contiguous inputs")
    if on_cpu:
        return conv_s8_plain(xq, w_packed, s_x, s_w, bias, stride, pad, act, out_dtype, q_scale,
                             q_dtype)
    if xq.data_ptr() % 16 or w_packed.data_ptr() % 16:
        raise ValueError("conv_s8 needs 16-byte aligned x and weights")
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    if max(b * ho * wo, b * h * w * ci16, w_packed.numel()) >= 2 ** 31:
        raise ValueError(f"conv_s8: B * Ho * Wo = {b * ho * wo}, x or the weights do not "
                         f"fit an int")
    out = torch.empty((b, co, ho, wo), dtype=out_dtype, device=xq.device)
    if out.numel() == 0:
        return out
    bm, bn = tile or conv_tile(b * ho * wo, co, _sm_count(xq.device.index))
    fn = cuda_build.load(SOURCE, "cerberus_conv_s8", _ARGTYPES)
    mode = _REQUANT_MODES[q_dtype] if requant else _MODES[out_dtype]
    q_ptr = q_scale.data_ptr() if requant else None
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xq.data_ptr(), w_packed.data_ptr(), s_x.data_ptr(), s_w.data_ptr(),
                 bias.data_ptr(), b, h, w, ci16, co, k, stride, pad, int(bool(act)),
                 mode, q_ptr, bm, bn, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"conv_s8 kernel launch failed: CUDA error {err}")
    conv_s8.launches += 1
    return out


conv_s8.launches = 0
