"""Training BatchNorm with its Conv's SiLU: the CUDA kernels for Hopper and the plain version.

`bn_silu` is BatchNorm in training mode (batch statistics over N, H, W,
the running statistics updated in place), followed by SiLU when `act`, as
one torch.autograd.Function of four passes:

    forward   bn_stats        per (chunk, channel) mean and centred M2, merged in a
                              fixed order: stat = (mean, rstd, inv, shift), running
              bn_apply        y = silu(x * inv + shift)
    backward  bn_grad_reduce  per (chunk, channel) sum g and sum g * xhat, summed in a
                              fixed order: dweight, dbias, coef
              bn_dx           dx = inv * (g - sum g / n - xhat * sum(g xhat) / n)

with inv = rsqrt(var + eps) * weight, shift = bias - mean * inv,
xhat = (x - mean) * rstd, g = dy * silu'(z), all statistics in float32. The
forward's y rounds as nn/module.py:BatchNorm followed by SiLU rounds it
(inv and shift cast to the activation dtype, the product rounded, then the
sum; SiLU in float32, rounded once), so given the same statistics it is
that y bit for bit. Only x and the (4, C) float32 `stat` are kept for the
backward. y and dx keep x's layout: NCHW planes, or channels last (which the
train step's convolutions keep from its NHWC images), dense.

The kernels (csrc/bn_silu.cu) replace no Pallas kernel: the JAX package
leaves BatchNorm and SiLU to XLA, which fuses them on the TPU; in PyTorch
the same function ran as ~8 kernels forward and ~10 backward through
float32 copies of the activation. They are bound by bytes (6 B a bfloat16
value forward, 10 B backward); csrc/bn_silu.cu gives the design. Each
wrapper launches its kernels for tensors on the card (or raises on what the
kernels do not take) and runs its plain version for tensors on the CPU;
its attribute `launches` counts the kernel launches (two each for bn_stats
and bn_grad_reduce: the chunks, then the merge). Sums take no atomics and
merge in a fixed order, so the passes repeat bit for bit.

`plan` reads a tensor's layout and cuts each channel's N * H * W values
into chunks, from the shape, so that every layer of a model fills the
card's SMs. The plain passes take the same chunks and merge them in the same
order, in float32.

The route counters FUSED and PLAIN count the training BatchNorm forwards on
the card (nn/module.py:BatchNorm) that took `bn_silu` and the PyTorch path
(an image mask, a process group of several ranks, or float64, which `takes`
names as the one dtype that keeps the PyTorch path).
COUNTED lists the wrappers and the counters for a captured program
(infer/graphs.py:CapturedProgram), so that a replay counts what ran.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from cerberusdet_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "bn_silu.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR = {torch.float32: 4, torch.bfloat16: 8}  # values in a 16-byte load
THREADS = 256        # a block's threads; a rows tile's vectors
ALIGN = 8            # a chunk's length is a multiple of every vector
MIN_CHUNK = 8192     # values: a block's least work (4 vectors a thread)
SLOTS_PER_SM = 16    # two waves of 8 resident 256-thread blocks
DEFAULT_SMS = 132    # an H100 SXM's SMs: the plans of tensors off the card
MAX_INDEX = 2 ** 31  # the kernels count a channel's values in 32 bits
MAX_CHANNELS = 65535  # the grid's y


class Route:
    """A route counter: `launches` counts the forwards that took the route
    (named as the kernel wrappers' counts, which CapturedProgram replays)."""

    def __init__(self):
        self.launches = 0


FUSED, PLAIN = Route(), Route()


def on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def takes(x: torch.Tensor, *params: torch.Tensor) -> bool:
    """Whether the kernels take x: True for a float32 or bfloat16 (N, C, H,
    W) tensor with float32 per-channel `params` (weight, bias, running
    statistics); False for float64 x, the one case that keeps the PyTorch
    path (the float64 reference runs); a TypeError for anything else."""
    if x.dtype in DTYPES and x.dim() == 4 and all(p.dtype == torch.float32 for p in params):
        return True
    if x.dtype == torch.float64:
        return False
    raise TypeError(f"training BatchNorm on the card takes float32 or bfloat16 (N, C, H, W) "
                    f"with float32 parameters, or float64; got {x.dtype} "
                    f"{tuple(x.shape)} with {sorted({str(p.dtype) for p in params})}")


def build(verbose: bool = False):
    """Compile csrc/bn_silu.cu (once) and return the library's path."""
    return cuda_build.build(SOURCE, verbose)


def sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return DEFAULT_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------- layout
def strides(t: torch.Tensor):
    """(rows, (sn, sc, sp)): t's layout family and its element strides of an
    image, a channel and a position of the H * W plane. rows 0: planes
    contiguous (sp 1); rows 1: channels contiguous (sc 1), positions sp
    apart. None if t is in neither family."""
    n, c, h, w = t.shape
    sn, sc, sh, sw = t.stride()
    if (w == 1 or sw == 1) and (h == 1 or sh == w):
        return 0, (sn, sc, 1)
    sp = sw if w > 1 else sh
    if (c == 1 or sc == 1) and (h == 1 or w == 1 or sh == w * sw):
        return 1, (sn, 1, sp if h * w > 1 else c)
    return None


def grad_layout(dy: torch.Tensor, rows: int) -> torch.Tensor:
    """dy itself where the backward kernels read it against an x of family
    `rows` (the same family, or NCHW planes against rows: the gradient of a
    channels-last map whose consumers ran in NCHW), else a dense copy in x's
    family."""
    got = strides(dy)
    if got is not None and (got[0] == rows or rows):
        return dy
    return dy.contiguous(memory_format=torch.channels_last if rows else torch.contiguous_format)


def dense_like(x: torch.Tensor, rows: int) -> torch.Tensor:
    """An empty tensor shaped as x, dense in family `rows` (y, dx)."""
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last if rows else torch.contiguous_format)


def scratch(shape, x: torch.Tensor) -> torch.Tensor:
    """An empty float32 tensor on x's device (partials, stat, coef, dweight,
    dbias)."""
    return torch.empty(shape, dtype=torch.float32, device=x.device)


class Plan(NamedTuple):
    """How the kernels walk x (and dy): the layout family, 16-byte vectors
    or single values, the chunks of each channel's values, and whether dy
    lies in NCHW planes against a rows x."""
    rows: int
    vec: int
    length: int
    chunks: int
    dy_planes: int = 0


def chunking(units: int, nhw: int, width: int = 1, sms: int = DEFAULT_SMS) -> Tuple[int, int]:
    """(length, chunks): each channel's nhw values cut into `chunks` chunks
    of `length` (the last may be shorter), so that the units (channels, or
    rows tiles of `width` channels) times the chunks make about two waves of
    blocks on `sms` SMs, no block under MIN_CHUNK values unless a unit holds
    fewer. A planar chunk (width 1) is a multiple of ALIGN values long, so
    that it holds whole vectors; a rows chunk is whole rows."""
    want = -(-SLOTS_PER_SM * sms // units)
    p = max(1, min(want, nhw * width // MIN_CHUNK))
    align = ALIGN if width == 1 else 1
    length = -(-nhw // p)
    length = -(-length // align) * align
    return length, -(-nhw // length)


def plan(x: torch.Tensor, *more: torch.Tensor) -> Plan:
    """The plan for x (N, C, H, W) and tensors that grad_layout lets through
    (dy)."""
    rows, _ = strides(x)
    n, c, h, w = x.shape
    v = VECTOR.get(x.dtype, 1)
    dy_planes = int(rows == 1 and any(strides(t)[0] == 0 for t in more))
    vec = all(_whole_vectors(t, rows, v) for t in (x,) + more if strides(t)[0] == rows)
    nhw = n * h * w
    if rows:
        tile = min(c, THREADS * (v if vec else 1))
        length, chunks = chunking(-(-c // tile), nhw, tile, sm_count(x.device))
    else:
        length, chunks = chunking(c, nhw, 1, sm_count(x.device))
    return Plan(rows, int(vec), length, chunks, dy_planes)


def _whole_vectors(t: torch.Tensor, rows: int, v: int) -> bool:
    """Whether every value of t lies in a 16-byte aligned vector of v values
    along its planes (rows 0) or its rows (rows 1)."""
    n, c, h, w = t.shape
    got = strides(t)
    if got is None or got[0] != rows or t.data_ptr() % 16:
        return False
    sn, sc, sp = got[1]
    along, strided = (c, ((n, sn), (h * w, sp))) if rows else (h * w, ((n, sn), (c, sc)))
    return along % v == 0 and all(size == 1 or s % v == 0 for size, s in strided)


# ------------------------------------------------------------ plain passes
def _by_channel(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (C, N * H * W) float32, image-major in a channel."""
    return t.float().transpose(0, 1).reshape(t.shape[1], -1)


def _chunk_sums(t: torch.Tensor, length: int, chunks: int) -> torch.Tensor:
    """(C, nhw) -> (C, chunks): each chunk's sum."""
    return torch.stack([t[:, k * length:(k + 1) * length].sum(1) for k in range(chunks)], 1)


def _merge_moments(part: torch.Tensor, nhw: int, length: int):
    """Chan's merge of the chunks' (mean, M2) (C, P, 2), in chunk order:
    (mean, M2) of the channels."""
    n = 0.0
    mean = torch.zeros(part.shape[0], device=part.device)
    m2 = torch.zeros_like(mean)
    for k in range(part.shape[1]):
        nb = float(min(length, nhw - k * length))
        d = part[:, k, 0] - mean
        f = nb / (n + nb)
        mean = mean + d * f
        m2 = (m2 + part[:, k, 1]) + d * d * (n * f)
        n += nb
    return mean, m2


def bn_stats_plain(x, weight, bias, running_mean, running_var, eps: float, momentum: float,
                   length: int, chunks: int):
    """(stat, part): each chunk's (mean, centred M2) in float32, part
    (C, chunks, 2), merged in chunk order; stat (4, C) = (mean, rstd, inv,
    shift); the running statistics updated in place."""
    xc = _by_channel(x)
    out = []
    for k in range(chunks):
        seg = xc[:, k * length:(k + 1) * length]
        mean = seg.sum(1) / seg.shape[1]
        out.append(torch.stack([mean, (seg - mean[:, None]).square().sum(1)], 1))
    part = torch.stack(out, 1)
    nhw = xc.shape[1]
    mean, m2 = _merge_moments(part, nhw, length)
    var = m2 / nhw
    rstd = torch.rsqrt(var + eps)
    inv = rstd * weight
    running_mean.copy_((1 - momentum) * running_mean + momentum * mean)
    running_var.copy_((1 - momentum) * running_var + momentum * (var * (nhw / max(nhw - 1, 1))))
    return torch.stack([mean, rstd, inv, bias - mean * inv]), part


def _affine(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x * inv + shift in x's dtype, as nn/module.py:BatchNorm rounds it."""
    return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


def bn_apply_plain(x, stat, act: bool) -> torch.Tensor:
    """y = silu(x * inv + shift) (act) or x * inv + shift, in x's dtype."""
    y = _affine(x, stat[2], stat[3])
    return F.silu(y) if act else y


def _grad_terms(dy, x, stat, act: bool):
    """(g, xhat) in float32: g = dy * silu'(z) at the forward's z (act) or dy."""
    mean, rstd, inv, shift = stat
    g = dy.float()
    if act:
        z = _affine(x, inv, shift).float()
        s = torch.sigmoid(z)
        g = g * (s * (1 + z * (1 - s)))
    return g, (x.float() - mean[:, None, None]) * rstd[:, None, None]


def bn_grad_reduce_plain(dy, x, stat, act: bool, length: int, chunks: int):
    """(coef, dweight, dbias, part): each chunk's (sum g, sum g * xhat) in
    float32, part (C, chunks, 2), summed in chunk order: dbias = sum g,
    dweight = sum g * xhat, coef (2, C) = both over n."""
    g, xh = _grad_terms(dy, x, stat, act)
    part = torch.stack([_chunk_sums(_by_channel(g), length, chunks),
                        _chunk_sums(_by_channel(g * xh), length, chunks)], 2)
    sg, sgx = torch.zeros_like(part[:, 0, 0]), torch.zeros_like(part[:, 0, 1])
    for k in range(chunks):
        sg, sgx = sg + part[:, k, 0], sgx + part[:, k, 1]
    nhw = x.shape[0] * x.shape[2] * x.shape[3]
    return torch.stack([sg / nhw, sgx / nhw]), sgx, sg, part


def bn_dx_plain(dy, x, stat, coef, act: bool) -> torch.Tensor:
    """dx = inv * (g - coef0 - xhat * coef1), in x's dtype."""
    g, xh = _grad_terms(dy, x, stat, act)
    a, b, inv = coef[0][:, None, None], coef[1][:, None, None], stat[2][:, None, None]
    return (inv * (g - a - xh * b)).to(x.dtype)


# ----------------------------------------------------------------- kernels
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_TENSOR = [_P, _L, _L, _L]                       # pointer, (sn, sc, sp)
_GEOMETRY = [_I, _I, _I, _I, _I, _L, _L, _I]     # dtype, vec, rows, C, HW, NHW, L, P
_STATS_ARGS = _TENSOR + _GEOMETRY + [_P, _P, _P, _F, _F, _F, _F, _P, _P, _P, _P]
_APPLY_ARGS = _TENSOR + _GEOMETRY + [_P, _I, _P, _P]
_REDUCE_ARGS = _TENSOR + _TENSOR + [_I] + _GEOMETRY + [_P, _I, _P, _P, _P, _P, _P]
_DX_ARGS = _TENSOR + _TENSOR + [_I] + _GEOMETRY + [_P, _P, _I, _P, _P]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launched(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"BatchNorm kernels {name} failed to launch: CUDA error {err}")


def _check_act(x: torch.Tensor, p: Plan, name: str = "x", rows: int = None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the BatchNorm kernels take tensors on the card, got {name} on "
                         f"{x.device}")
    if x.dtype not in DTYPES or x.dim() != 4:
        raise TypeError(f"the BatchNorm kernels take float32 or bfloat16 (N, C, H, W), got "
                        f"{name} {x.dtype} {tuple(x.shape)}")
    rows = p.rows if rows is None else rows
    got = strides(x)
    if got is None or got[0] != rows:
        raise ValueError(f"{name} strides {x.stride()} are not of the plan's layout "
                         f"({'rows' if rows else 'planar'})")
    n, c, h, w = x.shape
    if n * h * w >= MAX_INDEX or not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"the BatchNorm kernels take < 2^31 values a channel and 1..."
                         f"{MAX_CHANNELS} channels, got {name} {tuple(x.shape)}")
    if p.vec and rows == p.rows and not _whole_vectors(x, rows, VECTOR[x.dtype]):
        raise ValueError(f"{name} does not allow the plan's 16-byte vectors")


def _check_channel(t: torch.Tensor, x: torch.Tensor, name: str, *lead: int) -> None:
    if (t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous()
            or tuple(t.shape) != (*lead, x.shape[1])):
        raise ValueError(f"{name} must be a contiguous float32 tensor of {x.shape[1]} channels "
                         f"on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _tensor(t: torch.Tensor):
    return (t.data_ptr(), *strides(t)[1])


def _geometry(x: torch.Tensor, p: Plan):
    n, c, h, w = x.shape
    return (DTYPES[x.dtype], p.vec, p.rows, c, h * w, n * h * w, p.length, p.chunks)


def bn_stats(x, weight, bias, running_mean, running_var, eps: float, momentum: float, p: Plan):
    """(stat, part): bn_silu_stats_kernel and bn_silu_finalize_kernel for x on
    the card, the plain pass on the CPU (see bn_stats_plain)."""
    if x.device.type == "cpu":
        return bn_stats_plain(x, weight, bias, running_mean, running_var, eps, momentum,
                              p.length, p.chunks)
    _check_act(x, p)
    for t, name in ((weight, "weight"), (bias, "bias"), (running_mean, "running_mean"),
                    (running_var, "running_var")):
        _check_channel(t, x, name)
    n, c, h, w = x.shape
    nhw = n * h * w
    part, stat = scratch((c, p.chunks, 2), x), scratch((4, c), x)
    fn = cuda_build.load(SOURCE, "cerberus_bn_silu_stats", _STATS_ARGS)
    err = fn(*_tensor(x), *_geometry(x, p), part.data_ptr(), weight.data_ptr(), bias.data_ptr(),
             eps, 1 - momentum, momentum, nhw / max(nhw - 1, 1), running_mean.data_ptr(),
             running_var.data_ptr(), stat.data_ptr(), _stream(x))
    _launched(err, "bn_silu_stats")
    bn_stats.launches += 2
    return stat, part


def bn_apply(x, stat, act: bool, p: Plan) -> torch.Tensor:
    """y: bn_silu_apply_kernel for x on the card, the plain pass on the CPU.
    On the card y is dense in x's layout family."""
    if x.device.type == "cpu":
        return bn_apply_plain(x, stat, act)
    _check_act(x, p)
    _check_channel(stat, x, "stat", 4)
    y = dense_like(x, p.rows)
    fn = cuda_build.load(SOURCE, "cerberus_bn_silu_apply", _APPLY_ARGS)
    err = fn(*_tensor(x), *_geometry(x, p), stat.data_ptr(), int(act), y.data_ptr(), _stream(x))
    _launched(err, "bn_silu_apply")
    bn_apply.launches += 1
    return y


def bn_grad_reduce(dy, x, stat, act: bool, p: Plan):
    """(coef, dweight, dbias, part): bn_silu_grad_reduce_kernel and
    bn_silu_grad_finalize_kernel for tensors on the card, the plain pass on
    the CPU (see bn_grad_reduce_plain)."""
    if x.device.type == "cpu":
        return bn_grad_reduce_plain(dy, x, stat, act, p.length, p.chunks)
    _check_grad(dy, x, stat, p)
    c = x.shape[1]
    part, coef = scratch((c, p.chunks, 2), x), scratch((2, c), x)
    dweight, dbias = scratch(c, x), scratch(c, x)
    fn = cuda_build.load(SOURCE, "cerberus_bn_silu_grad_reduce", _REDUCE_ARGS)
    err = fn(*_tensor(dy), *_tensor(x), p.dy_planes, *_geometry(x, p), stat.data_ptr(),
             int(act), part.data_ptr(), dweight.data_ptr(), dbias.data_ptr(), coef.data_ptr(),
             _stream(x))
    _launched(err, "bn_silu_grad_reduce")
    bn_grad_reduce.launches += 2
    return coef, dweight, dbias, part


def bn_dx(dy, x, stat, coef, act: bool, p: Plan) -> torch.Tensor:
    """dx: bn_silu_dx_kernel for tensors on the card, the plain pass on the
    CPU. On the card dx is dense in x's layout family."""
    if x.device.type == "cpu":
        return bn_dx_plain(dy, x, stat, coef, act)
    _check_grad(dy, x, stat, p)
    _check_channel(coef, x, "coef", 2)
    dx = dense_like(x, p.rows)
    fn = cuda_build.load(SOURCE, "cerberus_bn_silu_dx", _DX_ARGS)
    err = fn(*_tensor(dy), *_tensor(x), p.dy_planes, *_geometry(x, p), stat.data_ptr(),
             coef.data_ptr(), int(act), dx.data_ptr(), _stream(x))
    _launched(err, "bn_silu_dx")
    bn_dx.launches += 1
    return dx


def _check_grad(dy, x, stat, p: Plan) -> None:
    _check_act(x, p)
    _check_act(dy, p, "dy", 0 if p.dy_planes else p.rows)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} must match x {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    _check_channel(stat, x, "stat", 4)


bn_stats.launches = 0
bn_apply.launches = 0
bn_grad_reduce.launches = 0
bn_dx.launches = 0

COUNTED = (bn_stats, bn_apply, bn_grad_reduce, bn_dx, FUSED, PLAIN)


# ---------------------------------------------------------------- function
class BnSilu(torch.autograd.Function):
    """bn_silu as an autograd Function: the four passes above."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps: float, momentum: float,
                act: bool):
        if strides(x) is None:
            x = x.contiguous()
        p = plan(x)
        stat, _ = bn_stats(x, weight, bias, running_mean, running_var, eps, momentum, p)
        y = bn_apply(x, stat, act, p)
        ctx.save_for_backward(x, stat)
        ctx.act = act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, stat = ctx.saved_tensors
        dy = grad_layout(dy, strides(x)[0])
        p = plan(x, dy)
        coef, dweight, dbias, _ = bn_grad_reduce(dy, x, stat, ctx.act, p)
        dx = bn_dx(dy, x, stat, coef, ctx.act, p)
        return dx, dweight, dbias, None, None, None, None, None


def bn_silu(x, weight, bias, running_mean, running_var, eps: float, momentum: float,
            act: bool) -> torch.Tensor:
    """Training BatchNorm of x (N, C, H, W) over N, H, W with float32
    `weight` and `bias`, then SiLU when `act`; `running_mean` and
    `running_var` (float32) take (1 - momentum) * running + momentum * batch
    in place, with the batch variance unbiased. Differentiable in x, weight
    and bias."""
    return BnSilu.apply(x, weight, bias, running_mean, running_var, eps, momentum, act)
