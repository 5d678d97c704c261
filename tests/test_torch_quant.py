"""The port's int8 PTQ serving (nn/module.py quantize_act / conv2d_int8,
ops/conv_int8_cuda.py, quant/ptq.py, the weight bridge and
CerberusDetInference(int8=...)) against the JAX package's.

The int8 conv's int32 sums are exact integer arithmetic in both packages, so
the plain version must equal lax.conv_general_dilated(int32) and the Pallas
kernel (interpret mode) bit for bit. Everything float is held to the limits
stated at each test."""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from cerberusdet_tpu.infer.inference import CerberusDetInference as JaxInference
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.nn.module import Ctx
from cerberusdet_tpu.nn.module import conv2d_int8 as jax_conv2d_int8
from cerberusdet_tpu.nn.module import quantize_act as jax_quantize_act
from cerberusdet_tpu.nn.module import silu as jax_silu
from cerberusdet_tpu.ops.conv_int8_pallas import conv3x3_s8
from cerberusdet_tpu.quant import calibrate_amax as jax_calibrate
from cerberusdet_tpu.quant import quantize_params as jax_quantize
from cerberusdet_tpu.quant import select_all as jax_select_all
from cerberusdet_tpu.quant.ptq import select_deep as jax_select_deep
from cerberusdet_tpu_torch.infer import CerberusDetInference
from cerberusdet_tpu_torch.manager.checkpoint import load_checkpoint, save_checkpoint
from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.nn.layers import ACT_QUANT
from cerberusdet_tpu_torch.nn.module import conv2d_int8, quantize_act
from cerberusdet_tpu_torch.ops.conv_int8_cuda import (
    TILES,
    conv_s8,
    conv_s8_plain,
    conv_tile,
    pack_vectorized,
    pack_weight,
    padded_channels,
    quant_cat_s8,
    quant_pack_s8,
    quant_pack_s8_plain,
    quant_s8,
    quant_s8_plain,
    unpack_weight,
)
from cerberusdet_tpu_torch.quant import (
    act_quant_annotations,
    calibrate_amax,
    clear_act_quant,
    conv_layers,
    fused_conv_weights,
    quantize_params,
    select_all,
    select_deep,
)

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]
NAMES = {"a": ["c0", "c1", "c2"], "b": ["k0", "k1", "k2", "k3", "k4"]}
IMG = 64


def _ptq_params(rng, ci, co, k):
    """A JAX PTQ leaf {w_q HWIO, s_w, s_x, b} of numpy arrays."""
    w = rng.normal(0, 0.4, (k, k, ci, co)).astype(np.float32)
    s_w = (np.max(np.abs(w), axis=(0, 1, 2)) / 127.0).astype(np.float32)
    return {"w_q": np.clip(np.round(w / s_w), -127, 127).astype(np.int8),
            "s_w": s_w,
            "s_x": np.float32(rng.uniform(0.01, 0.1)),
            "b": rng.normal(0, 0.2, co).astype(np.float32)}


def _torch_leaf(p):
    return {"w_q": pack_weight(torch.from_numpy(p["w_q"])), "s_w": torch.from_numpy(p["s_w"]),
            "s_x": torch.tensor(p["s_x"]), "b": torch.from_numpy(p["b"])}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.float().numpy().transpose(0, 2, 3, 1) if t.is_floating_point() \
        else t.numpy().transpose(0, 2, 3, 1)


def _ulps_bf16(a, b):
    """|a - b| in bf16 ulps at b's magnitude (tests/test_conv_int8_pallas.py)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b) / (np.maximum(np.abs(b), 2.0 ** -126) * 2.0 ** -8)


# ------------------------------------------------------------------ the conv


def _packed(xq):
    """(B, H, W, Ci) int8 numpy -> quant_pack_s8's (B, H, W, Ci16) layout."""
    xq = np.asarray(xq)
    ci = xq.shape[-1]
    out = np.zeros(xq.shape[:-1] + (padded_channels(ci),), np.int8)
    out[..., :ci] = xq
    return torch.from_numpy(out)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quantize_act_bitwise(dtype):
    """Same int8 codes as the JAX quantize_act, including the round-half-even
    ties at +-0.5 steps and the clip."""
    rng = np.random.default_rng(0)
    s_x = np.float32(0.037)
    x = rng.normal(0, 2.5, (2, 6, 9, 11)).astype(np.float32)
    x.flat[:40] = (np.arange(40) - 20 + 0.5) * s_x  # ties
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    ours = quantize_act(xt, torch.tensor(s_x))
    ref = np.asarray(jax_quantize_act(xj, jnp.float32(s_x)))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert quantize_act(ours, torch.tensor(s_x)) is ours  # int8 passes through


@pytest.mark.parametrize("ci", [3, 5, 80, 400])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quant_pack_plain_matches_jax_quantize_act(dtype, ci):
    """quant_pack_s8_plain of NCHW activations == JAX's quantize_act of the
    same NHWC activations, zero-padded to Ci16 channels: the codes bit for
    bit (ties and the clip included), the padding zero."""
    rng = np.random.default_rng(ci)
    s_x = np.float32(0.029)
    x = rng.normal(0, 2.5, (2, 5, 7, ci)).astype(np.float32)
    x.flat[:30] = (np.arange(30) - 15 + 0.5) * s_x  # ties
    xj = jnp.asarray(x)
    xt = _nchw(x)
    if dtype == "bfloat16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    ci16 = padded_channels(ci)
    ours = quant_pack_s8_plain(xt, torch.tensor(s_x), ci16)
    ref = np.asarray(jax_quantize_act(xj, jnp.float32(s_x)))
    assert ours.dtype == torch.int8 and ours.shape == (2, 5, 7, ci16) and ours.is_contiguous()
    np.testing.assert_array_equal(ours[..., :ci].numpy(), ref)
    assert not ours[..., ci:].any()
    # the wrapper on the CPU is the plain version, for a channel slice too
    before = quant_pack_s8.launches
    assert torch.equal(quant_pack_s8(xt, torch.tensor(s_x), ci16), ours)
    wide = torch.cat([xt, xt], 1)[:, ci:]  # images 2 * ci planes apart
    last = xt.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)  # channels last
    for view in (wide, last):
        assert not view.is_contiguous()
        assert torch.equal(quant_pack_s8(view, torch.tensor(s_x), ci16), ours)
    assert quant_pack_s8.launches == before


# ------------------------------------- a CPU model of quant_pack_s8's tiling

# (name, storage shape, view): layouts the kernel takes, each view made from
# a contiguous storage tensor so that its offset and strides are known
_PACK_CASES = [
    ("Ci 3, 15x20", (2, 3, 15, 20), lambda t: t),
    ("Ci 5, 1x1", (3, 5, 1, 1), lambda t: t),
    ("Ci 80, 15x20", (2, 80, 15, 20), lambda t: t),
    ("Ci 400, 15x20", (1, 400, 15, 20), lambda t: t),
    ("Ci 400, 8x8", (2, 400, 8, 8), lambda t: t),
    ("Ci 160, 12x12", (2, 160, 12, 12), lambda t: t),
    ("Ci 320, 7x9", (1, 320, 7, 9), lambda t: t),
    ("Ci 640, 4x5", (2, 640, 4, 5), lambda t: t),
    ("Ci 80 slice at channel 1, 15x20", (2, 161, 15, 20), lambda t: t[:, 1:81]),
    ("Ci 80 slice at channel 3, 8x8", (2, 163, 8, 8), lambda t: t[:, 3:83]),
    ("Ci 3 channels-last, 15x20", (2, 15, 20, 3), lambda t: t.permute(0, 3, 1, 2)),
    ("Ci 80 channels-last, 8x8", (2, 8, 8, 80), lambda t: t.permute(0, 3, 1, 2)),
]
_PACK_DTYPES = [torch.float32, torch.bfloat16, torch.int8]
_S_X = 0.029


def _pack_input(case, dtype, device="cpu"):
    """(view, storage) of _PACK_CASES[case] in dtype on device, with ties at
    half steps and values past the clip."""
    _, shape, view = _PACK_CASES[case]
    rng = np.random.default_rng(case)
    if dtype == torch.int8:
        flat = torch.from_numpy(rng.integers(-127, 128, int(np.prod(shape)), dtype=np.int8))
    else:
        a = rng.normal(0, 2.5, int(np.prod(shape))).astype(np.float32)
        ties = min(20, a.size)
        a[:ties] = (np.arange(ties) - 10 + 0.5) * np.float32(_S_X)
        flat = torch.from_numpy(a).to(dtype)
    flat = flat.to(device)
    return view(flat.reshape(shape)), flat


def _pack_model(x, flat, ci16):
    """quant_pack_s8's decomposition, in numpy: which element of the
    storage each output byte comes from, by which path. For planes at pixel
    stride 1 the threads take runs of V = 16 / itemsize pixels in the order
    (image, group of 32 pixels, 16-channel chunk, run in the group: lp = 32
    / V of them); a thread reads its run of each of its chunk's 16 channels,
    as one 16-byte load where pack_vectorized holds and the run is whole
    (it must then be 16-byte aligned, the storage being so), else element by
    element up to the plane's end; zero past C; then it writes one 16-byte
    chunk for each of its pixels. Any other layout: a thread per pixel and
    chunk. Returns ((B, HW, ci16) int8, {path: runs})."""
    b_, c_, h, w = x.shape
    hw = h * w
    sb, sc = x.stride(0), x.stride(1)
    sp = x.stride(3) if w > 1 else x.stride(2)
    off = x.storage_offset()
    size = x.element_size()
    if x.dtype == torch.int8:
        codes = flat.numpy().astype(np.int16)
    else:
        codes = quantize_act(flat, torch.tensor(_S_X)).numpy().astype(np.int16)
    out = np.full((b_, hw, ci16), 999, np.int16)  # 999: not written
    paths = {"vector": 0, "element": 0, "rows": 0}
    K = ci16 // 16
    if sp != 1:
        for t in range(b_ * hw * K):
            k, bp = t % K, t // K
            b, p = divmod(bp, hw)
            for i in range(16):
                c = 16 * k + i
                assert out[b, p, c] == 999
                out[b, p, c] = codes[off + b * sb + p * sp + c * sc] if c < c_ else 0
            paths["rows"] += 1
        return out.astype(np.int8), paths
    v = 16 // size
    lp = 32 // v
    vec = pack_vectorized(off * size, sb, sc, size)
    groups = -(-hw // 32)
    for b in range(b_):
        for g in range(groups):
            for k, pl in itertools.product(range(K), range(lp)):
                c0 = 16 * k
                p = g * 32 + pl * v
                n = hw - p
                if n <= 0:
                    continue
                raw = np.zeros((16, v), np.int16)
                for i in range(16):
                    if c0 + i >= c_:
                        continue
                    base = off + b * sb + (c0 + i) * sc + p
                    if vec and n >= v:
                        assert (base * size) % 16 == 0 and p + v <= hw
                        raw[i] = codes[base:base + v]
                        paths["vector"] += 1
                    else:
                        raw[i, :min(n, v)] = codes[base:base + min(n, v)]
                        paths["element"] += 1
                for j in range(min(n, v)):
                    assert (out[b, p + j, c0:c0 + 16] == 999).all()
                    out[b, p + j, c0:c0 + 16] = raw[:, j]
    assert (out != 999).all(), "an output byte was not written"
    return out.astype(np.int8), paths


@pytest.mark.parametrize("dtype", _PACK_DTYPES)
@pytest.mark.parametrize("case", range(len(_PACK_CASES)))
def test_pack_model_matches_plain(case, dtype):
    """The kernel's tiling, index map and edge masks (the CPU model above)
    write every output byte once and give quant_pack_s8_plain's packing
    (flattened over H, W): Ci 3, 5, 80, 160, 320, 400 and 640, HW 300
    (15x20, misaligned planes in bf16 and int8) and 1, ragged ends, channel
    slices at odd offsets, channels-last views, in float32, bf16 and int8."""
    x, flat = _pack_input(case, dtype)
    ci16 = padded_channels(x.shape[1])
    got, _ = _pack_model(x, flat, ci16)
    want = quant_pack_s8_plain(x, torch.tensor(_S_X), ci16).reshape(got.shape)
    np.testing.assert_array_equal(got, want.numpy(), err_msg=_PACK_CASES[case][0])


@pytest.mark.parametrize("dtype", _PACK_DTYPES)
def test_pack_model_cases_reach_every_path(dtype):
    """The cases reach the vector path, the element path (misaligned planes
    and ragged ends) and the channels-last kernel in every dtype."""
    total = {"vector": 0, "element": 0, "rows": 0}
    for case in range(len(_PACK_CASES)):
        x, flat = _pack_input(case, dtype)
        for key, n in _pack_model(x, flat, padded_channels(x.shape[1]))[1].items():
            total[key] += n
    assert all(total.values()), total


def test_pack_vectorized():
    """The vector path's test: every plane starts at a multiple of 16 bytes."""
    assert pack_vectorized(0, 400 * 400, 400, 2)
    assert not pack_vectorized(600, 80 * 300, 300, 2)  # a slice at channel 1 of 15x20 bf16
    assert not pack_vectorized(0, 80 * 300, 300, 1)
    assert pack_vectorized(1200, 80 * 300, 300, 4)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ci", [3, 5, 40, 80, 400])
def test_pack_weight_round_trip(ci, k):
    """HWIO int8 -> (Co, k, k, Ci16), zero beyond Ci, and back losslessly."""
    w = np.random.default_rng(ci + k).integers(-127, 128, (k, k, ci, 24), dtype=np.int8)
    packed = pack_weight(torch.from_numpy(w))
    ci16 = padded_channels(ci)
    assert ci16 % 16 == 0 and ci <= ci16 < ci + 16
    assert packed.dtype == torch.int8 and packed.shape == (24, k, k, ci16)
    assert packed.is_contiguous() and not packed[..., ci:].any()
    np.testing.assert_array_equal(packed[..., :ci].numpy(), w.transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(unpack_weight(packed, ci).numpy(), w)


CONV_CASES = [(160, 160, 3, 1, 8), (80, 80, 3, 1, 10), (48, 80, 3, 1, 9),
              (80, 160, 3, 2, 12), (64, 48, 1, 1, 7), (3, 16, 3, 2, 11), (3, 16, 3, 1, 6)]


@pytest.mark.parametrize("ci,co,k,s,hw", CONV_CASES)
def test_plain_int8_conv_int32_matches_lax(ci, co, k, s, hw):
    """Raw int32 sums of the plain version == XLA's int32 conv, exactly."""
    rng = np.random.default_rng(ci * 7 + co + k + s)
    p = _ptq_params(rng, ci, co, k)
    xq = rng.integers(-127, 128, (2, hw, hw + 1, ci), dtype=np.int8)
    ref = lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(p["w_q"]), (s, s), [(k // 2, k // 2)] * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    tp = _torch_leaf(p)
    got = conv_s8_plain(_packed(xq), tp["w_q"], tp["s_x"], tp["s_w"], tp["b"], s, k // 2,
                        False, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


@pytest.mark.parametrize("ci,co,hw", [(160, 160, 6), (80, 80, 7), (48, 80, 5)])
def test_plain_int8_conv_matches_pallas_interpret(ci, co, hw):
    """Raw int32 sums == the Pallas kernel's (raw=True, interpret mode)."""
    rng = np.random.default_rng(ci + co + hw)
    p = _ptq_params(rng, ci, co, 3)
    xq = rng.integers(-127, 128, (1, hw, hw, ci), dtype=np.int8)
    ref = conv3x3_s8(jnp.asarray(xq), {k: jnp.asarray(v) for k, v in p.items()},
                     raw=True, interpret=True)
    tp = _torch_leaf(p)
    got = conv_s8_plain(_packed(xq), tp["w_q"], tp["s_x"], tp["s_w"], tp["b"], 1, 1, False,
                        torch.int32)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))


@pytest.mark.parametrize("ci,co,k,s", [(160, 160, 3, 1), (80, 80, 3, 2), (64, 96, 1, 1)])
def test_epilogue_matches_jax(ci, co, k, s):
    """Float epilogue against JAX's silu(conv2d_int8(...)): the limits of
    tests/test_conv_int8_pallas.py. bf16 output within 2 bf16 ulps with
    fewer than 1e-3 of the elements differing (torch's silu is x / (1 +
    exp(-x)), JAX's x * sigmoid(x): float32 roundings apart, which a bf16
    rounding rarely shows); no activation: float32 within 1e-6 relative; the
    requantized int8 within 1 step with fewer than 1e-3 differing."""
    rng = np.random.default_rng(ci + co + k + s)
    p = _ptq_params(rng, ci, co, k)
    x = rng.normal(0, 1, (2, 12, 12, ci)).astype(np.float32)
    pj = {key: jnp.asarray(v) for key, v in p.items()}
    tp = _torch_leaf(p)
    y = jax_conv2d_int8(jnp.asarray(x), pj, s)
    ref = jax_silu(y)

    got = conv2d_int8(_nchw(x), tp, s, act=True, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    u = _ulps_bf16(_nhwc(got), ref.astype(jnp.bfloat16))
    assert u.max() <= 2.01 and (u > 0).mean() < 1e-3, (u.max(), (u > 0).mean())

    raw = conv2d_int8(_nchw(x), tp, s)
    assert raw.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(raw), np.asarray(y), rtol=1e-6, atol=1e-6)

    qs = float(np.abs(np.asarray(ref)).max() / 127.0)
    xq = quant_pack_s8_plain(_nchw(x), tp["s_x"], padded_channels(ci))
    q = conv_s8_plain(xq, tp["w_q"], tp["s_x"], tp["s_w"], tp["b"], s, k // 2, True,
                      torch.int8, q_scale=torch.tensor(np.float32(qs)))
    dq = np.abs(_nhwc(q).astype(np.int32)
                - np.asarray(jax_quantize_act(ref, jnp.float32(qs)), np.int32))
    assert dq.max() <= 1 and (dq > 0).mean() < 1e-3


def test_kernel_wrapper_on_cpu_is_plain_and_checks_shape_class():
    """CPU tensors take the plain version and launch nothing; the weight
    layout packs and unpacks losslessly; other conv shapes are refused."""
    rng = np.random.default_rng(4)
    p = _torch_leaf(_ptq_params(rng, 5, 24, 3))
    assert p["w_q"].shape == (24, 3, 3, 16)
    np.testing.assert_array_equal(unpack_weight(p["w_q"], 5).numpy(),
                                  _ptq_params(np.random.default_rng(4), 5, 24, 3)["w_q"])
    xq = _packed(rng.integers(-127, 128, (1, 7, 6, 5), dtype=np.int8))
    before = conv_s8.launches
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        args = (xq, p["w_q"], p["s_x"], p["s_w"], p["b"], 2, 1, True, dtype)
        a, b = conv_s8(*args), conv_s8_plain(*args)
        assert a.shape == (1, 24, 4, 3) and torch.equal(a, b)
        assert torch.equal(conv_s8(*args, tile=TILES[-1]), b)  # no kernel, no tile on the CPU
    assert conv_s8.launches == before
    with pytest.raises(ValueError, match="padding"):
        conv_s8(xq, p["w_q"], p["s_x"], p["s_w"], p["b"], 1, 0)
    with pytest.raises(ValueError, match="stride"):
        conv_s8(xq, p["w_q"], p["s_x"], p["s_w"], p["b"], 3, 1)


def _bad_conv_inputs():
    """{name: (args of conv_s8, exception type)}, each refused by conv_s8."""
    rng = np.random.default_rng(9)
    p = _torch_leaf(_ptq_params(rng, 20, 16, 3))
    xq = _packed(rng.integers(-127, 128, (2, 6, 5, 20), dtype=np.int8))
    ok = (xq, p["w_q"], p["s_x"], p["s_w"], p["b"], 1, 1)

    def but(i, v):
        return ok[:i] + (v,) + ok[i + 1:]

    return {
        "x NCHW": (but(0, xq.permute(0, 3, 1, 2).contiguous()), ValueError),
        "x not contiguous": (but(0, xq[:, :, :4]), ValueError),
        "x float": (but(0, xq.float()), TypeError),
        "x Ci not padded": (but(0, xq[..., :20].contiguous()), ValueError),
        "w HWIO": (but(1, unpack_weight(p["w_q"], 20).contiguous()), ValueError),
        "w Ci16 mismatch": (but(1, p["w_q"][..., :16].contiguous()), ValueError),
        "s_x float64": (but(2, p["s_x"].double()), TypeError),
        "s_x a vector": (but(2, p["s_x"].repeat(2)), TypeError),
        "s_w bf16": (but(3, p["s_w"].bfloat16()), TypeError),
        "bias short": (but(4, p["b"][:8]), ValueError),
        "k 5": (but(1, torch.zeros((16, 5, 5, 32), dtype=torch.int8)), ValueError),
        "float16 out": (ok + (True, torch.float16), TypeError),
        "int8 out without q_scale": (ok + (True, torch.int8), ValueError),
        "int8 out with a float q_scale": (ok + (True, torch.int8, 0.5), TypeError),
        "q_scale float64": (ok + (True, torch.int8, torch.tensor(0.5, dtype=torch.float64)),
                            TypeError),
        "tile not the kernel's": (ok + (True, torch.float32, None, (32, 32)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_conv_inputs()))
def test_conv_wrapper_refuses_bad_inputs_on_cpu(case):
    """conv_s8 checks layouts, shapes and dtypes before it dispatches, so the
    CPU path refuses what the kernel would refuse, and launches nothing."""
    args, exc = _bad_conv_inputs()[case]
    before = conv_s8.launches
    with pytest.raises(exc):
        conv_s8(*args)
    assert conv_s8.launches == before


@pytest.mark.parametrize("case", ["float64", "uint8", "H, W swapped", "ci16 short",
                                  "ci16 ragged", "s_x float64", "3-d"])
def test_quant_pack_wrapper_refuses_bad_inputs_on_cpu(case):
    """quant_pack_s8 takes NCHW float32 / bf16 / int8 whose planes are
    row-major at one pixel stride, one float32 s_x and a Ci16 that is a
    multiple of 16 and holds C."""
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 20, 5, 6)).astype(np.float32))
    s_x = torch.tensor(0.05)
    args = {"float64": (x.double(), s_x, 32), "uint8": (x.to(torch.uint8), s_x, 32),
            "H, W swapped": (x.transpose(2, 3), s_x, 32), "ci16 short": (x, s_x, 16),
            "ci16 ragged": (x, s_x, 40), "s_x float64": (x, s_x.double(), 32),
            "3-d": (x[0], s_x, 32)}[case]
    before = quant_pack_s8.launches
    with pytest.raises((TypeError, ValueError)):
        quant_pack_s8(*args)
    assert quant_pack_s8.launches == before


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float64])
def test_conv2d_int8_takes_float_activations_on_both_routes(dtype, use_kernel):
    """conv2d_int8 quantizes float32 / bf16 activations and takes int8 ones
    as already quantized (the JAX package's conv2d_int8); both routes refuse
    other types (use_kernel=False is the plain route), so the two routes
    take the same inputs."""
    rng = np.random.default_rng(3)
    p = _torch_leaf(_ptq_params(rng, 8, 16, 3))
    x = torch.from_numpy(rng.normal(0, 1, (1, 8, 5, 5)).astype(np.float32))
    y = conv2d_int8(x, p, use_kernel=use_kernel)
    assert y.shape == (1, 16, 5, 5)
    if dtype == torch.int8:
        xq = quantize_act(x, p["s_x"])
        assert torch.equal(conv2d_int8(xq, p, use_kernel=use_kernel), y)
    else:
        with pytest.raises(TypeError, match="activations"):
            conv2d_int8(x.to(dtype), p, use_kernel=use_kernel)


@pytest.mark.parametrize("ci", [3, 80])
def test_quant_pack_plain_takes_int8_unscaled(ci):
    """int8 activations are already quantized: packed NHWC, zero-padded to
    Ci16, with no rescale, on the plain route and through the CPU wrapper."""
    xq = np.random.default_rng(ci).integers(-127, 128, (2, 5, 7, ci), dtype=np.int8)
    s_x = torch.tensor(0.05)
    got = quant_pack_s8_plain(_nchw(xq), s_x, padded_channels(ci))
    assert torch.equal(got, _packed(xq)) and got.is_contiguous()
    before = quant_pack_s8.launches
    assert torch.equal(quant_pack_s8(_nchw(xq), s_x, padded_channels(ci)), got)
    assert quant_pack_s8.launches == before


def _int8_conv_pair(p, ci, co, k, s, dtype):
    """A JAX Conv and the port's int8 Conv holding the same PTQ leaf `p`,
    the port's cast to the compute dtype."""
    from cerberusdet_tpu.nn.layers import Conv as JaxConv
    from cerberusdet_tpu_torch.nn.layers import Conv

    conv = Conv(ci, co, k, s)
    del conv.bn  # a fused Conv's form; its weights are replaced below
    conv.b = torch.nn.Parameter(torch.zeros(co))
    conv.to_int8()
    for key, v in _torch_leaf(p).items():
        getattr(conv, key).copy_(v)
    return JaxConv(ci, co, k, s), conv.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci,co,k,s", [(16, 24, 3, 1), (40, 32, 3, 2), (24, 16, 1, 1)])
def test_int8_input_to_quantized_conv_matches_jax(ci, co, k, s, dtype):
    """The same int8 tensor (NHWC for JAX, NCHW for the port) into a
    quantized Conv of each package: taken as already quantized, output in
    the compute dtype, not the input's (JAX's ctx.dtype); values within the
    limits of test_epilogue_matches_jax (float32 1e-6 relative; bf16 within
    2 ulps, fewer than 1e-3 differing), except where SiLU meets sums near
    -85: JAX's x * sigmoid(x) gives -0.0 there and torch's x / (1 +
    exp(-x)) a value below 1e-36, so where JAX has 0 the port must be within
    1e-30 of it. Calibration records nothing for the int8 input in either
    package, and a float input is recorded."""
    rng = np.random.default_rng(ci + co + k + s)
    p = _ptq_params(rng, ci, co, k)
    xq = rng.integers(-127, 128, (2, 9, 11, ci), dtype=np.int8)
    jax_conv, conv = _int8_conv_pair(p, ci, co, k, s, dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ctx = Ctx(dtype=jdtype)
    ctx.taps = {}
    ref = jax_conv({key: jnp.asarray(v) for key, v in p.items()}, jnp.asarray(xq), ctx,
                   ("c",))
    conv.tap, conv.tap_key = {}, "c"
    got = conv(_nchw(xq))
    assert ctx.taps == {} and conv.tap == {}
    assert ref.dtype == jdtype and got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(_nhwc(got), np.asarray(ref), rtol=1e-6, atol=1e-6)
    else:
        ref = np.asarray(ref.astype(jnp.float32))
        zero = ref == 0
        assert np.abs(_nhwc(got)[zero]).max(initial=0.0) < 1e-30
        u = _ulps_bf16(_nhwc(got), ref)[~zero]
        assert u.max() <= 2.01 and (u > 0).mean() < 1e-3, (u.max(), (u > 0).mean())
    conv(_nchw(xq).to(dtype))
    assert set(conv.tap) == {"c"}


@pytest.mark.parametrize("m,co,tile", [(51200, 320, (128, 160)), (12800, 640, (128, 160)),
                                       (204800, 80, (128, 80)), (6400, 320, (128, 80)),
                                       (3200, 640, (128, 80)), (6400, 160, (64, 80)),
                                       (400, 320, (64, 80)), (1600, 80, (64, 80)),
                                       (16900, 160, (128, 160))])
def test_conv_tile_choice(m, co, tile):
    """The first of 128x160, 128x80, 64x160, 64x80 (BN 160 only where Co is
    a multiple of 160) whose grid has a block for each of an H100's 132
    SMs; 64x80 where none has."""
    assert conv_tile(m, co, 132) == tile


EDGE_CASES = CONV_CASES + [(640, 320, 3, 1, 20), (400, 80, 3, 1, 9), (320, 320, 3, 1, 20),
                           (160, 320, 3, 2, 21), (2560, 640, 1, 1, 5)]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """conv_s8 and quant_pack_s8 against their plain versions on the card:
    int32 sums identical, float32 / bf16 / int8 epilogues identical (the
    kernel repeats the plain version's operations without FMA contraction),
    the packed activations identical (int8 input packed unscaled), the int32
    sums with every block tile.
    The cases add Ci 400 (a multiple of 16,
    not of 32), Co 80 against the 160-wide tile, a batch-1 20x20 map (M below
    the 128-row tile) and stride 2 on an odd H; quant_pack_s8 also takes the
    layouts of the CPU model's cases (misaligned 15x20 planes, HW 1, channel
    slices at odd offsets, channels-last views) in each dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    s_x = torch.tensor(_S_X, device="cuda")
    for case in range(len(_PACK_CASES)):
        for dtype in _PACK_DTYPES:
            x, _ = _pack_input(case, dtype, "cuda")
            ci16 = padded_channels(x.shape[1])
            assert torch.equal(quant_pack_s8(x, s_x, ci16), quant_pack_s8_plain(x, s_x, ci16)), \
                (_PACK_CASES[case][0], dtype)
    rng = np.random.default_rng(0)
    for ci, co, k, s, hw in EDGE_CASES:
        p = {key: v.cuda() for key, v in _torch_leaf(_ptq_params(rng, ci, co, k)).items()}
        batch = 1 if (ci, hw) == (320, 20) else 3
        x = torch.from_numpy(rng.normal(0, 3, (batch, ci, hw, hw + 3)).astype(np.float32)).cuda()
        for xt in (quantize_act(x, p["s_x"]), x, x.to(torch.bfloat16)):
            args = (xt, p["s_x"], padded_channels(ci))
            xq = quant_pack_s8(*args)
            assert torch.equal(xq, quant_pack_s8_plain(*args)), (ci, xt.dtype)
        for dtype in (torch.int32, torch.float32, torch.bfloat16, torch.int8):
            args = (xq, p["w_q"], p["s_x"], p["s_w"], p["b"], s, k // 2, True, dtype, 0.05)
            a, b = conv_s8(*args), conv_s8_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(a, b), (ci, co, k, s, dtype)
        raw = (xq, p["w_q"], p["s_x"], p["s_w"], p["b"], s, k // 2, True, torch.int32)
        for tile in TILES:  # each block tile of the kernel, whichever conv_tile picks
            assert torch.equal(conv_s8(*raw, tile=tile), conv_s8_plain(*raw)), (ci, co, tile)


def _quant_s8_model(x, out):
    """quant_s8's index map, in numpy: for each output byte (its flat index
    in out's storage) the flat index of the element of x's storage it codes,
    block (x, c, b) by block of 128 threads, each thread a run of V pixels
    of one plane (as csrc/conv_int8.cu:quant_nchw_kernel)."""
    b_, c_, h, w = x.shape
    hw, v = h * w, 16 // x.element_size()
    sp = x.stride(3) if w > 1 else x.stride(2) if h > 1 else 1
    src = {}
    runs = -(-hw // v)
    for b in range(b_):
        for c in range(c_):
            for bx in range(-(-runs // 128)):
                for t in range(128):
                    p = (bx * 128 + t) * v
                    for j in range(min(v, hw - p)):
                        dst = b * out.stride(0) + c * out.stride(1) + p + j
                        assert dst not in src, "an output byte written twice"
                        src[dst] = (x.storage_offset() + b * x.stride(0) + c * x.stride(1)
                                    + (p + j) * sp)
    return src


@pytest.mark.parametrize("dtype", _PACK_DTYPES)
@pytest.mark.parametrize("case", range(len(_PACK_CASES)))
def test_quant_s8_matches_jax_and_its_model(case, dtype):
    """quant_s8 on the CPU (its plain version) gives JAX's quantize_act codes
    (int8 copied), into a new tensor and into a channel slice of a larger
    buffer, writing nothing outside it; the kernel's index map (model) reads
    each output's own element once, on every layout quant_pack_s8 takes."""
    x, flat = _pack_input(case, dtype)
    s_x = torch.tensor(_S_X)
    ref = x if dtype == torch.int8 else torch.from_numpy(np.array(jax_quantize_act(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                              else jnp.float32), jnp.float32(_S_X))))
    got = quant_s8(x, s_x)
    assert got.dtype == torch.int8 and torch.equal(got, ref)
    assert torch.equal(quant_s8_plain(x, s_x), ref)
    buf = torch.full((x.shape[0], x.shape[1] + 5, x.shape[2], x.shape[3]), 99, dtype=torch.int8)
    quant_s8(x, s_x, buf[:, 3:3 + x.shape[1]])
    assert torch.equal(buf[:, 3:3 + x.shape[1]], ref)
    assert bool((buf[:, :3] == 99).all()) and bool((buf[:, 3 + x.shape[1]:] == 99).all())
    out = buf[:, 3:3 + x.shape[1]]
    src = _quant_s8_model(x, out)
    assert len(src) == x.numel()
    codes = quant_s8_plain(flat.reshape(-1, 1, 1, 1), s_x).reshape(-1)
    obuf = buf.reshape(-1).clone()
    for d, i in src.items():
        obuf[out.storage_offset() + d] = codes[i]
    assert torch.equal(obuf.reshape(buf.shape), buf)


def test_quant_cat_s8_and_refusals():
    """quant_cat_s8 is torch.cat of the quantized tensors (int8 ones as they
    are); quant_s8 refuses what its kernel would refuse, on the CPU too."""
    rng = np.random.default_rng(3)
    s_x = torch.tensor(0.04)
    xs = [torch.from_numpy(rng.normal(0, 3, (2, c, 5, 7)).astype(np.float32)) for c in (3, 16)]
    xs.append(quantize_act(xs[0], s_x))
    xs.append(xs[1].to(torch.bfloat16)[:, 2:9])
    got = quant_cat_s8(xs, s_x)
    assert torch.equal(got, torch.cat([quantize_act(t, s_x) for t in xs], 1))
    x = xs[1]
    before = quant_s8.launches
    for bad, exc in [((x.double(), s_x), TypeError), ((x[0], s_x), ValueError),
                     ((x.transpose(2, 3), s_x), ValueError), ((x, s_x.double()), TypeError),
                     ((x, s_x, torch.zeros(x.shape)), ValueError),
                     ((x, s_x, torch.zeros((2, 15, 5, 7), dtype=torch.int8)), ValueError),
                     ((x, s_x, torch.zeros((2, 16, 7, 5), dtype=torch.int8).transpose(2, 3)),
                      ValueError)]:
        with pytest.raises(exc):
            quant_s8(*bad)
    assert quant_s8.launches == before


@pytest.mark.cuda
def test_quant_s8_and_requant_mode_match_plain_on_card():
    """quant_s8 and conv_s8's bf16 requantize (the scale read on the card)
    against their plain versions on the card, on every layout of
    _PACK_CASES and into channel slices at odd offsets."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    s_x = torch.tensor(_S_X, device="cuda")
    for case in range(len(_PACK_CASES)):
        for dtype in _PACK_DTYPES:
            x, _ = _pack_input(case, dtype, "cuda")
            ref = quant_s8_plain(x, s_x)
            assert torch.equal(quant_s8(x, s_x), ref), (_PACK_CASES[case][0], dtype)
            buf = torch.zeros((x.shape[0], x.shape[1] + 4, *x.shape[2:]), dtype=torch.int8,
                              device="cuda")
            assert torch.equal(quant_s8(x, s_x, buf[:, 1:1 + x.shape[1]]), ref)
    rng = np.random.default_rng(1)
    for ci, co, k, s, hw in EDGE_CASES:
        p = {key: v.cuda() for key, v in _torch_leaf(_ptq_params(rng, ci, co, k)).items()}
        x = torch.from_numpy(rng.normal(0, 3, (2, ci, hw, hw + 1)).astype(np.float32)).cuda()
        xq = quant_pack_s8(x, p["s_x"], padded_channels(ci))
        q = torch.tensor(0.05, device="cuda")
        args = (xq, p["w_q"], p["s_x"], p["s_w"], p["b"], s, k // 2, True, torch.int8, q)
        assert torch.equal(conv_s8(*args, q_dtype=torch.bfloat16),
                           conv_s8_plain(*args, torch.bfloat16)), (ci, co, k, s)


# ------------------------------------------------------- the slice as a whole


@pytest.fixture(scope="module")
def jax_fused():
    """(JAX model, fused params as numpy float32, JAX float32 amax, batch)."""
    model = JaxModel(CFG, TASKS, NCS)
    fused = jax.tree_util.tree_map(np.asarray, model.fuse(model.init(jax.random.PRNGKey(0))))
    batch = np.random.default_rng(0).uniform(0, 1, (2, IMG, IMG, 3)).astype(np.float32)
    amax = jax_calibrate(model, fused, [batch], dtype=jnp.float32)
    return model, fused, amax, batch


def _port_model(tree):
    return load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"), tree).eval()


def test_calibrate_amax_matches_jax(jax_fused):
    """The same conv paths, and each absmax within rtol 1e-5 (float32 convs
    summed in other orders)."""
    _, fused, amax, batch = jax_fused
    ours = calibrate_amax(_port_model(fused), [batch])
    assert sorted(ours) == sorted(amax) and len(ours) > 50
    for k, v in amax.items():
        np.testing.assert_allclose(ours[k], v, rtol=1e-5, err_msg=str(k))
    assert all(m.tap is None for _, m in conv_layers(_port_model(fused)))


@pytest.mark.parametrize("which", ["all", "deep64"])
def test_quantize_params_bitwise(jax_fused, which):
    """From JAX's fused params and amax, w_q, s_w and s_x bit for bit, and
    the same convs left in float."""
    _, fused, amax, _ = jax_fused
    ref = jax_quantize(fused, amax, select=jax_select_all if which == "all"
                       else jax_select_deep(64))
    model = _port_model(fused)
    quantize_params(model, amax, select=select_all if which == "all" else select_deep(64))
    ours = export_jax_params(model)
    paths_ref = jax.tree_util.tree_leaves_with_path(ref)
    paths_ours = jax.tree_util.tree_leaves_with_path(ours)
    assert [p for p, _ in paths_ours] == [p for p, _ in paths_ref]
    n_q = 0
    for (path, a), (_, b) in zip(paths_ours, paths_ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if path[-1].key in ("w_q", "s_w", "s_x"):
            np.testing.assert_array_equal(a, b, err_msg=str(path))
            n_q += path[-1].key == "w_q"
    assert (n_q == len(amax)) if which == "all" else (0 < n_q < len(amax))


def test_int8_params_stay_float32_after_cast(jax_fused):
    """A bf16 cast of a quantized model leaves s_w, s_x and b float32 (they
    are float32 in the JAX package, which never casts params) and w_q int8;
    a move keeps them so."""
    _, fused, amax, _ = jax_fused
    model = quantize_params(_port_model(fused), amax, select=select_all)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.to(torch.bfloat16)
    model.to(device="cpu", dtype=torch.float16)
    convs = [m for _, m in conv_layers(model)]
    assert all(m.int8 for m in convs)
    for m in convs:
        assert m.w_q.dtype == torch.int8
        assert m.s_w.dtype == m.s_x.dtype == m.b.dtype == torch.float32
    after = model.state_dict()
    for k, v in before.items():  # the rest (PlainConv) is cast
        if k.endswith((".w_q", ".s_w", ".s_x")) or k[:-1] + "w_q" in before:
            assert torch.equal(v, after[k]), k


def test_quantized_tree_round_trip(jax_fused):
    """A JAX tree quantized with model= (so carrying __q_out__ / q_in) loads
    into the port and exports back as the same tree, annotations included,
    bit for bit (float32 0-d scales)."""
    model, fused, amax, _ = jax_fused
    ref = jax.tree_util.tree_map(np.asarray,
                                 jax_quantize(fused, amax, select=jax_select_all, model=model))
    assert any("__q_out__" in v for v in ref.values() if isinstance(v, dict))
    assert any("q_in" in v for v in ref.values() if isinstance(v, dict))
    ours = export_jax_params(_port_model(ref))
    expect = {k: v for k, v in ref.items() if v}
    a = jax.tree_util.tree_leaves_with_path(ours)
    b = jax.tree_util.tree_leaves_with_path(expect)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_forward_matches_jax(jax_fused, dtype):
    """JAX's quantized tree in the port: the head outputs agree with JAX's
    int8 forward in the compute dtype. Both quantize the same activations,
    but a float conv or silu rounded one ulp apart can put one activation on
    the other side of a rounding step and move that int8 code by one, which
    later layers carry on. Measured on this 64 px input: scores identical,
    boxes within 3.1e-5 px in float32 and identical in bf16; the limits are
    1e-5 (scores) and 1e-3 px (boxes)."""
    model, fused, amax, batch = jax_fused
    qtree = jax.tree_util.tree_map(np.asarray, jax_quantize(fused, amax, select=jax_select_all))
    ref = model(qtree, jnp.asarray(batch), Ctx(train=False, dtype=getattr(jnp, dtype)))
    port = _port_model(qtree).to(getattr(torch, dtype))
    with torch.no_grad():
        out = port(torch.from_numpy(batch).permute(0, 3, 1, 2).to(getattr(torch, dtype)))
    for t in TASKS:
        r = np.asarray(ref[t][0], np.float32)
        o = out[t][0].float().numpy()
        np.testing.assert_allclose(o[..., 4:], r[..., 4:], rtol=0, atol=1e-5)
        np.testing.assert_allclose(o[..., :4], r[..., :4], rtol=0, atol=1e-3)


def test_int8_inference_matches_jax(jax_fused):
    """The whole route: CerberusDetInference(int8="all") in both packages on
    the same float32 weights and the noise calibration batch. Same detections
    (task, label), scores within 1e-5 absolute and boxes within 1 px (the
    forward's limits above, after letterbox scaling and rounding)."""
    model, _, _, batch = jax_fused
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    for t in TASKS:  # distinct box biases: both tasks survive cross-task NMS
        for i in range(3):
            last = params[f"head_{t}"][f"box{i}"]["2"]
            last["b"] = rng.normal(0, 3, last["b"].shape).astype(np.float32)
    common = dict(names=NAMES, conf_thres=1e-3, img_size=IMG)
    ref = JaxInference(model=model, params=params, half=False, int8="all", **common)
    ours = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                params=params, dtype=torch.float32, device="cpu",
                                int8="all", **common)
    assert len(ours.int8_convs) == len(list(conv_layers(ours.model)))
    shapes = [(96, 128), (64, 64)]
    a = ours.predict(batch, original_shape=shapes)
    b = ref.predict(batch, original_shape=shapes)
    assert sum(map(len, a)) > 0 and all(
        sum(d["task"] == t for r in a for d in r) > 0 for t in TASKS)
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert (x["task"], x["label"]) == (y["task"], y["label"]), (x, y)
            assert abs(x["score"] - y["score"]) <= 1e-5, (x, y)
            assert max(abs(u - v) for u, v in zip(x["box"], y["box"])) <= 1, (x, y)


def test_int8_inference_options():
    """The fused float32 weights are what is quantized even when serving in
    bf16 (each within half a step of its code), use_kernel=False on the CPU
    gives the same results, and int8="deep" quantizes exactly the convs
    with at least 256 input channels."""
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    ref_w = fused_conv_weights(CerberusModel(CFG, TASKS, NCS, device="cpu").init(0).fuse())
    inf = CerberusDetInference(model=model, names=NAMES, conf_thres=1e-3, img_size=IMG,
                               dtype=torch.bfloat16, device="cpu", int8="all")
    for path, m in conv_layers(inf.model):
        w = unpack_weight(m.w_q, m.c1).permute(3, 2, 0, 1).float() * m.s_w[:, None, None, None]
        step = m.s_w[:, None, None, None]
        assert bool(((w - ref_w[path][0]).abs() <= 0.5001 * step).all()), path
        assert torch.equal(m.b, ref_w[path][1])
    x = np.random.default_rng(2).uniform(0, 1, (1, IMG, IMG, 3)).astype(np.float32)
    assert inf.predict(x) == inf.predict(x, use_kernel=False)
    assert all(m.use_kernel is None for m in inf.int8_convs)  # the hook lasts one call
    deep = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu").init(0),
                                names=NAMES, img_size=IMG, dtype=torch.float32,
                                device="cpu", int8="deep")
    assert deep.int8_convs
    assert all(m.int8 == (m.c1 >= 256) for _, m in conv_layers(deep.model))
    with pytest.raises(ValueError, match="int8"):
        CerberusDetInference(model=model, names=NAMES, device="cpu", int8="yes")


# ------------------------------------------- int8 carried between the blocks


def test_requant_bf16_mode_is_the_bf16_graph():
    """conv_s8's int8 output of the bf16-rounded y (q_dtype bfloat16) equals
    JAX's quantize_act of silu(y) cast to bf16, the value a bf16 serving
    graph hands to a block's __q_out__; the scale may be a float or a float32
    tensor, on the plain route and through the CPU wrapper. It differs from
    mode 3 (the Pallas q_out, y requantized in float32) where y lies a
    float32 ulp past a half step and its bf16 rounding on the step."""
    rng = np.random.default_rng(21)
    p = _ptq_params(rng, 40, 48, 3)
    tp = _torch_leaf(p)
    x = rng.normal(0, 1, (2, 9, 10, 40)).astype(np.float32)
    xq = quant_pack_s8_plain(_nchw(x), tp["s_x"], padded_channels(40))
    conv = (xq, tp["w_q"], tp["s_x"], tp["s_w"], tp["b"], 1, 1, True)
    y = conv_s8_plain(*conv, torch.float32)
    qs = torch.tensor(np.float32(0.7 * float(y.abs().max()) / 127.0))  # some codes clip
    got = conv_s8_plain(*conv, torch.int8, qs, torch.bfloat16)
    ref = jax_quantize_act(jnp.asarray(_nhwc(y)).astype(jnp.bfloat16), jnp.float32(qs))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    assert int((got.abs() == 127).sum()) > 0
    before = conv_s8.launches
    assert torch.equal(conv_s8(*conv, torch.int8, qs, q_dtype=torch.bfloat16), got)
    assert conv_s8.launches == before
    # a half step: acc 0, bias 2.5 + 1 float32 ulp, q_scale 1
    one = torch.zeros((1, 1, 1, 16), dtype=torch.int8)
    one[..., 0] = 1
    w1 = one.clone()
    half = (torch.zeros_like(one), w1, torch.tensor(1.0), torch.ones(1),
            torch.from_numpy(np.nextafter(np.float32([2.5]), np.float32(3))), 1, 0, False,
            torch.int8, torch.tensor(1.0))
    assert int(conv_s8_plain(*half, torch.float32)) == 3
    assert int(conv_s8_plain(*half, torch.bfloat16)) == 2
    y_half = conv_s8_plain(*half[:8], torch.float32)
    assert int(np.asarray(jax_quantize_act(jnp.asarray(y_half.numpy()).astype(jnp.bfloat16),
                                           jnp.float32(1.0))).reshape(())) == 2
    with pytest.raises(TypeError, match="requantizes"):
        conv_s8(*half, q_dtype=torch.float16)


@pytest.mark.parametrize("use_kernel", [None, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_int8_q_out_is_quantize_of_its_output(dtype, use_kernel):
    """conv2d_int8(..., q_out=s) is quantize_act of the output in the compute
    dtype, bit for bit, from float and from int8 activations, on both
    routes (conv_s8's shape class and the integer route of a 5x5 depthwise
    conv)."""
    rng = np.random.default_rng(5)
    cases = [(_ptq_params(rng, 24, 32, 3), 1, 1), (_ptq_params(rng, 1, 24, 5), 24, 1)]
    for p, groups, s in cases:
        ci = p["w_q"].shape[2] * groups
        tp = _torch_leaf(p)
        x = torch.from_numpy(rng.normal(0, 1, (2, ci, 7, 8)).astype(np.float32)).to(dtype)
        q = torch.tensor(np.float32(0.02))
        kw = dict(act=True, out_dtype=dtype, use_kernel=use_kernel, groups=groups)
        for xin in (x, quantize_act(x, tp["s_x"])):
            ref = quantize_act(conv2d_int8(xin, tp, s, **kw), q)
            got = conv2d_int8(xin, tp, s, q_out=q, **kw)
            assert got.dtype == torch.int8 and torch.equal(got, ref), (groups, dtype)


@pytest.fixture(scope="module")
def jax_fused128():
    """(JAX model, fused params as numpy float32, JAX float32 amax, batch) of
    yolov8n_2task at 128 px."""
    model = JaxModel(CFG, TASKS, NCS)
    fused = jax.tree_util.tree_map(np.asarray, model.fuse(model.init(jax.random.PRNGKey(3))))
    batch = np.random.default_rng(3).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    amax = jax_calibrate(model, fused, [batch], dtype=jnp.float32)
    return model, fused, amax, batch


def _jax_annotations(tree):
    return {(uid, k): float(np.asarray(v[k])) for uid, v in tree.items()
            if isinstance(v, dict) for k in ("__q_out__", "q_in") if k in v}


def _annotations(model):
    """The port's annotations under the JAX tree's names."""
    return {(uid, ACT_QUANT[k]): v for (uid, k), v in act_quant_annotations(model).items()}


@pytest.mark.parametrize("which", ["all", "deep64"])
def test_propagate_matches_jax(jax_fused128, which):
    """quantize_params(..., propagate=True) annotates the blocks that JAX's
    quantize_params(..., model=model) annotates, each with the same float32
    scale: every int8 Conv in "all", and a selection where some consumers
    stay float (c_in >= 64) and their producers keep float outputs."""
    model, fused, amax, _ = jax_fused128
    jsel, sel = ((jax_select_all, select_all) if which == "all"
                 else (jax_select_deep(64), select_deep(64)))
    want = _jax_annotations(jax_quantize(fused, amax, select=jsel, model=model))
    port = quantize_params(_port_model(fused), amax, select=sel, propagate=True)
    got = _annotations(port)
    assert got == want and len(want) > 10
    assert all(float(np.float32(v)) == v for v in got.values())
    kinds = {k for _, k in want}
    assert kinds == {"__q_out__", "q_in"}
    if which == "deep64":
        assert len(want) < len(_jax_annotations(
            jax_quantize(fused, amax, select=jax_select_all, model=model)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_propagated_forward_is_bitwise_unpropagated(jax_fused, dtype):
    """The annotated model's heads equal the unannotated model's bit for bit
    (JAX's claim, tests/test_quant.py), in float32 and bf16, while every
    annotated block whose last Conv is int8 hands on the int8 that Conv
    wrote (utils/profiling.py:check_requant on the CPU)."""
    from cerberusdet_tpu_torch.utils.profiling import check_requant

    _, fused, amax, batch = jax_fused
    plain = quantize_params(_port_model(fused), amax, select=select_all).to(dtype)
    prop = quantize_params(_port_model(fused), amax, select=select_all,
                           propagate=True).to(dtype)
    assert not act_quant_annotations(plain) and act_quant_annotations(prop)
    x = torch.from_numpy(batch).permute(0, 3, 1, 2).to(dtype)
    with torch.no_grad():
        a, b = plain(x), prop(x)
        n = check_requant(prop, prop, x, "test")
    assert n > 10
    for t in TASKS:
        assert torch.equal(a[t][0], b[t][0])
        assert all(torch.equal(u, v) for u, v in zip(a[t][1], b[t][1]))


def test_propagated_inference_matches_jax(jax_fused):
    """CerberusDetInference(int8="all") propagates as the JAX package's does:
    the same annotated blocks, their scales within the calibration's rtol
    1e-5 (test_calibrate_amax_matches_jax), and the same detections within
    the limits of test_int8_inference_matches_jax."""
    model, _, _, batch = jax_fused
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    for t in TASKS:  # distinct box biases: both tasks survive cross-task NMS
        for i in range(3):
            last = params[f"head_{t}"][f"box{i}"]["2"]
            last["b"] = rng.normal(0, 3, last["b"].shape).astype(np.float32)
    common = dict(names=NAMES, conf_thres=1e-3, img_size=IMG)
    ref = JaxInference(model=model, params=params, half=False, int8="all", **common)
    ours = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                params=params, dtype=torch.float32, device="cpu",
                                int8="all", **common)
    want = _jax_annotations(jax.tree_util.tree_map(np.asarray, ref.params))
    got = _annotations(ours.model)
    assert want and sorted(got) == sorted(want)
    for k, v in want.items():  # each package calibrates: amax within rtol 1e-5
        np.testing.assert_allclose(got[k], v, rtol=1e-5, err_msg=str(k))
    a = ours.predict(batch)
    b = ref.predict(batch)
    assert sum(map(len, a)) > 0 and len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            assert (x["task"], x["label"]) == (y["task"], y["label"]), (x, y)
            assert abs(x["score"] - y["score"]) <= 1e-5, (x, y)
            assert max(abs(u - v) for u, v in zip(x["box"], y["box"])) <= 1, (x, y)


def test_annotations_survive_cast_and_round_trips(jax_fused, tmp_path):
    """The annotations stay float32 through a bf16 cast and a move, and a
    propagated model goes to a tree, a .ckpt.npz and back with the same
    annotations and leaves, bit for bit; loading a tree replaces the
    model's annotations with the tree's (none for a plain tree)."""
    _, fused, amax, batch = jax_fused
    model = quantize_params(_port_model(fused), amax, select=select_all, propagate=True)
    before = act_quant_annotations(model)
    model.to(torch.bfloat16).to(device="cpu")
    for uid in model.block_nodes:
        for name in ACT_QUANT:
            t = model.block(uid)._buffers.get(name)
            assert t is None or (t.dtype == torch.float32 and t.shape == ())
    assert act_quant_annotations(model) == before
    tree = export_jax_params(model.float())  # numpy has no bfloat16
    path = tmp_path / "prop.ckpt.npz"
    save_checkpoint(path, tree, {"cfg": CFG}, half=False)
    back = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"),
                           load_checkpoint(path)["params"])
    assert act_quant_annotations(back) == before
    a = jax.tree_util.tree_leaves_with_path(export_jax_params(back))
    b = jax.tree_util.tree_leaves_with_path(tree)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, u), (_, v) in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape, p
        np.testing.assert_array_equal(u, v, err_msg=str(p))
    plain = jax.tree_util.tree_map(np.asarray, jax_quantize(fused, amax, select=jax_select_all))
    assert not act_quant_annotations(load_jax_params(back, plain))


def test_quantized_model_refuses_calibration(jax_fused):
    """Calibrating an annotated or quantized model would skip the Convs
    whose input is int8 (annotated producers, the pre-concat quantizes of
    the blocks): both are refused. quantize_params without propagate leaves
    no annotation behind."""
    _, fused, amax, batch = jax_fused
    model = quantize_params(_port_model(fused), amax, select=select_deep(64), propagate=True)
    assert act_quant_annotations(model)
    with pytest.raises(ValueError, match="float model"):
        calibrate_amax(model, [batch])
    clear_act_quant(model)
    assert not act_quant_annotations(model)
    with pytest.raises(ValueError, match="float model"):
        calibrate_amax(model, [batch])
    quantize_params(model, amax, select=select_all, propagate=True)
    assert act_quant_annotations(model)
    quantize_params(model, amax, select=select_all)
    assert not act_quant_annotations(model)
