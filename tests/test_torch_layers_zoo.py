"""The six blocks the port adds to its main layer registry (DWConv, C2, C3,
SPP, Focus, GhostConv; cerberusdet_tpu/nn/layers.py:85-333), their int8
forms and the int8 routes they need, against the JAX package.

Blocks alone: eval and fused forwards in float32 (the limits of
tests/test_torch_layers.py), a training forward's outputs and BatchNorm
statistics. A tiny 2-task yaml that uses all six (written by the test):
float64 forwards on the BatchNorm tree and fused within rtol 1e-9, and the
int8 "all" forward, propagated as JAX propagates it (the same annotations),
within the limits of tests/test_torch_quant.py:test_int8_forward_matches_jax
and bit for bit equal to the unpropagated one. The grouped / 5x5 int8 sums
equal lax's integer convolution exactly, the int8 max pool's bf16 route
equals the int8 one, and a conv past the int32 sums' exactness bound is
refused."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from jax import lax

from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.models.config import parse_model_cfg as jax_parse
from cerberusdet_tpu.nn import layers as jl
from cerberusdet_tpu.nn.module import Ctx
from cerberusdet_tpu.quant import calibrate_amax as jax_calibrate
from cerberusdet_tpu.quant import quantize_params as jax_quantize
from cerberusdet_tpu.quant import select_all as jax_select_all
from cerberusdet_tpu_torch.manager.weights import load_jax_params, load_jax_tree
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.models.config import parse_model_cfg
from cerberusdet_tpu_torch.nn import layers as tl
from cerberusdet_tpu_torch.nn.layers import ACT_QUANT
from cerberusdet_tpu_torch.ops.conv_int8_cuda import conv_sums_s8, int8_sums_fit, pack_weight
from cerberusdet_tpu_torch.quant import (
    act_quant_annotations,
    calibrate_amax,
    conv_layers,
    quantize_params,
    select_all,
)
from cerberusdet_tpu_torch.testing import ZOO_CFG
from cerberusdet_tpu_torch.utils.profiling import check_requant

TASKS, NCS = ["a", "b"], [3, 5]


def _randomize_bn(tree, rng):
    """Non-trivial BatchNorm statistics, so the BN path is exercised."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.2, c).astype(np.float32),
                "mean": rng.normal(0, 0.2, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return {k: _randomize_bn(v, rng) for k, v in tree.items()}


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).double().numpy()


def _close(ours, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


BLOCKS = {
    "dwconv": (lambda m: m.DWConv(16, 32, 3, 2), (2, 12, 12, 16)),
    "dwconv_depthwise_k5": (lambda m: m.DWConv(24, 24, 5, 1), (2, 9, 9, 24)),
    "c2": (lambda m: m.C2(32, 32, 2, True), (2, 8, 8, 32)),
    "c2_no_shortcut_g2": (lambda m: m.C2(32, 48, 1, False, 2), (1, 8, 8, 32)),
    "c3": (lambda m: m.C3(32, 32, 2, True), (2, 8, 8, 32)),
    "c3_n0": (lambda m: m.C3(32, 24, 0), (1, 6, 6, 32)),
    "spp": (lambda m: m.SPP(32, 48, (5, 9, 13)), (2, 7, 7, 32)),
    "focus": (lambda m: m.Focus(3, 16, 3), (2, 16, 16, 3)),
    "ghostconv": (lambda m: m.GhostConv(16, 32, 3, 2), (2, 12, 12, 16)),
    "ghostconv_k1": (lambda m: m.GhostConv(32, 32), (1, 8, 8, 32)),
}


def _block_pair(name, seed):
    make, shape = BLOCKS[name]
    tree = jax.tree_util.tree_map(np.asarray, make(jl).init(jax.random.PRNGKey(seed)))
    tree = _randomize_bn(tree, np.random.default_rng(seed))
    layer = make(tl)
    load_jax_tree(layer, tree)
    x = np.random.default_rng(seed + 1).normal(0, 1, shape).astype(np.float32)
    return make(jl), jax.tree_util.tree_map(jnp.asarray, tree), layer, x


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    """Eval forward on the BatchNorm tree, and fused on JAX's fused tree."""
    jblock, p, layer, x = _block_pair(name, seed=len(name))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        _close(_nhwc(layer.eval()(xt)), jblock(p, jnp.asarray(x), Ctx(train=False)))
        for m in layer.modules():
            if isinstance(m, tl.Conv):
                m.fuse()
        ref = jblock(jax.tree_util.tree_map(jnp.asarray, _fuse_tree(jblock, p)),
                     jnp.asarray(x), Ctx(train=False))
        _close(_nhwc(layer(xt)), ref)


def _fuse_tree(block, p):
    """The JAX block's tree with every Conv's BatchNorm folded (the JAX
    CerberusModel.fuse does this per block)."""
    def walk(node):
        if isinstance(node, dict) and "bn" in node and "w" in node:
            return jl.Conv(1, 1).fuse(node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(p)


@pytest.mark.parametrize("name", ["dwconv", "c2", "c3", "spp", "focus", "ghostconv"])
def test_block_training_batchnorm_matches_jax(name):
    """A training forward: outputs on the batch statistics, and each
    BatchNorm's running statistics folded with JAX's collected batch
    statistics ((1 - 0.03) * running + 0.03 * batch)."""
    jblock, p, layer, x = _block_pair(name, seed=3 * len(name))
    ctx = Ctx(train=True)
    ref = jblock(p, jnp.asarray(x), ctx)
    bns = {n: (m.running_mean.clone(), m.running_var.clone())
           for n, m in layer.named_modules() if isinstance(m, tl.BatchNorm)}
    out = layer.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(_nhwc(out), ref, rtol=1e-4)
    assert len(ctx.updates) == 2 * len(bns) > 0
    for path, v in ctx.updates.items():
        name_, stat = ".".join(path[:-2]), path[-1]
        mean0, var0 = bns[name_ + ".bn" if name_ else "bn"]
        old = mean0 if stat == "mean" else var0
        m = layer.get_submodule((name_ + ".bn") if name_ else "bn")
        new = m.running_mean if stat == "mean" else m.running_var
        _close(new.detach().numpy(), 0.97 * old.numpy() + 0.03 * np.asarray(v), rtol=1e-5)


def test_config_parser_builds_the_six_blocks(tmp_path):
    """The port's parser builds every block of the zoo yaml, with the JAX
    parser's channels, routing and strides."""
    cfg = tmp_path / "zoo.yaml"
    cfg.write_text(yaml.safe_dump(ZOO_CFG))
    ours = parse_model_cfg(str(cfg))
    ref = jax_parse(str(cfg))
    assert {n.name for n in ours.nodes} >= {"DWConv", "C2", "C3", "SPP", "Focus", "GhostConv"}
    assert [(n.idx, n.frm, n.name, n.c2, n.log2_stride) for n in ours.nodes] == \
        [(n.idx, n.frm, n.name, n.c2, n.log2_stride) for n in ref.nodes]
    assert (ours.head_from, ours.head_strides, ours.head_ch) == \
        (ref.head_from, ref.head_strides, ref.head_ch)
    for n, r in zip(ours.nodes, ref.nodes):
        assert type(n.layer).__name__ == type(r.layer).__name__


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """(cfg path, JAX model, its params with random BatchNorm statistics as
    numpy float32, a (2, 64, 64, 3) batch)."""
    cfg = tmp_path_factory.mktemp("zoo") / "zoo.yaml"
    cfg.write_text(yaml.safe_dump(ZOO_CFG))
    model = JaxModel(str(cfg), TASKS, NCS)
    params = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(5)))
    params = _randomize_bn(params, np.random.default_rng(5))
    x = np.random.default_rng(6).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return str(cfg), model, params, x


@pytest.mark.parametrize("fused", [False, True])
def test_zoo_model_float64_matches_jax(zoo, fused):
    """All heads of the zoo model in float64, on the BatchNorm tree and
    fused (in float64 in both packages): the maps within rtol 1e-9 (float64
    sums in other orders), the predictions, which both packages decode in
    float32, within rtol 1e-5."""
    cfg, model, params, x = zoo
    with jax.enable_x64():
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        if fused:
            p64 = model.fuse(p64)
        ref = model(p64, jnp.asarray(x, jnp.float64), Ctx(train=False, dtype=jnp.float64))
        ref = jax.tree_util.tree_map(np.asarray, ref)
    ours = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"), params)
    ours = ours.to(torch.float64).eval()
    if fused:
        ours.fuse()
    with torch.no_grad():
        out = ours(torch.from_numpy(x).permute(0, 3, 1, 2).double())
    for t in TASKS:
        for f, tf in zip(ref[t][1], out[t][1]):
            _close(_nhwc(tf), f, 1e-9)
        _close(out[t][0].double().numpy(), ref[t][0], 1e-5)


def test_zoo_model_int8_all_matches_jax(zoo):
    """int8 "all" (the grouped and 5x5 Convs on the integer route) from
    JAX's fused params and amax: the port annotates the blocks JAX
    annotates with the same scales, its propagated float32 forward agrees
    with JAX's within test_int8_forward_matches_jax's limits (scores 1e-5,
    boxes 1e-3 px) and equals its unpropagated forward bit for bit, and
    every annotated block hands on the int8 its last Conv wrote."""
    cfg, model, params, x = zoo
    fused = jax.tree_util.tree_map(np.asarray, model.fuse(params))
    amax = jax_calibrate(model, fused, [x], dtype=jnp.float32)
    qtree = jax_quantize(fused, amax, select=jax_select_all, model=model)
    ref = model(qtree, jnp.asarray(x), Ctx(train=False, dtype=jnp.float32))
    port = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"), fused).eval()
    assert sorted(calibrate_amax(port, [x])) == sorted(amax)
    plain = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"), fused).eval()
    quantize_params(port, amax, select=select_all, propagate=True)
    quantize_params(plain, amax, select=select_all)
    convs = [m for _, m in conv_layers(port)]
    assert all(m.int8 for m in convs) and sum(not m.s8_kernel for m in convs) >= 4
    want = {(uid, k): float(np.asarray(v[k])) for uid, v in qtree.items()
            if isinstance(v, dict) for k in ("__q_out__", "q_in") if k in v}
    got = {(uid, ACT_QUANT[k]): v for (uid, k), v in act_quant_annotations(port).items()}
    assert got == want and len(want) > 10
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out, out_plain = port(xt), plain(xt)
        assert check_requant(port, port, xt, "zoo") > 5
    for t in TASKS:
        r = np.asarray(ref[t][0], np.float32)
        o = out[t][0].numpy()
        np.testing.assert_allclose(o[..., 4:], r[..., 4:], rtol=0, atol=1e-5)
        np.testing.assert_allclose(o[..., :4], r[..., :4], rtol=0, atol=1e-3)
        assert torch.equal(out[t][0], out_plain[t][0])


@pytest.mark.parametrize("ci,co,k,s,d,g,hw", [
    (24, 24, 5, 1, 1, 24, (9, 10)),     # GhostConv's 5x5 depthwise
    (16, 32, 3, 2, 1, 16, (11, 12)),    # DWConv c2 = 2 c1
    (32, 48, 3, 1, 1, 2, (7, 7)),       # a grouped bottleneck conv
    (8, 16, 5, 2, 1, 1, (13, 9)),       # k 5, groups 1
    (8, 8, 3, 1, 2, 1, (10, 10)),       # dilation 2
    (12, 6, (1, 3), (1, 2), 1, 3, (8, 9)),  # rectangular kernel and stride
])
def test_taps_route_is_lax_integer_conv(ci, co, k, s, d, g, hw):
    """The int32 sums of the convs conv_s8 does not take equal lax's int8
    convolution with int32 accumulation (the JAX package's conv2d_int8)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    sh, sw = (s, s) if isinstance(s, int) else s
    rng = np.random.default_rng(ci * co + kh)
    x = rng.integers(-127, 128, (2, *hw, ci), dtype=np.int8)
    w = rng.integers(-127, 128, (kh, kw, ci // g, co), dtype=np.int8)
    ph, pw = d * (kh - 1) // 2, d * (kw - 1) // 2
    ref = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (sh, sw), [(ph, ph), (pw, pw)], rhs_dilation=(d, d),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=g,
        preferred_element_type=jnp.int32)
    got = conv_sums_s8(torch.from_numpy(x).permute(0, 3, 1, 2), pack_weight(torch.from_numpy(w)),
                       (sh, sw), (ph, pw), d, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref))


def test_int8_route_refuses_sums_past_its_bound():
    """A 5x5 conv over 5325 channels sums at most 5325 * 25 * 127^2 <
    2^31 and is exact at the extremes; one more channel can overflow int32
    and is refused when the Conv is quantized."""
    assert int8_sums_fit(5, 5, 5325) and not int8_sums_fit(5, 5, 5326)
    x = torch.full((1, 5325, 5, 5), 127, dtype=torch.int8)
    w = torch.full((5, 5, 5325, 1), -127, dtype=torch.int8)
    got = conv_sums_s8(x, pack_weight(w), 1, 0)
    assert int(got) == -5325 * 25 * 127 * 127
    ok, big = tl.Conv(5325, 1, 5), tl.Conv(5326, 1, 5)
    for conv in (ok, big):
        conv.fuse()
    ok.to_int8()
    assert ok.int8 and not ok.s8_kernel
    with pytest.raises(ValueError, match="2\\^31"):
        big.to_int8()
    dw = tl.DWConv(64, 64, 5)
    dw.fuse()
    dw.to_int8()
    assert dw.w_q.shape == (64, 5, 5, 16) and not dw.s8_kernel


def test_int8_max_pool_routes_agree():
    """The int8 pools of SPP / SPPF: the card's route (bf16, which holds
    every int8 exactly) equals the int8 pool the CPU runs, and JAX's
    reduce_window with the int8 minimum as its padding, at every SPP k."""
    x = torch.from_numpy(np.random.default_rng(8).integers(
        -127, 128, (2, 6, 11, 13), dtype=np.int8))
    x[0, 0] = -127  # a plane of the lowest code: padding must never win
    for k in (5, 9, 13):
        cpu = tl.max_pool(x, k)
        card_route = F.max_pool2d(x.to(torch.bfloat16), k, 1, k // 2).to(torch.int8)
        ref = jl.max_pool(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), k)
        assert cpu.dtype == torch.int8 and torch.equal(cpu, card_route)
        np.testing.assert_array_equal(cpu.permute(0, 2, 3, 1).numpy(), np.asarray(ref))
