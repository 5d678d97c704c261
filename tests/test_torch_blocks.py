"""The blocks of the JAX package's second layer registry (BottleneckCSP to
ImplicitM, cerberusdet_tpu/nn/layers.py:472-824) and their helpers, in the
port (cerberusdet_tpu_torch/nn/layers.py), against the JAX package.

Tolerances, and why:
  * each of the seventeen classes alone, on JAX's parameters (random
    BatchNorm statistics) in float64 in both packages: rtol 1e-9 (float64
    sums in other orders) where the JAX layer stays in float64, rtol 1e-5
    with an atol of 1e-5 times the largest output where it rounds to
    float32: its BN casts its input to float32 (layers.py:504), and its
    Linear and MultiheadAttention sum with preferred_element_type float32
    (layers.py:533, 574-598), so a float64 forward through them carries
    float32 rounding (~6e-8 a step, a few steps deep);
  * a yaml with the four blocks the JAX parser builds: node for node as
    JAX parses it, and its float32 forward within test_forward_matches_jax's
    limits (tests/test_torch_cerberus.py: rtol 1e-4, atol 1e-4 of the
    largest value);
  * int8 "all" propagated on that yaml: the annotations JAX's
    propagate_act_quant writes (C3TR is a C3 to it), and the forward within
    tests/test_torch_quant.py:test_int8_forward_matches_jax's limits
    (scores 1e-5, boxes 1e-3 px);
  * the weight bridge both ways: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.models.config import parse_model_cfg as jax_parse
from cerberusdet_tpu.nn import layers as jl
from cerberusdet_tpu.nn.module import Ctx
from cerberusdet_tpu.quant import calibrate_amax as jax_calibrate
from cerberusdet_tpu.quant import quantize_params as jax_quantize
from cerberusdet_tpu.quant import select_all as jax_select_all
from cerberusdet_tpu_torch.manager.weights import (
    export_jax_params,
    export_jax_tree,
    load_jax_params,
    load_jax_tree,
)
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.models.config import parse_model_cfg
from cerberusdet_tpu_torch.nn import layers as tl
from cerberusdet_tpu_torch.nn.layers import ACT_QUANT, last_conv
from cerberusdet_tpu_torch.quant import act_quant_annotations, conv_layers, quantize_params
from cerberusdet_tpu_torch.quant import select_all
from cerberusdet_tpu_torch.testing import BLOCKS_CFG
from cerberusdet_tpu_torch.utils.profiling import check_requant

TASKS, NCS = ["a", "b"], [3, 5]
F32_ROUNDED = 1e-5  # a JAX layer that rounds to float32 inside (BN, Linear, attention)
F64 = 1e-9


def _randomize_bn(tree, rng):
    """Non-trivial BatchNorm statistics and attention biases (both start at
    constants), so those paths are exercised."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.2, c).astype(np.float32),
                "mean": rng.normal(0, 0.2, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    if "in_b" in tree:
        return {**tree, **{k: rng.normal(0, 0.2, tree[k].shape).astype(np.float32)
                           for k in ("in_b", "out_b")}}
    return {k: _randomize_bn(v, rng) for k, v in tree.items()}


def _seeded(layer, seed):
    """The port's layer drawn from `seed` (nn/layers.py:SEEDED), and its
    parameters as a JAX-layout tree of numpy float32."""
    gen = torch.Generator().manual_seed(seed)
    for m in layer.modules():
        if isinstance(m, tl.SEEDED):
            m.reset(gen)
    return layer, export_jax_tree(layer)


def _jax_layout(tree, jax_init, key):
    """The tree, which must have the keys and shapes of the JAX layer's own
    init (traced for its shapes only), with the empty dicts that JAX keeps
    for a parameterless layer (Identity, Concat) put back."""
    def prune(t):
        return {k: prune(v) for k, v in t.items() if v != {}} if isinstance(t, dict) else t

    def complete(t, ref):
        if not isinstance(ref, dict):
            return t
        return {k: complete(t[k], v) if v != {} else {} for k, v in ref.items()}

    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jax.eval_shape(jax_init, key))
    assert jax.tree_util.tree_map(np.shape, tree) == prune(shapes)
    return complete(tree, shapes)


def _close(ours, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _mha(m):
    return m.MultiheadAttention(32, 4)


# name -> (constructor over a layer module, input: an NHWC shape, a (B, N, C)
# sequence shape "seq", or "qkv" for three of them, the tolerance)
CLASSES = {
    "identity": (lambda m: m.Identity(), (2, 6, 7, 8), F64),
    "bareconv_3x3s2": (lambda m: m.BareConv(16, 24, 3, 2), (2, 10, 12, 16), F64),
    "bareconv_g2_p0": (lambda m: m.BareConv(16, 8, 3, 1, 0, 2), (1, 9, 9, 16), F64),
    "bn": (lambda m: m.BN(16), (2, 5, 6, 16), F32_ROUNDED),
    "linear": (lambda m: m.Linear(24, 16), ("seq", 2, 10, 24), F32_ROUNDED),
    "linear_nobias": (lambda m: m.Linear(16, 16, bias=False), ("seq", 1, 7, 16), F32_ROUNDED),
    "multiheadattention": (_mha, ("qkv", 2, 12, 32), F32_ROUNDED),
    "bottleneckcsp": (lambda m: m.BottleneckCSP(32, 32, 2, True), (2, 8, 8, 32), F32_ROUNDED),
    "bottleneckcsp_g2": (lambda m: m.BottleneckCSP(32, 48, 1, False, 2), (1, 6, 6, 32),
                         F32_ROUNDED),
    "transformerlayer": (lambda m: m.TransformerLayer(32, 4), ("seq", 2, 9, 32), F32_ROUNDED),
    "transformerblock": (lambda m: m.TransformerBlock(16, 32, 4, 2), (2, 4, 5, 16),
                         F32_ROUNDED),
    "c3tr": (lambda m: m.C3TR(32, 32, 1), (2, 4, 4, 32), F32_ROUNDED),
    "c3spp": (lambda m: m.C3SPP(32, 48, (3, 5)), (2, 7, 7, 32), F64),
    "crossconv": (lambda m: m.CrossConv(16, 16, 3, 1, 1, 1.0, True), (2, 9, 8, 16), F64),
    "crossconv_s2": (lambda m: m.CrossConv(16, 24, 3, 2, 1, 0.5), (2, 10, 10, 16), F64),
    "ghostbottleneck": (lambda m: m.GhostBottleneck(32, 32, 3, 1), (2, 8, 8, 32), F64),
    "ghostbottleneck_s2": (lambda m: m.GhostBottleneck(16, 32, 3, 2), (2, 10, 10, 16), F64),
    "mixconv2d": (lambda m: m.MixConv2d(24, 24, (1, 3, 5)), (2, 7, 8, 24), F32_ROUNDED),
    "contract": (lambda m: m.Contract(2), (2, 6, 8, 5), F64),
    "expand": (lambda m: m.Expand(2), (2, 3, 4, 12), F64),
    "implicita": (lambda m: m.ImplicitA(12), (2, 5, 5, 12), F64),
    "implicitm": (lambda m: m.ImplicitM(12), (2, 5, 5, 12), F64),
}


def _inputs(spec, seed):
    """(JAX input, port input) of one case, float64, the same values."""
    rng = np.random.default_rng(seed)
    if spec[0] in ("seq", "qkv"):
        xs = [rng.normal(0, 1, spec[1:]) for _ in range(3 if spec[0] == "qkv" else 1)]
        j, t = [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]
        return (tuple(j), tuple(t)) if spec[0] == "qkv" else (j[0], t[0])
    x = rng.normal(0, 1, spec)
    return jnp.asarray(x), torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_matches_jax_float64(name):
    """Every class of the second registry and its helpers (seventeen, some
    in two shapes), eval forward in float64 on the same parameters: the
    port's seeded draw in the JAX layout (the keys and shapes of JAX's
    init), BatchNorm statistics and attention biases randomized, loaded
    into both."""
    make, spec, rtol = CLASSES[name]
    seed = len(name)
    jblock = make(jl)
    layer, tree = _seeded(make(tl), seed)
    tree = _jax_layout(tree, jblock.init, jax.random.PRNGKey(seed))
    tree = _randomize_bn(tree, np.random.default_rng(seed))
    load_jax_tree(layer, tree)
    layer = layer.double().eval()
    with jax.enable_x64():
        xj, xt = _inputs(spec, seed + 1)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        ref = np.asarray(jax.jit(lambda p, x: jblock(p, x, Ctx(train=False,
                                                               dtype=jnp.float64)))(p64, xj))
    with torch.no_grad():
        out = layer(xt)
    assert out.dtype == torch.float64
    out = out.numpy() if out.dim() == 3 else out.permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    _close(out, ref, rtol)


def test_mixconv2d_unequal_split_raises_as_jax():
    for m in (jl, tl):
        with pytest.raises(NotImplementedError, match="equal-weight"):
            m.MixConv2d(8, 8, (1, 3), 1, equal_ch=False)


def test_registry_has_every_jax_name():
    assert set(tl.LAYERS) == set(jl.LAYERS)
    for name, cls in jl.LAYERS.items():
        assert tl.LAYERS[name].__name__ == cls.__name__
    assert issubclass(tl.C3TR, tl.C3) and issubclass(tl.C3SPP, tl.C3)
    assert last_conv(tl.C3TR(16, 16)) is not None and last_conv(tl.C3SPP(16, 16)) is not None


@pytest.mark.parametrize("row", [
    [-1, 1, "MixConv2d", [64]], [-1, 1, "Contract", [2]], [-1, 1, "Expand", [2]],
    [-1, 1, "TransformerLayer", [64, 4]], [-1, 1, "TransformerBlock", [64, 64, 4, 1]],
    [-1, 1, "ImplicitA", [64]], [-1, 1, "ImplicitM", [64]],
    [-1, 1, "C3SPP", [64]], [-1, 1, "C3SPP", [64, [5, 9, 13]]],
])
def test_yaml_refusals_match_jax(row):
    """The seven modules the JAX parser does not build from yaml raise its
    ValueError; a C3SPP row raises its TypeError (the repeat count lands on
    C3SPP's k)."""
    cfg = {"backbone": [[-1, 1, "Conv", [64, 3, 2]], row], "head": [[[1], 1, "Detect", []]]}
    with pytest.raises(Exception) as ref:
        jax_parse(cfg)
    with pytest.raises(type(ref.value)) as ours:
        with torch.device("meta"):
            parse_model_cfg(cfg)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("row", [[-1, 1, "CrossConv", [64, 3, 2]],
                                 [-1, 1, "GhostBottleneck", [64, 3, 2]]])
def test_stride_rule_matches_jax(row):
    """A stride counts only for Conv, DWConv, GhostConv and Focus: a
    CrossConv or GhostBottleneck at s=2 keeps its input's log2_stride."""
    cfg = {"backbone": [[-1, 1, "Conv", [64, 3, 2]], row], "head": [[[1], 1, "Detect", []]]}
    with torch.device("meta"):
        ours = parse_model_cfg(cfg)
    ref = jax_parse(cfg)
    assert [n.log2_stride for n in ours.nodes] == [n.log2_stride for n in ref.nodes] == [1, 1]


@pytest.fixture(scope="module")
def blocks(tmp_path_factory):
    """(cfg path, JAX model, params in its layout as numpy float32 (the
    port's seeded init, with JAX init's keys and shapes) with random
    BatchNorm statistics, a (2, 64, 64, 3) batch)."""
    cfg = tmp_path_factory.mktemp("blocks") / "blocks.yaml"
    cfg.write_text(yaml.safe_dump(BLOCKS_CFG))
    model = JaxModel(str(cfg), TASKS, NCS)
    params = export_jax_params(CerberusModel(str(cfg), TASKS, NCS, device="cpu").init(7))
    params = _jax_layout(params, model.init, jax.random.PRNGKey(7))
    params = _randomize_bn(params, np.random.default_rng(7))
    x = np.random.default_rng(8).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    return str(cfg), model, params, x


def _jax_forward(model, dtype):
    return jax.jit(lambda p, x: model(p, x, Ctx(train=False, dtype=dtype)))


def test_blocks_yaml_parses_as_jax(blocks):
    cfg = blocks[0]
    ours, ref = parse_model_cfg(cfg), jax_parse(cfg)
    assert {n.name for n in ours.nodes} >= {"BottleneckCSP", "C3TR", "CrossConv",
                                             "GhostBottleneck"}
    assert [(n.idx, n.frm, n.name, n.section, n.c2, n.log2_stride) for n in ours.nodes] == \
        [(n.idx, n.frm, n.name, n.section, n.c2, n.log2_stride) for n in ref.nodes]
    assert (ours.n_backbone, ours.head_from, ours.head_strides, ours.head_ch, ours.cerber) == \
        (ref.n_backbone, ref.head_from, ref.head_strides, ref.head_ch, ref.cerber)
    for n, r in zip(ours.nodes, ref.nodes):
        assert type(n.layer).__name__ == type(r.layer).__name__


@pytest.mark.parametrize("fused", [False, True])
def test_blocks_yaml_forward_matches_jax(blocks, fused):
    """All heads of the blocks' yaml in float32, on the BatchNorm tree and
    fused (the standalone BN of BottleneckCSP stays, as JAX's fuse leaves
    it): maps and predictions within test_forward_matches_jax's limits."""
    cfg, model, params, x = blocks
    p = model.fuse(params) if fused else params
    ref = _jax_forward(model, jnp.float32)(jax.tree_util.tree_map(jnp.asarray, p),
                                           jnp.asarray(x))
    ours = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"),
                           jax.tree_util.tree_map(np.asarray, p)).eval()
    assert ours.fused == fused
    with torch.no_grad():
        out = ours(torch.from_numpy(x).permute(0, 3, 1, 2))
    for t in TASKS:
        pred, feats = ref[t]
        for f, tf in zip(feats, out[t][1]):
            _close(tf.permute(0, 2, 3, 1).numpy(), f, 1e-4)
        _close(out[t][0].numpy(), pred, 1e-4)


def test_blocks_yaml_int8_propagated_matches_jax(blocks):
    """int8 "all" from JAX's fused params and amax, propagated: the port
    annotates the blocks JAX annotates (C3TR among them, a C3 to both),
    with the same scales; the head outputs agree with JAX's int8 forward
    within test_int8_forward_matches_jax's limits; each annotated block
    hands on the int8 its last Conv wrote."""
    cfg, model, params, x = blocks
    fused = jax.tree_util.tree_map(np.asarray, model.fuse(params))
    amax = jax_calibrate(model, fused, [x], dtype=jnp.float32)
    qtree = jax_quantize(fused, amax, select=jax_select_all, model=model)
    ref = _jax_forward(model, jnp.float32)(qtree, jnp.asarray(x))
    port = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"), fused).eval()
    quantize_params(port, amax, select=select_all, propagate=True)
    convs = [m for _, m in conv_layers(port)]
    assert all(m.int8 for m in convs) and sum(not m.s8_kernel for m in convs) >= 4
    want = {(uid, k): float(np.asarray(v[k])) for uid, v in qtree.items()
            if isinstance(v, dict) for k in ("__q_out__", "q_in") if k in v}
    got = {(uid, ACT_QUANT[k]): v for (uid, k), v in act_quant_annotations(port).items()}
    assert got == want
    c3tr = [uid for uid in port.block_nodes if isinstance(port.block(uid), tl.C3TR)]
    assert any((uid, "__q_out__") in want for uid in c3tr)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = port(xt)
        assert check_requant(port, port, xt, "blocks") > 0
    for t in TASKS:
        r = np.asarray(ref[t][0], np.float32)
        o = out[t][0].numpy()
        np.testing.assert_allclose(o[..., 4:], r[..., 4:], rtol=0, atol=1e-5)
        np.testing.assert_allclose(o[..., :4], r[..., :4], rtol=0, atol=1e-3)


def test_blocks_weights_round_trip(blocks, tmp_path):
    """JAX's tree -> the port -> JAX's tree is the identity (Linear's (c1,
    c2), the attention's (out, in), implicit's NHWC (1, 1, 1, C), BareConv's
    HWIO without b), and so is the port's export read back; every key of
    the twelve blocks' parameters is carried."""
    cfg, model, params, _ = blocks
    port = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"), params)
    back = export_jax_params(port)
    flat = dict(_flat(params))
    assert dict(_flat(back)).keys() == flat.keys()
    for k, v in _flat(back):
        np.testing.assert_array_equal(v, flat[k], err_msg="/".join(k))
    again = load_jax_params(CerberusModel(cfg, TASKS, NCS, device="cpu"), back)
    sa, sb = port.state_dict(), again.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("mixconv2d", "implicita", "implicitm", "transformerblock"):
        make = CLASSES[name][0]
        m, tree = _seeded(make(tl), 0)
        copy = load_jax_tree(make(tl), tree)
        assert all(torch.equal(a, b) for a, b in zip(m.state_dict().values(),
                                                     copy.state_dict().values()))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_seeded_init_draws_every_parameter(blocks):
    """CerberusModel.init draws the new layers' parameters from the seed, as
    the JAX package inits them: the same seed gives the same weights, every
    parameter is finite, the implicit ones near 0 (A) and 1 (M), the
    attention biases zero."""
    cfg = blocks[0]
    a = CerberusModel(cfg, TASKS, NCS, device="cpu").init(3)
    b = CerberusModel(cfg, TASKS, NCS, device="cpu").init(3)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert all(torch.isfinite(p).all() for p in a.parameters())
    mha = [m for m in a.modules() if isinstance(m, tl.MultiheadAttention)]
    assert mha and all(not m.in_b.detach().any() for m in mha)
    ia, im = tl.ImplicitA(64), tl.ImplicitM(64)
    gen = torch.Generator().manual_seed(1)
    ia.reset(gen)
    im.reset(gen)
    assert float(ia.implicit.detach().abs().max()) < 0.2
    assert float((im.implicit.detach() - 1).abs().max()) < 0.2

