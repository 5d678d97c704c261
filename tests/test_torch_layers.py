"""Port's layers (cerberusdet_tpu_torch/nn/layers.py) against the JAX package's
on the same weights, carried over by manager/weights.py.

Eval mode, float32 on the CPU, yolov8n widths. Tolerance: rtol 1e-5 with an
atol of 1e-5 times the output's largest magnitude (float32 convolutions
summed in another order; a few layers deep)."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.models.config import parse_model_cfg as jax_parse
from cerberusdet_tpu.nn import layers as jl
from cerberusdet_tpu.nn.module import Ctx
from cerberusdet_tpu_torch.manager.weights import load_jax_tree
from cerberusdet_tpu_torch.models.config import parse_model_cfg
from cerberusdet_tpu_torch.nn import layers as tl


def _randomize_bn(tree, rng):
    """Non-trivial BN statistics, so the BN path is exercised."""
    if not isinstance(tree, dict):
        return tree
    if set(tree) == {"scale", "bias", "mean", "var"}:
        c = tree["scale"].shape
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.2, c).astype(np.float32),
                "mean": rng.normal(0, 0.2, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return {k: _randomize_bn(v, rng) for k, v in tree.items()}


def _pair(jax_layer, torch_layer, seed):
    tree = jax.tree_util.tree_map(np.asarray, jax_layer.init(jax.random.PRNGKey(seed)))
    tree = _randomize_bn(tree, np.random.default_rng(seed))
    load_jax_tree(torch_layer, tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), torch_layer.eval()


def _close(ours, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def _x(shape, seed):
    """NHWC numpy input and its NCHW tensor."""
    x = np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


CASES = {
    "conv3x3s2": (lambda m: m.Conv(16, 32, 3, 2), (2, 16, 16, 16)),
    "conv1x1": (lambda m: m.Conv(32, 16, 1, 1), (2, 8, 8, 32)),
    "c2f_shortcut": (lambda m: m.C2f(32, 32, 1, True), (2, 16, 16, 32)),
    "c2f_n2": (lambda m: m.C2f(64, 32, 2, False), (1, 8, 8, 64)),
    "sppf": (lambda m: m.SPPF(64, 64, 5), (2, 4, 4, 64)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    make, shape = CASES[name]
    p, layer = _pair(make(jl), make(tl), seed=len(name))
    x, xt = _x(shape, seed=1)
    ref = make(jl)(p, jnp.asarray(x), Ctx(train=False))
    with torch.no_grad():
        _close(_nhwc(layer(xt)), ref)


def test_layer_fused_matches_jax_fused():
    """Conv.fuse() equals the JAX Conv on its fused {w, b} tree."""
    p, layer = _pair(jl.Conv(16, 32, 3, 1), tl.Conv(16, 32, 3, 1), seed=3)
    layer.fuse()
    x, xt = _x((2, 8, 8, 16), seed=2)
    ref = jl.Conv(16, 32, 3, 1)(jl.Conv(16, 32, 3, 1).fuse(p), jnp.asarray(x),
                                Ctx(train=False))
    with torch.no_grad():
        _close(_nhwc(layer(xt)), ref)
    assert set(dict(layer.named_parameters())) == {"w", "b"}


def test_upsample_and_concat_match_jax():
    x, xt = _x((2, 4, 5, 3), seed=4)
    y, yt = _x((2, 8, 10, 2), seed=5)
    up = jl.Upsample(None, 2, "nearest")({}, jnp.asarray(x), Ctx())
    cat = jl.Concat(1)({}, [up, jnp.asarray(y)], Ctx())
    ours = tl.Concat(1)([tl.Upsample(None, 2, "nearest")(xt), yt])
    np.testing.assert_array_equal(_nhwc(ours), np.asarray(cat))


def test_detect_matches_jax():
    """Raw per-level feature maps and the decoded (B, N, 4+nc) predictions,
    anchors flattened level-major then row-major as in the JAX package."""
    ch, nc = (64, 128, 128), 5
    p, head = _pair(jl.Detect(nc, ch), tl.Detect(nc, ch), seed=7)
    xs = [_x((2, s, s, c), seed=10 + i) for i, (s, c) in enumerate(zip((8, 4, 2), ch))]
    pred, feats = jl.Detect(nc, ch)(p, [jnp.asarray(x) for x, _ in xs], Ctx(train=False))
    with torch.no_grad():
        tpred, tfeats = head([xt for _, xt in xs])
    for f, tf in zip(feats, tfeats):
        _close(_nhwc(tf), f)
    assert tpred.dtype == torch.float32 and tpred.shape == pred.shape
    _close(tpred.numpy(), pred)


def test_detect_bias_init_and_widths():
    """c3 = max(ch[0], nc) and the prior biases of the reference."""
    head = tl.Detect(80, (64, 128, 256))
    head.bias_init()
    ref = jax.tree_util.tree_map(np.asarray, jl.Detect(80, (64, 128, 256)).init(
        jax.random.PRNGKey(0)))
    assert head.cls0[0].w.shape[0] == max(64, 80)
    for i in range(3):
        np.testing.assert_allclose(getattr(head, f"cls{i}")[2].b.detach().numpy(),
                                   ref[f"cls{i}"]["2"]["b"], rtol=1e-6)
        np.testing.assert_array_equal(getattr(head, f"box{i}")[2].b.detach().numpy(),
                                      ref[f"box{i}"]["2"]["b"])


CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "models")


@pytest.mark.parametrize("name", sorted(os.path.basename(f) for f in
                                        glob.glob(os.path.join(CFG_DIR, "*.yaml"))))
def test_parsed_table_matches_jax(name):
    """Channels, routing, strides and head inputs of every shipped config."""
    cfg = os.path.join(CFG_DIR, name)
    with torch.device("meta"):
        ours = parse_model_cfg(cfg)
    ref = jax_parse(cfg)
    assert [(n.idx, n.frm, n.name, n.section, n.c2, n.log2_stride) for n in ours.nodes] == \
        [(n.idx, n.frm, n.name, n.section, n.c2, n.log2_stride) for n in ref.nodes]
    assert (ours.n_backbone, ours.head_from, ours.head_strides, ours.head_ch, ours.cerber) == \
        (ref.n_backbone, ref.head_from, ref.head_strides, ref.head_ch, ref.cerber)


def test_unported_layer_raises():
    """A layer name that neither package's registry knows raises the JAX
    parser's ValueError."""
    cfg = {"backbone": [[-1, 1, "NoSuchBlock", [64]]], "head": [[[0], 1, "Detect", []]]}
    with pytest.raises(ValueError, match="unsupported module in yaml: NoSuchBlock"):
        jax_parse(cfg)
    with pytest.raises(ValueError, match="unsupported module in yaml: NoSuchBlock"):
        parse_model_cfg(cfg)
