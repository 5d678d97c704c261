"""Port's multi-task model (cerberusdet_tpu_torch/models/cerberus.py) against
the JAX CerberusModel: branch plan (no forward; the port's model is built on
the meta device) and the yolov8n_2task forward at 64 px in float32.

Forward tolerance: rtol 1e-4 with an atol of 1e-4 times the output's largest
magnitude (float32, ~60 convolutions summed in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.models.cerberus import build_branch_labels as jax_labels
from cerberusdet_tpu.nn.module import Ctx
from cerberusdet_tpu_torch.manager.weights import load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel, build_branch_labels

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "configs", "models")
CONFIGS = {
    "yolov8n_2task": (["a", "b"], [3, 5]),
    "yolov8x_2task": (["voc", "animals"], [20, 19]),
    "yolov8x_3task": (["t0", "t1", "t2"], [4, 6, 8]),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_branch_plan_matches_jax(name):
    tasks, ncs = CONFIGS[name]
    cfg = os.path.join(CFG_DIR, name + ".yaml")
    ref = JaxModel(cfg, tasks, ncs)
    ours = CerberusModel(cfg, tasks, ncs, device="meta")
    assert ours.labels == ref.labels
    assert ours._task_node_uid == ref._task_node_uid
    assert ours.block_nodes == ref.block_nodes
    assert ours.serving_counts == ref.serving_counts
    for subset in (None, tasks[:1], tasks[::-1]):
        assert ([(s.uid, s.node_idx, s.in_uids, s.task) for s in ours.plan(subset)]
                == [(s.uid, s.node_idx, s.in_uids, s.task) for s in ref.plan(subset)])
    # every block uid has exactly one module, plus one head per task
    assert len(ours.blocks) == len(ref.block_nodes) + len(tasks)


def test_branch_labels_readme_example():
    """The README's sequential-split example, as in tests/test_branch_plan.py."""
    cerber = [[2, [[15], [13, 14]]], [6, [[13], [14]]]]
    assert build_branch_labels(cerber, 12, 3) == jax_labels(cerber, 12, 3)


def test_init_is_seeded():
    cfg = os.path.join(CFG_DIR, "yolov8n_2task.yaml")
    a = CerberusModel(cfg, ["a", "b"], [3, 5], device="cpu").init(4).state_dict()
    b = CerberusModel(cfg, ["a", "b"], [3, 5], device="cpu").init(4).state_dict()
    c = CerberusModel(cfg, ["a", "b"], [3, 5], device="cpu").init(5).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_load_rejects_missing_and_extra_keys():
    cfg = os.path.join(CFG_DIR, "yolov8n_2task.yaml")
    tree = jax.tree_util.tree_map(np.asarray, JaxModel(cfg, ["a", "b"], [3, 5]).init(
        jax.random.PRNGKey(0)))
    model = CerberusModel(cfg, ["a", "b"], [3, 5], device="cpu")
    short = dict(tree)
    del short["b0"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, short)
    extra = dict(tree, b0=dict(tree["b0"], extra=np.zeros(3)))
    with pytest.raises(KeyError, match="extra"):
        load_jax_params(model, extra)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_jax(fused):
    """All heads of yolov8n_2task at 64 px: decoded predictions and raw maps,
    on the BN tree or on the fused {w, b} tree."""
    cfg = os.path.join(CFG_DIR, "yolov8n_2task.yaml")
    ref = JaxModel(cfg, ["a", "b"], [3, 5])
    params = ref.init(jax.random.PRNGKey(1))
    if fused:
        params = ref.fuse(params)
    model = CerberusModel(cfg, ["a", "b"], [3, 5], device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    assert model.fused == fused
    x = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    out = ref(params, jnp.asarray(x), Ctx(train=False))
    with torch.no_grad():
        ours = model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert set(ours) == {"a", "b"}
    for t in ("a", "b"):
        pred, feats = out[t]
        for f, tf in zip(feats, ours[t][1]):
            f = np.asarray(f)
            np.testing.assert_allclose(tf.permute(0, 2, 3, 1).numpy(), f, rtol=1e-4,
                                       atol=1e-4 * np.abs(f).max())
        pred = np.asarray(pred)
        np.testing.assert_allclose(ours[t][0].numpy(), pred, rtol=1e-4,
                                   atol=1e-4 * np.abs(pred).max())
