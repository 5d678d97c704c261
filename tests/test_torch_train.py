"""Port's train slice (cerberusdet_tpu_torch/train/, training BatchNorm, the
weight export) against the JAX package's on the CPU.

Tolerances, and why:
  * training BatchNorm: the statistics are float32 sums on both sides,
    taken in another order: rtol 1e-5 on statistics and outputs;
  * DetectionLoss (float32): the assigner is exact, the losses are float32
    sums in another order: rtol 1e-5 on values, 1e-4 on gradients;
  * optimizers, clip and EMA: elementwise float32 with lrs and momentum
    rounded to float32 as the JAX step takes them: rtol 1e-6;
  * two yolov8n_2task train steps in float64: the BatchNorm statistics are
    float32 in both packages whatever the activation dtype, summed in
    another order, and ~60 layers amplify that rounding. Measured by
    `python tests/test_torch_train.py` (_noise_report): the port against
    itself, with only the order of those float32 sums changed, moves the
    losses by ~4e-6 (relative) and the parameters by ~3e-4 of each
    tensor's largest change over the two steps; against the JAX package,
    ~7e-6 and ~1e-3. The test holds losses to rtol 3e-5 and each parameter,
    BN statistic and EMA tensor to 5e-3 of its largest change.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.nn.module import Ctx, apply_bn_updates, batch_norm
from cerberusdet_tpu.train import optim as jax_optim
from cerberusdet_tpu.train import schedules as jax_sched
from cerberusdet_tpu.train.loss import DetectionLoss as JaxLoss
from cerberusdet_tpu.train.step import MultiTaskTrainer as JaxTrainer
from cerberusdet_tpu.train.step import init_train_state as jax_init_state
from cerberusdet_tpu_torch.manager.weights import (
    export_jax_params,
    export_jax_tree,
    load_jax_params,
    load_jax_tree,
)
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.nn.layers import Conv
from cerberusdet_tpu_torch.nn.module import BatchNorm
from cerberusdet_tpu_torch.train import optim, schedules
from cerberusdet_tpu_torch.train.loss import DetectionLoss
from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]


def _batches(seed, B=2, M=6, img_mask=False):
    rng = np.random.default_rng(seed)
    out = {}
    for t, nc in zip(TASKS, NCS):
        mask = np.zeros((B, M), bool)
        mask[:, :4] = True
        mask[1, 2] = False
        out[t] = {
            "img": rng.uniform(0, 1, (B, 64, 64, 3)),
            "cls": rng.integers(0, nc, (B, M)).astype(np.int32),
            "bboxes": rng.uniform(0.25, 0.6, (B, M, 4)),
            "mask": mask,
            "prob": np.ones((B, M)),
        }
        if img_mask:
            out[t]["img_mask"] = np.array([1.0] * (B - 1) + [0.0])
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _assert_updates_close(ours, ref, init, frac):
    """Each tensor of `ours` within frac of the largest change ref - init."""
    ref, ours, init = dict(_flat(ref)), dict(_flat(ours)), dict(_flat(init))
    assert set(ours) == set(ref)
    for k, r in ref.items():
        change = np.abs(r - init[k]).max()
        np.testing.assert_allclose(ours[k], r, rtol=0, atol=frac * change + 1e-12,
                                   err_msg="/".join(k))


# ------------------------------------------------------------ BatchNorm
@pytest.mark.parametrize("masked", [False, True])
def test_training_batchnorm_and_fold_match_jax(masked):
    """Two 'task' forwards through one BatchNorm in training mode: the
    outputs, and the running statistics folded in task order, against
    batch_norm + apply_bn_updates."""
    rng = np.random.default_rng(0)
    c = 6
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 1, c).astype(np.float32),
         "mean": rng.normal(0, 1, c).astype(np.float32),
         "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    xs = [rng.normal(1, 2, (3, 5, 4, c)).astype(np.float32) for _ in range(2)]
    img_mask = np.array([1.0, 0.0, 1.0], np.float32) if masked else None
    bn = BatchNorm(c)
    load_jax_tree(bn, {"weight": p["scale"], "bias": p["bias"], "running_mean": p["mean"],
                       "running_var": p["var"]})
    bn.img_mask = None if img_mask is None else torch.from_numpy(img_mask)
    params = {"bn": {k: jnp.asarray(v) for k, v in p.items()}}
    for x in xs:
        ctx = Ctx(train=True, img_mask=None if img_mask is None else jnp.asarray(img_mask))
        ref = batch_norm(params["bn"], jnp.asarray(x), ctx, ("bn",))
        params = apply_bn_updates(params, ctx.updates)
        ours = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(ours.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(params["bn"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(params["bn"]["var"]),
                               rtol=1e-5, atol=1e-6)


def test_frozen_batchnorm_uses_running_stats_in_training():
    bn = BatchNorm(4).train()
    bn.frozen = True
    x = torch.randn(2, 4, 3, 3)
    before = bn.running_mean.clone()
    torch.testing.assert_close(bn(x), bn.eval()(x))
    assert torch.equal(bn.running_mean, before)


def test_batchnorm_statistics_are_float32_for_float64_activations():
    """As the JAX batch_norm: float32 statistics whatever the dtype."""
    bn = BatchNorm(3).double().train()
    x = torch.randn(2, 3, 4, 4, dtype=torch.float64)
    mean, var, _ = bn.batch_stats(x)
    assert mean.dtype == var.dtype == torch.float32
    assert bn(x).dtype == torch.float64


@pytest.mark.parametrize("kind", ["Conv", "PlainConv"])
def test_bf16_compute_with_float32_masters_matches_jax(kind):
    """Training layers keep float32 weights and compute in the input's dtype
    (bf16): Conv with training BN and PlainConv with its float32 bias,
    against the JAX layers under Ctx(train=True, dtype=bfloat16). bf16 keeps
    8 bits, and the two convolutions round their sums apart: rtol 2e-2 with
    an atol of 2e-2 of the output's largest magnitude."""
    from cerberusdet_tpu.nn import layers as jl
    from cerberusdet_tpu_torch.nn import layers as tl

    jlayer, tlayer = getattr(jl, kind)(8, 16, 3), getattr(tl, kind)(8, 16, 3)
    tree = jax.tree_util.tree_map(np.asarray, jlayer.init(jax.random.PRNGKey(0)))
    load_jax_tree(tlayer, tree)
    x = np.random.default_rng(0).normal(0, 1, (2, 6, 6, 8)).astype(np.float32)
    ctx = Ctx(train=True, dtype=jnp.bfloat16)
    ref = np.asarray(jlayer(jax.tree_util.tree_map(jnp.asarray, tree),
                            jnp.asarray(x, jnp.bfloat16), ctx, ("blk",)).astype(jnp.float32))
    ours = tlayer.train()(torch.from_numpy(x).permute(0, 3, 1, 2).bfloat16())
    assert ours.dtype == torch.bfloat16 and tlayer.w.dtype == torch.float32
    np.testing.assert_allclose(ours.float().permute(0, 2, 3, 1).detach().numpy(), ref,
                               rtol=2e-2, atol=2e-2 * np.abs(ref).max())


# ------------------------------------------------------------ loss
@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(0)
    B, M, nc = 2, 8, 3
    feats = [rng.normal(0, 1, (B, s, s, nc + 64)).astype(np.float32) for s in (8, 4, 2)]
    batch = {
        "cls": rng.integers(0, nc, (B, M)).astype(np.int32),
        "bboxes": rng.uniform(0.3, 0.6, (B, M, 4)).astype(np.float32),
        "mask": np.tile([True] * 5 + [False] * 3, (B, 1)),
        "prob": np.ones((B, M), np.float32),
    }
    return feats, batch, nc


@pytest.mark.parametrize("tal_impl", ["xla", "pallas"])
@pytest.mark.parametrize("with_img_mask", [False, True])
def test_detection_loss_matches_jax(loss_case, tal_impl, with_img_mask):
    feats, batch, nc = loss_case
    if with_img_mask:
        batch = dict(batch, img_mask=np.array([1.0, 0.0], np.float32))
    strides = (8.0, 16.0, 32.0)
    ref = JaxLoss(nc=nc, strides=strides, tal_impl=tal_impl)

    def jax_total(fs):
        return ref(fs, {k: jnp.asarray(v) for k, v in batch.items()})

    (tot_j, items_j), grads_j = jax.value_and_grad(jax_total, has_aux=True)(
        [jnp.asarray(f) for f in feats])
    tf = [torch.from_numpy(f).permute(0, 3, 1, 2).requires_grad_(True) for f in feats]
    tot, items = DetectionLoss(nc=nc, strides=strides)(
        tf, {k: torch.from_numpy(v) for k, v in batch.items()})
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(tot_j), rtol=1e-5)
    for f in items._fields:
        np.testing.assert_allclose(float(getattr(items, f)), float(getattr(items_j, f)),
                                   rtol=1e-5, atol=1e-7, err_msg=f)
    for g, gj in zip(tf, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.grad.permute(0, 2, 3, 1).numpy(), gj, rtol=1e-4,
                                   atol=1e-4 * np.abs(gj).max())


# ------------------------------------------------------------ optimizer
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"blk": {"w": rng.normal(0, 1, (3, 3, 2, 4)).astype(np.float32),
                    "b": rng.normal(0, 1, 4).astype(np.float32),
                    "bn": {"scale": rng.uniform(0.5, 1.5, 4).astype(np.float32),
                           "bias": rng.normal(0, 1, 4).astype(np.float32)}}}


_PORT_NAME = {("blk", "w"): "blk.w", ("blk", "b"): "blk.b",
              ("blk", "bn", "scale"): "blk.bn.weight", ("blk", "bn", "bias"): "blk.bn.bias"}


@pytest.mark.parametrize("name,nesterov", [("SGD", True), ("SGD", False), ("Adam", True),
                                           ("AdamW", True), ("RMSProp", True)])
def test_optimizer_clip_and_ema_match_jax(name, nesterov):
    """Three steps of clip -> update -> EMA on a small tree, with per-step
    lrs and momentum, against train/optim.py."""
    tree = _opt_tree(0)
    jcfg = jax_optim.SGDConfig(name=name, nesterov=nesterov)
    pcfg = optim.SGDConfig(name=name, nesterov=nesterov)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jax_optim.sgd_init(jparams, jcfg)
    groups = jax_optim.build_group_tree(jparams)
    jema = jax.tree_util.tree_map(jnp.copy, jparams)
    params = {_PORT_NAME[k]: torch.from_numpy(v.copy()) for k, v in _flat(tree)}
    state = optim.sgd_init(params, pcfg)
    ema = {k: v.clone() for k, v in params.items()}
    assert {k: optim.param_group(k) for k in params} == \
        {_PORT_NAME[k]: int(v) for k, v in _flat(groups)}
    rng = np.random.default_rng(1)
    for step in range(3):
        gtree = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 8, a.shape).astype(np.float32), tree)
        lrs = np.array([0.01, 0.02, 0.05], np.float32) * (step + 1)
        mom = 0.8 + 0.05 * step
        jgrads = jax_optim.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, gtree), 10.0)
        jparams, jstate = jax_optim.sgd_update(jcfg, groups, jparams, jgrads, jstate,
                                               jnp.asarray(lrs), jnp.float32(mom))
        jema = jax_optim.ema_update(jema, jparams, jnp.asarray(step + 1, jnp.int32))
        grads = {_PORT_NAME[k]: torch.from_numpy(v.copy()) for k, v in _flat(gtree)}
        optim.clip_by_global_norm(list(grads.values()), 10.0)
        optim.sgd_update(pcfg, params, grads, state, lrs, mom)
        optim.ema_update(ema.values(), params.values(), step + 1)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jparams)):
        np.testing.assert_allclose(params[_PORT_NAME[k]].numpy(), v, rtol=1e-6, atol=1e-7)
    for k, v in _flat(jax.tree_util.tree_map(np.asarray, jema)):
        np.testing.assert_allclose(ema[_PORT_NAME[k]].numpy(), v, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("ni", [0, 7, 99, 100, 250])
def test_schedules_match_jax(ni):
    lf, lf_j = schedules.lr_lambda(30, 0.1), jax_sched.lr_lambda(30, 0.1)
    lin, lin_j = schedules.lr_lambda(30, 0.1, False), jax_sched.lr_lambda(30, 0.1, False)
    epoch = ni // 10
    assert lf(epoch) == lf_j(epoch) and lin(epoch) == lin_j(epoch)
    lrs, mom = schedules.warmup_lrs(ni, 100, 0.0, 0.01, lf(epoch))
    lrs_j, mom_j = jax_sched.warmup_lrs(ni, 100, 0.0, 0.01, lf_j(epoch))
    np.testing.assert_array_equal(lrs, lrs_j)
    assert mom == mom_j
    es, es_j = schedules.EarlyStopping(3), jax_sched.EarlyStopping(3)
    fits = [0.1, 0.2, 0.2, 0.1, 0.15, 0.19, 0.1][: 2 + ni % 5]
    assert [es(i, f) for i, f in enumerate(fits)] == [es_j(i, f) for i, f in enumerate(fits)]


# ------------------------------------------------------------ train step
def _warmup(ni):
    return schedules.warmup_lrs(ni, 4, 0.0, 0.01, 1.0)


@pytest.fixture(scope="module")
def jax_two_steps():
    return _jax_two_steps()


def _jax_two_steps():
    """Two JAX MultiTaskTrainer steps of yolov8n_2task at 64 px in float64:
    (initial params, [items per step], params, ema) as numpy."""
    model = JaxModel(CFG, TASKS, NCS)
    losses = {t: JaxLoss(nc=nc, strides=model.strides, tal_impl="xla")
              for t, nc in zip(TASKS, NCS)}
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        model.init(jax.random.PRNGKey(0)))
        init = jax.tree_util.tree_map(np.asarray, params)
        trainer = JaxTrainer(model, losses, compute_dtype=jnp.float64)
        state = jax_init_state(params)
        items = []
        for ni, seed in enumerate((1, 2)):
            batches = {t: {k: jnp.asarray(v) for k, v in b.items()}
                       for t, b in _batches(seed, img_mask=ni == 1).items()}
            lrs, mom = _warmup(ni + 1)
            state, it = trainer.step(state, batches, lrs, mom)
            items.append({t: [float(x) for x in v] for t, v in it.items()})
        out = jax.tree_util.tree_map(np.asarray, (state.params, state.ema_params))
    return init, items, out[0], out[1]


def _port_trainer(init, dtype=torch.float64):
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").to(dtype)
    load_jax_params(model, init)
    losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(TASKS, NCS)}
    return MultiTaskTrainer(model, losses, compute_dtype=dtype, device="cpu"), model


def _port_two_steps(init):
    """The same two steps by the port: ([items per step], model, state)."""
    trainer, model = _port_trainer(init)
    state = init_train_state(model)
    items = []
    for ni, seed in enumerate((1, 2)):
        lrs, mom = _warmup(ni + 1)
        state, it = trainer.step(state, _batches(seed, img_mask=ni == 1), lrs, mom)
        items.append({t: [float(x) for x in v] for t, v in it.items()})
    return items, model, state


def test_two_train_steps_match_jax_float64(jax_two_steps):
    init, items_j, params_j, ema_j = jax_two_steps
    items, model, state = _port_two_steps(init)
    for ni in range(2):
        for t in TASKS:
            np.testing.assert_allclose(items[ni][t], items_j[ni][t], rtol=3e-5,
                                       err_msg=f"step {ni} task {t}")
    assert state.n_updates == 2
    _assert_updates_close(export_jax_params(model), params_j, init, 5e-3)
    _assert_updates_close(export_jax_params(state.ema), ema_j, init, 5e-3)


@pytest.fixture(scope="module")
def init_tree(jax_two_steps):
    return jax.tree_util.tree_map(lambda a: a.astype(np.float32), jax_two_steps[0])


def test_single_task_subset_step(init_tree):
    """An a-only step: head_b gets no update, decay or momentum."""
    trainer, model = _port_trainer(init_tree, dtype=torch.float32)
    state = init_train_state(model)
    before = export_jax_params(model)
    state, items = trainer.step(state, {"a": _batches(0)["a"]}, [0.01] * 3, 0.9)
    after = export_jax_params(model)
    assert set(items) == {"a"}
    for k, v in _flat(before["head_b"]):
        np.testing.assert_array_equal(dict(_flat(after["head_b"]))[k], v)
    for name, buf in state.opt_state.momentum_buf.items():
        if name.startswith("blocks.head_b."):
            assert not buf.any(), name
    assert not np.allclose(after["head_a"]["box0"]["0"]["w"], before["head_a"]["box0"]["0"]["w"])


def test_freeze_shared(init_tree):
    """freeze_shared: shared weights and BN statistics unchanged, heads train."""
    trainer, model = _port_trainer(init_tree, dtype=torch.float32)
    state = init_train_state(model)
    before = export_jax_params(model)
    trainer.step(state, _batches(0), [0.01] * 3, 0.9, freeze_shared=True)
    after = export_jax_params(model)
    shared = model.shared_uids()
    assert "b0" in shared
    for uid in (u for u in shared if u in before):  # Upsample/Concat hold nothing
        for k, v in _flat(before[uid]):
            np.testing.assert_array_equal(dict(_flat(after[uid]))[k], v, err_msg=uid)
    assert not np.allclose(after["head_a"]["box0"]["0"]["w"], before["head_a"]["box0"]["0"]["w"])


def test_bn_stats_move_at_zero_lr(init_tree):
    trainer, model = _port_trainer(init_tree, dtype=torch.float32)
    state = init_train_state(model)
    mean0 = model.block("b0").bn.running_mean.clone()
    w0 = model.block("b0").w.detach().clone()
    trainer.step(state, _batches(0), [0.0] * 3, 0.9)
    assert not torch.allclose(model.block("b0").bn.running_mean, mean0)
    assert torch.equal(model.block("b0").w, w0)


def test_task_order_invariance(init_tree):
    """The weights see only the summed gradients, so reversing the task
    order changes them by float summation only; BN running statistics keep
    the sequential fold's recency weighting (tests/test_train_step.py)."""
    cfg = os.path.join(os.path.dirname(CFG), "yolov8n.yaml")
    m1 = CerberusModel(cfg, ["a", "b"], [3, 5], device="cpu")
    m2 = CerberusModel(cfg, ["b", "a"], [5, 3], device="cpu")
    m1.init(0)
    load_jax_params(m2, export_jax_params(m1))
    la, lb = DetectionLoss(nc=3, strides=m1.strides), DetectionLoss(nc=5, strides=m1.strides)
    t1 = MultiTaskTrainer(m1, {"a": la, "b": lb}, device="cpu")
    t2 = MultiTaskTrainer(m2, {"b": lb, "a": la}, device="cpu")
    batches = _batches(3)
    batches = {t: {k: np.asarray(v, np.float32) if v.dtype == np.float64 else v
                   for k, v in b.items()} for t, b in batches.items()}
    s1, it1 = t1.step(init_train_state(m1), batches, [0.01] * 3, 0.9)
    s2, it2 = t2.step(init_train_state(m2), dict(reversed(batches.items())), [0.01] * 3, 0.9)
    for t in ("a", "b"):
        np.testing.assert_allclose(float(it1[t].total), float(it2[t].total), rtol=1e-5)
    p2 = dict(_flat(export_jax_params(m2)))
    for k, v in _flat(export_jax_params(m1)):
        is_stat = k[-1] in ("mean", "var")
        np.testing.assert_allclose(v, p2[k], rtol=5e-3 if is_stat else 2e-4,
                                   atol=1e-3 if is_stat else 1e-5, err_msg="/".join(k))


# ------------------------------------------------------------ weights
@pytest.mark.parametrize("fused", [False, True])
def test_weights_round_trip(init_tree, fused):
    """load -> export -> load gives identical state_dicts (BN and fused trees)."""
    model = CerberusModel(CFG, TASKS, NCS, device="cpu")
    tree = init_tree
    if fused:
        tree = export_jax_params(load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                                 tree).fuse())
    load_jax_params(model, tree)
    exported = export_jax_params(model)
    again = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"), exported)
    a, b = model.state_dict(), again.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert model.fused == fused
    ref = dict(_flat(tree))
    assert all(np.array_equal(v, ref[k]) for k, v in _flat(exported))


def test_export_tree_of_a_layer():
    conv = Conv(3, 8, 3)
    conv.reset(torch.Generator().manual_seed(0))
    tree = export_jax_tree(conv)
    assert tree["w"].shape == (3, 3, 3, 8) and set(tree["bn"]) == {"scale", "bias", "mean",
                                                                    "var"}
    other = Conv(3, 8, 3)
    load_jax_tree(other, tree)
    assert all(torch.equal(x, y) for x, y in zip(conv.state_dict().values(),
                                                  other.state_dict().values()))


def _noise_report():
    """Prints how far the float64 two-step run lies from JAX's, and from the
    port's own run with only the order of the BatchNorm's float32 sums
    changed: the largest relative loss difference and the largest
    |difference| / (largest change over the two steps) of any tensor. The
    tolerances of test_two_train_steps_match_jax_float64 come from it."""
    init, items_j, params_j, _ = _jax_two_steps()
    items, model, _ = _port_two_steps(init)
    params = export_jax_params(model)
    batch_stats = BatchNorm.batch_stats

    def reversed_sums(self, x):
        if self.img_mask is not None:
            return batch_stats(self, x)
        xf = x.float().transpose(0, 1).reshape(x.shape[1], -1).flip(1)
        n = xf.shape[1]
        mean = xf.sum(1) / n
        var = (xf - mean[:, None]).square().sum(1) / n
        return mean, var, var * (n / max(n - 1, 1))

    BatchNorm.batch_stats = reversed_sums
    try:
        items_r, model_r, _ = _port_two_steps(init)
    finally:
        BatchNorm.batch_stats = batch_stats
    flat_init = dict(_flat(init))
    for name, other_items, other in (("JAX", items_j, params_j),
                                     ("port, reversed BN sums", items_r,
                                      export_jax_params(model_r))):
        loss = max(abs(a / b - 1) for ni in range(2) for t in TASKS
                   for a, b in zip(items[ni][t], other_items[ni][t]))
        other = dict(_flat(other))
        tensor = max(np.abs(v - other[k]).max() / max(np.abs(other[k] - flat_init[k]).max(),
                                                       1e-30)
                     for k, v in _flat(params))
        print(f"port vs {name}: losses {loss:.3g} (relative), tensors {tensor:.3g} "
              f"of their change")


if __name__ == "__main__":  # python tests/test_torch_train.py (from the repo root)
    _noise_report()
