"""The captured train step (train/step.py, train/optim.py, infer/graphs.py)
on the CPU, and against eager steps on the card.

On the CPU `MultiTaskTrainer.step` is `raw_step`; what a capture depends on
is tested here: the per-step scalars read from one tensor refilled in place
(lrs, momentum, Adam's bias corrections, the EMA decay), against JAX's
train/optim.py in float64; the step's key; the address check that raises on
a replaced state tensor. The test marked `cuda`
replays the captured step against eager steps on the card, bit for bit under
deterministic algorithms, and skips without a card.
"""

import copy
import os
import time

import numpy as np
import pytest
import torch


from cerberusdet_tpu_torch.infer.graphs import addresses, check_addresses
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import train_batches
from cerberusdet_tpu_torch.train import optim
from cerberusdet_tpu_torch.train.loss import DetectionLoss
from cerberusdet_tpu_torch.train.schedules import warmup_lrs
from cerberusdet_tpu_torch.train.step import (
    MultiTaskTrainer,
    init_train_state,
    state_tensors,
)

CFG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: thousands of tiny CPU ops, which test processes
    running at once make far slower when each op's threads wait for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the optimizer
_PORT_NAME = {("blk", "w"): "blk.w", ("blk", "b"): "blk.b",
              ("blk", "bn", "scale"): "blk.bn.weight", ("blk", "bn", "bias"): "blk.bn.bias"}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"blk": {"w": rng.normal(0, 1, (3, 3, 2, 4)),
                    "b": rng.normal(0, 1, 4),
                    "bn": {"scale": rng.uniform(0.5, 1.5, 4), "bias": rng.normal(0, 1, 4)}}}


@pytest.mark.parametrize("name,nesterov", [("SGD", True), ("SGD", False), ("Adam", True),
                                           ("AdamW", True), ("RMSProp", True)])
def test_tensor_scalars_match_jax_float64(name, nesterov):
    """Three steps of update -> EMA in float64, fed as a replay is fed:
    sgd_apply / ema_apply read lrs, momentum, Adam's bias corrections and
    the EMA decay from one scalar tensor refilled in place every step, while
    lrs and momentum change; against JAX's train/optim.py under x64, within
    rtol 1e-12 (float64 rounding). No clipping: both take the global norm in
    float32, by design. tests/test_torch_train.py's
    test_optimizer_clip_and_ema_match_jax holds the float32 step, clipping
    included. JAX is imported here: the card's tests of this file run where
    it is not installed."""
    import jax
    import jax.numpy as jnp

    from cerberusdet_tpu.train import optim as jax_optim

    tree = _opt_tree(0)
    cfg = optim.SGDConfig(name=name, nesterov=nesterov)
    params = {_PORT_NAME[k]: torch.from_numpy(v.copy()) for k, v in _flat(tree)}
    state = optim.sgd_init(params, cfg)
    ema = {k: v.clone() for k, v in params.items()}
    static = torch.zeros(optim.N_UPDATE_SCALARS + optim.N_EMA_SCALARS, dtype=torch.float64)
    rng = np.random.default_rng(1)
    steps = []  # (gradient tree, lrs, momentum)
    for step in range(3):
        gtree = jax.tree_util.tree_map(lambda a: rng.normal(0, 8, a.shape), tree)
        lrs = np.array([0.01, 0.02, 0.05], np.float32) * (step + 1)
        mom = 0.8 + 0.05 * step
        steps.append((gtree, lrs, mom))
        grads = {_PORT_NAME[k]: torch.from_numpy(v.copy()) for k, v in _flat(gtree)}
        state.step += 1
        static.copy_(torch.from_numpy(np.concatenate(
            [optim.update_scalars(cfg, lrs, mom, state.step), optim.ema_scalars(step + 1)])))
        optim.sgd_apply(cfg, params, grads, state, static[:optim.N_UPDATE_SCALARS])
        optim.ema_apply(ema.values(), params.values(), static[optim.N_UPDATE_SCALARS:])

    with jax.enable_x64():
        jcfg = jax_optim.SGDConfig(name=name, nesterov=nesterov)
        jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        jstate = jax_optim.sgd_init(jparams, jcfg)
        groups = jax_optim.build_group_tree(jparams)
        jema = jax.tree_util.tree_map(jnp.copy, jparams)
        for step, (gtree, lrs, mom) in enumerate(steps):
            jgrads = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), gtree)
            jparams, jstate = jax_optim.sgd_update(jcfg, groups, jparams, jgrads, jstate,
                                                   jnp.asarray(lrs), jnp.float32(mom))
            jema = jax_optim.ema_update(jema, jparams, jnp.asarray(step + 1, jnp.int32))
        want_p = dict(_flat(jax.tree_util.tree_map(np.asarray, jparams)))
        want_e = dict(_flat(jax.tree_util.tree_map(np.asarray, jema)))
    for k, v in want_p.items():
        assert v.dtype == np.float64
        np.testing.assert_allclose(params[_PORT_NAME[k]].numpy(), v, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ema[_PORT_NAME[k]].numpy(), want_e[k], rtol=1e-12, atol=0)


def test_update_scalars_layout():
    """The scalars sit at the indices sgd_apply reads."""
    cfg = optim.SGDConfig(weight_decay=5e-4)
    sc = optim.update_scalars(cfg, [0.1, 0.2, 0.3], 0.9, 2)
    assert sc.dtype == np.float32 and sc.shape == (optim.N_UPDATE_SCALARS,)
    np.testing.assert_array_equal(sc[optim.LR:optim.LR + 3], np.float32([0.1, 0.2, 0.3]))
    np.testing.assert_array_equal(sc[optim.NEG_LR:optim.NEG_LR + 3], -np.float32([0.1, 0.2, 0.3]))
    np.testing.assert_array_equal(sc[optim.LR_WD:optim.LR_WD + 3],
                                  np.float32([0.1, 0.2, 0.3]) * np.float32(5e-4))
    assert sc[optim.MU] == np.float32(0.9)
    assert sc[optim.ONE_MINUS_MU] == np.float32(1) - np.float32(0.9)
    assert sc[optim.BC1] == np.float32(1.0 - np.float32(0.9) ** np.float32(2))
    assert sc[optim.BC2] == np.float32(1.0 - np.float32(0.999) ** np.float32(2))
    d, one_minus = optim.ema_scalars(7)
    assert d == np.float32(optim.ema_decay(7)) and one_minus == np.float32(1) - d


# ------------------------------------------------------------ the train step
def _trainer(seed=0, dtype=torch.float32, device="cpu"):
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(seed).to(device=device,
                                                                        dtype=dtype)
    losses = {t: DetectionLoss(nc=nc, strides=model.strides) for t, nc in zip(TASKS, NCS)}
    return MultiTaskTrainer(model, losses, compute_dtype=dtype, device=device), model


def _batches(seed, img_mask=False):
    out = train_batches(TASKS, NCS, 2, 64, 6, 4, seed=seed)
    if img_mask:
        for b in out.values():
            b["img_mask"] = np.array([1.0, 0.0], np.float32)
    return out


def _state_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert [n for n, _ in ta] == [n for n, _ in tb]
    for (n, x), (_, y) in zip(ta, tb):
        assert torch.equal(x, y), n
    assert (a.n_updates, a.opt_state.step) == (b.n_updates, b.opt_state.step)


def test_step_equals_raw_step_on_cpu():
    """On the CPU step is the eager step: three steps of each from one state,
    with warmup lrs and momentum that change every step (and an img_mask
    batch), bit for bit in losses and every state tensor."""
    tr_a, model_a = _trainer()
    tr_b, model_b = _trainer()
    sa, sb = init_train_state(model_a), init_train_state(model_b)
    for ni in range(3):
        lrs, mom = warmup_lrs(ni + 1, 4, 0.0, 0.01, 1.0)
        batches = _batches(ni, img_mask=ni == 2)
        _, ia = tr_a.step(sa, batches, lrs, mom)
        _, ib = tr_b.raw_step(sb, batches, lrs, mom)
        for t in TASKS:
            assert all(torch.equal(x, y) for x, y in zip(ia[t], ib[t])), (ni, t)
    _state_equal(sa, sb)
    assert sa.n_updates == sa.opt_state.step == 3
    assert not tr_a.programs  # nothing is captured on the CPU


def test_step_key():
    """The key differs when the active tasks, freeze_shared, a field's shape
    or dtype, the presence of img_mask or a loss's use_kernel differs, and
    is equal for other arrays of the same shapes and dtypes."""
    trainer, _ = _trainer()
    base = _batches(0)
    key = trainer.step_key(base)
    assert trainer.step_key(_batches(1)) == key
    as_tensors = {t: {k: torch.from_numpy(v) for k, v in b.items()} for t, b in base.items()}
    assert trainer.step_key(as_tensors) == key
    assert trainer.step_key({t: base[t] for t in reversed(TASKS)}) == key

    def changed(fn):
        b = copy.deepcopy(base)
        fn(b)
        return b

    variants = {
        "one task": {"a": base["a"]},
        "a field's shape": changed(lambda b: b["a"].update(cls=np.zeros((2, 7), np.int32))),
        "a field's dtype": changed(lambda b: b["b"].update(img=b["b"]["img"].astype(np.float64))),
        "img_mask": _batches(0, img_mask=True),
    }
    keys = {name: trainer.step_key(b) for name, b in variants.items()}
    keys["freeze_shared"] = trainer.step_key(base, freeze_shared=True)
    trainer.losses["b"].use_kernel = False
    keys["a loss's use_kernel"] = trainer.step_key(base)
    keys["the other loss's use_kernel, a alone"] = trainer.step_key({"a": base["a"]})
    assert keys["the other loss's use_kernel, a alone"] == keys["one task"]
    del keys["the other loss's use_kernel, a alone"]
    assert len(set(keys.values()) | {key}) == len(keys) + 1, keys


def test_address_check_names_a_replaced_tensor():
    """The check a replay makes: in-place updates pass; a replaced momentum
    buffer (what a deep copy of opt_state does) or parameter raises, naming it."""
    trainer, model = _trainer()
    state = init_train_state(model)
    trainer.step(state, _batches(0), *warmup_lrs(1, 4, 0.0, 0.01, 1.0))
    was = addresses(state_tensors(state))
    check_addresses(was, state_tensors(state))
    name = next(iter(state.opt_state.momentum_buf))
    with torch.no_grad():
        state.opt_state.momentum_buf[name].mul_(0.5)
        model.load_state_dict(copy.deepcopy(model.state_dict()))
    check_addresses(was, state_tensors(state))
    kept = state.opt_state.momentum_buf[name]
    state.opt_state.momentum_buf[name] = kept.clone()
    with pytest.raises(RuntimeError, match=f"opt_state.momentum_buf\\[{name!r}\\]"):
        check_addresses(was, state_tensors(state))
    state.opt_state.momentum_buf[name] = kept
    check_addresses(was, state_tensors(state))
    opt_state = state.opt_state
    state.opt_state = copy.deepcopy(opt_state)
    with pytest.raises(RuntimeError, match="opt_state.momentum_buf"):
        check_addresses(was, state_tensors(state))
    state.opt_state = opt_state
    name, p = next(iter(model.named_parameters()))
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match=f"model.{name} is not"):
        check_addresses(was, state_tensors(state))


# ----------------------------------------------------------------- the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_replays_equal_raw_steps_on_card():
    """On the card, under deterministic algorithms: 4 replays of the
    captured step from a snapshot, with lrs and momentum changing every
    step, equal 4 raw_steps from the same snapshot bit for bit (losses and
    every state tensor); a replaced momentum buffer then raises."""
    _needs_card()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        trainer, model = _trainer(device="cuda")
        state = init_train_state(model)
        batches = _batches(0)
        trainer.step(state, batches, *warmup_lrs(0, 8, 0.0, 0.01, 1.0))  # the capture
        snap = copy.deepcopy((model.state_dict(), state.ema.state_dict(), state.opt_state))
        runs = []
        for form in (trainer.step, trainer.raw_step):
            model.load_state_dict(snap[0])
            state.ema.load_state_dict(snap[1])
            for k, v in snap[2].momentum_buf.items():
                state.opt_state.momentum_buf[k].copy_(v)
            state.opt_state.step = state.n_updates = 1
            items = []
            for ni in range(1, 5):
                _, it = form(state, batches, *warmup_lrs(ni, 8, 0.0, 0.01, 1.0))
                items.append({t: [x.clone() for x in v] for t, v in it.items()})
            runs.append((items, [t.clone() for _, t in state_tensors(state)]))
        assert len(trainer.programs) == 1
        (ia, ta), (ib, tb) = runs
        for a, b in zip(ia, ib):
            for t in TASKS:
                assert all(torch.equal(x, y) for x, y in zip(a[t], b[t]))
        assert all(torch.equal(x, y) for x, y in zip(ta, tb))
        name = next(iter(state.opt_state.momentum_buf))
        state.opt_state.momentum_buf[name] = state.opt_state.momentum_buf[name].clone()
        with pytest.raises(RuntimeError, match="momentum_buf"):
            trainer.step(state, batches, *warmup_lrs(5, 8, 0.0, 0.01, 1.0))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


STAGES = ["forward_loss", "backward", "forward_loss", "backward", "clip", "optimizer", "ema"]


def test_raw_step_marks_each_stage_as_it_ends():
    trainer, model = _trainer()
    state = init_train_state(model)
    names = []
    trainer.raw_step(state, _batches(0), *warmup_lrs(0, 8, 0.0, 0.01, 1.0), mark=names.append)
    assert names == STAGES


@pytest.mark.cuda
def test_replays_time_the_raw_step_stages_on_card(monkeypatch):
    """On the card: the captured step holds raw_step's stage marks; a
    replay's stages are read at the next step once complete (each step is
    waited for here, and every replay read), and they sum to at most the replay's time between
    CUDA events around it."""
    _needs_card()
    from cerberusdet_tpu_torch.utils import tracing

    ring = tracing.Ring()
    monkeypatch.setattr(tracing, "RING", ring)
    monkeypatch.setattr(tracing, "READ_GAP_S", 0.0)  # every replay read
    trainer, model = _trainer(device="cuda")
    state = init_train_state(model)
    batches = _batches(0)
    for ni in range(4):  # the capture, then 3 replays
        trainer.step(state, batches, *warmup_lrs(ni, 8, 0.0, 0.01, 1.0))
        torch.cuda.synchronize()
    (prog,) = trainer.programs.values()
    assert [n for n, _ in prog.marks.stages] == STAGES
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    prog.replay()  # reads the last step's replay first
    b.record()
    torch.cuda.synchronize()
    prog.marks.collect()
    w = tracing.window(0.0, time.perf_counter() + 1)
    replays = w.spans(("replay",))
    assert len(w.spans(("replay",), ("train.step",))) == 3 and len(replays) == 4
    stage = w.col["kind"] == tracing.STAGE
    for seq in w.col["seq"][replays]:
        mine = stage & (w.col["parent"] == seq)
        assert list(w.names[mine]) == STAGES
        assert list(w.col["value"][mine]) == [0, 0, 1, 1, 0, 0, 0]
    last = stage & (w.col["parent"] == w.col["seq"][replays[-1]])
    total = float((w.col["t1"] - w.col["t0"])[last].sum()) / 1e6
    assert 0.5 * a.elapsed_time(b) <= total <= a.elapsed_time(b)
