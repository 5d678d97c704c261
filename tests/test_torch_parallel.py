"""The port's data parallelism (cerberusdet_tpu_torch/parallel/, and its
callers) against the JAX package's mesh, on the CPU at yolov8n_2task, 64 px.

The ranks are processes (tests/torch_parallel_worker.py) in a Gloo group
joined through a file:// init method. Tolerances, and why:
  * the two-rank float64 train step against JAX's step over its 8 virtual
    devices (tests/test_mesh.py's setup): both take the BatchNorm
    statistics as float32 sums, in other orders (per rank here, per device
    there), so tests/test_torch_train.py's rule holds at every one of the
    three steps of SCHEDULE (momentum, the EMA and the BN running fold
    carried from step to step): losses to rtol 3e-5, each parameter, BN
    statistic and EMA tensor to 1e-3 of its largest change over the steps;
    the two ranks bit for bit (they reduce the same sums);
  * a padded rank (pad_batch_to) against the port's one-process step over
    the unpadded rows, over the same steps: the same float32 order rule,
    the same tolerances;
  * a rank alone in its group against the group-less step: bit for bit
    (its all-reduces of one rank copy);
  * HostShardSampler and pad_batch_to: exactly JAX's;
  * distributed run_task over 2 ranks: the one-process run_task's results
    and JAX's within 1e-6 (tests/test_torch_val.py's tolerance);
  * mesh serving in float64: JAX's mesh predict within
    tests/test_torch_inference.py's tolerance, and the port's one-device
    predict exactly.
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.data import samplers as jax_samplers
from cerberusdet_tpu.data.loaders import create_dataloader as jax_create_dataloader
from cerberusdet_tpu.evaluation import val as jax_val
from cerberusdet_tpu.infer.inference import CerberusDetInference as JaxInference
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.parallel import mesh as jax_mesh
from cerberusdet_tpu.train.loss import DetectionLoss as JaxLoss
from cerberusdet_tpu.train.step import MultiTaskTrainer as JaxTrainer
from cerberusdet_tpu.train.step import init_train_state as jax_init_state
from cerberusdet_tpu_torch.data import samplers
from cerberusdet_tpu_torch.data.loaders import create_dataloader
from cerberusdet_tpu_torch.evaluation.val import run_task
from cerberusdet_tpu_torch.infer import CerberusDetInference
from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.parallel import make_mesh, pad_batch_to, shard_batch
from cerberusdet_tpu_torch.testing import calibrate_bn, write_labels, write_val_set
from cerberusdet_tpu_torch.train.loss import DetectionLoss
from cerberusdet_tpu_torch.train.step import MultiTaskTrainer, init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [2, 3]
NAMES = {"a": ["c0", "c1"], "b": ["k0", "k1", "k2"]}
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
SIZES = [(80, 60), (100, 60), (96, 72), (90, 60), (60, 80), (60, 100), (72, 96), (60, 90)]


def _spawn(mode, job, tmp_path, world=2, timeout=600):
    """Run `mode` of the worker in `world` ranks; their pickled outputs."""
    init = tmp_path / f"{mode}.init"
    job_path = tmp_path / f"{mode}.job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    outs = [tmp_path / f"{mode}.{r}.pkl" for r in range(world)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, WORKER, mode, str(r), str(world), str(init),
                               str(job_path), str(outs[r])], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed ({p.returncode}):\n{log[-4000:]}"
    result = []
    for o in outs:
        with open(o, "rb") as f:
            result.append(pickle.load(f))
    return result


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


def _assert_trees_equal(a, b):
    a, b = dict(_flat(a)), dict(_flat(b))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg="/".join(k))


def _batch(nc, seed, B=8):
    """tests/test_mesh.py's batches, in float64."""
    rng = np.random.default_rng(seed)
    return {
        "img": rng.uniform(0, 1, (B, 64, 64, 3)),
        "cls": rng.integers(0, nc, (B, 4)).astype(np.int32),
        "bboxes": rng.uniform(0.3, 0.5, (B, 4, 4)),
        "mask": np.ones((B, 4), bool),
        "prob": np.ones((B, 4)),
    }


# three steps (lrs of the 3 parameter groups, momentum), as a warmup moves them
SCHEDULE = [(np.array([0.08, 0.001, 0.001], np.float32), 0.8),
            (np.array([0.05, 0.005, 0.005], np.float32), 0.85),
            (np.full(3, 0.01, np.float32), 0.9)]


@pytest.fixture
def one_thread():
    """One intra-op thread (tests/test_torch_tools.py's rule): the ranks run
    one thread each, and several test processes at once make many threads
    an op wait for cores that the others hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


# ------------------------------------------------------------ the train step


@pytest.fixture(scope="module")
def jax_mesh_step():
    """JAX's float64 steps of SCHEDULE over its 8-device mesh: (initial
    params, batches, [items a step], params, ema) as numpy."""
    assert len(jax.devices()) >= 8, "conftest provides 8 virtual devices"
    model = JaxModel(CFG, TASKS, NCS)
    losses = {t: JaxLoss(nc=nc, strides=model.strides, tal_impl="xla")
              for t, nc in zip(TASKS, NCS)}
    batches = {"a": _batch(2, 0), "b": _batch(3, 1)}
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        model.init(jax.random.PRNGKey(0)))
        init = jax.tree_util.tree_map(np.asarray, params)
        trainer = JaxTrainer(model, losses, compute_dtype=jnp.float64)
        mesh = jax_mesh.make_mesh()
        with mesh:
            state = jax_mesh.replicate(jax_init_state(params), mesh)
            sharded = {t: jax_mesh.shard_batch(b, mesh) for t, b in batches.items()}
            items = []
            for lrs, mom in SCHEDULE:
                state, it = trainer.step(state, sharded, lrs, mom)
                items.append({t: [float(x) for x in v] for t, v in it.items()})
        out = jax.tree_util.tree_map(np.asarray, (state.params, state.ema_params))
    return init, batches, items, out[0], out[1]


@pytest.fixture(scope="module")
def rank_steps(jax_mesh_step, tmp_path_factory):
    """The two ranks' float64 steps of SCHEDULE: "split" over the 8 rows of
    each task, 4 a rank; "padded" over 7, rank 1's 3 padded to 4."""
    init, batches, _, _, _ = jax_mesh_step
    padded = {"a": _batch(2, 10, B=7), "b": _batch(3, 11, B=7)}
    job = dict(tasks=TASKS, ncs=NCS, init=init, n0=4, schedule=SCHEDULE,
               scenarios={"split": batches, "padded": padded})
    return _spawn("step", job, tmp_path_factory.mktemp("rank_steps")), padded


def test_two_rank_step_matches_jax_mesh_float64(jax_mesh_step, rank_steps):
    init, _, items_j, params_j, ema_j = jax_mesh_step
    (r0, r1), _ = rank_steps
    assert len(r0["split"]["items"]) == len(items_j) == len(SCHEDULE)
    for step, it_j in enumerate(items_j):
        for t in TASKS:
            np.testing.assert_allclose(r0["split"]["items"][step][t], it_j[t], rtol=3e-5,
                                       err_msg=f"step {step + 1}, {t}")
    _assert_updates_close(r0["split"]["params"], params_j, init, 1e-3)
    _assert_updates_close(r0["split"]["ema"], ema_j, init, 1e-3)
    # both ranks hold the same state, bit for bit
    assert r0["split"]["items"] == r1["split"]["items"]
    _assert_trees_equal(r0["split"]["params"], r1["split"]["params"])
    _assert_trees_equal(r0["split"]["ema"], r1["split"]["ema"])


def test_padded_rank_equals_unpadded_step(jax_mesh_step, rank_steps):
    init = jax_mesh_step[0]
    (r0, r1), padded = rank_steps
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").double()
    load_jax_params(model, init)
    trainer = MultiTaskTrainer(model, {t: DetectionLoss(nc=nc, strides=model.strides)
                                       for t, nc in zip(TASKS, NCS)},
                               compute_dtype=torch.float64, device="cpu")
    state = init_train_state(model)
    for step, (lrs, mom) in enumerate(SCHEDULE):
        state, items = trainer.step(state, padded, lrs, mom)
        for t in TASKS:
            np.testing.assert_allclose(r0["padded"]["items"][step][t],
                                       [float(x) for x in items[t]], rtol=3e-5,
                                       err_msg=f"step {step + 1}, {t}")
    _assert_updates_close(r0["padded"]["params"], export_jax_params(model), init, 1e-3)
    _assert_updates_close(r0["padded"]["ema"], export_jax_params(state.ema), init, 1e-3)
    _assert_trees_equal(r0["padded"]["params"], r1["padded"]["params"])


def test_group_of_one_equals_group_less_step_bit_for_bit(jax_mesh_step, tmp_path):
    """A rank alone in its group runs the group-less step's arithmetic (its
    all-reduces of one rank copy), so its steps equal the group-less
    steps bit for bit, as the captured step on one card must."""
    init, batches = jax_mesh_step[:2]
    job = dict(tasks=TASKS, ncs=NCS, init=init, schedule=SCHEDULE,
               scenarios={"split": batches})
    (alone,) = _spawn("step", job, tmp_path, world=1)
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").double()
    load_jax_params(model, init)
    trainer = MultiTaskTrainer(model, {t: DetectionLoss(nc=nc, strides=model.strides)
                                       for t, nc in zip(TASKS, NCS)},
                               compute_dtype=torch.float64, device="cpu")
    state, items = init_train_state(model), []
    for lrs, mom in SCHEDULE:
        state, it = trainer.step(state, batches, lrs, mom)
        items.append({t: [float(x) for x in v] for t, v in it.items()})
    assert alone["split"]["items"] == items
    _assert_trees_equal(alone["split"]["params"], export_jax_params(model))
    _assert_trees_equal(alone["split"]["ema"], export_jax_params(state.ema))


# ------------------------------------------------- sampler, padding, sharding


@pytest.mark.parametrize("n,hosts,shuffle", [(31, 2, False), (31, 2, True), (16, 4, True),
                                             (5, 3, False), (2, 4, False)])
def test_host_shard_sampler_matches_jax(n, hosts, shuffle):
    lens = []
    for host in range(hosts):
        ours = samplers.HostShardSampler(samplers.ShuffleSampler(n, shuffle, seed=3), hosts,
                                         host)
        ref = jax_samplers.HostShardSampler(jax_samplers.ShuffleSampler(n, shuffle, seed=3),
                                            hosts, host)
        for s in (ours, ref):
            s.set_epoch(2)
        assert len(ours) == len(ref) and list(ours) == list(ref)
        lens.append(len(list(ours)))
    # ceil(n / k) on every host; hosts at or past n % k yield one fewer
    assert sum(lens) == n
    if n == 31:
        assert lens == [16, 15] and len(ours) == 16


def test_host_shard_sampler_blocks_keep_rect_batches(tmp_path):
    """A rect loader shards whole batches, so every batch keeps its one
    letterbox shape; the two ranks' batches are the one-process loader's."""
    s = [list(samplers.HostShardSampler(samplers.ShuffleSampler(10, False), 2, h, block=4))
         for h in range(2)]
    assert s == [[0, 1, 2, 3, 8, 9], [4, 5, 6, 7]]
    assert len(samplers.HostShardSampler(samplers.ShuffleSampler(10, False), 2, 1, block=4)) \
        == 8
    src = write_val_set(str(tmp_path), 8, SIZES, seed=1)
    one = [b["img"].shape for b in create_dataloader(src, 64, 2, rect=True, pad=0.5,
                                                     cache_dir=str(tmp_path))[1]]
    ranks = []
    for h in range(2):
        _, loader = create_dataloader(src, 64, 2, rect=True, pad=0.5, cache_dir=str(tmp_path))
        loader.sampler = samplers.HostShardSampler(loader.sampler, 2, h, block=2)
        ranks.append([b["img"].shape for b in loader])
    assert ranks[0] == one[0::2] and ranks[1] == one[1::2]


@pytest.mark.parametrize("size", [6, 8])
def test_pad_batch_to_matches_jax(size):
    b = {**_batch(3, 5, B=6), "mask": np.tile([True, True, False, True], (6, 1))}
    ours, ref = pad_batch_to(b, size), jax_mesh.pad_batch_to({k: v.copy() for k, v in
                                                              b.items()}, size)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)
        assert ours[k].dtype == np.asarray(ref[k]).dtype
    # a tensor batch stays on its device, in the tensor's dtype
    t = pad_batch_to({k: torch.from_numpy(v) for k, v in b.items()}, size)
    for k in ref:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_shard_batch_splits_rows_in_order():
    b = _batch(2, 0)
    shards = shard_batch(b, make_mesh(["cpu", "cpu"]))
    assert [s["img"].device.type for s in shards] == ["cpu", "cpu"]
    np.testing.assert_array_equal(torch.cat([s["cls"] for s in shards]).numpy(), b["cls"])
    np.testing.assert_array_equal(shard_batch(b, 4, index=3)["img"], b["img"][6:])
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(b, 3)


# ---------------------------------------------------------------- val


def _seeded_tree():
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0).double()
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for t in TASKS:
            head = model.block(model.head_uid(t))
            for i in range(head.nl):
                b = getattr(head, f"box{i}")[2].b
                b.copy_(torch.randn(b.shape, generator=gen, dtype=b.dtype) * 3.0)
    calibrate_bn(model, torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (4, 3, 64, 96))))
    return export_jax_params(model)


def test_distributed_val_matches_one_process_and_jax(tmp_path):
    tree = _seeded_tree()
    model = load_jax_params(CerberusModel(CFG, TASKS, NCS, device="cpu"), tree).double()
    sets = {}
    for i, (t, nc) in enumerate(zip(TASKS, NCS)):
        sets[t] = write_val_set(str(tmp_path / t), 8, SIZES, seed=10 + i)
        _, loader = create_dataloader(sets[t], 64, 4, rect=True, pad=0.5, task="seed",
                                      cache_dir=str(tmp_path / t))
        dets = run_task(model, t, loader, nc, return_dets=True)["dets"]
        write_labels({p: d[:4] for p, d in dets.items()})
    job = dict(tasks=TASKS, ncs=NCS, tree=tree, val_sets=sets, cache=str(tmp_path / "cache"))
    ranks = _spawn("val", job, tmp_path)
    jmodel = JaxModel(CFG, TASKS, NCS)
    for t, nc in zip(TASKS, NCS):
        dl = dict(imgsz=64, batch_size=4, augment=False, rect=True, pad=0.5, task=f"{t}_val",
                  cache_dir=str(tmp_path / t), max_labels=16)
        one = run_task(model, t, create_dataloader(sets[t], **dl)[1], nc, plots=True)
        with jax.enable_x64():
            params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
            ref = jax_val.run_task(jmodel, params, t,
                                   jax_create_dataloader(sets[t], shuffle=False, **dl)[1], nc,
                                   compute_dtype=jnp.float64, plots=True)
        assert one["metrics"].stats and one["results"][2] > 0
        for r in ranks:
            ours = r[t]
            # each rank validated one of the two rect batches, then merged them all
            assert len(ours["shapes"]) == 1 and ours["seen"] == one["seen"] == 8
            assert ours["n_stats"] == 2  # one merged entry a rank, as JAX's merge
            np.testing.assert_allclose(ours["results"][:4], one["results"][:4], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(ours["results"][:4], ref["results"][:4], rtol=0,
                                       atol=1e-6)
            np.testing.assert_allclose(ours["maps"], one["maps"], rtol=0, atol=1e-6)
            assert ours["fitness"] == pytest.approx(ref["fitness"], abs=1e-6)
            np.testing.assert_array_equal(ours["confusion"].sum(0),
                                          one["confusion"].matrix.sum(0))
        assert sorted(s for r in ranks for s in r[t]["shapes"]) == \
            sorted(s[0] for s in one["times"])


# -------------------------------------------------------------- serving


def _distinct_heads(params, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    for t in TASKS:
        for i in range(3):
            last = params[f"head_{t}"][f"box{i}"]["2"]
            last["b"] = rng.normal(0, 3, last["b"].shape).astype(np.float32)
    return params


def test_mesh_serving_matches_jax_mesh_float64():
    x = np.random.default_rng(3).uniform(0, 1, (8, 64, 64, 3))
    shapes = [(96, 128), (64, 64), (50, 80), (128, 96)] * 2
    model = JaxModel(CFG, TASKS, NCS)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        _distinct_heads(model.init(jax.random.PRNGKey(0)), 1))
        ref = JaxInference(model=model, params=params, names=NAMES, conf_thres=1e-4,
                           img_size=64, half=False, dtype=jnp.float64,
                           mesh=jax_mesh.make_mesh()).predict(x, original_shape=shapes)
    params = jax.tree_util.tree_map(np.asarray, params)
    kw = dict(names=NAMES, conf_thres=1e-4, img_size=64, dtype=torch.float64, device="cpu")
    one = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                               params=params, **kw)
    kw.pop("device")
    ours = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu"),
                                params=params, mesh=make_mesh(["cpu", "cpu"]), **kw)
    assert len(ours.replicas) == 2 and ours.replicas[0] is ours.model
    assert ours.replicas[1] is not ours.model
    dets = ours.predict(x, original_shape=shapes)
    assert dets == one.predict(x, original_shape=shapes)
    assert len(dets) == len(ref)
    for ro, rr in zip(dets, ref):
        assert len(ro) == len(rr)
        for o, r in zip(ro, rr):
            assert (o["task"], o["label"], o["label_name"]) == \
                (r["task"], r["label"], r["label_name"]), (o, r)
            np.testing.assert_allclose(o["score"], r["score"], rtol=1e-9)
            assert max(abs(a - b) for a, b in zip(o["box"], r["box"])) <= 1, (o, r)
    assert all(sum(d["task"] == t for r in dets for d in r) > 0 for t in TASKS)
    with pytest.raises(ValueError, match="does not divide over the 2-device mesh"):
        ours.predict(x[:3])


def test_mesh_serving_int8_replicas_equal_one_device():
    """int8 "all" over a mesh of two: each replica quantized identically, the
    rows' detections those of one device."""
    x = np.random.default_rng(4).uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)
    kw = dict(names=NAMES, conf_thres=1e-3, img_size=64, dtype=torch.float32, int8="all",
              calib_batches=[x])
    one = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu").init(0),
                               device="cpu", **kw)
    ours = CerberusDetInference(model=CerberusModel(CFG, TASKS, NCS, device="cpu").init(0),
                                mesh=make_mesh(["cpu", "cpu"]), **kw)
    assert len(ours._int8_convs[1]) == len(one.int8_convs) > 0
    assert ours.predict(x) == one.predict(x)


# ------------------------------------------------------------ the loop


@pytest.mark.slow
def test_two_rank_trainloop(tmp_path):
    """The whole TrainLoop over 2 ranks, 1 epoch: host-sharded train
    loaders, rank-0 val and checkpoints, the broadcast decision; both ranks
    end with the same state."""
    data = {"task_ids": TASKS, "nc": NCS, "names": [NAMES[t] for t in TASKS],
            "train": [], "val": []}
    for i, (t, nc) in enumerate(zip(TASKS, NCS)):
        data["train"].append(write_val_set(str(tmp_path / t / "train"), 8, SIZES, seed=i,
                                           n_labels=3, nc=nc))
        data["val"].append(write_val_set(str(tmp_path / t / "val"), 4, SIZES, seed=10 + i,
                                         n_labels=2, nc=nc))
    options = dict(cfg=CFG, epochs=1, batch_size=[2, 2], imgsz=64,
                   project=str(tmp_path / "runs"), name="mesh", plots=False,
                   warmup_min_iters=2, workers=1, max_labels=16, seed=3, use_mesh=True)
    r0, r1 = _spawn("trainloop", dict(options=options, data=data), tmp_path)
    assert r0["nb"] == r1["nb"] == 2 and r0["steps"] == r1["steps"] == 2
    assert r0["rows"] == r1["rows"] == [4, 4]  # each rank's half of the 8 images
    assert r0["save_dir"] == r1["save_dir"] and r0["ckpt_written"]
    assert r0["fitness"] == pytest.approx(r1["fitness"], abs=1e-12)
    for k, v in r0["params"].items():
        np.testing.assert_array_equal(v, r1["params"][k], err_msg=k)
