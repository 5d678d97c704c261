"""The port's training entry point (train/trainer.py, manager/, cli/train.py)
against the JAX package's, on the CPU at yolov8n_2task, 64 px.

  * The loop's schedule: each package's MultiTaskTrainer.step is replaced
    in the test by a recorder that returns the state unchanged. Over 2
    epochs with skip_batches, freeze_shared_till_epoch=1 and a warmup that
    ends inside the run, both TrainLoops feed the step identical batches
    (bit for bit), learning rates, momentum, active tasks and freeze flags.
  * The per-epoch val of the same EMA weights, in float64 on both sides
    (JAX under enable_x64, its run_task given compute_dtype float64 by the
    test): identical results.txt lines (5 decimals) and fitness within 1e-6,
    as tests/test_torch_val.py holds run_task.
  * Checkpoints both ways: a JAX-written last.ckpt.npz resumes in the port
    with the same params, EMA, momentum and n_updates (exactly); a
    port-written one resumes in the JAX TrainLoop and loads through JAX's
    load_checkpoint and load_single (exactly; fused within rtol 1e-5, each
    package fusing in float32); strip_checkpoint writes the same contents.
  * cli/train.py on --device cpu: a single-cls run, --resume reinstating
    the run's opt.yaml in place, --resume auto picking the newest run by
    modification time (after tests/test_cli.py:115-240).
TensorBoard's writer is stubbed out (importing it can pull in TensorFlow, ~15 s)."""

import os
import shutil
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import cerberusdet_tpu.train.trainer as jax_trainer
from cerberusdet_tpu.manager import checkpoint as jax_ckpt
from cerberusdet_tpu.manager.attempt_load import load_single as jax_load_single
from cerberusdet_tpu.manager.run_manager import RunManager as JaxRunManager
from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.train.optim import SGDState
from cerberusdet_tpu.train.step import MultiTaskTrainer as JaxStepper
from cerberusdet_tpu.train.step import init_train_state as jax_init_state
from cerberusdet_tpu_torch.cli import train as cli
from cerberusdet_tpu_torch.data.loaders import create_dataloader
from cerberusdet_tpu_torch.evaluation.val import run_task
from cerberusdet_tpu_torch.manager import checkpoint
from cerberusdet_tpu_torch.manager.attempt_load import load_single
from cerberusdet_tpu_torch.manager.run_manager import RunManager
from cerberusdet_tpu_torch.manager.weights import (
    export_jax_momentum,
    export_jax_params,
    load_jax_momentum,
)
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.testing import calibrate_bn, write_labels, write_val_set
from cerberusdet_tpu_torch.train import trainer as port_trainer
from cerberusdet_tpu_torch.train.step import MultiTaskTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]
NAMES = [["c0", "c1", "c2"], ["k0", "k1", "k2", "k3", "k4"]]
SIZES = [(80, 60), (60, 80), (64, 64), (100, 40), (120, 70), (640, 480)]
with open(os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml")) as _f:
    HYP = {**yaml.safe_load(_f), "warmup_epochs": 0.5}  # the paper's, warmup shortened


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(RunManager, "tb_writer", lambda self: None)
    monkeypatch.setattr(JaxRunManager, "tb_writer", lambda self: None)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(a, b, what=""):
    a, b = dict(_flat(a)), dict(_flat(b))
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype, (what, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {'/'.join(k)}")


def _seeded_model():
    """yolov8n_2task, init(0), BatchNorm statistics from a seeded batch."""
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0)
    calibrate_bn(model, torch.from_numpy(
        np.random.default_rng(2).uniform(0, 1, (4, 3, 64, 64)).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A 2-task data.yaml (train: 8 / 4 images, val: 4 / 4 labelled with the
    seeded model's own detections) and that model as a .ckpt.npz."""
    root = tmp_path_factory.mktemp("torch_trainer")
    model = _seeded_model()
    weights = str(root / "seeded.ckpt.npz")
    checkpoint.save_checkpoint(weights, export_jax_params(model),
                               {"cfg": CFG, "task_ids": TASKS, "nc": NCS, "names": NAMES},
                               half=False)
    fused = _seeded_model().fuse().eval()
    data = {"task_ids": TASKS, "nc": NCS, "names": NAMES, "train": [], "val": []}
    for ti, (t, nc) in enumerate(zip(TASKS, NCS)):
        data["train"].append(write_val_set(str(root / t / "train"), 8 if ti == 0 else 4, SIZES,
                                           seed=ti, n_labels=3, nc=nc))
        val = write_val_set(str(root / t / "val"), 4, SIZES, seed=10 + ti)
        _, loader = create_dataloader(val, 64, 2, task="seed", cache_dir=str(root / t))
        dets = run_task(fused, t, loader, nc, return_dets=True)["dets"]
        write_labels({p: d[:4] for p, d in dets.items()})
        data["val"].append(val)
    data_yaml = root / "data.yaml"
    data_yaml.write_text(yaml.safe_dump(data))
    return root, data, str(data_yaml), weights


def _options(mod, root, name, **kw):
    base = dict(cfg=CFG, epochs=2, batch_size=[2, 2], imgsz=64, project=str(root / "runs"),
                name=name, nosave=True, plots=False, warmup_min_iters=3, workers=2,
                max_labels=16, seed=3)
    return mod.TrainOptions(**{**base, **kw})


def _jax_loop(opt, data, **kw):
    return jax_trainer.TrainLoop(opt, data, dict(HYP), use_mesh=False, **kw)


def _port_loop(opt, data):
    return port_trainer.TrainLoop(opt, data, dict(HYP), device="cpu")


# ----------------------------------------------------------- the schedule


def test_loop_feeds_the_step_as_jax_does(case, monkeypatch):
    root, data, _, weights = case
    calls = {"jax": [], "port": []}

    def recorder(key, zero):
        def step(self, state, batches, lrs, momentum, freeze_shared=False, **_):
            calls[key].append((list(batches), {t: {k: np.asarray(v) for k, v in b.items()}
                                               for t, b in batches.items()},
                               np.asarray(lrs), float(momentum), bool(freeze_shared)))
            z = zero()
            return state, {t: types.SimpleNamespace(box=z, cls=z, dfl=z) for t in batches}
        return step

    monkeypatch.setattr(JaxStepper, "step", recorder("jax", lambda: jnp.zeros(())))
    monkeypatch.setattr(MultiTaskTrainer, "step", recorder("port", lambda: torch.zeros(())))
    kw = dict(skip_batches=True, freeze_shared_till_epoch=1, weights=weights)
    ours = _port_loop(_options(port_trainer, root, "sched_port", **kw), data)
    ref = _jax_loop(_options(jax_trainer, root, "sched_jax", **kw), data)
    assert (ours.nb, ours.nw, ours.iters_per_task) == (ref.nb, ref.nw, ref.iters_per_task) == (
        4, 3, [1, 2])
    for epoch in (0, 1):
        out = ours.train_epoch(epoch)
        ref.train_epoch(epoch)
        assert set(out) == set(TASKS) and all(np.all(v == 0) for v in out.values())
    assert len(calls["port"]) == len(calls["jax"]) == 8
    for i, (a, b) in enumerate(zip(calls["port"], calls["jax"])):
        assert a[0] == b[0], i  # the active tasks, in order
        for t in a[0]:
            assert sorted(a[1][t]) == sorted(b[1][t]) == ["bboxes", "cls", "img", "mask",
                                                            "prob"]
            for k in a[1][t]:
                assert a[1][t][k].dtype == b[1][t][k].dtype
                np.testing.assert_array_equal(a[1][t][k], b[1][t][k], err_msg=f"{i} {t} {k}")
        np.testing.assert_array_equal(a[2], b[2])
        assert a[3] == b[3] and a[4] == b[4], i
    assert [c[0] for c in calls["port"][:4]] == [["a", "b"], ["a"], ["a", "b"], ["a"]]
    assert [c[4] for c in calls["port"]] == [True] * 4 + [False] * 4
    lrs = [c[2] for c in calls["port"]]
    assert lrs[2][2] != lrs[2][0] and lrs[3][2] == lrs[3][0]  # warmup ends at ni 3
    assert len(ours.timings) == 8


# ------------------------------------------------------------ the val


def test_epoch_val_of_the_ema_matches_jax(case, monkeypatch):
    root, data, _, weights = case
    ours = _port_loop(_options(port_trainer, root, "val_port", weights=weights), data)
    ref = _jax_loop(_options(jax_trainer, root, "val_jax", weights=weights), data)
    ours.state.ema.double()
    fit = ours.val_epoch(0)
    real_run_task = jax_trainer.run_task
    monkeypatch.setattr(jax_trainer, "run_task",
                        lambda *a, **k: real_run_task(*a, compute_dtype=jnp.float64, **k))
    with jax.enable_x64():
        ref.state.ema_params = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float64),
                                                      ref.state.ema_params)
        fit_ref = ref.val_epoch(0)
    lines = ours.manager.results_file.read_text()
    assert lines == ref.manager.results_file.read_text()
    assert lines.count("\n") == 2 and fit == pytest.approx(fit_ref, abs=1e-6)
    assert fit > 0.05, lines  # the seeded model finds its own detections


# ------------------------------------------------------------ checkpoints


def _random_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.asarray(a).dtype), tree)


def test_jax_checkpoint_resumes_in_the_port(case):
    root, data, _, _ = case
    jmodel = JaxModel(CFG, TASKS, NCS)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
    state = jax_init_state(params)
    state.ema_params = _random_like(params, 2)
    state.opt_state = SGDState(momentum_buf=_random_like(params, 3), step=jnp.asarray(7))
    state.n_updates = 7
    jman = JaxRunManager(HYP, data, CFG, root / "runs" / "from_jax")
    jman.best_fitness, jman.best_fitness_per_task = 0.25, {"a": 0.5, "b": 0.125}
    jman.save_model(state, epoch=3, is_best=True)
    path = str(jman.wdir / "last.ckpt.npz")
    ours = _port_loop(_options(port_trainer, root, "resume_port", epochs=6, resume=path), data)
    saved = jax_ckpt.load_checkpoint(path)
    _same_tree(export_jax_params(ours.model), saved["params"], "params")
    _same_tree(export_jax_params(ours.state.ema), saved["ema"], "ema")
    momentum = export_jax_momentum(ours.model, ours.state.opt_state.momentum_buf)
    for k, v in _flat(saved["opt"]):
        if k[-1] in ("mean", "var"):  # the JAX tree's buffers at BN statistics
            continue
        np.testing.assert_array_equal(dict(_flat(momentum))[k], v, err_msg="/".join(k))
    assert ours.state.n_updates == ours.state.opt_state.step == 7
    assert ours.start_epoch == 4 and ours.manager.best_fitness == 0.25
    assert ours.manager.best_fitness_per_task == {"a": 0.5, "b": 0.125}


def test_port_checkpoint_resumes_in_jax(case, tmp_path):
    root, data, _, _ = case
    ours = _port_loop(_options(port_trainer, root, "to_jax", nosave=False), data)
    st = ours.state
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.01)
        for t in list(st.ema.state_dict().values()) + list(st.opt_state.momentum_buf.values()):
            t.copy_(torch.randn(t.shape, generator=gen))
    st.n_updates = st.opt_state.step = 5
    ours.manager.save_model(st, epoch=1, is_best=True)
    last = str(ours.manager.wdir / "last.ckpt.npz")
    ref = _jax_loop(_options(jax_trainer, root, "from_port", epochs=4, resume=last), data)
    expect = export_jax_params(st.model)
    _same_tree(jax.tree_util.tree_map(np.asarray, ref.state.params), expect, "params")
    _same_tree(jax.tree_util.tree_map(np.asarray, ref.state.ema_params),
               export_jax_params(st.ema), "ema")
    _same_tree(jax.tree_util.tree_map(np.asarray, ref.state.opt_state.momentum_buf),
               export_jax_momentum(st.model, st.opt_state.momentum_buf), "momentum")
    assert int(ref.state.n_updates) == 5 and ref.start_epoch == 2
    # and back: the momentum tree reads in as the port's buffers
    back = load_jax_momentum(st.model, jax_ckpt.load_checkpoint(last)["opt"])
    assert all(torch.equal(back[k], v) for k, v in st.opt_state.momentum_buf.items())

    best = str(ours.manager.wdir / "best.ckpt.npz")  # params and EMA in float16
    _, jparams, meta = jax_load_single(best, fuse=False)
    assert meta["epoch"] == 1 and meta["n_updates"] == 5
    half = jax.tree_util.tree_map(lambda a: a.astype(np.float16).astype(np.float32),
                                  export_jax_params(st.ema))
    _same_tree(jax.tree_util.tree_map(np.asarray, jparams), half, "best ema")
    _, jfused, _ = jax_load_single(best, fuse=True)
    fused = export_jax_params(load_single(best, fuse=True, device="cpu")[0])
    jf = dict(_flat(jax.tree_util.tree_map(np.asarray, jfused)))
    assert sorted(jf) == sorted(dict(_flat(fused)))
    for k, v in _flat(fused):
        np.testing.assert_allclose(v, jf[k], rtol=1e-5, atol=1e-6, err_msg="/".join(k))

    a, b = tmp_path / "port.ckpt.npz", tmp_path / "jax.ckpt.npz"
    shutil.copy(last, a)
    shutil.copy(last, b)
    checkpoint.strip_checkpoint(a)
    jax_ckpt.strip_checkpoint(b)
    with np.load(a) as x, np.load(b) as y:
        assert x.files == y.files and not any(k.startswith("opt/") for k in x.files)
        for k in x.files:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_intersect_and_pretrained_load(case):
    root, data, _, weights = case
    src = checkpoint.load_checkpoint(weights)["params"]
    dst = export_jax_params(CerberusModel(CFG, TASKS, [3, 2], device="cpu").init(5))
    merged, n, total = checkpoint.intersect_trees(dst, src)
    ref, n_ref, total_ref = jax_ckpt.intersect_trees(dst, src)
    assert (n, total) == (n_ref, total_ref) and 0 < n < total
    _same_tree(merged, ref)
    man = RunManager(HYP, {**data, "nc": [3, 2], "names": [NAMES[0], ["x", "y"]]}, CFG,
                     root / "runs" / "pretrained", device="cpu")
    model, meta = man.load_model(weights, seed=5)
    assert meta["task_ids"] == TASKS
    _same_tree(export_jax_params(model), merged)


def test_refusals(case):
    root, data, _, _ = case
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        _port_loop(_options(port_trainer, root, "mesh", use_mesh=True), data)
    # --mlflow-url is ported: without mlflow installed the run gets a no-op logger
    man = RunManager(HYP, data, CFG, root / "runs" / "mlflow", mlflow_url="http://localhost:1",
                     device="cpu")
    assert man.mlflow is not None and not man.mlflow.active
    with pytest.raises(ValueError, match="architecture metadata"):  # .pt needs cfg, tasks, nc
        load_single("w.pt", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--data", case[2], "--device", "cuda"])


# -------------------------------------------------------------------- CLI


def _cli_args(case, project, *extra):
    return ["--data", case[2], "--cfg", CFG, "--hyp",
            os.path.join(ROOT, "configs", "hyps", "hyp.cerber-voc_obj365.yaml"),
            "--epochs", "1", "--batch-size", "2", "--imgsz", "64", "--project", str(project),
            "--name", "exp", "--workers", "2", "--device", "cpu", "--warmup-min-iters", "2",
            *extra]


def test_cli_single_cls_run(case, tmp_path):
    loop = cli.main(_cli_args(case, tmp_path, "--single-cls", "--sync-bn"))
    w = tmp_path / "exp" / "weights"
    ckpt = checkpoint.load_checkpoint(str(w / "last.ckpt.npz"))
    assert ckpt["meta"]["nc"] == [1, 1] and ckpt["meta"]["names"] == [["item"], ["item"]]
    assert ckpt["meta"].get("stripped") and ckpt["opt"] is None  # finalised
    assert set(loop.final_val) == {"last", "best"} and (w / "best.ckpt.npz").exists()
    lines = (tmp_path / "exp" / "results.txt").read_text().splitlines()
    assert [ln.split()[:4] for ln in lines] == [["epoch", "0", "task", "a"],
                                                ["epoch", "0", "task", "b"]]
    assert loop.model.nc == {"a": 1, "b": 1} and len(loop.timings) == 4


def test_cli_resume_reinstates_opt_yaml(case, tmp_path):
    cli.main(_cli_args(case, tmp_path))
    ckpt = tmp_path / "exp" / "weights" / "last.ckpt.npz"
    saved = yaml.safe_load((tmp_path / "exp" / "opt.yaml").read_text())
    saved["epochs"] = 2  # the run is extended by one epoch through its opt.yaml
    (tmp_path / "exp" / "opt.yaml").write_text(yaml.safe_dump(saved))
    # the flags of the resume command that conflict are overridden by opt.yaml;
    # the finalised (stripped) last.ckpt.npz resumes from its EMA, epoch 0 done
    loop = cli.main(["--data", case[2], "--imgsz", "96", "--batch-size", "4", "--device",
                     "cpu", "--project", str(tmp_path), "--resume", str(ckpt)])
    saved = yaml.safe_load((tmp_path / "exp" / "opt.yaml").read_text())
    assert saved["imgsz"] == 64 and saved["batch_size"] == 2 and saved["resume"] == str(ckpt)
    assert loop.start_epoch == 1 and len(loop.timings) == 4  # one epoch of 4 steps
    assert [p.name for p in tmp_path.iterdir() if p.is_dir()] == ["exp"]
    assert (tmp_path / "exp" / "results.txt").read_text().count("epoch 1 task") == 2


def test_cli_resume_auto_picks_newest_by_mtime(case, tmp_path, monkeypatch):
    project = tmp_path / "runs"
    for name, age in (("exp10", 100), ("exp9", 0)):  # exp9 is the newer
        w = project / name / "weights"
        w.mkdir(parents=True)
        (w / "last.ckpt.npz").write_bytes(b"x")
        t = time.time() - age
        os.utime(w / "last.ckpt.npz", (t, t))
    captured = {}

    class Stop(Exception):
        pass

    class FakeLoop:
        def __init__(self, opt, *a, **kw):
            captured["resume"] = opt.resume
            raise Stop

    monkeypatch.setattr(port_trainer, "TrainLoop", FakeLoop)
    with pytest.raises(Stop):
        cli.main(["--data", case[2], "--project", str(project), "--device", "cpu",
                  "--resume"])
    assert Path(captured["resume"]).parent.parent.name == "exp9"
    with pytest.raises(SystemExit):
        cli.main(["--data", case[2], "--project", str(tmp_path / "none"), "--device", "cpu",
                  "--resume"])


@pytest.mark.parametrize("flag,item", [
    (["--evolve", "2"], "item 9"), (["--mesh"], "item 6"), (["--augment-device"], "item 8"),
    (["--proc-workers", "2"], "item 2"), (["--cache-images", "disk"], "item 2"),
    (["--mlflow-url", "http://localhost:1"], "item 9")])
def test_cli_refuses_what_is_not_ported(case, tmp_path, flag, item, monkeypatch):
    class Stop(Exception):
        pass

    seen = {}
    if item == "item 9":
        # ported (tests/test_torch_integrations.py, tests/test_torch_evolve_cli.py):
        # --evolve reaches the evolver, --mlflow-url the run's MLflow logger
        from cerberusdet_tpu_torch.evolve import yolov5_evolver
        from cerberusdet_tpu_torch.utils import mlflow_logging

        def evolver(opt, hyp, data, generations, params_to_evolve, device, seed):
            seen.update(name=opt.name, generations=generations, device=device)
            raise Stop

        def logger(experiment, run, tracking_uri):
            seen.update(experiment=experiment, run=run, uri=tracking_uri)
            raise Stop

        monkeypatch.setattr(yolov5_evolver, "Yolov5Evolver", evolver)
        monkeypatch.setattr(mlflow_logging, "MLFlowLogger", logger)
        with pytest.raises(Stop):
            cli.main(_cli_args(case, tmp_path, *flag))
        if flag[0] == "--evolve":
            assert seen == {"name": "yolov5_exp", "generations": 2,
                            "device": torch.device("cpu")}
        else:
            assert seen == {"experiment": "cerberusdet", "run": "exp",
                            "uri": "http://localhost:1"}
        return
    if item in ("item 2", "item 8"):
        # ported (tests/test_torch_loaders.py trains with them): the flags
        # reach TrainLoop's options as the JAX CLI passes them

        def loop(opt, *a, **kw):
            seen.update(cache=opt.cache_images, procs=opt.proc_workers,
                        device_aug=opt.augment_device)
            raise Stop

        monkeypatch.setattr(port_trainer, "TrainLoop", loop)
        with pytest.raises(Stop):
            cli.main(_cli_args(case, tmp_path, *flag))
        want = {"--augment-device": ("", 0, True), "--proc-workers": ("", 2, False),
                "--cache-images": ("disk", 0, False)}[flag[0]]
        assert (seen["cache"], seen["procs"], seen["device_aug"]) == want
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        cli.main(_cli_args(case, tmp_path, *flag))
    assert not (tmp_path / "exp").exists()
