"""The port's checkpoint Ensemble and orbax reader against the JAX package,
on the CPU at yolov8n_2task, 64 px:

  * attempt_load([a, b]) of two seeded checkpoints (BatchNorm statistics
    from a seeded batch), both packages' members cast to float64 and fused
    in float64 (JAX under enable_x64): the Ensemble's candidates, which
    concatenate the members' on the anchor axis, and their per-task NMS
    equal JAX's;
  * a directory written by the JAX package's save_checkpoint_orbax reads in
    the port equal to the JAX .npz of the same tree, loads through
    load_single as the .npz does, and without tensorstore the orbax route
    raises ImportError with its reason; the port refuses to write one."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cerberusdet_tpu.manager import checkpoint as jax_ckpt
from cerberusdet_tpu.manager.attempt_load import attempt_load as jax_attempt_load
from cerberusdet_tpu.nn.module import Ctx
from cerberusdet_tpu.ops.nms import non_max_suppression as jax_nms
from cerberusdet_tpu_torch.manager import checkpoint
from cerberusdet_tpu_torch.manager.attempt_load import Ensemble, attempt_load, load_single
from cerberusdet_tpu_torch.manager.weights import export_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.ops.nms import non_max_suppression
from cerberusdet_tpu_torch.testing import calibrate_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
TASKS, NCS = ["a", "b"], [3, 5]
NAMES = [["c0", "c1", "c2"], [f"k{i}" for i in range(5)]]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("ensemble")
    paths = []
    for seed in (0, 1):
        model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(seed)
        calibrate_bn(model, torch.from_numpy(np.random.default_rng(10 + seed).uniform(
            0, 1, (4, 3, 64, 64)).astype(np.float32)))
        path = str(root / f"m{seed}.ckpt.npz")
        checkpoint.save_checkpoint(path, export_jax_params(model), {
            "cfg": CFG, "task_ids": TASKS, "nc": NCS, "names": NAMES}, half=False)
        paths.append(path)
    return paths


def test_ensemble_float64_matches_jax(ckpts):
    x = np.random.default_rng(3).uniform(0, 1, (3, 64, 64, 3))
    ens, meta = attempt_load(ckpts, fuse=False, device="cpu")
    assert isinstance(ens, Ensemble) and meta["task_ids"] == TASKS
    for m in ens.members:
        m.to(torch.float64).fuse()
    with torch.no_grad():
        ours = ens.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    with jax.enable_x64():
        ref, _, _ = jax_attempt_load(ckpts, fuse=False)
        ref.members = [(m, m.fuse(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), p))) for m, p in ref.members]
        theirs = ref(jnp.asarray(x), Ctx(train=False, dtype=jnp.float64))
        ref_dets = {t: jax_nms(theirs[t], nc=nc, conf_thres=0.01, iou_thres=0.6,
                               multi_label=True, max_det=300)
                    for t, nc in zip(TASKS, NCS)}
    single = load_single(ckpts[0], fuse=False, device="cpu")[0].to(torch.float64).fuse()
    with torch.no_grad():
        n_one = single.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))["a"][0].shape[1]
    for t, nc in zip(TASKS, NCS):
        pred = np.asarray(theirs[t])
        assert ours[t].shape == pred.shape == (3, 2 * n_one, 4 + nc)
        # the decode is float32 on both sides, from float64 logits: boxes
        # (pixels, up to 64) agree to a few float32 ulps
        np.testing.assert_allclose(ours[t].numpy(), pred, rtol=1e-6, atol=1e-4)
        dets, counts = non_max_suppression(ours[t], nc=nc, conf_thres=0.01, iou_thres=0.6,
                                           multi_label=True, max_det=300)
        rd, rc = (np.asarray(v) for v in ref_dets[t])
        np.testing.assert_array_equal(counts.numpy(), rc)
        assert counts.sum() > 0
        for i, n in enumerate(rc):
            np.testing.assert_allclose(dets[i, :n].numpy(), rd[i, :n], rtol=1e-5, atol=1e-4)


def test_attempt_load_one_weight_is_load_single(ckpts):
    model, meta = attempt_load([ckpts[1]], device="cpu")
    ref, _ = load_single(ckpts[1], device="cpu")
    assert not isinstance(model, Ensemble) and meta["nc"] == NCS
    for (k, a), (_, b) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), k
    with pytest.raises(ValueError, match="empty"):
        Ensemble([])


def _tree(seed: int):
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(seed)
    return export_jax_params(model)


def _same(a, b, what):
    fa, fb = checkpoint.flatten_tree(a), checkpoint.flatten_tree(b)
    assert set(fa) == set(fb), (what, set(fa) ^ set(fb))
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), (what, k)


@pytest.mark.parametrize("with_opt", [True, False])
def test_orbax_directory_reads_as_its_npz(tmp_path, with_opt):
    meta = {"epoch": 2, "task_ids": TASKS, "nc": NCS, "names": NAMES, "cfg": CFG,
            "n_updates": 9}
    extra = dict(ema_params=_tree(1), opt_momentum=_tree(2)) if with_opt else {}
    npz, odir = tmp_path / "last.ckpt.npz", tmp_path / "last.ckpt"
    jax_ckpt.save_checkpoint(npz, _tree(0), meta, **extra)
    jax_ckpt.save_checkpoint(odir, _tree(0), meta, **extra)
    assert odir.is_dir() and checkpoint.is_orbax_path(odir)
    want, got = checkpoint.load_checkpoint(npz), checkpoint.load_checkpoint(str(odir))
    assert got["meta"] == want["meta"] == meta
    for group in ("params", "ema", "opt"):
        if want[group] is None:
            assert got[group] is None, group
        else:
            _same(got[group], want[group], group)
    a, b = load_single(str(odir), device="cpu")[0], load_single(str(npz), device="cpu")[0]
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), k


def test_orbax_without_tensorstore_and_no_writer(tmp_path, monkeypatch):
    odir = tmp_path / "w.ckpt"
    jax_ckpt.save_checkpoint(odir, {"a": {"w": np.ones(3, np.float32)}}, {"epoch": 0})
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        checkpoint.load_checkpoint(odir)
    with pytest.raises(ValueError, match="npz checkpoints only"):
        checkpoint.save_checkpoint(tmp_path / "port_dir", {"a": {"w": np.ones(3)}}, {})
