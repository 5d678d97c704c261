"""The port's spatial (image-height) sharding (cerberusdet_tpu_torch/parallel/
spatial.py) against the one-process forward and against the JAX package's
make_spatial_forward, on the CPU.

The ranks are four processes of tests/torch_parallel_worker.py in a Gloo
group joined through a file:// init method, started once for every
scenario: the four ranks as one spatial mesh, as a 2 x 2 (data, spatial)
mesh, and as two spatial meshes of two ranks each ({0, 1} and {2, 3}). Each
rank returns its run's predictions beside the one-process forward of the
same model on the same image in the same process. Tolerances, and why:
  * sharded against one process: bit for bit, as tests/test_spatial.py
    holds JAX's. Each output element is the same sums in the same order on
    both sides: a rank's conv sees its halo rows where the one process sees
    its neighbours' rows, and zero rows where the one process pads with
    zeros, whose products add +0.0. The float forwards compare in float64:
    the CPU's float32 F.conv2d (oneDNN) picks its algorithm by the map's
    size, so its sums depend on the height (an 8 -> 16 channel 3x3 conv over
    128 rows of 32 gives rows 64.. that differ by ~1e-5 from the same conv
    over those rows framed by their halo), where float64's does not;
  * int8 "all" propagated, in float32: bit for bit (integer sums, the same
    epilogue; its float parts are pointwise);
  * against JAX's make_spatial_forward over its 8 virtual devices:
    tests/test_torch_cerberus.py:test_forward_matches_jax's limits (rtol
    1e-4, atol 1e-4 of the largest value: float32 sums in other orders).
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
import yaml

from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu.parallel import make_spatial_forward as jax_spatial_forward
from cerberusdet_tpu.parallel import make_spatial_mesh as jax_spatial_mesh
from cerberusdet_tpu_torch.manager.weights import export_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.parallel import (
    check_spatial_shape,
    make_data_spatial_mesh,
    make_spatial_forward,
    make_spatial_mesh,
)
from cerberusdet_tpu_torch.testing import BLOCKS_CFG, ZOO_CFG, calibrate_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
TASKS, NCS = ["a", "b"], [3, 5]
WORLD = 4


def _img(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32))


def _tree(cfg, seed):
    """A seeded model's JAX-layout parameters, BatchNorm statistics from one
    batch (so that every layer's activations matter)."""
    model = CerberusModel(cfg, TASKS, NCS, device="cpu").init(seed)
    calibrate_bn(model, _img((2, 3, 64, 64), seed + 100))
    return export_jax_params(model)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(job, the four ranks' outputs)."""
    tmp = tmp_path_factory.mktemp("spatial")
    job = {
        "tasks": TASKS, "ncs": NCS, "tmp": str(tmp),
        "cfgs": {"v8n": CFG, "zoo": ZOO_CFG, "blocks": BLOCKS_CFG},
        "scenarios": {
            "sp4": {"cfg": "v8n", "mesh": "all", "img": _img((1, 3, 512, 256), 1)},
            "dsp22": {"cfg": "v8n", "mesh": "data", "img": _img((2, 3, 512, 256), 2)},
            "sp2": {"cfg": "v8n", "mesh": "pair", "img": _img((1, 3, 512, 256), 1)},
            "subset": {"cfg": "v8n", "mesh": "pair", "tasks": ["b"],
                       "img": torch.zeros((1, 3, 256, 256))},
            "zoo_sp4": {"cfg": "zoo", "mesh": "all", "img": _img((1, 3, 256, 192), 3)},
            "int8_sp2": {"cfg": "v8n", "mesh": "pair", "int8": True, "dtype": torch.float32,
                         "img": _img((1, 3, 256, 192), 4)},
            "zoo_int8_sp4": {"cfg": "zoo", "mesh": "all", "int8": True, "dtype": torch.float32,
                             "img": _img((1, 3, 256, 128), 6)},
            "blocks_sp2": {"cfg": "blocks", "mesh": "pair", "img": _img((2, 3, 128, 96), 5)},
        },
    }
    trees = {}
    for name, cfg in job["cfgs"].items():
        path = cfg
        if not isinstance(cfg, str):
            path = str(tmp / f"parent_{name}.yaml")
            with open(path, "w") as f:
                yaml.safe_dump(cfg, f)
        trees[name] = _tree(path, seed=len(name))
    job["trees"] = trees
    init, job_path = tmp / "spatial.init", tmp / "spatial.job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    outs = [tmp / f"spatial.{r}.pkl" for r in range(WORLD)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, WORKER, "spatial", str(r), str(WORLD), str(init),
                               str(job_path), str(outs[r])], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
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
    return job, result


def _exact(results, name, tasks=TASKS):
    for r in results:
        got, ref = r[name]["got"], r[name]["ref"]
        assert sorted(got) == sorted(tasks)
        for t in tasks:
            assert got[t].shape == ref[t].shape
            np.testing.assert_array_equal(got[t], ref[t], err_msg=f"{name} {t}")
            np.testing.assert_array_equal(got[t], results[0][name]["got"][t])


def test_two_ranks_exact(runs):
    """(a) yolov8n_2task at H 512 x W 256 over two ranks (each pair of the
    four): bit for bit the one-process forward, on every rank."""
    _exact(runs[1], "sp2")
    assert [r["sp2"]["mesh"] for r in runs[1]] == [(0, 2, 0, 1), (1, 2, 0, 1)] * 2


def test_data_spatial_2x2_exact(runs):
    """(a) a batch of 2 over the 2 x 2 (data, spatial) mesh, ranks laid out
    row-major: each rank's result is the whole batch, bit for bit."""
    _exact(runs[1], "dsp22")
    assert [r["dsp22"]["mesh"] for r in runs[1]] == [(0, 2, 0, 2), (1, 2, 0, 2), (0, 2, 1, 2),
                                                     (1, 2, 1, 2)]


def test_four_ranks_exact(runs):
    """The four ranks as one spatial mesh: 4 rows a shard at P5 (SPPF's
    5-pools take 2 halo rows each)."""
    _exact(runs[1], "sp4")


def test_matches_jax_spatial_forward(runs):
    """(b) the same weights and image through JAX's make_spatial_forward
    over its 8 virtual devices."""
    job, results = runs
    model = JaxModel(CFG, TASKS, NCS)
    params = jax.tree_util.tree_map(jnp.asarray, job["trees"]["v8n"])
    run = jax_spatial_forward(model, jax_spatial_mesh(), dtype=jnp.float32)
    img = job["scenarios"]["sp4"]["img"].permute(0, 2, 3, 1).numpy()
    ref = run(params, jnp.asarray(img))
    for name in ("sp4", "sp2"):
        for t in TASKS:
            r = np.asarray(ref[t])
            np.testing.assert_allclose(results[0][name]["got"][t], r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max())


def test_task_subset(runs):
    """(c) tasks=["b"] returns that task alone."""
    _exact(runs[1], "subset", tasks=["b"])


def test_shape_checks_raise_as_jax(runs):
    """(d) H not a multiple of ranks x 32, a batch that does not divide
    over the data axis, and ranks that do not divide by n_spatial raise
    ValueError "divisible", where JAX's raise."""
    check_spatial_shape(512, 8, 32)
    with pytest.raises(ValueError, match="divisible"):
        check_spatial_shape(320, 8, 32)
    for r in runs[1]:
        assert set(r["errors"]) == {"h320", "batch3", "n_spatial3"}
        assert all("divisible" in e for e in r["errors"].values())


def test_zoo_four_ranks_exact(runs):
    """(e) testing.ZOO_CFG (Focus, GhostConv's 5x5 depthwise conv, SPP's 13
    pool) over four ranks at H 256: P5 holds 2 rows a shard and the 13-pool
    takes 6 rows from each side, from three ranks on."""
    _exact(runs[1], "zoo_sp4")


def test_int8_two_ranks_exact(runs):
    """(f) int8 "all", propagated (int8 carried and exchanged between the
    blocks), over two ranks: bit for bit the one-process int8 forward."""
    _exact(runs[1], "int8_sp2")


def test_zoo_int8_four_ranks_exact(runs):
    """int8 "all" propagated on testing.ZOO_CFG over four ranks: the grouped
    and 5x5 int8 convs (conv_sums_s8) and the int8 SPP pools on framed rows,
    as well as conv_s8's."""
    _exact(runs[1], "zoo_int8_sp4")


def test_blocks_two_ranks_exact(runs):
    """(g) testing.BLOCKS_CFG (C3TR's TransformerBlock attends over the
    whole map; CrossConv's (k, 1) conv takes halo rows, its (1, k) none)
    over two ranks."""
    _exact(runs[1], "blocks_sp2")


def test_mesh_of_one_is_the_plain_forward():
    """Without a process group the meshes have one rank and the forward is
    the model's own (the training flag is restored)."""
    model = CerberusModel(CFG, TASKS, NCS, device="cpu").init(0).train()
    x = _img((2, 3, 64, 64), 9)
    with torch.no_grad():
        ref = model.eval()(x)
    model.train()
    for mesh in (make_spatial_mesh(), make_data_spatial_mesh(1)):
        assert mesh.size == 1 and mesh.data_size == 1
        out = make_spatial_forward(model, mesh, dtype=torch.float32)(x)
        assert model.training
        for t in TASKS:
            assert torch.equal(out[t], ref[t][0])
    with pytest.raises(ValueError, match="divisible"):
        make_spatial_forward(model, make_spatial_mesh(), dtype=torch.float32)(x[:, :, :48])
