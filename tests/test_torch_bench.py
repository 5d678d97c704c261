"""The port's headline benchmark (cerberusdet_tpu_torch/bench.py) and the
honest loop behind it (utils/profiling.py) against the JAX package's
bench.py, on the CPU.

  * calib_batches: the same arrays as the root bench.py's, array for array.
  * The golden check: passes on the committed file (yolov8n_2task at 64 px),
    raises on a 6% drift and on a changed key set, passes within 5%;
    --write-golden writes only the port's golden, never
    assets/calib/amax_golden.json (its sha1 is unchanged).
  * The JAX golden bridged: JAX's PRNGKey(0) flagship, fused, carried across
    with manager/weights.py and calibrated by the port in float64 on the
    calibration images, lies within rtol 0.05 of
    assets/calib/amax_golden.json["yolov8x_2task"] (JAX calibrates in bf16).
  * Both flagship configs parse into the JAX package's parameter shapes.
  * bench.main on the CPU prints the JAX metric names and keys in its last
    line, in int8 and bf16.
  * HonestLoop consumes every output leaf and chains its iterations through
    the input; the conv-node guard counts and refuses as it should.
"""

import hashlib
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from cerberusdet_tpu.models.cerberus import CerberusModel as JaxModel
from cerberusdet_tpu_torch import bench
from cerberusdet_tpu_torch.manager.weights import export_jax_params, load_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.quant import calibrate_amax
from cerberusdet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
FLAGSHIP = os.path.join(ROOT, "configs", "models", "yolov8x_2task.yaml")
FLAGSHIP_TPU = os.path.join(ROOT, "configs", "models", "yolov8x_2task_tpu.yaml")
JAX_GOLDEN = os.path.join(ROOT, "assets", "calib", "amax_golden.json")


@pytest.fixture
def one_thread():
    """One intra-op thread: these tests run thousands of tiny CPU ops, which
    several test processes running at once make hundreds of times slower
    when each op's threads wait for cores that the other processes hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sha1(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tuple(np.shape(v))


def test_calib_batches_equal_root_bench():
    ours, theirs = bench.calib_batches(), _root_bench().calib_batches()
    assert len(ours) == len(theirs) == 1
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (4, 640, 640, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.usefixtures("one_thread")
def test_golden_passes_on_the_committed_file():
    key = bench.golden_key(SMALL, 64)
    assert key in json.loads(bench.GOLDEN.read_text())
    before = _sha1(bench.GOLDEN)
    model = bench.build(SMALL, "cpu", int8=True, imgsz=64)
    assert _sha1(bench.GOLDEN) == before
    assert profiling.model_convs(model) == (99, 87)
    assert next(model.parameters()).dtype == torch.bfloat16


@pytest.mark.parametrize("change, raises", [
    ("none", False), ("drift 4%", False), ("drift 6%", True), ("drift -6%", True),
    ("key missing", True), ("key added", True)])
def test_golden_check(tmp_path, change, raises):
    gold = {("b0",): 1.0, ("b1",): 0.5, ("n12:2.0", "m", "0", "cv1"): 0.02}
    path = tmp_path / "golden.json"
    bench.check_golden_amax(gold, "cfg", write=True, path=path)
    amax = dict(gold)
    if change.startswith("drift"):
        amax[("b1",)] *= 1 + float(change.split()[1].rstrip("%")) / 100
    elif change == "key missing":
        del amax[("b0",)]
    elif change == "key added":
        amax[("b2", "cv1")] = 0.1
    if raises:
        with pytest.raises(AssertionError):
            bench.check_golden_amax(amax, "cfg", write=False, path=path)
    else:
        bench.check_golden_amax(amax, "cfg", write=False, path=path)
    assert json.loads(path.read_text()) == {"cfg": {"b0": 1.0, "b1": 0.5,
                                                    "n12:2.0/m/0/cv1": 0.02}}


@pytest.mark.usefixtures("one_thread")
def test_write_golden_writes_only_the_ports_file(tmp_path, monkeypatch):
    port_golden = bench.GOLDEN
    committed = json.loads(port_golden.read_text())
    jax_sha, port_sha = _sha1(JAX_GOLDEN), _sha1(port_golden)
    golden = tmp_path / "amax_golden.json"
    golden.write_text(json.dumps({"other": {"b0": 1.0}}))
    monkeypatch.setattr(bench, "GOLDEN", golden)
    assert bench.main(["--write-golden", "--device", "cpu", "--cfg", SMALL,
                       "--imgsz", "64"]) is None
    written = json.loads(golden.read_text())
    key = bench.golden_key(SMALL, 64)
    assert set(written) == {"other", key}
    # float64 on the CPU: the same numbers up to the order of the sums, which
    # the thread count may change (the seeded v8n amplifies a rounding ~1e5-fold)
    assert written[key].keys() == committed[key].keys()
    for k, v in written[key].items():
        assert v == pytest.approx(committed[key][k], rel=1e-8), k
    assert _sha1(JAX_GOLDEN) == jax_sha and _sha1(port_golden) == port_sha


def test_jax_golden_bridged_into_the_port():
    jm = JaxModel(FLAGSHIP, bench.TASKS, bench.NCS)
    params = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(jax.random.PRNGKey(0))))
    model = CerberusModel(FLAGSHIP, bench.TASKS, bench.NCS, device="cpu")
    load_jax_params(model, params)
    del params
    amax = calibrate_amax(model.to(torch.float64).eval(), bench.calib_batches())
    with open(JAX_GOLDEN) as f:
        gold = json.load(f)["yolov8x_2task"]
    flat = {"/".join(k): v for k, v in amax.items()}
    assert set(flat) == set(gold) and len(gold) == 143
    rel = {k: abs(flat[k] - gold[k]) / max(abs(gold[k]), 1e-6) for k in gold}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 0.05, (worst, flat[worst], gold[worst])


@pytest.mark.parametrize("cfg", [FLAGSHIP, FLAGSHIP_TPU], ids=["v8x", "v8x_tpu"])
def test_flagship_configs_parse_into_jax_shapes(cfg):
    jm = JaxModel(cfg, bench.TASKS, bench.NCS)
    want = dict(_flat(jax.eval_shape(jm.init, jax.random.PRNGKey(0))))
    model = CerberusModel(cfg, bench.TASKS, bench.NCS, device="cpu")
    assert dict(_flat(export_jax_params(model))) == want
    assert profiling.model_convs(model) == (155, 0)


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.usefixtures("one_thread")
def test_main_prints_the_jax_metric(capsys, bf16):
    argv = ["--device", "cpu", "--cfg", SMALL, "--imgsz", "64", "--batch", "2",
            "--iters", "1"] + (["--bf16"] if bf16 else [])
    out = bench.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert list(last) == ["metric", "value", "unit", "vs_baseline"]
    assert last["metric"] == ("2task_inference_throughput_640" if bf16
                              else "2task_inference_throughput_640_int8ptq")
    assert last["unit"] == "img/s/chip" and last["value"] > 0
    assert abs(last["vs_baseline"] - last["value"] / (1000.0 / 7.2)) < 0.01
    assert lines[-2].startswith("[bench] cpu")
    assert out["ms"] is None and out["conv_nodes"] is None  # no device numbers on the CPU
    assert out["int8_convs"] == (0 if bf16 else 87)
    # yolov8n_2task's 19 annotated blocks each end in an int8 Conv
    assert out["requant_blocks"] == (0 if bf16 else 19)


@pytest.mark.usefixtures("one_thread")
def test_requant_guard():
    """check_requant passes where every annotated block's last Conv writes
    its int8 output, and raises where a block hands on float (its last
    Conv's requantize taken away)."""
    model = bench.build(SMALL, "cpu", True, 64)
    x = bench.make_input(1, 64, "cpu")
    fn = bench.forward_fn(model)
    convs = profiling.requant_convs(model)
    assert profiling.check_requant(model, fn, x, "test") == len(convs) == 19
    uid = sorted(convs)[0]
    q = model.block(uid)._buffers.pop("q_out")
    model.block(uid).register_buffer("q_later", q)  # not the block's annotation any more
    model.block(uid).act_quant = lambda name: q if name == "q_out" else None
    with pytest.raises(AssertionError, match="did not requantize"):
        profiling.check_requant(model, fn, x, "test")
    assert profiling.classify_conv_kernels(["void quant_nchw_kernel<bf16>(...)"])[
        "unmatched"] == ["void quant_nchw_kernel<bf16>(...)"]


@pytest.mark.usefixtures("one_thread")
def test_honest_loop_consumes_every_leaf_and_chains():
    calls = []

    def fn(x):
        calls.append(x.clone())
        return {"a": x * 2, "b": [x.sum(), torch.full((3,), float(len(calls)))],
                "c": (x[:1] > 0,)}

    x = torch.ones(2, 4)
    loop = profiling.HonestLoop(fn, x)
    ms, host_ms = loop.time(iters=2, rounds=3)
    assert ms is None and host_ms > 0
    assert len(calls) == 2 + 3 * 2  # a warm round, then 3 rounds of 2
    assert all(torch.equal(c, torch.ones(2, 4)) for c in calls)  # x += 0 * sink
    assert loop.conv_nodes() is None and loop.pool_mib() is None
    assert len(profiling.tensor_leaves(fn(x))) == 4

    def poisoned(x):  # a NaN in any leaf reaches the next iteration's input
        return {"a": x, "b": [x.sum() * float("nan")]}

    loop = profiling.HonestLoop(poisoned, torch.ones(3))
    loop.step(1)
    assert torch.isnan(loop.x).all()


def test_conv_count_guard():
    names = ["void conv_s8_kernel<128, 160>(...)", "quant_pack_planes_kernel<bf16>",
             "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw",
             "cudnn::detail::implicit_convolve_sgemm<float>",
             "nvjet_tst_320x64_64x4_1x1_h_bz_NNT",  # a 1x1 conv as a cuBLASLt GEMM
             "at::native::vectorized_elementwise_kernel<4, silu>",
             "_ZN8internal5gemvx6kernelIiiffffLb1ELb1ELb1ELb0ELi6ELb0E18cublasGemvParamsEx",
             "cudnn::engines_precompiled::nchwToNhwcKernel"]
    nodes = profiling.classify_conv_kernels(names)
    assert (nodes["conv_s8"], nodes["quant_pack_s8"], nodes["cudnn"], nodes["convs"],
            nodes["kernels"]) == (1, 1, 3, 4, 8)
    assert nodes["unmatched"] == sorted(names[5:])
    profiling.check_convs(nodes, 4, 1, "test")
    with pytest.raises(AssertionError):
        profiling.check_convs(nodes, 5, 1, "test")  # a convolution lost
    with pytest.raises(AssertionError):
        profiling.check_convs(nodes, 4, 2, "test")  # an int8 Conv without its kernel


@pytest.mark.usefixtures("one_thread")
def test_profile_op_chains_its_calls():
    seen = []

    def fn(x, w):
        seen.append(x.clone())
        return (x * w).sum(), x

    x = torch.ones(3)
    out = profiling.profile_op(fn, x, torch.full((3,), 2.0), iters=4)
    assert out["ms"] > 0 and len(seen) == 5  # one untimed call, then 4 chained ones
    assert all(torch.equal(s, x) for s in seen)  # each fed x + 0 * the previous output
    with profiling.Profile() as p:
        profiling.time_sync()
    assert p.t == p.dt >= 0
