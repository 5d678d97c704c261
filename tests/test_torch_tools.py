"""The port's measurement tools (cerberusdet_tpu_torch/tools/bench_*,
profile_step, summarize_trace, make_synthetic_data, strip_weights) and
utils/profiling.py's model-graph dump, on the CPU at yolov8n_2task, 64 px,
against the JAX package's tools (cerberusdet_tpu/tools/).

  * Each bench tool's main on --device cpu prints its JSON line with the
    JAX tool's keys (bench_loader's are held against the JAX tool's own
    run); bench_train_step's two routes (plain assigner and TAL kernels,
    which take their plain versions on the CPU) give equal losses.
  * bench_loader and bench_train_e2e refuse what the port does not have
    yet: worker processes, the disk cache, augmentation on the card.
  * profile_step writes a Chrome trace that summarize_trace reads;
    summarize_trace totals a hand-written trace exactly.
  * make_synthetic_data writes files byte-identical to the JAX tool's;
    strip_weights gives the JAX strip_checkpoint's arrays.
  * dump_model_graph writes both artifacts with the JAX package's cost
    keys, and TrainLoop writes them for a run that saves.
"""

import gzip
import hashlib
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu.manager.checkpoint import load_checkpoint as jax_load_checkpoint
from cerberusdet_tpu.manager.checkpoint import strip_checkpoint as jax_strip_checkpoint
from cerberusdet_tpu.tools import bench_loader as jax_bench_loader
from cerberusdet_tpu.tools import make_synthetic_data as jax_make_synthetic_data
from cerberusdet_tpu_torch.manager.checkpoint import save_checkpoint
from cerberusdet_tpu_torch.manager.weights import export_jax_params
from cerberusdet_tpu_torch.models.cerberus import CerberusModel
from cerberusdet_tpu_torch.tools import (
    bench_int8,
    bench_loader,
    bench_serving,
    bench_train_e2e,
    bench_train_step,
    make_synthetic_data,
    profile_step,
    strip_weights,
    summarize_trace,
)
from cerberusdet_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = os.path.join(ROOT, "configs", "models", "yolov8n_2task.yaml")
CPU = ["--device", "cpu", "--cfg", SMALL, "--imgsz", "64"]


@pytest.fixture
def one_thread():
    """One intra-op thread: these tests run thousands of tiny CPU ops, which
    several test processes running at once make hundreds of times slower
    when each op's threads wait for cores that the other processes hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_thread")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_int8_keys(capsys):
    out = bench_int8.main(CPU + ["--batch", "4", "--iters", "1"])
    assert _last_json(capsys) == out
    assert list(out) == ["bf16", "int8_deep(cin>=256)", "int8_all"]
    for r in out.values():
        assert set(r) == {"ms_per_batch", "img_per_s", "speedup_vs_bf16"}
    assert out["bf16"]["speedup_vs_bf16"] == 1.0


def test_bench_serving_keys(capsys):
    out = bench_serving.main(CPU + ["--batch", "2", "--iters", "1"])
    assert _last_json(capsys) == out
    assert list(out) == ["forward", "forward+nms", "full"]
    assert set(out["forward"]) == {"ms_per_batch", "img_per_s"}
    for stage in ("forward+nms", "full"):
        assert set(out[stage]) == {"ms_per_batch", "img_per_s", "delta_ms"}


def test_bench_serving_trace_reads_back(tmp_path, capsys):
    path = bench_serving.main(CPU + ["--batch", "1", "--iters", "3", "--int8", "off",
                                     "--max-det", "20", "--trace", str(tmp_path)])
    assert Path(path).parent == tmp_path and path.endswith(".pt.trace.json.gz")
    assert summarize_trace.main([str(tmp_path), "--iters", "3"])["events"] == 0  # no card


def test_bench_train_step_routes_agree(capsys):
    out = bench_train_step.main(CPU + ["--batch", "2", "--iters", "1", "--max-labels", "20"])
    assert _last_json(capsys) == out
    assert list(out) == ["xla", "pallas", "loss_rel_diff", "speedup"]
    assert set(out["xla"]) == set(out["pallas"]) == {"ms_per_step", "img_per_s"}
    assert out["loss_rel_diff"] == 0.0


def test_bench_loader_keys_match_jax(capsys):
    bench_loader.main(["--imgsz", "64", "--n", "32", "--threads", "2"])
    ours = _last_json(capsys)
    jax_bench_loader.main(["--imgsz", "64", "--n", "32", "--threads", "2"])
    theirs = _last_json(capsys)
    assert list(ours) == list(theirs)
    assert {k: v for k, v in ours.items() if k != "imgs_per_sec"} == \
        {k: v for k, v in theirs.items() if k != "imgs_per_sec"}
    assert ours["imgs_per_sec"] > 0


@pytest.mark.parametrize("flags", [["--proc-workers", "2"], ["--cache-images", "disk"],
                                   ["--device-augment"]])
def test_bench_loader_refuses_unported_modes(flags):
    with pytest.raises(NotImplementedError, match="item (2|8)"):
        bench_loader.main(["--imgsz", "64", "--n", "4", "--batch", "2"] + flags)


def test_bench_train_e2e_host(capsys):
    out = bench_train_e2e.main(CPU + ["--batch", "2", "--n", "4", "--workers", "1"])
    assert _last_json(capsys) == out
    assert list(out) == ["mode", "imgs_per_sec", "sec_per_epoch", "imgs", "imgsz", "batch",
                         "cfg", "hyp"]
    assert out["mode"] == "host" and out["imgs"] == 8


@pytest.mark.parametrize("mode", ["device", "both"])
def test_bench_train_e2e_refuses_device_mode(mode):
    with pytest.raises(NotImplementedError, match="item 8"):
        bench_train_e2e.main(CPU + ["--mode", mode])


@pytest.mark.parametrize("mode", ["train", "infer"])
def test_profile_step_trace_reads_back(tmp_path, mode, capsys):
    path = profile_step.main(CPU + ["--out", str(tmp_path), "--mode", mode, "--batch", "2",
                                    "--iters", "2", "--max-labels", "8"]
                             + (["--int8", "all"] if mode == "infer" else []))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert "aten::conv2d" in ops or "aten::convolution" in ops
    if mode == "train":
        assert any("backward" in n.lower() for n in ops)
    assert summarize_trace.main([str(tmp_path), "--iters", "2"])["events"] == 0  # no card


@pytest.mark.parametrize("suffix", [".pt.trace.json", ".pt.trace.json.gz"])
def test_summarize_trace_totals(tmp_path, suffix, capsys):
    kernels = [
        ("void conv_s8_kernel<128, 160>(signed char const*)", 300.0),
        ("void conv_s8_kernel<64, 80>(signed char const*)", 100.0),
        ("void quant_pack_planes_kernel<__nv_bfloat16>(...)", 50.0),
        ("nms_kernel(float4 const*, float const*, int)", 20.0),
        ("tal_select_kernel(float const*)", 7.0),
        ("tal_norm_kernel(long const*)", 3.0),
        ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nchw", 400.0),
        ("void at::native::vectorized_elementwise_kernel<4, silu>(int)", 60.0),
        ("void at::native::reduce_kernel<512, 1>(...)", 40.0),
        ("cudnn::engines_precompiled::nchwToNhwcKernel", 10.0),
    ]
    events = [{"ph": "X", "cat": "kernel", "name": n, "dur": d, "pid": 0, "tid": 7, "ts": i}
              for i, (n, d) in enumerate(kernels)]
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
                "dur": 30.0, "pid": 0, "tid": 7, "ts": 20},
               {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "dur": 5.0,
                "pid": 0, "tid": 7, "ts": 21},
               {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "dur": 999.0, "pid": 1,
                "tid": 1, "ts": 0},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 77.0,
                "pid": 1, "tid": 1, "ts": 1},
               {"ph": "i", "cat": "kernel", "name": "marker", "pid": 0, "tid": 7, "ts": 3}]
    path = tmp_path / f"host_1{suffix}"
    data = json.dumps({"traceEvents": events})
    if suffix.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(data)
    else:
        path.write_text(data)
    out = summarize_trace.main([str(tmp_path), "--iters", "2", "--min-ms", "0"])
    assert out["events"] == 12
    assert out["total_ms"] == pytest.approx(1025.0 / 2000.0, abs=0, rel=1e-12)
    want = {"conv_s8": 0.2, "quant_pack_s8": 0.025, "nms": 0.01, "tal": 0.005,
            "conv / gemm": 0.2, "elementwise": 0.05, "other": 0.005, "memcpy": 0.0175}
    assert out["by_category"].keys() == want.keys()
    for k, v in want.items():
        assert out["by_category"][k] == pytest.approx(v, rel=1e-12)
    printed = capsys.readouterr().out
    assert "device busy: 0.512 ms/iter (12 events / 2 iters)" in printed


def _tree_sha1(root: Path):
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_make_synthetic_data_byte_identical(tmp_path):
    out = tmp_path / "demo"
    args = ["--out", str(out), "--n", "3", "--imgsz", "64"]
    jax_make_synthetic_data.main(args)
    theirs = _tree_sha1(out)
    for p in sorted(out.rglob("*"), reverse=True):
        p.unlink() if p.is_file() else p.rmdir()
    make_synthetic_data.main(args)
    ours = _tree_sha1(out)
    assert len(ours) == 1 + 2 * 2 * 3 * 2  # data.yaml; 2 tasks x 2 splits x 3 (jpg, txt)
    assert ours == theirs


def test_strip_weights_matches_jax(tmp_path, capsys):
    model = CerberusModel(SMALL, ["a", "b"], [3, 2], device="cpu").init(1)
    params = export_jax_params(model)
    ema = {k: v for k, v in export_jax_params(model.init(2)).items()}
    meta = {"cfg": SMALL, "task_ids": ["a", "b"], "nc": [3, 2], "epoch": 4}
    run = tmp_path / "weights"
    for name in ("last", "best"):
        save_checkpoint(run / f"{name}.ckpt.npz", params, meta, ema_params=ema,
                        opt_momentum=params, half=False)
    ref = tmp_path / "ref.ckpt.npz"
    jax_strip_checkpoint(run / "last.ckpt.npz", ref)
    strip_weights.main(["--weights", str(run)])  # the directory: both files, in place
    assert "stripped" in capsys.readouterr().out
    with np.load(ref) as r, np.load(run / "last.ckpt.npz") as o, \
            np.load(run / "best.ckpt.npz") as b:
        assert sorted(r.files) == sorted(o.files) == sorted(b.files)
        for k in r.files:
            np.testing.assert_array_equal(o[k], r[k])
            np.testing.assert_array_equal(b[k], r[k])
    assert jax_load_checkpoint(str(run / "last.ckpt.npz"))["meta"]["stripped"] is True


def test_dump_model_graph_writes_both_artifacts(tmp_path):
    model = CerberusModel(SMALL, ["a", "b"], [3, 2], device="cpu").init(0)
    model.train()
    info = profiling.dump_model_graph(model, tmp_path, imgsz=64)
    assert model.training  # the mode is restored
    cost = json.loads((tmp_path / "model_graph.cost.json").read_text())
    assert cost == info
    assert list(cost) == ["imgsz", "params_m", "flops", "bytes_accessed", "n_blocks"]
    with gzip.open(tmp_path / "model_graph.txt.gz", "rt") as f:
        text = f.read()
    assert "C2f" in text and "head_b <- " in text
    # 2 flops a multiply-add of the convolutions (the DFL's bin expectation is
    # a matrix-vector product, which torch.utils.flop_counter does not count)
    macs = []

    def hook(m, args, out):
        w = m.w
        macs.append(out.numel() * w.shape[1] * w.shape[2] * w.shape[3])

    from cerberusdet_tpu_torch.nn.layers import Conv, PlainConv

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (Conv, PlainConv))]
    with torch.no_grad():
        preds = model.eval()(torch.zeros(1, 3, 64, 64))
    for h in hooks:
        h.remove()
    assert len(macs) == 99 and set(preds) == {"a", "b"}
    assert cost["flops"] == 2 * sum(macs)
    assert cost["flops"] == profiling.model_info(model, imgsz=64)["gflops"] * 1e9
    assert cost["bytes_accessed"] > 0 and cost["n_blocks"] == len(model.block_nodes) + 2


def test_train_loop_dumps_the_model_graph(tmp_path):
    from cerberusdet_tpu_torch.train.trainer import TrainLoop, TrainOptions

    data_yaml = make_synthetic_data.main(["--out", str(tmp_path / "data"), "--n", "2",
                                          "--imgsz", "64"])
    with open(data_yaml) as f:
        data = yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "hyps", "hyp.cerber-default.yaml")) as f:
        hyp = yaml.safe_load(f)
    opt = TrainOptions(cfg=SMALL, epochs=1, batch_size=2, imgsz=64, plots=False,
                       project=str(tmp_path / "runs"), name="exp", workers=1)
    loop = TrainLoop(opt, data, hyp, device="cpu")
    save_dir = Path(loop.manager.save_dir)
    assert (save_dir / "model_graph.txt.gz").exists()
    assert json.loads((save_dir / "model_graph.cost.json").read_text())["imgsz"] == 64
