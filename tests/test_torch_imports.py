"""The port stands alone: no module of cerberusdet_tpu_torch, nor
chip_smoke.py, imports jax, orbax (which imports jax) or the JAX package
(cerberusdet_tpu)."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "cerberusdet_tpu_torch")
IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|cerberusdet_tpu|orbax)(?!\w)"
    r"|import_module\(\s*['\"](?:jax|cerberusdet_tpu|orbax)(?!\w)", re.M)


def _port_modules():
    import cerberusdet_tpu_torch

    names = ["cerberusdet_tpu_torch"]
    for m in pkgutil.walk_packages(cerberusdet_tpu_torch.__path__, "cerberusdet_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith((".py", ".cu", ".cpp"))]
    return sorted(out)


def test_importing_every_port_module_loads_no_jax():
    mods = _port_modules()
    assert len(mods) >= 30, mods
    assert {"cerberusdet_tpu_torch.train.step", "cerberusdet_tpu_torch.ops.tal_cuda",
            "cerberusdet_tpu_torch.quant", "cerberusdet_tpu_torch.quant.ptq",
            "cerberusdet_tpu_torch.ops.conv_int8_cuda",
            "cerberusdet_tpu_torch.data.labels", "cerberusdet_tpu_torch.data.samplers",
            "cerberusdet_tpu_torch.data.dataset", "cerberusdet_tpu_torch.data.loaders",
            "cerberusdet_tpu_torch.data.device_augment",
            "cerberusdet_tpu_torch.evaluation.metrics", "cerberusdet_tpu_torch.evaluation.val",
            "cerberusdet_tpu_torch.cli.val", "cerberusdet_tpu_torch.manager.run_manager",
            "cerberusdet_tpu_torch.utils.checks", "cerberusdet_tpu_torch.utils.hyp",
            "cerberusdet_tpu_torch.utils.seeds", "cerberusdet_tpu_torch.data.augment",
            "cerberusdet_tpu_torch.native", "cerberusdet_tpu_torch.manager.checkpoint",
            "cerberusdet_tpu_torch.manager.attempt_load", "cerberusdet_tpu_torch.manager.weights",
            "cerberusdet_tpu_torch.train.trainer", "cerberusdet_tpu_torch.cli.train",
            "cerberusdet_tpu_torch.cli.detect", "cerberusdet_tpu_torch.cli.serve",
            "cerberusdet_tpu_torch.serve", "cerberusdet_tpu_torch.serve.server",
            "cerberusdet_tpu_torch.infer.visualizer", "cerberusdet_tpu_torch.infer.yolo_wrapper",
            "cerberusdet_tpu_torch.manager.pt_import", "cerberusdet_tpu_torch.manager.pt_export",
            "cerberusdet_tpu_torch.tools.export_to_pt",
            "cerberusdet_tpu_torch.tools.convert_to_cerber",
            "cerberusdet_tpu_torch.bench", "cerberusdet_tpu_torch.utils.profiling",
            "cerberusdet_tpu_torch.tools.bench_int8", "cerberusdet_tpu_torch.tools.bench_serving",
            "cerberusdet_tpu_torch.tools.bench_train_step",
            "cerberusdet_tpu_torch.tools.bench_loader",
            "cerberusdet_tpu_torch.tools.bench_train_e2e",
            "cerberusdet_tpu_torch.tools.profile_step",
            "cerberusdet_tpu_torch.tools.summarize_trace",
            "cerberusdet_tpu_torch.tools.make_synthetic_data",
            "cerberusdet_tpu_torch.tools.strip_weights",
            "cerberusdet_tpu_torch.utils.plots", "cerberusdet_tpu_torch.utils.mlflow_logging",
            "cerberusdet_tpu_torch.evolve", "cerberusdet_tpu_torch.evolve.loggers",
            "cerberusdet_tpu_torch.evolve.base_evolver",
            "cerberusdet_tpu_torch.evolve.yolov5_evolver",
            "cerberusdet_tpu_torch.evolve.ray_evolver",
            "cerberusdet_tpu_torch.tools.bench_c2f_split",
            "cerberusdet_tpu_torch.parallel", "cerberusdet_tpu_torch.parallel.mesh",
            "cerberusdet_tpu_torch.parallel.spatial", "cerberusdet_tpu_torch.nn.layers",
            "cerberusdet_tpu_torch.testing"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'cerberusdet_tpu', 'orbax'))\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", [os.path.relpath(p, ROOT) for p in _sources()])
def test_source_has_no_jax_import(path):
    with open(os.path.join(ROOT, path)) as f:
        hits = IMPORT_RE.findall(f.read())
    assert not hits, (path, hits)
