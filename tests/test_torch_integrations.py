"""The port's MLflow tracking (utils/mlflow_logging.py) and hyperparameter
evolvers (evolve/) against the JAX package's, on the CPU, driven against the
in-repo stubs as tests/test_integrations_stub.py drives the JAX package's
(mlflow and ray are not installed):

  * MLFlowLogger's whole surface, run dedup, the degrade to a no-op on a
    broken backend, models:/ URIs (also through load_single), and the
    RunManager and cli/val.py wiring;
  * DEFAULT_META key for key; Yolov5Evolver writing the JAX evolver's hyps
    for 4 generations from the same seed and results (train_once stubbed
    on both sides, no training); RayEvolver through tests/fake_ray.py."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from cerberusdet_tpu.evolve.base_evolver import DEFAULT_META as JAX_META
from cerberusdet_tpu.evolve.yolov5_evolver import Yolov5Evolver as JaxEvolver
from cerberusdet_tpu_torch.evolve.base_evolver import DEFAULT_META, BaseEvolver
from cerberusdet_tpu_torch.evolve.loggers import FileLogger
from cerberusdet_tpu_torch.evolve.ray_evolver import RayEvolver, reformat_config
from cerberusdet_tpu_torch.evolve.yolov5_evolver import Yolov5Evolver
from cerberusdet_tpu_torch.manager import attempt_load
from cerberusdet_tpu_torch.manager.run_manager import RunManager
from cerberusdet_tpu_torch.utils import mlflow_logging as ml
from fake_ray import install_ray_stub
from test_integrations_stub import RecordingMlflow

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "configs", "hyps", "hyp.cerber-default.yaml")) as _f:
    HYP = yaml.safe_load(_f)


@pytest.fixture()
def stub_mlflow(monkeypatch):
    stub = RecordingMlflow()
    monkeypatch.setattr(ml, "mlflow", stub)
    monkeypatch.setattr(ml, "MLFLOW_AVAILABLE", True)
    return stub


# ------------------------------------------------------------------ mlflow
def test_mlflow_logger_full_surface(stub_mlflow, tmp_path):
    logger = ml.MLFlowLogger("exp", "run1", tracking_uri="http://mlflow:5000")
    assert logger.active
    assert stub_mlflow.named("set_tracking_uri")
    assert stub_mlflow.named("set_experiment")
    assert stub_mlflow.named("start_run")[0][2].get("run_name") == "run1"

    logger.log_params({"lr0": 0.01, "long": "x" * 400})
    (_, (params,), _), = stub_mlflow.named("log_params")
    assert params["lr0"] == "0.01" and len(params["long"]) == 250

    logger.log_metrics({"metrics/voc/mAP_0.5": 0.5}, step=3)
    (_, (metrics,), kw), = stub_mlflow.named("log_metrics")
    assert metrics["metrics/voc/mAP_0.5"] == 0.5 and kw["step"] == 3

    ckpt = tmp_path / "best.ckpt.npz"
    ckpt.write_bytes(b"weights")
    logger.log_model(ckpt, signature={"inputs": "(B,3,640,640) f32",
                                      "outputs": "{task: (B,N,4+nc)}"})
    assert stub_mlflow.named("log_artifact")
    logged = {a[0]: a[1] for _, a, _ in stub_mlflow.named("log_param")}
    assert logged["model_md5"] == ml.file_md5(ckpt)
    assert "inputs" in logged["model_signature"]

    logger.finish()
    assert stub_mlflow.named("end_run")


def test_mlflow_run_dedup(monkeypatch):
    stub = RecordingMlflow(existing_runs=["abc123"])
    monkeypatch.setattr(ml, "mlflow", stub)
    monkeypatch.setattr(ml, "MLFLOW_AVAILABLE", True)
    ml.MLFlowLogger("exp", "run1")
    assert stub.named("start_run")[0][2] == {"run_id": "abc123"}


def test_mlflow_degrades_on_broken_backend(monkeypatch):
    class Broken:
        def set_experiment(self, *a, **k):
            raise ConnectionError("no server")

    monkeypatch.setattr(ml, "mlflow", Broken())
    monkeypatch.setattr(ml, "MLFLOW_AVAILABLE", True)
    logger = ml.MLFlowLogger("exp", "run1")
    assert not logger.active
    logger.log_params({"a": 1})  # must not raise

    class Flaky(RecordingMlflow):  # a call that fails later is skipped with a warning
        def log_metrics(self, *a, **k):
            raise ConnectionError("lost")

    monkeypatch.setattr(ml, "mlflow", Flaky())
    logger = ml.MLFlowLogger("exp", "run2")
    logger.log_metrics({"a": 1.0})
    assert logger.active


def test_mlflow_absent_is_a_no_op(monkeypatch, tmp_path):
    monkeypatch.setattr(ml, "mlflow", None)
    monkeypatch.setattr(ml, "MLFLOW_AVAILABLE", False)
    logger = ml.MLFlowLogger("exp", "run1", tracking_uri="http://mlflow:5000")
    assert not logger.active and not ml.init_mlflow("http://mlflow:5000")
    logger.log_params({"a": 1})
    logger.finish()
    with pytest.raises(RuntimeError, match="mlflow is not installed"):
        ml.attempt_mlflow_download("models:/cerber/3", str(tmp_path))


def test_models_uri_download(stub_mlflow, tmp_path, monkeypatch):
    out = ml.attempt_mlflow_download("models:/cerber/3", str(tmp_path))
    assert out == f"{tmp_path}/resolved.pt"
    assert ml.attempt_mlflow_download("/plain/path.pt") == "/plain/path.pt"
    # load_single resolves the URI before it reads the file
    with pytest.raises(ValueError, match="architecture metadata"):
        attempt_load.load_single("models:/cerber/3", device="cpu")
    assert stub_mlflow.named("download_artifacts")[-1][1][0] == "models:/cerber/3"


def test_run_manager_logs_to_mlflow(stub_mlflow, tmp_path, monkeypatch):
    monkeypatch.setattr(RunManager, "tb_writer", lambda self: None)
    data = {"task_ids": ["a", "b"], "nc": [2, 1], "names": [["x", "y"], ["z"]],
            "train": ["", ""], "val": ["", ""]}
    man = RunManager({"lr0": 0.01}, data, "cfg.yaml", tmp_path / "run",
                     mlflow_url="http://localhost:1", experiment_name="e", device="cpu")
    assert stub_mlflow.named("set_experiment")[0][1] == ("e",)
    man.dump_settings({"epochs": 3})
    (_, (params,), _), = stub_mlflow.named("log_params")
    assert params == {"lr0": "0.01", "opt/epochs": "3"}
    man.train_log("a", [0.1, 0.2, 0.3], np.array([1.0, 2.0, 3.0]), epoch=0)
    man.val_log("a", (0.5, 0.4, 0.3, 0.2), 0, 0.21)
    logged = {}
    for _, (m,), kw in stub_mlflow.named("log_metrics"):
        logged.update(m)
    assert logged["train/a/box_loss"] == 1.0 and logged["x/a/lr2"] == 0.3
    assert logged["metrics/a/mAP_0.5_0.95"] == 0.2
    (tmp_path / "run" / "labels.png").write_bytes(b"png")
    (tmp_path / "run" / "weights" / "last.ckpt.npz").write_bytes(b"w")
    man.finalize(imgsz=64)
    arts = [a[0] for _, a, _ in stub_mlflow.named("log_artifact")]
    assert [os.path.basename(a) for a in arts] == ["results.txt", "labels.png", "last.ckpt.npz"]
    assert stub_mlflow.named("end_run")


def test_val_cli_uploads_metrics(stub_mlflow, monkeypatch):
    from cerberusdet_tpu_torch.cli import val as cli_val

    metrics = types.SimpleNamespace(ap_class_index=np.array([1]),
                                    class_result=lambda i: (0.1, 0.2, 0.7, 0.3))
    results = {"a": {"results": (0.5, 0.4, 0.3, 0.2), "fitness": 0.21, "metrics": metrics}}
    opt = types.SimpleNamespace(experiment_name="e", name="exp", mlflow_url="http://m",
                                single_cls=False)
    cli_val.log_to_mlflow(results, {"task_ids": ["a"], "names": [["x", "big dog"]]}, opt)
    (_, (logged,), _), = stub_mlflow.named("log_metrics")
    assert logged["val/a/ap50_big_dog"] == 0.7 and logged["val/a/fitness"] == 0.21
    assert stub_mlflow.named("start_run")[0][2]["run_name"] == "val_exp"


# ------------------------------------------------------------------ evolvers
def test_default_meta_matches_jax():
    assert list(DEFAULT_META) == list(JAX_META)
    for k, v in JAX_META.items():
        assert DEFAULT_META[k] == v, k


def _fake_results(tasks, seed):
    """Seeded per-generation results, the same for both packages."""
    rng = np.random.default_rng(seed)

    def train_once(hyp):
        r = rng.random((len(tasks), 4))
        return {t: tuple(float(x) for x in r[i]) for i, t in enumerate(tasks)}

    return train_once


@pytest.mark.parametrize("params", [None, "lr0,momentum,mosaic,box"])
def test_yolov5_evolver_writes_jax_hyps(tmp_path, params):
    hyp = dict(HYP)
    hyp["box"] = [0.05, 0.07]  # a per-task list: one mutation vector per task
    tasks = ["voc", "animals"]
    data = {"task_ids": tasks, "nc": [2, 3]}
    evolve = params.split(",") if params else None
    logs = {}
    for pkg, cls in (("jax", JaxEvolver), ("port", Yolov5Evolver)):
        opt = types.SimpleNamespace(project=str(tmp_path / pkg), name="evo", epochs=1)
        ev = cls(opt, hyp, data, generations=4, params_to_evolve=evolve, seed=0)
        ev.train_once = _fake_results(tasks, 1)
        ev.run_evolution()
        logs[pkg] = ev.file_logger.read_mutations()
    assert len(logs["port"]) == 4
    assert [m["hyps"] for m in logs["port"]] == [m["hyps"] for m in logs["jax"]]
    assert logs["port"] == logs["jax"]
    hyps = [m["hyps"] for m in logs["port"]]
    assert all(hyps[i] != hyps[i + 1] for i in range(3))
    for h in hyps:
        for k, (_, lo, hi, _) in DEFAULT_META.items():
            for v in (h[k] if isinstance(h.get(k), list) else [h.get(k, lo)]):
                assert lo <= v <= hi, k
    assert (tmp_path / "port" / "evo" / "hyp_evolved.yaml").read_text() == \
        (tmp_path / "jax" / "evo" / "hyp_evolved.yaml").read_text()


def test_reformat_config_folds_task_keys():
    cfg = {"lr0_voc": 0.1, "lr0_animals": 0.2, "box": 0.05}
    assert reformat_config(cfg, ["voc", "animals"]) == {"box": 0.05, "lr0": [0.1, 0.2]}


def test_ray_evolver_tune_path(monkeypatch, tmp_path):
    record = {"configs": [], "reports": []}
    install_ray_stub(monkeypatch, record)
    hyp = dict(HYP)
    hyp["lr0"] = [0.01, 0.01]  # per-task list -> per-task search keys
    data = {"task_ids": ["voc", "animals"], "nc": [2, 3], "names": [["a", "b"], ["c", "d", "e"]],
            "train": ["x", "y"], "val": ["x", "y"]}
    opt = types.SimpleNamespace(project=str(tmp_path), name="evo", epochs=1)
    ev = RayEvolver(opt, hyp, data, generations=3, searcher="random")

    def train_once(h):
        f = float(np.mean(h["lr0"]))
        return {t: (0, 0, f, f, 0, 0, 0) for t in data["task_ids"]}

    monkeypatch.setattr(ev, "train_once", train_once)
    ev.run_evolution()
    assert len(record["configs"]) == 3 and len(record["reports"]) == 3
    assert any(k.endswith("_voc") for k in record["configs"][0])
    assert any(k.endswith("_animals") for k in record["configs"][0])
    assert record["scheduler"] == {"metric": "overall_fitness", "mode": "max"}
    assert all(np.isfinite(r["overall_fitness"]) for r in record["reports"])
    muts = ev.file_logger.read_mutations()
    assert len(muts) == 3
    assert [m["hyps"]["lr0"] for m in muts] == [
        [c["lr0_voc"], c["lr0_animals"]] for c in record["configs"]]


def test_ray_evolver_searcher_registry(monkeypatch, tmp_path):
    record = {"configs": [], "reports": []}
    install_ray_stub(monkeypatch, record)
    data = {"task_ids": ["t"], "nc": [2], "names": [["a", "b"]], "train": ["x"], "val": ["x"]}
    opt = types.SimpleNamespace(project=str(tmp_path), name="evo", epochs=1)
    with pytest.raises(ValueError):
        RayEvolver(opt, HYP, data, generations=1, searcher="nonsense")
    fake_mod = types.ModuleType("ray.tune.search.optuna")
    fake_mod.OptunaSearch = lambda: None
    monkeypatch.setitem(sys.modules, "ray.tune.search.optuna", fake_mod)
    ev = RayEvolver(opt, HYP, data, generations=1, searcher="optuna", max_concurrent=2)
    monkeypatch.setattr(ev, "train_once", lambda h: {"t": (0, 0, 0.1, 0.1, 0, 0, 0)})
    ev.run_evolution()
    assert record["max_concurrent"] == 2


def test_ray_evolver_without_ray(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "ray", None)
    opt = types.SimpleNamespace(project=str(tmp_path), name="evo", epochs=1)
    with pytest.raises(ImportError, match="ray"):
        RayEvolver(opt, HYP, {"task_ids": ["t"]}, generations=1)


def test_evolver_mlflow_generation_logging(stub_mlflow, tmp_path):
    opt = types.SimpleNamespace(project=str(tmp_path), name="evo", epochs=1,
                                mlflow_url="http://mlflow:5000", experiment_name="exp_evo")
    ev = BaseEvolver(opt, {"lr0": 0.01, "box": 0.05}, {"task_ids": ["t1"]}, generations=1,
                     params_to_evolve=["lr0", "box"])
    ev.log_generation_to_mlflow(3, {"lr0": 0.02, "box": 0.06, "mosaic": 1.0},
                                {"t1": (0.5, 0.6, 0.7, 0.4)})
    (_, (params,), _), = stub_mlflow.named("log_params")
    assert set(params) == {"lr0", "box"}
    metrics = {}
    for _, (m,), _kw in stub_mlflow.named("log_metrics"):
        metrics.update(m)
    assert metrics["overall_fitness"] == pytest.approx(0.1 * 0.7 + 0.9 * 0.4)
    assert metrics["t1/mAP_0.5"] == pytest.approx(0.7)
    FileLogger(tmp_path / "evo").append_mutation_to_file({"lr0": 0.02}, {"t1": (0, 0, 0, 0)},
                                                         1, 0)
    ev.sync_final_artifacts_to_mlflow()
    arts = stub_mlflow.named("log_artifact")
    assert any("evolve.json" in str(a[1][0]) for a in arts)
    assert json.loads((tmp_path / "evo" / "evolve.json").read_text())["hyps"] == {"lr0": 0.02}
