"""MLflow experiment tracking (an optional dependency).

A copy of cerberusdet_tpu/utils/mlflow_logging.py (the reference's
cerberusdet/utils/mlflow_logging.py:14-225): init_mlflow, MLFlowLogger (run
naming and dedup, params, metrics, artifacts, the model checksum and
signature) and attempt_mlflow_download for models:/ URIs. Without mlflow
every logger is a no-op (training keeps TensorBoard and results.txt), and a
models:/ URI raises. A backend that fails degrades the logger to a no-op
with a warning, call by call. The module-level `mlflow` is the only handle
on the package, so that a test can stand a stub in for it.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Optional

try:
    import mlflow  # type: ignore

    MLFLOW_AVAILABLE = True
except ImportError:
    mlflow = None
    MLFLOW_AVAILABLE = False


def init_mlflow(tracking_uri: str) -> bool:
    """Point mlflow at the tracking server (mlflow_logging.py:14-23)."""
    if not MLFLOW_AVAILABLE:
        return False
    mlflow.set_tracking_uri(tracking_uri)
    return True


def file_md5(path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class MLFlowLogger:
    """Params, metrics and artifacts of one run; a no-op without mlflow or
    when the backend fails at start."""

    def __init__(self, experiment_name: str, run_name: str,
                 tracking_uri: Optional[str] = None):
        self.active = MLFLOW_AVAILABLE
        if not self.active:
            return
        try:
            if tracking_uri:
                init_mlflow(tracking_uri)
            mlflow.set_experiment(experiment_name)
            existing = mlflow.search_runs(
                filter_string=f"tags.mlflow.runName = '{run_name}'", output_format="list")
            if existing:  # resume the run of that name instead of a duplicate
                mlflow.start_run(run_id=existing[0].info.run_id)
            else:
                mlflow.start_run(run_name=run_name)
        except Exception as e:  # a broken or partial backend: log nothing
            print(f"WARNING: mlflow unavailable ({e}); logging disabled")
            self.active = False

    def _safe(self, thunk):
        if not self.active:
            return
        try:
            thunk()
        except Exception as e:
            print(f"WARNING: mlflow call failed ({e})")

    def log_params(self, params: Dict[str, Any]):
        self._safe(lambda: mlflow.log_params({k: str(v)[:250] for k, v in params.items()}))

    def log_metrics(self, metrics: Dict[str, float], step: int = 0):
        self._safe(lambda: mlflow.log_metrics({k: float(v) for k, v in metrics.items()},
                                              step=step))

    def log_artifact(self, path, artifact_path: Optional[str] = None):
        if Path(path).exists():
            self._safe(lambda: mlflow.log_artifact(str(path), artifact_path))

    def log_model_checksum(self, path):
        if Path(path).exists():
            self._safe(lambda: mlflow.log_param("model_md5", file_md5(path)))

    def log_model(self, ckpt_path, signature: Optional[Dict[str, Any]] = None,
                  artifact_path: str = "model"):
        """Register the checkpoint file with an I/O signature, a {inputs,
        outputs} dict (the reference logs the torch module and an
        infer_signature, mlflow_logging.py:90-107; the model here is the
        .ckpt.npz that either package loads)."""
        if not Path(ckpt_path).exists():
            return
        self._safe(lambda: mlflow.log_artifact(str(ckpt_path), artifact_path))
        if signature:
            self._safe(lambda: mlflow.log_param("model_signature", json.dumps(signature)[:450]))
        self.log_model_checksum(ckpt_path)

    def finish(self):
        self._safe(lambda: mlflow.end_run())


def attempt_mlflow_download(uri: str, dst_dir: str = ".") -> str:
    """Resolve a 'models:/name/version' URI to a local file
    (mlflow_logging.py:161-225); any other path is returned as it is."""
    if not uri.startswith("models:/"):
        return uri
    if not MLFLOW_AVAILABLE:
        raise RuntimeError(f"cannot resolve {uri!r}: mlflow is not installed")
    return mlflow.artifacts.download_artifacts(artifact_uri=uri, dst_path=dst_dir)
