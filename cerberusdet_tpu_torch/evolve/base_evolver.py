"""Hyperparameter-evolution scaffolding.

Counterpart of cerberusdet_tpu/evolve/base_evolver.py (the reference's
cerberusdet/evolvers/base_evolver.py:29-132): the 24-hyp search space
(mutation gain, lower, upper, enabled), the --params-to-evolve filter, one
short training run a generation with noval, its val per task, one MLflow run
a generation and the final artifacts, and the evolution scatter.

Each generation builds a TrainLoop on the evolver's device and closes it
after its val (TrainLoop.close), so that the process holds one
generation's captured steps, graph pool, model and loaders at a time.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from cerberusdet_tpu_torch.evaluation.metrics import overall_fitness
from cerberusdet_tpu_torch.evolve.loggers import CheckpointLogger, FileLogger

# {name: [mutation gain 0-1, lower, upper, enabled]} (base_evolver.py:37-61)
DEFAULT_META: Dict[str, List] = {
    "lr0": [1, 1e-5, 1e-1, True],
    "lrf": [1, 0.01, 1.0, True],
    "momentum": [0.3, 0.6, 0.98, True],
    "weight_decay": [1, 0.0, 0.001, True],
    "warmup_epochs": [1, 0.0, 5.0, True],
    "warmup_momentum": [1, 0.0, 0.95, True],
    "warmup_bias_lr": [1, 0.0, 0.2, True],
    "box": [1, 0.02, 0.2, True],
    "cls": [1, 0.2, 4.0, True],
    "dfl": [1, 0.2, 4.0, True],
    "hsv_h": [1, 0.0, 0.1, True],
    "hsv_s": [1, 0.0, 0.9, True],
    "hsv_v": [1, 0.0, 0.9, True],
    "degrees": [1, 0.0, 45.0, True],
    "translate": [1, 0.0, 0.9, True],
    "scale": [1, 0.0, 0.9, True],
    "scaleup": [1, 0.0, 1.0, True],
    "shear": [1, 0.0, 10.0, True],
    "perspective": [0, 0.0, 0.001, True],
    "flipud": [1, 0.0, 1.0, True],
    "fliplr": [0, 0.0, 1.0, True],
    "mosaic": [1, 0.0, 1.0, True],
    "mixup": [1, 0.0, 1.0, True],
    "label_smoothing": [1, 0.0, 0.5, True],
}


class BaseEvolver:
    """`opt` is the train CLI's TrainOptions; generations train on `device`
    (the card when None)."""

    def __init__(self, opt, hyp: Dict[str, Any], data_dict: Dict[str, Any],
                 generations: int = 300, params_to_evolve: Optional[List[str]] = None,
                 device=None):
        self.opt = opt
        self.init_hyp = copy.deepcopy(hyp)
        self.data_dict = data_dict
        self.generations = generations
        self.device = device
        self.task_ids = list(data_dict["task_ids"])
        self.meta = copy.deepcopy(DEFAULT_META)
        if params_to_evolve:
            for k in self.meta:
                if k not in params_to_evolve:
                    self.meta[k][3] = False
        self.params_to_evolve = [k for k, v in self.meta.items() if v[3]]
        self.save_dir = Path(opt.project) / opt.name
        self.file_logger = FileLogger(self.save_dir)
        self.ckpt_logger = CheckpointLogger(self.save_dir)
        # one MLflow run a generation, the artifacts at the end
        # (base_evolver.py:134-223); nothing without --mlflow-url
        self.mlflow_url = getattr(opt, "mlflow_url", "") or ""

    # ------------------------------------------------------------- mlflow
    def log_generation_to_mlflow(self, gen: int, hyp: Dict[str, Any],
                                 results_per_task: Dict[str, tuple]) -> None:
        """One MLflow run a generation: the evolved hyps as params, per-task
        (P, R, mAP50, mAP) and the overall fitness as metrics."""
        if not self.mlflow_url:
            return
        from cerberusdet_tpu_torch.utils.mlflow_logging import MLFlowLogger

        logger = MLFlowLogger(self.opt.experiment_name, f"{self.opt.name}_gen{gen}",
                              tracking_uri=self.mlflow_url)
        logger.log_params({k: hyp[k] for k in self.params_to_evolve if k in hyp})
        metrics = {"overall_fitness": float(overall_fitness(results_per_task))}
        for task, (p, r, map50, mAP) in results_per_task.items():
            metrics.update({
                f"{task}/precision": float(p), f"{task}/recall": float(r),
                f"{task}/mAP_0.5": float(map50), f"{task}/mAP_0.5_0.95": float(mAP),
            })
        logger.log_metrics(metrics)
        logger.finish()

    def sync_final_artifacts_to_mlflow(self) -> None:
        """After the last generation: evolve.json, hyp_evolved.yaml and
        evolve.png to a summary run (_update_best_run_artifacts)."""
        if not self.mlflow_url:
            return
        from cerberusdet_tpu_torch.utils.mlflow_logging import MLFlowLogger

        logger = MLFlowLogger(self.opt.experiment_name, f"{self.opt.name}_final",
                              tracking_uri=self.mlflow_url)
        for name in ("evolve.json", "hyp_evolved.yaml", "evolve.png"):
            p = self.save_dir / name
            if p.exists():
                logger.log_artifact(p, artifact_path="final_output")
        logger.finish()

    # ------------------------------------------------------------------
    def train_once(self, hyp: Dict[str, Any]) -> Dict[str, tuple]:
        """One generation: a TrainLoop with noval in <save_dir>/gen
        (base_evolver.py:74), then a val of its EMA model per task. Returns
        {task: (P, R, mAP50, mAP)}. The loop is closed before returning."""
        from cerberusdet_tpu_torch.evaluation.val import eval_flags, run_task
        from cerberusdet_tpu_torch.train.trainer import TrainLoop

        opt = dataclasses.replace(self.opt, noval=True, exist_ok=True,
                                  project=str(self.save_dir), name="gen")
        loop = TrainLoop(opt, self.data_dict, copy.deepcopy(hyp), device=self.device)
        try:
            loop.train()
            results = {}
            with eval_flags():
                for ti, task in enumerate(self.task_ids):
                    out = run_task(loop.state.ema, task, loop.val_loaders[task],
                                   nc=loop.manager.nc[ti])
                    results[task] = out["results"][:4]
        finally:
            loop.close()
        return results

    def plot_evolution(self) -> None:
        """Scatter of fitness against each evolved hyp (plots.py:409-430),
        evolve.png; not drawn without matplotlib (utils/plots.py:pyplot)."""
        muts = self.file_logger.read_mutations()
        if not muts:
            return
        from cerberusdet_tpu_torch.utils.plots import pyplot

        plt = pyplot("evolve.png")
        if plt is None:
            return
        fits = [overall_fitness(m["results_per_task"]) for m in muts]
        keys = [k for k in self.params_to_evolve if k in muts[0]["hyps"]]
        cols = 5
        rows = -(-len(keys) // cols)
        plt.figure(figsize=(3 * cols, 3 * rows))
        for i, k in enumerate(keys):
            vals = [m["hyps"][k] if not isinstance(m["hyps"][k], list)
                    else float(np.mean(m["hyps"][k])) for m in muts]
            plt.subplot(rows, cols, i + 1)
            plt.scatter(vals, fits, c=fits, cmap="viridis", alpha=0.8)
            plt.title(k, fontsize=9)
        plt.tight_layout()
        plt.savefig(self.save_dir / "evolve.png", dpi=150)
        plt.close()
