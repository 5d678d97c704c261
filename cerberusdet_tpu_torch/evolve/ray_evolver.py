"""Ray Tune hyperparameter search (an optional dependency).

Counterpart of cerberusdet_tpu/evolve/ray_evolver.py (the reference's
cerberusdet/evolvers/ray_evolver.py:22-235): tune.Tuner with the ASHA
scheduler, a searcher from a predefined registry behind
ConcurrencyLimiter, uniform search spaces with per-task '{hyp}_{task}' keys,
and reformat_config folding those back into list-valued hyps. ray is
imported when the evolver is built, and its absence raises ImportError
there; the trials report to the driver, which keeps evolve.json and MLflow.
"""

from __future__ import annotations

import copy
import importlib
import json
from typing import Any, Dict, List

from cerberusdet_tpu_torch.evaluation.metrics import overall_fitness
from cerberusdet_tpu_torch.evolve.base_evolver import BaseEvolver

# searcher name -> (module, class) (predefined_evolvers.py:2-33)
PREDEFINED_SEARCHERS = {
    "ax": ("ray.tune.search.ax", "AxSearch"),
    "bohb": ("ray.tune.search.bohb", "TuneBOHB"),
    "cfo": ("ray.tune.search.flaml", "CFO"),
    "dragonfly": ("ray.tune.search.dragonfly", "DragonflySearch"),
    "hebo": ("ray.tune.search.hebo", "HEBOSearch"),
    "hyperopt": ("ray.tune.search.hyperopt", "HyperOptSearch"),
    "nevergrad": ("ray.tune.search.nevergrad", "NevergradSearch"),
    "optuna": ("ray.tune.search.optuna", "OptunaSearch"),
    "skopt": ("ray.tune.search.skopt", "SkOptSearch"),
    "zoopt": ("ray.tune.search.zoopt", "ZOOptSearch"),
    "random": (None, None),
}


def reformat_config(config: Dict[str, Any], task_ids: List[str]) -> Dict[str, Any]:
    """Fold '{hyp}_{task}'-suffixed samples back into per-task lists
    (ray_evolver.py:208-235)."""
    out: Dict[str, Any] = {}
    per_task: Dict[str, Dict[str, float]] = {}
    for k, v in config.items():
        for task in task_ids:
            suffix = f"_{task}"
            if k.endswith(suffix):
                per_task.setdefault(k[: -len(suffix)], {})[task] = v
                break
        else:
            out[k] = v
    for name, vals in per_task.items():
        out[name] = [vals[t] for t in task_ids]
    return out


class RayEvolver(BaseEvolver):
    def __init__(self, *args, searcher: str = "random", max_concurrent: int = 4, **kw):
        super().__init__(*args, **kw)
        try:
            import ray  # noqa: F401
            from ray import tune  # noqa: F401
        except ImportError as e:
            raise ImportError("RayEvolver needs ray[tune], which is not installed; "
                              "--evolver yolov5 needs no ray") from e
        if searcher not in PREDEFINED_SEARCHERS:
            raise ValueError(f"unknown searcher {searcher!r}")
        self.searcher = searcher
        self.max_concurrent = max_concurrent

    def search_space(self, hyp: Dict[str, Any]) -> Dict[str, Any]:
        from ray import tune

        space: Dict[str, Any] = {}
        for k, (g, lo, hi, enabled) in self.meta.items():
            if not enabled or k not in hyp:
                continue
            if isinstance(hyp[k], list):
                for task in self.task_ids:
                    space[f"{k}_{task}"] = tune.uniform(lo, hi)
            else:
                space[k] = tune.uniform(lo, hi)
        return space

    def run_evolution(self) -> None:
        from ray import tune
        from ray.tune.schedulers import ASHAScheduler
        from ray.tune.search import BasicVariantGenerator, ConcurrencyLimiter

        hyp0 = copy.deepcopy(self.init_hyp)

        def objective(config):
            # runs in a trial worker, which shares no state with the driver:
            # it reports, and the driver keeps the books from the results
            # (the reference's LoggerCallback is driver-side for this reason,
            # ray_evolver.py:166-193)
            from ray.air import session

            hyp = dict(hyp0)
            hyp.update(reformat_config(config, self.task_ids))
            results = self.train_once(hyp)
            session.report({
                "overall_fitness": overall_fitness(results),
                "hyps_json": json.dumps(hyp, default=float),
                "results_json": json.dumps({t: list(map(float, r)) for t, r in results.items()}),
            })

        if self.searcher == "random":
            search_alg = BasicVariantGenerator()
        else:
            mod_name, cls_name = PREDEFINED_SEARCHERS[self.searcher]
            cls = getattr(importlib.import_module(mod_name), cls_name)
            search_alg = ConcurrencyLimiter(cls(), max_concurrent=self.max_concurrent)

        tuner = tune.Tuner(
            objective,
            param_space=self.search_space(hyp0),
            tune_config=tune.TuneConfig(
                num_samples=self.generations,
                scheduler=ASHAScheduler(metric="overall_fitness", mode="max"),
                search_alg=search_alg,
            ),
        )
        # the driver's bookkeeping, in completion order
        for gen, res in enumerate(tuner.fit()):
            metrics = getattr(res, "metrics", None) or {}
            if "results_json" not in metrics:
                continue  # an errored trial
            hyp = json.loads(metrics["hyps_json"])
            results = {t: tuple(r) for t, r in json.loads(metrics["results_json"]).items()}
            self.file_logger.append_mutation_to_file(hyp, results, self.opt.epochs, gen)
            self.log_generation_to_mlflow(gen, hyp, results)
        self.plot_evolution()
        self.sync_final_artifacts_to_mlflow()
