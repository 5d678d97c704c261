"""Genetic (YOLOv5-style) hyperparameter evolution.

Counterpart of cerberusdet_tpu/evolve/yolov5_evolver.py (the reference's
cerberusdet/evolvers/yolov5_evolver.py:22-112): a parent drawn from the top 5
mutations weighted by fitness, multiplicative N(1, sigma) gains clipped to
[0.3, 3], a mutation vector per task for list-valued hyps, bounds clamped and
rounded to 5 digits. The draws come from np.random.default_rng(seed) and
random.Random(seed) in the JAX package's order, so for the same seed and the
same results every generation's hyps are the JAX package's.
"""

from __future__ import annotations

import copy
import random
from typing import Any, Dict, Optional

import numpy as np

from cerberusdet_tpu_torch.evaluation.metrics import overall_fitness
from cerberusdet_tpu_torch.evolve.base_evolver import BaseEvolver


class Yolov5Evolver(BaseEvolver):
    def __init__(self, *args, seed: Optional[int] = None, **kw):
        super().__init__(*args, **kw)
        self.rng = np.random.default_rng(seed)
        self.pyrng = random.Random(seed)

    def run_evolution(self) -> None:
        hyp = copy.deepcopy(self.init_hyp)
        for gen in range(self.generations):
            hyp = self.get_next_hyp(hyp)
            results_per_task = self.train_once(hyp)
            self.file_logger.append_mutation_to_file(
                copy.deepcopy(hyp), results_per_task, self.opt.epochs, gen)
            self.log_generation_to_mlflow(gen, hyp, results_per_task)
            if self.file_logger.is_last_mutation_best():
                self.ckpt_logger.update_best_model()
            else:
                self.ckpt_logger.remove_last_model()
            print(f"evolve {gen + 1}/{self.generations}: fitness "
                  f"{overall_fitness(results_per_task):.5f}")
        self.plot_evolution()
        self.sync_final_artifacts_to_mlflow()

    # ------------------------------------------------------------------
    def get_next_hyp(self, hyp: Dict[str, Any]) -> Dict[str, Any]:
        if self.file_logger.read_mutations():
            hyp = self.mutate_from_prev_result(hyp)
        return self.bound_hyp_values(hyp)

    def mutate_from_prev_result(self, hyp: Dict[str, Any]) -> Dict[str, Any]:
        mutations = self.file_logger.read_top_5_mutations()
        of = np.array([overall_fitness(m["results_per_task"]) for m in mutations])
        w = of - of.min() + 1e-6
        parent = mutations[self.pyrng.choices(range(len(mutations)), weights=w)[0]]["hyps"]

        mp, sigma = 0.8, 0.2
        keys = [k for k in hyp if k in self.meta]
        ng = len(keys)
        gains = np.array([self.meta[k][0] for k in keys])
        task_vectors = []
        for _ in self.task_ids:
            v = np.ones(ng)
            while (v == 1).all():  # force a change (prevent duplicates)
                v = (gains * (self.rng.random(ng) < mp) * self.rng.standard_normal(ng)
                     * self.rng.random() * sigma + 1).clip(0.3, 3.0)
            task_vectors.append(v)

        out = copy.deepcopy(hyp)
        for i, k in enumerate(keys):
            if not self.meta[k][3]:
                continue
            pv = parent.get(k, hyp[k])
            if isinstance(hyp[k], list):
                base = pv if isinstance(pv, list) else [pv] * len(self.task_ids)
                out[k] = [float(base[t] * task_vectors[t][i]) for t in range(len(self.task_ids))]
            else:
                base = pv[0] if isinstance(pv, list) else pv
                out[k] = float(base * task_vectors[0][i])
        return out

    def bound_hyp_values(self, hyp: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(hyp)
        for k, (g, lo, hi, enabled) in self.meta.items():
            if k not in out:
                continue
            if isinstance(out[k], list):
                out[k] = [round(min(max(float(v), lo), hi), 5) for v in out[k]]
            else:
                out[k] = round(min(max(float(out[k]), lo), hi), 5)
        return out
