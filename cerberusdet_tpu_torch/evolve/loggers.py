"""Evolution bookkeeping: the mutation log, the best hyps, checkpoint
promotion.

A copy of cerberusdet_tpu/evolve/loggers.py (the reference's
cerberusdet/evolvers/file_logger.py:12-98, evolve.json and
hyp_evolved.yaml, and checkpoint_logger.py:8-25, promote or drop the last
checkpoint), with the same files, so that either package reads the other's
evolve.json.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List

import numpy as np
import yaml

from cerberusdet_tpu_torch.evaluation.metrics import overall_fitness


class FileLogger:
    def __init__(self, save_dir):
        self.save_dir = Path(save_dir)
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.evolve_results_file = self.save_dir / "evolve.json"
        self.best_hyp_file = self.save_dir / "hyp_evolved.yaml"

    def read_mutations(self) -> List[Dict[str, Any]]:
        if not self.evolve_results_file.exists():
            return []
        with open(self.evolve_results_file) as f:
            return [json.loads(line) for line in f if line.strip()]

    def read_top_5_mutations(self) -> List[Dict[str, Any]]:
        muts = self.read_mutations()
        muts.sort(key=lambda m: overall_fitness(m["results_per_task"]), reverse=True)
        return muts[:5]

    def append_mutation_to_file(self, hyps: Dict[str, Any],
                                results_per_task: Dict[str, tuple],
                                train_epochs: int, step: int) -> None:
        """One line of evolve.json a generation; hyp_evolved.yaml rewritten
        with the best generation's hyps."""
        rec = {
            "step": step,
            "hyps": hyps,
            "results_per_task": {k: list(map(float, v)) for k, v in results_per_task.items()},
            "train_epochs": train_epochs,
        }
        with open(self.evolve_results_file, "a") as f:
            f.write(json.dumps(rec) + "\n")
        best = self.read_top_5_mutations()[0]
        with open(self.best_hyp_file, "w") as f:
            f.write("# best evolved hyperparameters "
                    f"(fitness {overall_fitness(best['results_per_task']):.5f})\n")
            yaml.safe_dump(best["hyps"], f, sort_keys=False)

    def is_last_mutation_best(self) -> bool:
        muts = self.read_mutations()
        if not muts:
            return False
        fits = [overall_fitness(m["results_per_task"]) for m in muts]
        return int(np.argmax(fits)) == len(fits) - 1


class CheckpointLogger:
    """Keep only the best generation's weights (checkpoint_logger.py:8-25)."""

    def __init__(self, save_dir):
        self.wdir = Path(save_dir) / "weights"

    def update_best_model(self) -> None:
        last = self.wdir / "last.ckpt.npz"
        if last.exists():
            shutil.copy(last, self.wdir / "best.ckpt.npz")

    def remove_last_model(self) -> None:
        last = self.wdir / "last.ckpt.npz"
        if last.exists():
            last.unlink()
