"""Index samplers: shuffled and class-balanced.

Copies of ShuffleSampler and BalancedSampler from
cerberusdet_tpu/data/samplers.py:17-81 (the reference's BalancedBatchSampler,
cerberusdet/data/samplers.py:9-95, with its least_sampled / random / cycle
modes), with the same draws for the same seed and epoch. The JAX package's
HostShardSampler, which splits the indices over processes, comes with the
port's multi-GPU data parallelism (ROADMAP.md queue 1, item 6).
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List

import numpy as np


class ShuffleSampler:
    def __init__(self, n: int, shuffle: bool = True, seed: int = 0):
        self.n = n
        self.shuffle = shuffle
        self.epoch = 0
        self.seed = seed

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return iter(idx.tolist())


class BalancedSampler:
    """Class-balanced sampling: pick a class, then a random image containing
    it. Epoch length = dataset length."""

    def __init__(self, labels: List[np.ndarray], class_choice: str = "least_sampled",
                 seed: int = 0):
        assert class_choice in ("least_sampled", "random", "cycle")
        self.class_choice = class_choice
        self.seed = seed
        self.epoch = 0
        self.image_classes: List[List[int]] = []
        self.class_indices: Dict[int, List[int]] = {}
        for idx, lb in enumerate(labels):
            classes = [int(c) for c in (lb[:, 0].tolist() if len(lb) else [])]
            self.image_classes.append(classes)
            for c in classes:
                self.class_indices.setdefault(c, []).append(idx)
        self.all_classes = sorted(self.class_indices)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.image_classes)

    def __iter__(self) -> Iterator[int]:
        rng = random.Random(self.seed + self.epoch)
        counts = {c: 0 for c in self.all_classes}
        current = 0
        for _ in range(len(self.image_classes)):
            if self.class_choice == "random":
                cls = rng.choice(self.all_classes)
            elif self.class_choice == "cycle":
                cls = self.all_classes[current]
                current = (current + 1) % len(self.all_classes)
            else:  # least_sampled
                min_count = min(counts.values())
                cls = rng.choice([c for c in self.all_classes if counts[c] == min_count])
            idx = rng.choice(self.class_indices[cls])
            if self.class_choice == "least_sampled":
                for c in self.image_classes[idx]:
                    counts[c] += 1
            yield idx
