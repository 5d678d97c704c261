"""Index samplers: shuffled, class-balanced, and split over processes.

Copies of ShuffleSampler, BalancedSampler and HostShardSampler from
cerberusdet_tpu/data/samplers.py:17-104 (the reference's BalancedBatchSampler,
cerberusdet/data/samplers.py:9-95, with its least_sampled / random / cycle
modes, and its DistributedSamplerWrapper, :137-184), with the same draws for
the same seed and epoch.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional

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


class HostShardSampler:
    """Wrap any sampler: each process keeps every k-th index (its slice of
    the process group; rank and world size from torch.distributed unless
    given). As in the JAX package, __len__ is ceil(n / k) on every process,
    so that every rank counts the same batches an epoch, while the ranks at
    or past n % k yield one index fewer.

    block > 1 shards runs of `block` consecutive indices instead (a rect
    loader's batches, whose images share one letterbox shape: every k-th
    batch), with __len__ ceil(n / block / k) * block on every process. The
    JAX package has no such mode: its host-sharded rect loader puts images
    of two batches' shapes in one batch."""

    def __init__(self, base, num_hosts: Optional[int] = None, host_id: Optional[int] = None,
                 block: int = 1):
        import torch.distributed as dist

        joined = dist.is_available() and dist.is_initialized()
        self.base = base
        self.num_hosts = num_hosts if num_hosts is not None else (
            dist.get_world_size() if joined else 1)
        self.host_id = host_id if host_id is not None else (dist.get_rank() if joined else 0)
        self.block = max(int(block), 1)

    def set_epoch(self, epoch: int):
        if hasattr(self.base, "set_epoch"):
            self.base.set_epoch(epoch)

    def __len__(self):
        blocks = -(-len(self.base) // self.block)
        return -(-blocks // self.num_hosts) * self.block

    def __iter__(self) -> Iterator[int]:
        for i, idx in enumerate(self.base):
            if (i // self.block) % self.num_hosts == self.host_id:
                yield idx
