"""Global RNG seeding: the port's counterpart of
cerberusdet_tpu/utils/seeds.py:18 (the reference's general.py:38 init_seeds).

The data pipeline does not rely on these globals: the dataset derives a
random.Random per (seed, epoch, index) (data/dataset.py), so threaded
prefetch stays bit for bit repeatable. Seeding them covers the rest and
makes whole runs repeatable.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def init_seeds(seed: int = 0) -> torch.Generator:
    """Seed python's, numpy's and torch's global RNGs and return a
    torch.Generator seeded with `seed` (where the JAX package returns
    jax.random.PRNGKey(seed))."""
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
