"""Seeded 80/10/10 dataset split (numpy only), as
``diffusion_model_tpu.data.split.split_dataset``: lengths ``int(0.8 n)``,
``int(0.1 n)`` and the remainder, from ``default_rng(seed).permutation``."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def split_dataset(dataset: Sequence, seed: int, train_ratio: float = 0.8,
                  val_ratio: float = 0.1):
    """(train, validation, test) lists of the items of ``dataset``."""
    n = len(dataset)
    n_train = int(n * train_ratio)
    n_val = int(n * val_ratio)
    perm = np.random.default_rng(seed).permutation(n)
    pick = lambda idx: [dataset[i] for i in idx]
    return (pick(perm[:n_train]), pick(perm[n_train:n_train + n_val]),
            pick(perm[n_train + n_val:]))
