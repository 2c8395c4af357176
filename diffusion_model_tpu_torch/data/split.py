"""Seeded dataset splitting and batching (numpy orders), as
``diffusion_model_tpu.data.split``.

``split_dataset``: lengths ``int(0.8 n)``, ``int(0.1 n)`` and the remainder,
from ``default_rng(seed).permutation``. The batch iterators shuffle with
``default_rng(seed).shuffle`` and pad the last short batch up to
``batch_size`` by cycling the shuffled order, the filler graphs' masks
zeroed, so every batch has one shape and each graph counts once an epoch.
"""

from __future__ import annotations

from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from diffusion_model_tpu_torch.data.batch import GraphBatch, collate


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


def batch_order(count: int, batch_size: int, seed: Optional[int] = None,
                drop_remainder: bool = False):
    """(indices, valid): the seeded order of ``count`` graphs cut to whole
    batches, the last one filled by cycling the order (``valid`` 0 on the
    filler), or dropped with ``drop_remainder``."""
    idx = np.arange(count)
    if seed is not None:
        np.random.default_rng(seed).shuffle(idx)
    full = count // batch_size * batch_size
    valid = np.ones(count, np.float32)
    if count > full and not drop_remainder:
        filler = np.resize(idx, full + batch_size - count)
        idx = np.concatenate([idx, filler])
        valid = np.concatenate([valid, np.zeros(len(filler), np.float32)])
    else:
        idx, valid = idx[:full], valid[:full]
    return idx, valid


def device_batch_iterator(data: GraphBatch, batch_size: int,
                          seed: Optional[int] = None,
                          drop_remainder: bool = False
                          ) -> Iterator[GraphBatch]:
    """Shuffled padded batches gathered on ``data``'s device from a dataset
    collated once (``collate(graphs, n_max, device)``): the order and the
    filler of ``batch_iterator``, and one small index transfer an epoch."""
    idx, valid = batch_order(data.batch_size, batch_size, seed,
                             drop_remainder)
    idx_dev = torch.as_tensor(idx, dtype=torch.int64, device=data.device)
    valid_dev = torch.as_tensor(valid, device=data.device)
    for start in range(0, len(idx), batch_size):
        sl = idx_dev[start:start + batch_size]
        v = valid_dev[start:start + batch_size]
        batch = data.map(lambda a: a.index_select(0, sl))
        yield GraphBatch(pos=batch.pos, species=batch.species,
                         spectrum=batch.spectrum, exo=batch.exo,
                         mask=batch.mask * v[:, None])


def batch_iterator(graphs: Sequence[dict], batch_size: int, n_max: int,
                   seed: Optional[int] = None, drop_remainder: bool = False,
                   device="cpu") -> Iterator[GraphBatch]:
    """Shuffled padded batches collated from graph dicts on ``device``,
    batch by batch."""
    idx, valid = batch_order(len(graphs), batch_size, seed, drop_remainder)
    for start in range(0, len(idx), batch_size):
        batch = collate([graphs[i] for i in idx[start:start + batch_size]],
                        n_max, device)
        v = torch.as_tensor(valid[start:start + batch_size],
                            device=batch.device)
        yield GraphBatch(pos=batch.pos, species=batch.species,
                         spectrum=batch.spectrum, exo=batch.exo,
                         mask=batch.mask * v[:, None])
