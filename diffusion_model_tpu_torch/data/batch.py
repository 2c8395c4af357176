"""Padded fixed-shape graph batches.

  pos      [B, N, 3]   coordinates
  species  [B, N, A]   one-hot species
  spectrum [B, N, S]   per-node conditioning spectra
  exo      [B, N, 1]   excited-atom indicator
  mask     [B, N]      1 for real atoms, 0 for padding

All fields are float32 tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from diffusion_model_tpu_torch.ops.edges import dense_pair_mask


@dataclasses.dataclass(frozen=True)
class GraphBatch:
    pos: torch.Tensor
    species: torch.Tensor
    spectrum: torch.Tensor
    exo: torch.Tensor
    mask: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    @property
    def n_max(self) -> int:
        return self.pos.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def pair_mask(self) -> torch.Tensor:
        return dense_pair_mask(self.mask)

    def num_nodes(self) -> torch.Tensor:
        """The batch's real atoms (the sum of ``mask``)."""
        return self.mask.sum()

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "GraphBatch":
        """Apply ``fn`` to every field."""
        return GraphBatch(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})

    def __len__(self) -> int:
        return self.batch_size


def pad_graph(pos: np.ndarray, species: np.ndarray, spectrum: np.ndarray,
              exo: np.ndarray, n_max: int):
    """Pad one graph's arrays to ``n_max`` nodes, returning (arrays, mask)."""
    n = pos.shape[0]
    if n > n_max:
        raise ValueError(f"graph has {n} atoms > n_max={n_max}")

    def pad(a):
        out = np.zeros((n_max,) + a.shape[1:], dtype=np.float32)
        out[:n] = a
        return out

    mask = np.zeros((n_max,), np.float32)
    mask[:n] = 1.0
    return pad(pos), pad(species), pad(spectrum), pad(exo), mask


def collate(graphs: Sequence[dict], n_max: int, device) -> GraphBatch:
    """Stack graph dicts (numpy arrays keyed pos/species/spectrum/exo) into a
    padded GraphBatch on ``device``."""
    fields = [pad_graph(np.asarray(g["pos"], np.float32),
                        np.asarray(g["species"], np.float32),
                        np.asarray(g["spectrum"], np.float32),
                        np.asarray(g["exo"], np.float32), n_max)
              for g in graphs]
    pos, sp, spec, exo, mask = (
        torch.from_numpy(np.stack(col)).to(device) for col in zip(*fields))
    return GraphBatch(pos=pos, species=sp, spectrum=spec, exo=exo, mask=mask)
