"""Atom-count predictor: spectrum -> number of atoms in the local
environment, as ``diffusion_model_tpu/nn/cn_mlp.py`` ``CNPredictor``: a ReLU
MLP ``spectrum_size -> hidden_dims -> 1``.

The layers are ``nn.Linear`` named as the flax modules (``dense0`` ...
``dense_out``), so a flax parameter tree ``{"params": {"dense0": {"kernel",
"bias"}, ...}}`` loads through ``train.checkpoint.state_dict_from_flax``
(``load_flax``), kernels transposed.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from diffusion_model_tpu_torch.train.checkpoint import state_dict_from_flax


class CNPredictor(nn.Module):
    def __init__(self, hidden_dims: Sequence[int] = (100, 100, 50, 25),
                 spectrum_size: int = 200, device=None):
        super().__init__()
        self.hidden_dims = tuple(hidden_dims)
        width = spectrum_size
        for i, f in enumerate(self.hidden_dims):
            setattr(self, f"dense{i}", nn.Linear(width, f, device=device))
            width = f
        self.dense_out = nn.Linear(width, 1, device=device)

    def forward(self, spectrum: torch.Tensor) -> torch.Tensor:
        y = spectrum
        for i in range(len(self.hidden_dims)):
            y = torch.relu(getattr(self, f"dense{i}")(y))
        return self.dense_out(y)

    def load_flax(self, params: dict) -> "CNPredictor":
        """Hold a flax parameter tree (``{"params": ...}``); strict."""
        self.load_state_dict(state_dict_from_flax(params))
        return self
