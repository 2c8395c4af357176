"""EELS spectrum compressor: a Linear/ReLU stack ``S -> hidden -> out``,
applied per node over ``[..., S]`` spectra, drawn as flax's ``Dense``
(``lecun_normal`` weights, zero biases)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from diffusion_model_tpu_torch.nn.egnn import flax_dense


class SpectrumCompressor(nn.Module):
    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (150, 100, 50),
                 out_dim: int = 32, compute_dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        widths = [in_dim, *hidden_dims]
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"dense{i}", flax_dense(a, b, device))
        self.dense_out = flax_dense(widths[-1], out_dim, device)
        self.num_hidden = len(hidden_dims)

    def forward(self, spectrum: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = spectrum.to(dt)
        for i in range(self.num_hidden):
            layer = getattr(self, f"dense{i}")
            y = torch.relu(nn.functional.linear(
                y, layer.weight.to(dt), layer.bias.to(dt)))
        y = nn.functional.linear(y, self.dense_out.weight.to(dt),
                                 self.dense_out.bias.to(dt))
        return y.to(spectrum.dtype)
