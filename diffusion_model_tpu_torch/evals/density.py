"""Oxygen density of generated structures, as
``diffusion_model_tpu/evals/density.py`` (numpy, statement for statement)."""

from __future__ import annotations

import numpy as np


def o_density(species: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fraction of O (one-hot [1, 0]) per structure over real atoms.

    species: ``[G, N, 2]``; mask: ``[G, N]``.
    """
    m = np.asarray(mask)
    o = np.asarray(species)[..., 0] * m
    return o.sum(-1) / np.maximum(m.sum(-1), 1)


def density_accuracy(density_original: np.ndarray,
                     density_generated: np.ndarray) -> float:
    """Share of structures whose O density matches exactly."""
    a = np.asarray(density_original)
    b = np.asarray(density_generated)
    return float(np.mean(np.abs(a - b) == 0))
