"""Synthetic amorphous SiO2 cells for the large-cell path (numpy only).

The same generator, draw for draw, as ``diffusion_model_tpu.data.synthetic``
``amorphous_cell`` and the ``synthetic_spectrum`` it calls, so a seed gives
the same cell in both packages. ``bench.py``'s large cells (1024+ atoms)
come from it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def synthetic_spectrum(cn: int, rng: np.random.Generator, size: int = 200,
                       mean_angle_deg: Optional[float] = None) -> np.ndarray:
    """ELNES-like curve on the -1..19 eV grid: two Gaussian peaks whose
    centres and amplitudes shift with the coordination number ``cn``, plus a
    third tracking the mean bond angle when it is given; min-max
    normalised."""
    ev = np.linspace(-1.0, 19.0, size)
    c1 = 5.0 + 1.2 * cn + rng.normal(0, 0.15)
    c2 = 11.0 + 0.8 * cn + rng.normal(0, 0.2)
    w1 = 1.2 + 0.1 * cn
    w2 = 2.5
    a2 = 0.5 + 0.1 * cn
    y = (np.exp(-0.5 * ((ev - c1) / w1) ** 2)
         + a2 * np.exp(-0.5 * ((ev - c2) / w2) ** 2))
    if mean_angle_deg is not None:
        c3 = -0.5 + 4.0 * (mean_angle_deg / 180.0) + rng.normal(0, 0.05)
        y += 0.7 * np.exp(-0.5 * ((ev - c3) / 0.6) ** 2)
    y += rng.normal(0, 0.01, size)
    y -= y.min()
    y /= max(y.max(), 1e-9)
    return y.astype(np.float32)


def amorphous_cell(seed: int, num_atoms: int, density_si_ratio: float = 1 / 3,
                   spectrum_size: int = 200) -> dict:
    """An amorphous-like SiO2 cell of ``num_atoms`` atoms as a graph dict:
    atoms drawn with a minimum-distance (1.4 A) rejection loop inside a cube
    sized for silica's number density (~0.066 atoms/A^3), atom 0 the excited
    oxygen at the origin, a third of the others Si."""
    rng = np.random.default_rng(seed)
    side = (num_atoms / 0.066) ** (1 / 3)
    pos: list = []
    while len(pos) < num_atoms:
        cand = rng.uniform(0, side, 3)
        if all(np.sum((cand - p) ** 2) > 1.4**2 for p in pos[-200:]):
            pos.append(cand)
    pos = np.asarray(pos, np.float32)
    pos -= pos[0]
    n_si = int(num_atoms * density_si_ratio)
    species = np.zeros((num_atoms, 2), np.float32)
    species[:, 0] = 1.0
    si_idx = rng.choice(np.arange(1, num_atoms), n_si, replace=False)
    species[si_idx] = [0.0, 1.0]
    spectrum = np.zeros((num_atoms, spectrum_size), np.float32)
    spectrum[0] = synthetic_spectrum(4, rng, spectrum_size)
    exo = np.zeros((num_atoms, 1), np.float32)
    exo[0, 0] = 1.0
    return {"pos": pos, "species": species, "spectrum": spectrum, "exo": exo,
            "cn": 4, "id": f"amorphous_{seed}"}
