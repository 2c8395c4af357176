"""Synthetic SiO2 data (numpy only): local environments and amorphous cells.

The same generators, draw for draw, as ``diffusion_model_tpu.data.synthetic``
``synthetic_sio2_dataset`` (with ``make_graph`` and ``_random_unit_vectors``),
``amorphous_cell`` and the ``synthetic_spectrum`` both call, so a seed gives
the same graphs in both packages, bit for bit on one numpy. The flagship's
test conditions come from the first (split by ``data.split``), ``bench.py``'s
large cells (1024+ atoms) from the second.

A local environment: node 0 the excited oxygen (exO) at the origin, species
one-hot O = [1, 0]; CN in {2, 3, 4} Si neighbours at ~1.62 A (Si = [0, 1]),
pairwise at least 60 degrees apart; with ``shells >= 2`` a bridging O beyond
each Si; the spectrum on row 0 only, encoding CN and the mean Si-exO-Si
angle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SI_O_BOND = 1.62  # A, typical silica bond length


def _random_unit_vectors(rng: np.random.Generator, n: int,
                         min_angle_deg: float = 60.0) -> np.ndarray:
    """``n`` unit vectors pairwise separated by at least ``min_angle_deg``
    (rejection sampling, one normal draw of 3 per candidate)."""
    cos_max = np.cos(np.radians(min_angle_deg))
    vecs: list = []
    while len(vecs) < n:
        v = rng.normal(size=3)
        v /= np.linalg.norm(v)
        if all(np.dot(v, u) < cos_max for u in vecs):
            vecs.append(v)
    return np.stack(vecs)


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


def make_graph(rng: np.random.Generator, n_max: int, spectrum_size: int = 200,
               shells: int = 1, cn: Optional[int] = None) -> dict:
    """One synthetic local environment as a graph dict (numpy ``pos``,
    ``species``, ``spectrum``, ``exo``; ``cn``, ``mean_angle_deg``, ``id``)."""
    if cn is None:
        cn = int(rng.integers(2, 5))  # CN in {2, 3, 4}
    dirs = _random_unit_vectors(rng, cn)
    angles = [np.degrees(np.arccos(np.clip(np.dot(dirs[i], dirs[j]),
                                           -1.0, 1.0)))
              for i in range(cn) for j in range(i + 1, cn)]
    mean_angle = float(np.mean(angles)) if angles else 180.0
    pos = [np.zeros(3)]
    species = [[1.0, 0.0]]  # exO is oxygen
    for d in dirs:
        pos.append(d * (SI_O_BOND + rng.normal(0, 0.04)))
        species.append([0.0, 1.0])  # Si
    if shells >= 2:
        for i in range(cn):
            if len(pos) >= n_max:
                break
            si = pos[1 + i]
            out_dir = si / np.linalg.norm(si)
            perp = np.cross(out_dir, rng.normal(size=3))
            perp /= np.linalg.norm(perp)
            bridge = out_dir * 0.5 + perp * 0.87
            bridge /= np.linalg.norm(bridge)
            pos.append(si + bridge * (SI_O_BOND + rng.normal(0, 0.04)))
            species.append([1.0, 0.0])  # bridging O
    pos = np.asarray(pos, np.float32)
    species = np.asarray(species, np.float32)
    n = pos.shape[0]
    spectrum = np.zeros((n, spectrum_size), np.float32)
    spectrum[0] = synthetic_spectrum(cn, rng, spectrum_size,
                                     mean_angle_deg=mean_angle)
    exo = np.zeros((n, 1), np.float32)
    exo[0, 0] = 1.0
    return {"pos": pos, "species": species, "spectrum": spectrum, "exo": exo,
            "cn": cn, "mean_angle_deg": mean_angle,
            "id": f"synthetic_{rng.integers(1 << 30)}"}


def synthetic_sio2_dataset(seed: int, num_graphs: int, n_max: int,
                           spectrum_size: int = 200,
                           shells: int = 1) -> list:
    """``num_graphs`` local environments from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [make_graph(rng, n_max, spectrum_size, shells)
            for _ in range(num_graphs)]


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
