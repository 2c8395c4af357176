"""Synthetic data (numpy, with scipy's k-d tree for the network cells):
local environments, molecules and amorphous cells.

The same generators, draw for draw, as ``diffusion_model_tpu.data.synthetic``
``synthetic_sio2_dataset`` (with ``make_graph`` and ``_random_unit_vectors``),
``synthetic_molecule_dataset``, ``amorphous_cell``, ``amorphous_network_cell``
and the ``synthetic_spectrum`` they call, so a seed gives the same graphs in
both packages, bit for bit on one numpy. The flagship's test conditions come
from the first (split by ``data.split``), ``bench.py``'s large cells (1024+
atoms) from ``amorphous_cell``, the large-cell recipe's cells from
``amorphous_network_cell``; ``cached_cell`` memoises a cell on disk under the
JAX package's key and payload, so either package reads the other's cache.

A local environment: node 0 the excited oxygen (exO) at the origin, species
one-hot O = [1, 0]; CN in {2, 3, 4} Si neighbours at ~1.62 A (Si = [0, 1]),
pairwise at least 60 degrees apart; with ``shells >= 2`` a bridging O beyond
each Si; the spectrum on row 0 only, encoding CN and the mean Si-exO-Si
angle.
"""

from __future__ import annotations

import os
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


def synthetic_molecule_dataset(seed: int, num_graphs: int, n_max: int,
                               atom_type_size: int = 5,
                               spectrum_size: int = 200) -> list:
    """Multi-species clusters of 3 to ``min(n_max, 9)`` atoms, the
    ``atom_type_size=5`` smoke path: species one-hot over ``atom_type_size``
    classes, node 0 at the origin, bond lengths keyed to the species index,
    directions pairwise at least 40 degrees apart."""
    rng = np.random.default_rng(seed)
    out = []
    for g in range(num_graphs):
        n = int(rng.integers(3, min(n_max, 9) + 1))
        types = rng.integers(0, atom_type_size, n)
        dirs = _random_unit_vectors(rng, n - 1, min_angle_deg=40.0)
        pos = [np.zeros(3)]
        for i in range(n - 1):
            r = 1.0 + 0.15 * types[i + 1] + rng.normal(0, 0.03)
            pos.append(dirs[i] * r)
        pos = np.asarray(pos, np.float32)
        species = np.eye(atom_type_size, dtype=np.float32)[types]
        spectrum = np.zeros((n, spectrum_size), np.float32)
        spectrum[0] = synthetic_spectrum(int(types.sum() % 3 + 2), rng,
                                         spectrum_size)
        exo = np.zeros((n, 1), np.float32)
        exo[0, 0] = 1.0
        out.append({"pos": pos, "species": species, "spectrum": spectrum,
                    "exo": exo, "id": f"mol_{seed}_{g}"})
    return out


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


def amorphous_network_cell(seed: int, num_atoms: int,
                           spectrum_size: int = 200,
                           bond_length: float = 1.61,
                           si_o_si_deg: float = 147.0,
                           jitter: float = 0.12) -> dict:
    """A continuous-random-network SiO2 cluster of ``num_atoms`` atoms:
    a beta-cristobalite (diamond) Si sublattice sized so that Si-O is
    ``bond_length`` and Si-O-Si ``si_o_si_deg``, every bridging O moved off
    its Si-Si axis by a random azimuth, Gaussian ``jitter`` on every site, a
    random rotation, and the ball of sites nearest an O near the centre,
    which becomes the exO at the origin (atom 0). CN(Si) = 4, CN(O) = 2,
    silica's number density; the exO spectrum encodes CN 2 and the exO's
    own Si-O-Si angle.

    The draws, in order: the azimuths (``normal`` of the bonds' shape), the
    jitter, the 3x3 rotation, the spectrum. The bonds come from
    ``cKDTree.query_pairs`` as an array and the ball from a stable argsort,
    as the JAX package has them: another order of either gives other
    cells."""
    rng = np.random.default_rng(seed)
    theta = np.radians(si_o_si_deg)
    d_sisi = 2.0 * bond_length * np.sin(theta / 2.0)
    a = 4.0 * d_sisi / np.sqrt(3.0)
    delta = bond_length * np.cos(theta / 2.0)   # O off-axis displacement
    density = 24.0 / a**3   # atoms per A^3 (24 a cubic cell)
    radius = (num_atoms / density * 3.0 / (4.0 * np.pi)) ** (1.0 / 3.0)
    ncell = int(np.ceil((radius + a) / a))

    fcc = np.array([[0, 0, 0], [0, .5, .5], [.5, 0, .5], [.5, .5, 0]])
    basis = np.concatenate([fcc, fcc + 0.25])
    cells = np.arange(-ncell, ncell + 1)
    grid = np.stack(np.meshgrid(cells, cells, cells,
                                indexing="ij"), -1).reshape(-1, 3)
    si = ((grid[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a
          ).astype(np.float64)
    si = si[np.linalg.norm(si, axis=-1) < radius + a]

    from scipy.spatial import cKDTree
    pairs = cKDTree(si).query_pairs(d_sisi * 1.05, output_type="ndarray")

    mid = 0.5 * (si[pairs[:, 0]] + si[pairs[:, 1]])
    axis = si[pairs[:, 1]] - si[pairs[:, 0]]
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    rand = rng.normal(size=axis.shape)
    perp = rand - np.sum(rand * axis, axis=-1, keepdims=True) * axis
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    ox = mid + delta * perp

    pos = np.concatenate([si, ox])
    is_o = np.zeros(len(pos), bool)
    is_o[len(si):] = True
    pos = pos + rng.normal(0.0, jitter, pos.shape)

    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    pos = pos @ q.T

    o_idx = np.nonzero(is_o)[0]
    exo_site = o_idx[np.argmin(np.linalg.norm(pos[o_idx], axis=-1))]
    pos = pos - pos[exo_site]
    order = np.argsort(np.linalg.norm(pos, axis=-1), kind="stable")
    keep = order[:num_atoms]   # keep[0] is the exO (distance 0)
    pos_k = pos[keep].astype(np.float32)
    is_o_k = is_o[keep]

    species = np.zeros((num_atoms, 2), np.float32)
    species[is_o_k] = [1.0, 0.0]
    species[~is_o_k] = [0.0, 1.0]

    # the exO's Si-O-Si angle, from its two nearest Si
    si_k = pos_k[~is_o_k]
    nb = si_k[np.argsort(np.linalg.norm(si_k, axis=-1))[:2]]
    cosang = np.dot(nb[0], nb[1]) / (
        np.linalg.norm(nb[0]) * np.linalg.norm(nb[1]))
    angle = float(np.degrees(np.arccos(np.clip(cosang, -1.0, 1.0))))

    spectrum = np.zeros((num_atoms, spectrum_size), np.float32)
    spectrum[0] = synthetic_spectrum(2, rng, spectrum_size,
                                     mean_angle_deg=angle)
    exo_col = np.zeros((num_atoms, 1), np.float32)
    exo_col[0, 0] = 1.0
    return {"pos": pos_k, "species": species, "spectrum": spectrum,
            "exo": exo_col, "cn": 2, "id": f"network_{seed}"}


def cached_cell(maker, cache_dir: str, **kw) -> dict:
    """``maker(**kw)``, memoised in ``cache_dir`` as one ``.npz`` per cell,
    named by the maker's name and its sorted keyword arguments (the JAX
    package's key and payload, so either package reads the other's
    entries). A write goes to a temporary file renamed into place, so an
    interrupted run leaves no partial entry."""
    key = "_".join([maker.__name__] + [f"{k}={kw[k]}" for k in sorted(kw)])
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        z = np.load(path, allow_pickle=False)
        out = {k: z[k] for k in z.files}
        out["id"] = str(out["id"])
        out["cn"] = int(out["cn"])
        return out
    g = maker(**kw)
    os.makedirs(cache_dir, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **g)
    os.replace(tmp, path)
    return g
