"""Neighbour-shell dataset builder (2NN/3NN/4NN local environments).

Rebuild of ``make_dataset.py`` (ref make_dataset.py:60-308, whose 3NN/4NN
branches are near-duplicates of the 2NN one — here a single parameterised
routine): starting from the excited oxygen in a 3x3x3 supercell, BFS over
successive <2.0 A bonded shells, put exO at index 0, one-hot species
(O=[1,0], Si=[0,1], exO counted as O), positions relative to exO, per-node
spectrum tensor with row 0 carrying the real curve, exO indicator column.
Output graphs use the framework's dict schema consumed by
``data.batch.collate``.

The port's own copy of ``diffusion_model_tpu/data/shells.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from diffusion_model_tpu_torch.data.cell import (
    CellStructure,
    distance_matrix,
    read_castep_cell,
    supercell_333,
)
from diffusion_model_tpu_torch.data.spectra import fitted_intensity

BOND_CUTOFF = 2.0  # Angstrom (ref make_dataset.py return_index_within_2ang)

SPECIES_ONEHOT = {"O": [1.0, 0.0], "Si": [0.0, 1.0]}


def indices_within_cutoff(dist: np.ndarray, center: int,
                          cutoff: float = BOND_CUTOFF) -> list:
    """Neighbours of ``center`` strictly within ``cutoff`` (excluding self)."""
    idx = np.nonzero((dist[center] < cutoff) & (dist[center] > 0))[0]
    return idx.tolist()


def shell_indices(dist: np.ndarray, exo_index: int, n_shells: int,
                  cutoff: float = BOND_CUTOFF) -> list:
    """BFS over ``n_shells`` bonded shells from exO; exO first.

    n_shells=2 reproduces the reference's '2NN' range (exO's neighbours and
    their neighbours, ref make_dataset.py:100-107), etc.
    """
    frontier = [exo_index]
    collected: list[int] = []
    for _ in range(n_shells):
        nxt: list[int] = []
        for c in frontier:
            nxt += indices_within_cutoff(dist, c, cutoff)
        frontier = [i for i in set(nxt) if i not in collected and i != exo_index]
        collected += frontier
    collected = sorted(set(collected) - {exo_index})
    return [exo_index] + collected


def graph_from_structure(struct: CellStructure, indices: list,
                         spectrum: np.ndarray, graph_id: str) -> dict:
    """Graph dict with exO-origin coordinates and the reference schema."""
    cart = struct.cart_coords
    exo = indices[0]
    pos = np.stack([cart[i] - cart[exo] for i in indices]).astype(np.float32)
    species = np.stack(
        [SPECIES_ONEHOT[struct.species[i]] for i in indices]
    ).astype(np.float32)
    n = len(indices)
    spec = np.zeros((n, spectrum.shape[0]), np.float32)
    spec[0] = spectrum
    exo_col = np.zeros((n, 1), np.float32)
    exo_col[0, 0] = 1.0
    return {
        "pos": pos,
        "species": species,
        "spectrum": spec,
        "exo": exo_col,
        "id": graph_id,
    }


RANGE_TO_SHELLS = {"1NN": 1, "2NN": 2, "3NN": 3, "4NN": 4}


def _graph_from_native(base: CellStructure, pos: np.ndarray,
                       src: np.ndarray, spectrum: np.ndarray,
                       graph_id: str) -> dict:
    species = np.stack(
        [SPECIES_ONEHOT[base.species[i]] for i in src]
    ).astype(np.float32)
    n = pos.shape[0]
    spec = np.zeros((n, spectrum.shape[0]), np.float32)
    spec[0] = spectrum
    exo_col = np.zeros((n, 1), np.float32)
    exo_col[0, 0] = 1.0
    return {
        "pos": pos.astype(np.float32),
        "species": species,
        "spectrum": spec,
        "exo": exo_col,
        "id": graph_id,
    }


def build_graph(struct_base: CellStructure, n_shells: int,
                spectrum: np.ndarray, graph_id: str,
                use_native: bool | None = None,
                cutoff: float = BOND_CUTOFF) -> dict:
    """Shell extraction for one structure; native C++ path when available
    (data/native.py), numpy otherwise — identical selection and ordering."""
    from diffusion_model_tpu_torch.data import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        pos, src = native.build_shells_native(
            struct_base.lattice, struct_base.frac_coords,
            struct_base.exo_index, n_shells, cutoff,
        )
        return _graph_from_native(struct_base, pos, src, spectrum, graph_id)
    struct = supercell_333(struct_base)
    dist = distance_matrix(struct)
    indices = shell_indices(dist, struct.exo_index, n_shells, cutoff)
    return graph_from_structure(struct, indices, spectrum, graph_id)


def build_dataset(cell_dir: str, nn_range: str = "2NN",
                  cell_name: str = "coreloss.cell",
                  edge_name: str = "coreloss_core_edge.dat",
                  use_native: bool | None = None) -> list:
    """Walk sample directories and build the shell dataset
    (ref make_dataset.py:60-143)."""
    if nn_range not in RANGE_TO_SHELLS:
        raise ValueError(f"range must be one of {list(RANGE_TO_SHELLS)}")
    n_shells = RANGE_TO_SHELLS[nn_range]
    dataset = []
    for d in sorted(os.listdir(cell_dir)):
        cell_path = os.path.join(cell_dir, d, cell_name)
        edge_path = os.path.join(cell_dir, d, edge_name)
        if not os.path.isfile(cell_path):
            continue
        base = read_castep_cell(cell_path)
        spectrum = fitted_intensity(edge_path).astype(np.float32)
        dataset.append(
            build_graph(base, n_shells, spectrum, d, use_native=use_native)
        )
    return dataset
