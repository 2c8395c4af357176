"""Legacy .npy dataset ingestion.

Equivalent of ``SetUpData.npy_to_graph`` (ref split_to_train_and_test.py:
67-96): records are ``(mp_id, spectrum, local_atom_list)`` where
``local_atom_list`` is ``[[atom_onehot, coord], ...]``; single-atom records
(CN0) are dropped, every node carries a copy of the spectrum (unlike the
shell builder's row-0-only layout), and the graph is fully connected.

The port's own copy of ``diffusion_model_tpu/data/legacy.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def npy_to_graphs(npy_data) -> list:
    """Convert the legacy record list into the framework's graph dicts."""
    out = []
    for record in npy_data:
        mp_id, spectrum, local_atoms = record[0], record[1], record[2]
        if len(local_atoms) == 1:  # CN0 graphs dropped (ref :74)
            continue
        species = np.asarray([a[0] for a in local_atoms], np.float32)
        pos = np.asarray([a[1] for a in local_atoms], np.float32)
        n = pos.shape[0]
        spec = np.tile(
            np.asarray(spectrum, np.float32)[None, :], (n, 1)
        )  # every node gets the spectrum (ref :78-80)
        exo = np.zeros((n, 1), np.float32)
        exo[0, 0] = 1.0
        out.append({
            "pos": pos,
            "species": species,
            "spectrum": spec,
            "exo": exo,
            "id": str(mp_id),
        })
    return out


def load_npy_dataset(path: str) -> list:
    data = np.load(path, allow_pickle=True)
    return npy_to_graphs(data)
