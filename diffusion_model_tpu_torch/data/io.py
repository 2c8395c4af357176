"""Dataset serialization: ragged graph lists <-> one .npz file.

The reference persists datasets as pickled PyG lists (``dataset.pt``,
ref make_dataset.py:143). Here a dataset is a single compressed .npz with
flat per-graph keys, loadable without torch/pickle.

The port's own copy of ``diffusion_model_tpu/data/io.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

_FIELDS = ("pos", "species", "spectrum", "exo")


def save_dataset(graphs: list, path: str) -> None:
    arrays = {"num_graphs": np.asarray(len(graphs))}
    ids = []
    for i, g in enumerate(graphs):
        for f in _FIELDS:
            arrays[f"g{i}_{f}"] = np.asarray(g[f], np.float32)
        ids.append(str(g.get("id", i)))
    arrays["ids"] = np.asarray(ids)
    np.savez_compressed(path, **arrays)


def load_dataset(path: str) -> list:
    z = np.load(path, allow_pickle=False)
    n = int(z["num_graphs"])
    ids = z["ids"]
    out = []
    for i in range(n):
        g = {f: z[f"g{i}_{f}"] for f in _FIELDS}
        g["id"] = str(ids[i])
        out.append(g)
    return out


def resize_spectra(graphs: list, size: int = 200) -> list:
    """Truncate per-node spectra to ``size`` channels
    (ref main.py:140-144, split_to_train_and_test.py:110-115)."""
    for g in graphs:
        g["spectrum"] = np.asarray(g["spectrum"])[:, :size]
    return graphs
