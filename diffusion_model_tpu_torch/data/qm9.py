"""QM9 (GDB-9) raw ``.xyz`` ingestion — the public-data smoke path.

The reference smoke-tests its model/pipeline on PyG's QM9 dataset
(ref main.py:43,90-95,145-152): ``atom_type_size`` widens to 5 and a
seeded 10k random subset is drawn; per-node features keep only the
H/C/N/O/F one-hot (``data.x[:, :5]``, ref main.py:151). torch_geometric
is not available in this stack, so this module parses the *raw* GDB-9
extended-xyz files (Ramakrishnan et al., Scientific Data 2014 — the same
files PyG's QM9 class processes) directly into the framework's graph
schema. Format per file::

    line 1          na  (atom count)
    line 2          "gdb <index>" + 15 scalar properties
    lines 3..na+2   element  x  y  z  mulliken_charge
    line na+3       harmonic vibrational frequencies
    line na+4       SMILES (GDB9, relaxed)
    line na+5       InChI

Floats may carry Mathematica-style ``*^`` exponents (a known QM9 wart,
e.g. ``1.6991*^-6``).

QM9 molecules have no EELS spectrum and no excited atom, so graphs are
emitted with zero spectra and zero exO flags; runs on them use
``conditional=False, give_exO=False`` (the reference's QM9 branch only
ever ran unconditionally — its ``Data`` objects carry no ``spectrum`` /
``exO`` attributes for the conditioning code to read).

The port's own copy of ``diffusion_model_tpu/data/qm9.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# PyG's QM9 one-hot column order for data.x[:, :5] (ref main.py:151).
QM9_SPECIES: Sequence[str] = ("H", "C", "N", "O", "F")

QM9_PROPERTY_NAMES: Sequence[str] = (
    "A", "B", "C", "mu", "alpha", "homo", "lumo", "gap", "r2", "zpve",
    "U0", "U", "H", "G", "Cv",
)


def _qm9_float(tok: str) -> float:
    """Parse a QM9 float, accepting ``*^`` Fortran/Mathematica exponents."""
    return float(tok.replace("*^", "e"))


def read_qm9_xyz(path: str, spectrum_size: int = 200) -> dict:
    """Parse one GDB-9 .xyz file into a framework graph dict.

    Returns the usual keys (``pos``, ``species`` one-hot over
    :data:`QM9_SPECIES`, zero ``spectrum``/``exo``, ``id``) plus
    ``properties`` — the 15 scalar targets keyed by
    :data:`QM9_PROPERTY_NAMES`.
    """
    with open(path) as f:
        lines = f.read().splitlines()
    if len(lines) < 3:
        raise ValueError(f"{path}: not a QM9 xyz file (too short)")
    na = int(lines[0].strip())
    header = lines[1].split()
    if len(header) < 2 + len(QM9_PROPERTY_NAMES):
        raise ValueError(f"{path}: QM9 property line has {len(header)} "
                         f"fields, expected >= {2 + len(QM9_PROPERTY_NAMES)}")
    mol_id = f"{header[0]}_{header[1]}"
    props = {name: _qm9_float(tok)
             for name, tok in zip(QM9_PROPERTY_NAMES, header[2:])}

    if len(lines) < 2 + na:
        raise ValueError(f"{path}: declares {na} atoms but has "
                         f"{len(lines) - 2} body lines")
    species = np.zeros((na, len(QM9_SPECIES)), np.float32)
    pos = np.zeros((na, 3), np.float32)
    for i, line in enumerate(lines[2:2 + na]):
        toks = line.split()
        elem = toks[0]
        if elem not in QM9_SPECIES:
            raise ValueError(f"{path}: unexpected element {elem!r}")
        species[i, QM9_SPECIES.index(elem)] = 1.0
        pos[i] = [_qm9_float(t) for t in toks[1:4]]

    return {
        "pos": pos,
        "species": species,
        "spectrum": np.zeros((na, spectrum_size), np.float32),
        "exo": np.zeros((na, 1), np.float32),
        "id": mol_id,
        "properties": props,
    }


def load_qm9_dataset(path: str, spectrum_size: int = 200,
                     limit: Optional[int] = None,
                     seed: int = 2024) -> list[dict]:
    """Load a directory of GDB-9 .xyz files (or one file) as graph dicts.

    ``limit`` draws a seeded random subset, mirroring the reference's
    ``random_split(dataset, [10000, ...])`` smoke subset
    (ref main.py:146-148); without it, files load in sorted order.
    """
    if os.path.isfile(path):
        files = [path]
    else:
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.endswith(".xyz")
        )
    if not files:
        raise FileNotFoundError(f"no .xyz files under {path}")
    if limit is not None and limit < len(files):
        keep = np.random.default_rng(seed).permutation(len(files))[:limit]
        files = [files[i] for i in sorted(keep)]
    return [read_qm9_xyz(f, spectrum_size) for f in files]
