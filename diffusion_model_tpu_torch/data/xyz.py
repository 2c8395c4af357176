"""xyz structure I/O, as ``diffusion_model_tpu/data/xyz.py`` (numpy,
statement for statement):

  * single-structure write and read,
  * the original and the generated structure overlaid in one file, the
    original's species written as Al/F in place of Si/O so viewers colour
    the two apart,
  * per-sample original/generated pair directories,
  * multi-frame trajectories.
"""

from __future__ import annotations

import os

import numpy as np

O_ONEHOT = (1.0, 0.0)
SI_ONEHOT = (0.0, 1.0)


def species_symbol(onehot, si_sym: str = "Si", o_sym: str = "O") -> str:
    arr = np.asarray(onehot)
    return si_sym if int(np.argmax(arr)) == 1 else o_sym


def write_xyz(path: str, pos: np.ndarray, species: np.ndarray,
              comment: str = "") -> None:
    pos = np.asarray(pos)
    with open(path, "w") as f:
        f.write(f"{pos.shape[0]}\n{comment}\n")
        for i in range(pos.shape[0]):
            sym = species_symbol(species[i])
            f.write(f"{sym} {pos[i][0]} {pos[i][1]} {pos[i][2]}\n")


def write_xyz_overlay(path: str, original_pos, original_species,
                      generated_pos, generated_species,
                      comment: str = "") -> None:
    """Both structures in one file; the original uses Al/F standing in for
    Si/O so viewers render the pair distinguishably."""
    original_pos = np.asarray(original_pos)
    generated_pos = np.asarray(generated_pos)
    n = original_pos.shape[0] + generated_pos.shape[0]
    with open(path, "w") as f:
        f.write(f"{n}\n{comment}\n")
        for i in range(original_pos.shape[0]):
            sym = species_symbol(original_species[i], si_sym="Al", o_sym="F")
            p = original_pos[i]
            f.write(f"{sym} {p[0]} {p[1]} {p[2]}\n")
        for i in range(generated_pos.shape[0]):
            sym = species_symbol(generated_species[i])
            p = generated_pos[i]
            f.write(f"{sym} {p[0]} {p[1]} {p[2]}\n")


def write_xyz_pair_dir(save_dir: str, sample_id: str,
                       original_pos, original_species,
                       generated_pos, generated_species,
                       comment: str = "") -> str:
    """original.xyz / generated.xyz under ``save_dir/sample_id``."""
    out = os.path.join(save_dir, sample_id)
    os.makedirs(out, exist_ok=True)
    write_xyz(os.path.join(out, "original.xyz"), original_pos,
              original_species, comment)
    write_xyz(os.path.join(out, "generated.xyz"), generated_pos,
              generated_species, comment)
    return out


def write_xyz_trajectory(path: str, traj_pos: np.ndarray,
                         species: np.ndarray, comment: str = "") -> None:
    """Multi-frame xyz movie of a reverse-diffusion trajectory.

    traj_pos: ``[frames, N, 3]``; species: ``[N, A]``.
    """
    traj_pos = np.asarray(traj_pos)
    with open(path, "w") as f:
        for frame in range(traj_pos.shape[0]):
            f.write(f"{traj_pos.shape[1]}\n{comment} frame {frame}\n")
            for i in range(traj_pos.shape[1]):
                sym = species_symbol(species[i])
                p = traj_pos[frame, i]
                f.write(f"{sym} {p[0]} {p[1]} {p[2]}\n")


_SYMBOL_TO_ONEHOT = {
    "O": O_ONEHOT, "F": O_ONEHOT,
    "Si": SI_ONEHOT, "Al": SI_ONEHOT,
}


def read_xyz(path: str):
    """Read an xyz file -> (pos [N,3] float32, species one-hot [N,2],
    symbols list)."""
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[0].strip())
    pos, onehot, symbols = [], [], []
    for line in lines[2 : 2 + n]:
        parts = line.split()
        symbols.append(parts[0])
        onehot.append(_SYMBOL_TO_ONEHOT.get(parts[0], O_ONEHOT))
        pos.append([float(x) for x in parts[1:4]])
    return (np.asarray(pos, np.float32), np.asarray(onehot, np.float32),
            symbols)
