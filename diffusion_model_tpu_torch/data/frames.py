"""Coordinate-frame alignment utilities.

Equivalents of the reference's CoM frame helpers
(ref data_preparation.py:62-124): mass-weighted centre of mass over Si/O
environments, the Rodrigues rotation aligning the exO-CoM vector with the
x-axis, and the 5-site zero-padding + flatten used by the legacy fixed-size
pipelines.

The port's own copy of ``diffusion_model_tpu/data/frames.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

ATOMIC_MASS = {"O": 16.0, "Si": 28.0855}


def center_of_mass(pos: np.ndarray, symbols: list) -> np.ndarray:
    """Mass-weighted CoM (ref data_preparation.py:62-77)."""
    masses = np.asarray([ATOMIC_MASS[s] for s in symbols])
    return (masses[:, None] * np.asarray(pos)).sum(0) / masses.sum()


def rotation_matrix_to_x(vector: np.ndarray) -> np.ndarray:
    """Rodrigues rotation aligning ``vector`` with the x-axis
    (ref data_preparation.py:79-99)."""
    v = np.asarray(vector, np.float64)
    v = v / np.linalg.norm(v)
    x_axis = np.array([1.0, 0.0, 0.0])
    if np.allclose(v, x_axis):
        return np.eye(3)
    if np.allclose(v, -x_axis):
        # 180-degree rotation about z
        return np.diag([-1.0, -1.0, 1.0])
    axis = np.cross(v, x_axis)
    axis = axis / np.linalg.norm(axis)
    angle = np.arccos(np.clip(np.dot(v, x_axis), -1.0, 1.0))
    k = np.array([
        [0, -axis[2], axis[1]],
        [axis[2], 0, -axis[0]],
        [-axis[1], axis[0], 0],
    ])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def align_exo_frame(pos: np.ndarray, symbols: list,
                    exo_index: int = 0) -> np.ndarray:
    """Rotate the environment so exO - CoM points along +x
    (ref base_convert, data_preparation.py:109-115)."""
    pos = np.asarray(pos, np.float64)
    com = center_of_mass(pos, symbols)
    rot = rotation_matrix_to_x(pos[exo_index] - com)
    return pos @ rot.T


def pad_and_flatten(pos: np.ndarray, n_sites: int = 5) -> np.ndarray:
    """Zero-pad to ``n_sites`` coordinates and flatten
    (ref padding_and_flatten, data_preparation.py:117-124)."""
    pos = np.asarray(pos, np.float64)
    out = np.zeros((n_sites, 3))
    out[: pos.shape[0]] = pos[:n_sites]
    return out.flatten()
