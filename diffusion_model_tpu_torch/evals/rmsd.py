"""RMSD evaluation of generated structures, as
``diffusion_model_tpu/evals/rmsd.py``:

- ``evaluate_by_rmsd``: batched Kabsch RMSD over the set, sorted;
- ``evaluate_by_rmsd_and_atom_type``: the same with the O densities;
- ``permutation_min_rmsd``: the least RMSD over every order of the non-exO
  atoms, for graphs of at most ``max_atoms``;
- ``hungarian_align``: Kabsch on the atoms nearest exO, then a global
  assignment (``scipy.optimize.linear_sum_assignment``), for larger graphs.

The Kabsch products run on ``device``; the sorting and the assignment on
the host.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from diffusion_model_tpu_torch.ops.kabsch import kabsch, kabsch_rmsd


def _t(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _rmsd(generated_pos, original_pos, mask, device) -> np.ndarray:
    return kabsch_rmsd(_t(generated_pos, device), _t(original_pos, device),
                       _t(mask, device)).cpu().numpy()


def evaluate_by_rmsd(original_pos, generated_pos, mask, ids=None,
                     device="cuda") -> list:
    """``[(id, rmsd), ...]`` over the structure set, ascending."""
    rmsd = _rmsd(generated_pos, original_pos, mask, device)
    ids = ids if ids is not None else list(range(len(rmsd)))
    return sorted(zip(ids, rmsd.tolist()), key=lambda x: x[1])


def evaluate_by_rmsd_and_atom_type(original_pos, original_species,
                                   generated_pos, generated_species,
                                   mask, ids=None, device="cuda") -> list:
    """``[(id, rmsd, (o_density_orig, o_density_gen)), ...]``, ascending by
    RMSD (O = one-hot [1, 0])."""
    rmsd = _rmsd(generated_pos, original_pos, mask, device)
    m = np.asarray(mask)
    o_orig = (np.asarray(original_species)[..., 0] * m).sum(-1) / m.sum(-1)
    o_gen = (np.asarray(generated_species)[..., 0] * m).sum(-1) / m.sum(-1)
    ids = ids if ids is not None else list(range(len(rmsd)))
    rows = list(zip(ids, rmsd.tolist(), zip(o_orig.tolist(), o_gen.tolist())))
    return sorted(rows, key=lambda x: x[1])


def permutation_min_rmsd(original_pos: np.ndarray, generated_pos: np.ndarray,
                         max_atoms: int = 10, device="cuda"):
    """The least RMSD over all (N-1)! orders of the non-exO atoms, positions
    taken relative to atom 0: ``(min_rmsd, best_order, aligned_generated)``,
    or None for a graph of more than ``max_atoms``."""
    n = original_pos.shape[0]
    if n > max_atoms:
        return None
    o = np.asarray(original_pos) - np.asarray(original_pos)[0]
    g = np.asarray(generated_pos) - np.asarray(generated_pos)[0]
    orders = np.asarray(
        [[0] + list(p) for p in itertools.permutations(range(1, n))],
        np.int32)
    perms_g = _t(g, device)[torch.as_tensor(orders, device=device).long()]
    o_t = _t(o, device)
    rmsds = kabsch_rmsd(perms_g, o_t.expand_as(perms_g)).cpu().numpy()
    k = int(np.argmin(rmsds))
    _, _, aligned = kabsch(perms_g[k], o_t)
    return float(rmsds[k]), orders[k].tolist(), aligned.cpu().numpy()


def _nearest_to_exo(pos: np.ndarray, k: int = 5) -> list:
    d = np.linalg.norm(pos[1:] - pos[0], axis=-1)
    return (np.argsort(d)[: k - 1] + 1).tolist()


def hungarian_align(original_pos: np.ndarray, generated_pos: np.ndarray,
                    device="cuda"):
    """Align large graphs: every order of the 4 atoms nearest exO picks the
    rotation, then a global assignment matches the atoms.

    Returns ``(rmsd, row_ind, col_ind, aligned_generated_pos)``.
    """
    o = np.asarray(original_pos) - np.asarray(original_pos)[0]
    g = np.asarray(generated_pos) - np.asarray(generated_pos)[0]
    o_near = _t(np.concatenate([[o[0]], o[_nearest_to_exo(o, 5)]]), device)
    g_near_idx = _nearest_to_exo(g, 5)
    best_rmsd, best_rot = np.inf, np.eye(3)
    for perm in itertools.permutations(range(4)):
        g_near = _t(np.concatenate([[g[0]], g[[g_near_idx[p] for p in perm]]]),
                    device)
        rot, _, _ = kabsch(g_near, o_near)
        r = float(kabsch_rmsd(g_near, o_near))
        if r < best_rmsd:
            best_rmsd, best_rot = r, rot.cpu().numpy()
    aligned_g = g @ best_rot.T
    cost = np.linalg.norm(o[:, None, :] - aligned_g[None, :, :], axis=-1)
    row_ind, col_ind = linear_sum_assignment(cost)
    final_rmsd = float(kabsch_rmsd(_t(aligned_g[col_ind], device),
                                   _t(o[row_ind], device)))
    return final_rmsd, row_ind, col_ind, aligned_g
