"""CN2 (two-coordinated oxygen) angle and bond-length evaluation.

``cn2_statistics`` computes on a device (``ops.angles``); the rest is
numpy, the same statements as ``diffusion_model_tpu.evals.cn2``, so the same
inputs give the same bits:

  * per-condition group means over the ``group`` samples of a condition;
  * the hand-rolled linear-regression R² (``r2score``);
  * the shell-agnostic CN2 readout of a generation result
    (``_cn2_sample_geometry``);
  * the amorphous Si-O-Si filter: graphs whose exO has exactly two Si
    within 2 A.
"""

from __future__ import annotations

import numpy as np
import torch

from diffusion_model_tpu_torch.ops.angles import (
    cn2_angle_deg,
    cn2_bond_lengths,
)


def cn2_statistics(pos, device="cuda") -> dict:
    """Angles and bond lengths (numpy float32) of a ``[G, >=3, 3]`` stack of
    CN2 graphs (node 0 = exO, nodes 1..2 = the two Si), on ``device``."""
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    l1, l2 = cn2_bond_lengths(pos)
    return {"angle_deg": cn2_angle_deg(pos).cpu().numpy(),
            "bond1": l1.cpu().numpy(), "bond2": l2.cpu().numpy()}


def per_graph_group_means(values: np.ndarray, group: int) -> np.ndarray:
    """Mean over consecutive groups of ``group`` samples, NaN groups
    dropped."""
    values = np.asarray(values, np.float64)
    n = (len(values) // group) * group
    means = values[:n].reshape(-1, group).mean(axis=1)
    return means[~np.isnan(means)]


def aligned_group_means(a, b, group: int, invalid=None):
    """Per-condition group means of two paired per-sample arrays. A sample
    non-finite in either array (or ``invalid``) is NaN in both, so its
    group drops from both outputs alike and the pairing holds."""
    a = np.asarray(a, np.float64).copy()
    b = np.asarray(b, np.float64).copy()
    bad = ~np.isfinite(a) | ~np.isfinite(b)
    if invalid is not None:
        bad |= np.asarray(invalid, bool)
    a[bad] = np.nan
    b[bad] = np.nan
    ga = per_graph_group_means(a, group)
    gb = per_graph_group_means(b, group)
    n = min(len(ga), len(gb))
    return ga[:n], gb[:n]


def r2score(a, b) -> float:
    """R² of the least-squares line y = slope x + intercept, residuals
    against the variance of y; NaN for empty or constant inputs."""
    x = np.asarray(a, np.float64)
    y = np.asarray(b, np.float64)
    n = len(x)
    if n == 0:
        return float("nan")
    mean_x = x.sum() / n
    t_xx = np.sum((x - mean_x) ** 2)
    t_yy = np.sum((y - y.sum() / n) ** 2)
    if t_xx == 0.0 or t_yy == 0.0:
        return float("nan")
    t_xy = np.sum((x - mean_x) * (y - y.sum() / n))
    slope = t_xy / t_xx
    intercept = y.sum() / n - slope * x.sum() / n
    resid = y - (intercept + slope * x)
    return float(1 - np.sum(resid**2) / t_yy)


def _cn2_sample_geometry(results: dict):
    """Per-sample CN2 geometry of a generation result: the original angle
    and bonds from rows 1 and 2 (where ``make_graph`` puts the Si on 1- and
    2-shell data), the generated ones from the two Si located by species
    argmax over the real rows. A sample is invalid when its condition is
    not CN2 (3 or 5 real atoms), it was rejected, or its generated
    composition is not exactly two Si, none of them row 0.

    Returns per-sample arrays ``angle_o``/``angle_g`` (degrees),
    ``bond1_o``/``bond2_o``/``bond1_g``/``bond2_g`` (A), ``invalid``.
    """
    mask = np.asarray(results["mask"])
    accepted = np.asarray(results["accepted"]).astype(bool)
    gen_pos = np.asarray(results["generated_pos"])
    gen_species = np.asarray(results["generated_species"])
    orig_pos = np.asarray(results["original_pos"])
    n_real = mask.sum(-1).astype(int)

    def angle(center, a, b):
        u, v = a - center, b - center
        c = np.dot(u, v) / max(np.linalg.norm(u) * np.linalg.norm(v),
                               1e-12)
        return np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))

    n = len(mask)
    out = {k: np.full(n, np.nan) for k in
           ("angle_o", "angle_g", "bond1_o", "bond2_o", "bond1_g",
            "bond2_g")}
    invalid = np.ones(n, bool)
    for i in range(n):
        if n_real[i] not in (3, 5) or not accepted[i]:
            continue
        k = n_real[i]
        out["angle_o"][i] = angle(orig_pos[i, 0], orig_pos[i, 1],
                                  orig_pos[i, 2])
        out["bond1_o"][i] = np.linalg.norm(orig_pos[i, 1] - orig_pos[i, 0])
        out["bond2_o"][i] = np.linalg.norm(orig_pos[i, 2] - orig_pos[i, 0])
        sp = gen_species[i, :k].argmax(-1)  # 0 = O, 1 = Si
        si_rows = np.nonzero(sp == 1)[0]
        if len(si_rows) != 2 or 0 in si_rows:
            continue
        out["angle_g"][i] = angle(gen_pos[i, 0], gen_pos[i, si_rows[0]],
                                  gen_pos[i, si_rows[1]])
        out["bond1_g"][i] = np.linalg.norm(
            gen_pos[i, si_rows[0]] - gen_pos[i, 0])
        out["bond2_g"][i] = np.linalg.norm(
            gen_pos[i, si_rows[1]] - gen_pos[i, 0])
        invalid[i] = False
    out["invalid"] = invalid
    return out


def conditional_angle_parity(results: dict, group: int, geo: dict = None):
    """Aligned per-condition group means of (original, generated)
    Si-exO-Si angles over the CN2 conditions of a generation result; pass
    ``geo`` (``_cn2_sample_geometry``) to share the per-sample readout."""
    if geo is None:
        geo = _cn2_sample_geometry(results)
    return aligned_group_means(geo["angle_o"], geo["angle_g"], group,
                               invalid=geo["invalid"])


def conditional_bond_parity(results: dict, group: int, geo: dict = None):
    """Aligned per-condition group means of the two Si-exO bond lengths,
    both bonds concatenated."""
    if geo is None:
        geo = _cn2_sample_geometry(results)
    bonds_o = np.concatenate([geo["bond1_o"], geo["bond2_o"]])
    bonds_g = np.concatenate([geo["bond1_g"], geo["bond2_g"]])
    invalid = np.concatenate([geo["invalid"], geo["invalid"]])
    return aligned_group_means(bonds_o, bonds_g, group, invalid=invalid)


def filter_si_o_si(pos: np.ndarray, species: np.ndarray, mask: np.ndarray,
                   cutoff: float = 2.0):
    """Indices of graphs whose exO (node 0) has exactly two Si neighbours
    within ``cutoff``, and the ``[G, 3, 3]`` stack (exO and its two Si)
    for ``cn2_statistics``."""
    keep, triplets = [], []
    for g in range(pos.shape[0]):
        m = mask[g] > 0
        p = pos[g][m]
        sp = species[g][m]
        d = np.linalg.norm(p[1:] - p[0], axis=-1)
        is_si = sp[1:, 1] > 0.5
        near_si = np.nonzero((d < cutoff) & is_si)[0] + 1
        if len(near_si) == 2:
            keep.append(g)
            triplets.append(np.stack([p[0], p[near_si[0]], p[near_si[1]]]))
    if not triplets:
        return [], np.zeros((0, 3, 3), np.float32)
    return keep, np.stack(triplets).astype(np.float32)
