"""Structural quality panel of amorphous-cell generation, as
``diffusion_model_tpu/evals/amorphous.py``.

At large cells the exO-centred RDF aggregate is limited by sample noise
(the spectrum conditions only the exO's shell), so a score is read against
``exo_rdf_resampling_ceiling``: ground truth against ground truth, over
disjoint sets of cells of the evaluation's size. ``structure_panel`` adds
distribution-level metrics: the all-pairs distance Wasserstein-1, the Si-O
coordination numbers, the first-shell bond peak, the O-Si-O and Si-O-Si
angle Wasserstein-1, radial-envelope percentiles, and the envelope-matched
structureless floor of the aggregate RDF cosine and of its
envelope-subtracted form (``excess_rdf_cos``).

Inputs are the padded ``[G, N, 3]`` / ``[G, N, 2]`` / ``[G, N]`` stacks the
sampler returns. Everything but the RDF curves is the JAX module's numpy
and scipy, statement for statement (the same numbers on one numpy, and
``envelope_matched_cloud`` draws in the same order); the curves are
``ops.rdf.rdf_from_exo`` on ``device``, batched over the stack, whose bin of
a distance can move with one ulp of it, so what they feed agrees with the
JAX module to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import wasserstein_distance

from diffusion_model_tpu_torch.evals.rdf import rdf_metrics
from diffusion_model_tpu_torch.ops.rdf import rdf_from_exo


def _exo_rdf_curves(pos, mask, device, **kw) -> np.ndarray:
    """``[G, nbins]`` float32 exO-RDF curves of a padded stack, computed on
    ``device`` (``ops.rdf.rdf_from_exo``, batched)."""
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    mask = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    return rdf_from_exo(pos, mask, **kw).cpu().numpy()


# ---------------------------------------------------------------------------
# Geometry primitives
# ---------------------------------------------------------------------------

def pair_distances(pos: np.ndarray, mask: np.ndarray,
                   r_max: float | None = None) -> np.ndarray:
    """All unique pair distances of one structure's real atoms."""
    n = int(np.asarray(mask).sum())
    p = np.asarray(pos)[:n]
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    d = d[np.triu_indices(n, 1)]
    if r_max is not None:
        d = d[d <= r_max]
    return d


def _bond_lists(pos: np.ndarray, species: np.ndarray, mask: np.ndarray,
                cutoff: float):
    """Per-structure Si-O adjacency under a distance cutoff.

    Returns (is_o[n], neighbor index lists) where neighbors are
    hetero-species bonds only (Si-O), the bond definition the reference
    uses for its <2 A shell logic (ref make_dataset.py:100-107,
    evaluate_Si-O-Si.py:23-41).
    """
    n = int(np.asarray(mask).sum())
    p = np.asarray(pos)[:n]
    is_o = np.asarray(species)[:n, 0] > 0.5
    d = np.linalg.norm(p[:, None] - p[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    hetero = is_o[:, None] != is_o[None, :]
    bonded = (d < cutoff) & hetero
    return is_o, [np.nonzero(bonded[i])[0] for i in range(n)]


def coordination_stats(pos: np.ndarray, species: np.ndarray,
                       mask: np.ndarray, cutoff: float = 2.0) -> dict:
    """Mean hetero-coordination number per species (Si->O and O->Si)."""
    is_o, nbrs = _bond_lists(pos, species, mask, cutoff)
    cn = np.array([len(x) for x in nbrs], np.float64)
    return {
        "cn_si_mean": float(cn[~is_o].mean()) if (~is_o).any() else 0.0,
        "cn_o_mean": float(cn[is_o].mean()) if is_o.any() else 0.0,
    }


def bond_angle_samples(pos: np.ndarray, species: np.ndarray,
                       mask: np.ndarray, cutoff: float = 2.0):
    """O-Si-O angles (vertex Si) and Si-O-Si angles (vertex O), degrees."""
    n = int(np.asarray(mask).sum())
    p = np.asarray(pos)[:n]
    is_o, nbrs = _bond_lists(pos, species, mask, cutoff)
    osio, siosi = [], []
    for i in range(n):
        nb = nbrs[i]
        if len(nb) < 2:
            continue
        sink = osio if not is_o[i] else siosi
        for a in range(len(nb)):
            for b in range(a + 1, len(nb)):
                u = p[nb[a]] - p[i]
                v = p[nb[b]] - p[i]
                c = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
                sink.append(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))
    return np.asarray(osio, np.float64), np.asarray(siosi, np.float64)


def radial_envelope(pos: np.ndarray, mask: np.ndarray,
                    percentiles=(25, 50, 75, 95)) -> dict:
    """Percentiles of |x - CoM| pooled over a structure stack."""
    rows = []
    for p_, m_ in zip(np.asarray(pos), np.asarray(mask)):
        n = int(m_.sum())
        p = p_[:n]
        rows.append(np.linalg.norm(p - p.mean(0), axis=-1))
    r = np.concatenate(rows)
    return {f"p{q}": round(float(np.percentile(r, q)), 3)
            for q in percentiles}


def envelope_matched_cloud(pos: np.ndarray, mask: np.ndarray,
                           rng: np.random.Generator) -> np.ndarray:
    """Structureless control: radii resampled from the STACK-POOLED
    radial distribution (smooth quantile interpolation), directions
    uniform. Scores the 'right envelope, zero order' floor.

    Radii must be RESAMPLED, not reused per atom: the exO sits at ~the
    CoM, so a cloud that keeps each atom's exact |x - CoM| keeps each
    exO-atom distance exactly — random directions alone are a no-op for
    the exO-centred RDF and the 'structureless' floor silently inherits
    the full fine structure (measured round 3: raw floor 0.9917 at 512
    atoms, ABOVE the 0.9364 resampling ceiling). Pooled-quantile
    resampling preserves the aggregate envelope but no per-cell order.
    """
    out = np.array(pos, np.float32, copy=True)
    pos_a, mask_a = np.asarray(pos), np.asarray(mask)
    pooled = np.sort(np.concatenate([
        np.linalg.norm(p_[: int(m_.sum())]
                       - p_[: int(m_.sum())].mean(0), axis=-1)
        for p_, m_ in zip(pos_a, mask_a)
    ]))
    q_grid = np.linspace(0.0, 1.0, len(pooled))
    for g, (p_, m_) in enumerate(zip(pos_a, mask_a)):
        n = int(m_.sum())
        c = p_[:n].mean(0)
        r = np.interp(rng.uniform(size=n), q_grid, pooled)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        out[g, :n] = c + d * r[:, None]
    return out


def aggregate_exo_rdf(pos: np.ndarray, mask: np.ndarray,
                      sigma: float = 5.0, r_max: float = 5.0,
                      dr: float = 0.01, device="cuda") -> np.ndarray:
    """Mean exO-RDF over a structure stack (the reference aggregate); the
    curves on ``device``, their mean in numpy."""
    return np.mean(_exo_rdf_curves(pos, mask, device, sigma=sigma,
                                   r_max=r_max, dr=dr), axis=0)


def _highpass(v: np.ndarray, sigma_bins: float) -> np.ndarray:
    """Subtract a wide-Gaussian-smoothed copy: keeps structure peaks
    (width ~0.1 A), removes the smooth envelope (scale ~2-5 A)."""
    half = int(4 * sigma_bins)
    k = np.exp(-0.5 * (np.arange(-half, half + 1) / sigma_bins) ** 2)
    k /= k.sum()
    padded = np.pad(v, half, mode="reflect")
    return v - np.convolve(padded, k, mode="valid")


def excess_rdf_cos(pos_a, mask_a, pos_b, mask_b, seed: int = 0,
                   bg_sigma_angstrom: float = 0.5, sigma: float = 5.0,
                   r_max: float = 5.0, dr: float = 0.01,
                   agg_a: np.ndarray = None,
                   agg_b: np.ndarray = None, device="cuda") -> float:
    """Cosine of the envelope-SUBTRACTED aggregate exO-RDFs of two stacks.

    For large dense cells the raw exO-RDF is dominated by the smooth
    radial-envelope background (~r^2 growth of the shell population): an
    envelope-matched structureless cloud scores raw cosine > 0.99 at 512
    atoms — ABOVE the ground-truth resampling ceiling — so the raw score
    stops discriminating order from envelope (measured round 3,
    docs/quality/size512net_eval.json). Each aggregate is therefore
    high-passed (minus its own ``bg_sigma_angstrom``-wide-Gaussian
    smoothing — deterministic, unlike a Monte-Carlo cloud background)
    before the cosine: a structureless generator scores ~0, ground truth
    vs ground truth defines the ceiling under the same subtraction.
    ``seed`` is accepted for API stability; the readout is deterministic.
    ``agg_a``/``agg_b``: optional precomputed ``aggregate_exo_rdf`` curves
    — the O(G*N^2) aggregation dominates panel cost, so callers that
    already hold the curves pass them instead of recomputing.
    """
    del seed
    kw = dict(sigma=sigma, r_max=r_max, dr=dr, device=device)
    sb = bg_sigma_angstrom / dr
    if agg_a is None:
        agg_a = aggregate_exo_rdf(pos_a, mask_a, **kw)
    if agg_b is None:
        agg_b = aggregate_exo_rdf(pos_b, mask_b, **kw)
    a = _highpass(agg_a, sb)
    b = _highpass(agg_b, sb)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return float(np.dot(a, b) / max(denom, 1e-12))


# ---------------------------------------------------------------------------
# The panel
# ---------------------------------------------------------------------------

def structure_panel(original_pos, original_species, generated_pos,
                    generated_species, mask, cutoff: float = 2.0,
                    r_max_pairs: float = 6.0, seed: int = 0,
                    device="cuda") -> dict:
    """Distribution-level structural comparison of two structure stacks.

    Every entry compares generated against original over the SAME mask
    stack (the samplers keep the condition's mask). Returns a flat dict
    of rounded floats, ready for a JSON summary.
    """
    rng = np.random.default_rng(seed)
    o_pos = np.asarray(original_pos)
    g_pos = np.asarray(generated_pos)
    m = np.asarray(mask)

    panel: dict = {}

    # Reference aggregate exO-RDF cosine, bracketed by its structureless
    # floor (envelope-matched cloud vs original).
    rdf_o = aggregate_exo_rdf(o_pos, m, device=device)
    rdf_g = aggregate_exo_rdf(g_pos, m, device=device)
    panel["aggregate_rdf_cos"] = round(
        float(rdf_metrics(rdf_o, rdf_g)["cos"]), 4)
    cloud = envelope_matched_cloud(o_pos, m, rng)
    rdf_cloud = aggregate_exo_rdf(cloud, m, device=device)
    panel["aggregate_rdf_cos_structureless_floor"] = round(
        float(rdf_metrics(rdf_o, rdf_cloud)["cos"]), 4)

    # Envelope-subtracted readout: discriminative where the raw cosine
    # saturates on the smooth background (see excess_rdf_cos). Bracket:
    # a structureless generator scores ~0, the resampling ceiling under
    # the same subtraction is exo_rdf_resampling_ceiling()["excess_mean"].
    # The already-computed aggregates are passed through — the O(G*N^2)
    # aggregation dominates panel cost and was being paid 2-3x.
    panel["excess_rdf_cos"] = round(
        excess_rdf_cos(o_pos, m, g_pos, m, agg_a=rdf_o, agg_b=rdf_g), 4)
    panel["excess_rdf_cos_structureless_floor"] = round(
        excess_rdf_cos(o_pos, m, cloud, m, agg_a=rdf_o, agg_b=rdf_cloud),
        4)

    # All-pairs distance distribution W1 (A). Scale- and order-sensitive,
    # monotone in corruption; pooled over the stack.
    d_o = np.concatenate([pair_distances(p_, m_, r_max_pairs)
                          for p_, m_ in zip(o_pos, m)])
    d_g = np.concatenate([pair_distances(p_, m_, r_max_pairs)
                          for p_, m_ in zip(g_pos, m)])
    panel["pair_dist_w1"] = round(
        float(wasserstein_distance(d_o, d_g)), 4)

    # Coordination numbers (hetero bonds < cutoff).
    cn_o = [coordination_stats(p_, s_, m_, cutoff)
            for p_, s_, m_ in zip(o_pos, np.asarray(original_species), m)]
    cn_g = [coordination_stats(p_, s_, m_, cutoff)
            for p_, s_, m_ in zip(g_pos, np.asarray(generated_species), m)]
    for k in ("cn_si_mean", "cn_o_mean"):
        panel[f"{k}_original"] = round(
            float(np.mean([c[k] for c in cn_o])), 3)
        panel[f"{k}_generated"] = round(
            float(np.mean([c[k] for c in cn_g])), 3)

    # First-shell Si-O bond peak. The diagnosed large-cell failure mode is
    # a CENTRED but broader peak (docs/quality/size512net_per_t_profile
    # .json: generated ~2x the ground-truth width), which the W1/CN
    # numbers above only reflect indirectly — track mean and width
    # explicitly so sampling-temperature / training-arm sweeps read off
    # one number. Bonds = hetero pairs under a slightly loose 2.2 A
    # cutoff (loose so a broadened peak is measured, not clipped).
    def _bond_lengths(pos, species, msk, cut=2.2):
        n = int(msk.sum())
        p = pos[:n]
        is_o = species[:n, 0] > 0.5
        if is_o.all() or (~is_o).all():
            return np.zeros((0,))
        d = np.linalg.norm(p[is_o][:, None] - p[~is_o][None], axis=-1)
        return d[d < cut]

    b_o = np.concatenate([
        _bond_lengths(p_, s_, m_)
        for p_, s_, m_ in zip(o_pos, np.asarray(original_species), m)])
    b_g = np.concatenate([
        _bond_lengths(p_, s_, m_)
        for p_, s_, m_ in zip(g_pos, np.asarray(generated_species), m)])
    if len(b_o) and len(b_g):
        # robust centre/width (median, half the 16-84 percentile span) so
        # the sparse 1.9-2.2 A tail doesn't drown the peak statistics
        def centre_width(b):
            p16, p50, p84 = np.percentile(b, (16, 50, 84))
            return float(p50), float((p84 - p16) / 2)

        c_o, w_o = centre_width(b_o)
        c_g, w_g = centre_width(b_g)
        panel["bond_peak_center_original"] = round(c_o, 4)
        panel["bond_peak_center_generated"] = round(c_g, 4)
        panel["bond_peak_width_original"] = round(w_o, 4)
        panel["bond_peak_width_generated"] = round(w_g, 4)

    # Bond-angle distributions.
    ang_o = [bond_angle_samples(p_, s_, m_, cutoff)
             for p_, s_, m_ in zip(o_pos, np.asarray(original_species), m)]
    ang_g = [bond_angle_samples(p_, s_, m_, cutoff)
             for p_, s_, m_ in zip(g_pos, np.asarray(generated_species), m)]
    for idx, name in ((0, "osio"), (1, "siosi")):
        a_o, a_g = (np.concatenate([a[idx] for a in ang]) if ang
                    else np.array([]) for ang in (ang_o, ang_g))
        if len(a_o) and len(a_g):
            panel[f"angle_{name}_w1_deg"] = round(
                float(wasserstein_distance(a_o, a_g)), 2)
            panel[f"angle_{name}_mean_original"] = round(float(a_o.mean()), 1)
            panel[f"angle_{name}_mean_generated"] = round(float(a_g.mean()), 1)

    # Radial envelope + global scale.
    env_o = radial_envelope(o_pos, m)
    env_g = radial_envelope(g_pos, m)
    panel["radius_profile_original"] = env_o
    panel["radius_profile_generated"] = env_g
    panel["envelope_scale_ratio_p50"] = round(
        env_g["p50"] / max(env_o["p50"], 1e-9), 4)
    panel["envelope_scale_ratio_p95"] = round(
        env_g["p95"] / max(env_o["p95"], 1e-9), 4)
    return panel


# ---------------------------------------------------------------------------
# The protocol ceiling
# ---------------------------------------------------------------------------

def exo_rdf_resampling_ceiling(cell_fn, num_cells: int, pairs: int = 4,
                               seed: int = 0, sigma: float = 5.0,
                               r_max: float = 5.0, dr: float = 0.01,
                               device="cuda") -> dict:
    """Ground-truth-vs-ground-truth ceiling of the aggregate exO-RDF cosine.

    ``cell_fn(seed) -> dict`` draws one ground-truth cell (e.g. a
    ``data.synthetic`` generator with ``num_atoms`` bound). For each of
    ``pairs`` disjoint seed blocks, two independent ``num_cells``-sized
    sets are aggregated and scored against each other — the expected
    score of a PERFECT generator that matches the data distribution but
    (like the model, whose spectrum conditions only the exO shell)
    cannot reproduce the specific far-field of each evaluation cell.

    Returns mean/sd/min over the pair splits for the raw cosine plus
    ``excess_mean``/``excess_sd`` under the envelope-subtracted protocol
    (see ``excess_rdf_cos``). Compare a model's aggregate_rdf_cos /
    excess_rdf_cos against these — not against 1.0.
    """
    scores, excess_scores = [], []
    for p in range(pairs):
        base = seed + 2 * p * num_cells + 100_000 * (p + 1)
        def block(b0):
            pos, msk = [], []
            for i in range(num_cells):
                c = cell_fn(b0 + i)
                pos.append(np.asarray(c["pos"]))
                msk.append(np.ones(len(c["pos"]), np.float32))
            # cells may differ in atom count: pad to a common n
            n = max(len(x) for x in pos)
            pp = np.zeros((num_cells, n, 3), np.float32)
            mm = np.zeros((num_cells, n), np.float32)
            for i, (x, m_) in enumerate(zip(pos, msk)):
                pp[i, : len(x)] = x
                mm[i, : len(m_)] = m_
            return pp, mm
        pa, ma = block(base)
        pb, mb = block(base + num_cells)
        kw = dict(sigma=sigma, r_max=r_max, dr=dr, device=device)
        a = aggregate_exo_rdf(pa, ma, **kw)
        b = aggregate_exo_rdf(pb, mb, **kw)
        scores.append(float(rdf_metrics(a, b)["cos"]))
        excess_scores.append(
            excess_rdf_cos(pa, ma, pb, mb, seed=base, dr=dr, agg_a=a,
                           agg_b=b))
    return {
        "mean": round(float(np.mean(scores)), 4),
        "sd": round(float(np.std(scores)), 4),
        "min": round(float(np.min(scores)), 4),
        "excess_mean": round(float(np.mean(excess_scores)), 4),
        "excess_sd": round(float(np.std(excess_scores)), 4),
        "pairs": pairs,
        "num_cells": num_cells,
    }
