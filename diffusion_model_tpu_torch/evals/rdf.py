"""RDF comparison of original and generated structure lists.

The curves are computed on the given device, batched over the structures
(``ops.rdf``); the four similarity metrics (cosine, euclidean, MSE,
Wasserstein) per pair on the host in float64, Wasserstein by scipy, as
``diffusion_model_tpu.evals.rdf`` does.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import wasserstein_distance

from diffusion_model_tpu_torch.ops.rdf import rdf_from_exo


def rdf_metrics(rdf_a: np.ndarray, rdf_b: np.ndarray) -> dict:
    """Cosine, euclidean, MSE and Wasserstein of two curves (float64); the
    cosine of an all-zero curve (no atom within r_max of exO) is 0."""
    a = np.asarray(rdf_a, np.float64)
    b = np.asarray(rdf_b, np.float64)
    denom = np.linalg.norm(a) * np.linalg.norm(b)
    return {
        "cos": float(np.dot(a, b) / denom) if denom > 0 else 0.0,
        "euclidean": float(np.linalg.norm(a - b)),
        "mse": float(np.mean((a - b) ** 2)),
        "wasserstein": float(wasserstein_distance(a, b)),
    }


def evaluate_rdf_lists(original_pos, original_mask, generated_pos,
                       generated_mask, sigma: float = 5.0, r_max: float = 5.0,
                       dr: float = 0.01, device="cuda") -> list:
    """Per-pair metric dicts, each with its two curves (``rdf_original``,
    ``rdf_generated``, numpy float32).

    Args:
      original_pos / generated_pos: ``[G, N, 3]`` padded position stacks.
      original_mask / generated_mask: ``[G, N]`` masks.
      device: where the curves are computed.
    """
    def curves(pos, mask):
        pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
        mask = torch.as_tensor(np.asarray(mask, np.float32), device=device)
        return rdf_from_exo(pos, mask, sigma=sigma, r_max=r_max,
                            dr=dr).cpu().numpy()

    rdf_orig = curves(original_pos, original_mask)
    rdf_gen = curves(generated_pos, generated_mask)
    out = []
    for i in range(rdf_orig.shape[0]):
        m = rdf_metrics(rdf_orig[i], rdf_gen[i])
        m["rdf_original"] = rdf_orig[i]
        m["rdf_generated"] = rdf_gen[i]
        out.append(m)
    return out
