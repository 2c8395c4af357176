"""Template matching: spectrum-MSE nearest references scored by a local
structural descriptor, as ``diffusion_model_tpu/evals/template.py``
(ref template_matching.py:26-70): for each target, the best-3 reference
structures by spectrum MSE, each scored by the cosine similarity of a
rotation-invariant descriptor of the exO environment.

Two descriptors:
  * ``descriptor="soap"``: the SOAP power spectrum (``evals/soap.py``, numpy)
    with the reference's settings (r_cut=8, n_max=15, l_max=10, sigma=0.1);
  * ``descriptor="histogram"``: per species-pair Gaussian-smeared radial
    densities and a bond-angle histogram at exO (``local_descriptor``),
    float32 torch on ``device`` (the card unless the caller asks for the
    CPU), where the JAX package jits it.

The matching loop runs on the host. An angle that lies on a bin edge to
float32 rounding may fall in either neighbouring bin on another device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffusion_model_tpu_torch.ops.schedules import linspace_f32


def local_descriptor(pos: torch.Tensor, species: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     r_cut: float = 8.0, n_radial: int = 32,
                     n_angular: int = 18,
                     sigma: float = 0.3) -> torch.Tensor:
    """Rotation-invariant descriptor of the node-0 (exO) environment.

    Args:
      pos: ``[N, 3]``; species: ``[N, 2]`` one-hot (O, Si); mask: ``[N]``;
        all on one device, float32.

    Returns:
      ``[2 * n_radial + n_angular]``: the radial Gaussian-smeared densities
      per neighbour species, then the angle histogram over neighbour pairs
      within 2.5 A.
    """
    device = pos.device
    n = pos.shape[0]
    m = (torch.ones(n, device=device) if mask is None
         else mask.to(torch.float32))
    rel = pos[1:] - pos[0]
    d = torch.linalg.vector_norm(rel, dim=-1)
    valid = m[1:] * m[0] * (d < r_cut)

    centers = linspace_f32(0.0, r_cut, n_radial, device=device)
    g = torch.exp(-0.5 * ((d[:, None] - centers[None, :]) / sigma) ** 2)
    g = g * valid[:, None]
    rad_o = (g * species[1:, 0:1]).sum(dim=0)
    rad_si = (g * species[1:, 1:2]).sum(dim=0)

    near = valid * (d < 2.5)
    unit = rel / d[:, None].clamp_min(1e-9)
    # a broadcast sum: no TF32 product may touch the geometry
    cosang = (unit[:, None, :] * unit[None, :, :]).sum(dim=-1)
    pair_w = near[:, None] * near[None, :]
    pair_w = pair_w * (1.0 - torch.eye(rel.shape[0], device=device))
    ang = torch.rad2deg(torch.arccos(cosang.clamp(-1.0, 1.0)))
    edges_lo = linspace_f32(0.0, 180.0, n_angular + 1, device=device)[:-1]
    width = 180.0 / n_angular
    in_bin = ((ang[..., None] >= edges_lo)
              & (ang[..., None] < edges_lo + width))
    hist = (in_bin * pair_w[..., None]).sum(dim=(0, 1))
    return torch.cat([rad_o, rad_si, hist])


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(np.dot(a, b) / (na * nb))


def template_match(target_graphs: list, reference_graphs: list,
                   best_k: int = 3, descriptor: str = "histogram",
                   device=None) -> dict:
    """For each target graph dict, the best-k reference matches by spectrum
    MSE, each scored with descriptor cosine similarity
    (ref template_matching.py:42-68; self-matches by id excluded).

    ``descriptor``: "histogram" (``local_descriptor`` on ``device``, the
    card by default) or "soap" (``evals/soap.py`` on the host).

    Returns {target_id: [{ref_id: [mse, similarity]}, ...]}.
    """
    if descriptor == "soap":
        from diffusion_model_tpu_torch.evals.soap import soap_descriptor

        def desc_fn(pos, species):
            return soap_descriptor(np.asarray(pos), np.asarray(species))
    elif descriptor == "histogram":
        dev = torch.device("cuda" if device is None else device)

        def desc_fn(pos, species):
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            return local_descriptor(t(pos), t(species)).cpu().numpy()
    else:
        raise ValueError(f"unknown descriptor: {descriptor!r}")
    ref_desc = {g["id"]: np.asarray(desc_fn(g["pos"], g["species"]))
                for g in reference_graphs}
    results: dict = {}
    for tg in target_graphs:
        t_spec = np.asarray(tg["spectrum"][0])
        t_desc = np.asarray(desc_fn(tg["pos"], tg["species"]))
        scored = []
        for rg in reference_graphs:
            if rg["id"] == tg["id"]:
                continue
            mse = float(np.mean((t_spec - np.asarray(rg["spectrum"][0])) ** 2))
            scored.append((mse, rg["id"]))
        scored.sort(key=lambda x: x[0])
        best = []
        for mse, rid in scored[:best_k]:
            best.append({rid: [mse, _cos(t_desc, ref_desc[rid])]})
        results[tg["id"]] = best
    return results
