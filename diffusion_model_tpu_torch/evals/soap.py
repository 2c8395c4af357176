"""SOAP power-spectrum descriptor (native numpy implementation).

Replaces the dscribe dependency of the reference's template matching
(ref template_matching.py:41: ``SOAP(species=["O","Si"], r_cut=8, n_max=15,
l_max=10, sigma=0.1)`` evaluated at atom 0, scored by cosine similarity).

Implements the standard SOAP construction (Bartok et al., "On representing
chemical environments", PRB 87, 184115):

  1. The neighbour density of species Z around the centre is a sum of
     Gaussians  rho_Z(r) = sum_i exp(-|r - R_i|^2 / (2 sigma^2)).
  2. Expand in an orthonormal radial basis g_n(r) x spherical harmonics:
     c^Z_nlm = integral g_n(r) Y_lm* (r_hat) rho_Z(r) d^3r.
  3. Rotation-invariant power spectrum
     p^{Z1 Z2}_{n1 n2 l} = pi sqrt(8/(2l+1)) sum_m c^{Z1}_{n1lm} c^{Z2*}_{n2lm}.

Radial basis: dscribe's "polynomial" family phi_n(r) = (r_cut - r)^(n+2),
Loewdin-orthonormalised with the analytic overlap integral. The angular
integral of a displaced Gaussian has the closed form

  c contribution of neighbour at R = 4 pi exp(-(r^2+R^2)/(2 s^2))
                                     i_l(r R / s^2) Y_lm*(R_hat)

with i_l the modified spherical Bessel function; evaluated in the
exponentially-scaled form  exp(-(r-R)^2/(2 s^2)) * sqrt(pi/(2x)) * ive(l+1/2, x)
so sigma=0.1 at r_cut=8 (x ~ 6400) stays finite.

The port's own copy of ``diffusion_model_tpu/evals/soap.py`` (scipy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
from scipy.special import ive

try:  # scipy >= 1.15
    from scipy.special import sph_harm_y as _sph_harm_y
except ImportError:  # pragma: no cover - older scipy
    from scipy.special import sph_harm as _sph_harm_legacy

    def _sph_harm_y(l, m, theta, phi):
        return _sph_harm_legacy(m, l, phi, theta)


def _radial_basis(r_cut: float, n_max: int, r: np.ndarray) -> np.ndarray:
    """Orthonormal polynomial radial basis evaluated on grid ``r``: [n_max, Q].

    phi_n(r) = (r_cut - r)^(n+2), n = 1..n_max, with the analytic overlap
    S_nm = integral phi_n phi_m r^2 dr
         = r_cut^(n+m+7) * (1/(n+m+5) - 2/(n+m+6) + 1/(n+m+7)),
    Loewdin-orthonormalised by S^(-1/2) (eigendecomposition with clipping —
    the polynomial overlap is ill-conditioned at n_max = 15).
    """
    n_idx = np.arange(1, n_max + 1)
    phi = (r_cut - r[None, :]) ** (n_idx[:, None] + 2)      # [n, Q]
    s = n_idx[:, None] + n_idx[None, :]
    overlap = r_cut ** (s + 7.0) * (
        1.0 / (s + 5.0) - 2.0 / (s + 6.0) + 1.0 / (s + 7.0)
    )
    w, v = np.linalg.eigh(overlap)
    w = np.maximum(w, w.max() * 1e-14)
    inv_sqrt = (v / np.sqrt(w)) @ v.T
    return inv_sqrt @ phi


def _radial_integrals(dists: np.ndarray, r_cut: float, n_max: int,
                      l_max: int, sigma: float, n_quad: int) -> np.ndarray:
    """I[i, n, l] = integral g_n(r) w_l(r; R_i) r^2 dr on a uniform grid.

    w_l(r; R) = 4 pi exp(-(r^2+R^2)/(2 s^2)) i_l(r R / s^2), computed in the
    scaled form that is numerically finite for large r R / s^2. The R -> 0
    limit (the centre atom's own density) is i_l(0) = delta_l0.
    """
    r = np.linspace(0.0, r_cut, n_quad)
    dr = r[1] - r[0]
    g = _radial_basis(r_cut, n_max, r)                       # [n, Q]
    s2 = sigma * sigma

    big_r = dists[:, None, None]                             # [i, 1, 1]
    rr = r[None, None, :]                                    # [1, 1, Q]
    ls = np.arange(l_max + 1)[None, :, None]                 # [1, l, 1]
    x = rr * big_r / s2
    small = x < 1e-10
    x_safe = np.where(small, 1.0, x)
    # exp(-(r^2+R^2)/2s^2) i_l(x) = exp(-(r-R)^2/2s^2) sqrt(pi/2x) ive(l+.5, x)
    scaled = np.sqrt(np.pi / (2.0 * x_safe)) * ive(ls + 0.5, x_safe)
    gauss = np.exp(-((rr - big_r) ** 2) / (2.0 * s2))
    w = 4.0 * np.pi * gauss * np.where(small, 1.0 * (ls == 0), scaled)
    w = np.where(small & (ls == 0),
                 4.0 * np.pi * np.exp(-(rr**2 + big_r**2) / (2.0 * s2)), w)
    # trapezoid weights on the uniform grid
    quad_w = np.full(n_quad, dr)
    quad_w[0] = quad_w[-1] = dr / 2.0
    integrand = g * (r * r * quad_w)[None, :]                # [n, Q]
    return np.einsum("nq,ilq->inl", integrand, w)            # [i, n, l]


def _sph_harm_table(unit: np.ndarray, l_max: int) -> np.ndarray:
    """Y[l, m + l_max, i] = Y_lm(theta_i, phi_i) (complex), zero for |m| > l."""
    theta = np.arccos(np.clip(unit[:, 2], -1.0, 1.0))
    phi = np.arctan2(unit[:, 1], unit[:, 0])
    n = unit.shape[0]
    table = np.zeros((l_max + 1, 2 * l_max + 1, n), np.complex128)
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            table[l, m + l_max] = _sph_harm_y(l, m, theta, phi)
    return table


def soap_descriptor(pos: np.ndarray, species: np.ndarray,
                    center: int = 0, r_cut: float = 8.0, n_max: int = 15,
                    l_max: int = 10, sigma: float = 0.1,
                    mask: np.ndarray | None = None,
                    n_quad: int = 2048) -> np.ndarray:
    """SOAP power spectrum of the environment of atom ``center``.

    Args:
      pos: ``[N, 3]`` positions; species: ``[N, 2]`` one-hot (O, Si).
      mask: optional ``[N]`` validity mask (padded rows dropped).

    Returns:
      Real vector over species pairs (O,O), (O,Si), (Si,Si): same-species
      blocks use n1 <= n2 (the spectrum is symmetric), the cross block all
      (n1, n2); each block spans l = 0..l_max. Total length
      2 * C(n_max+1, 2) * (l_max+1) + n_max^2 * (l_max+1); for the reference
      settings (15, 10): 5115.
    """
    pos = np.asarray(pos, np.float64)
    species = np.asarray(species, np.float64)
    n = pos.shape[0]
    m = np.ones(n) if mask is None else np.asarray(mask, np.float64)

    rel = pos - pos[center]
    d = np.linalg.norm(rel, axis=-1)
    keep = (m > 0) & (d < r_cut)
    keep[center] = m[center] > 0   # centre contributes its own density
    rel, d, spec = rel[keep], d[keep], species[keep]
    unit = rel / np.maximum(d, 1e-12)[:, None]
    unit[d < 1e-12] = [0.0, 0.0, 1.0]  # centre: only l = 0 survives anyway

    rad = _radial_integrals(d, r_cut, n_max, l_max, sigma, n_quad)  # [i,n,l]
    ylm = _sph_harm_table(unit, l_max)                       # [l, 2L+1, i]

    # c[Z, n, l, m] = sum_i w_Z(i) I[i,n,l] conj(Y_lm(i))
    coeff = np.einsum("iz,inl,lmi->znlm", spec, rad, np.conj(ylm))

    blocks = []
    iu = np.triu_indices(n_max)
    for z1, z2 in ((0, 0), (0, 1), (1, 1)):
        # p[n1, n2, l] = pi sqrt(8/(2l+1)) sum_m c1 conj(c2)  (real-valued)
        p = np.einsum("nlm,olm->nol", coeff[z1], np.conj(coeff[z2])).real
        p = p * (np.pi * np.sqrt(8.0 / (2.0 * np.arange(l_max + 1) + 1.0)))
        if z1 == z2:
            p = p[iu]                # symmetric: keep n1 <= n2
        else:
            p = p.reshape(-1, l_max + 1)
        blocks.append(p.ravel())
    return np.concatenate(blocks)
