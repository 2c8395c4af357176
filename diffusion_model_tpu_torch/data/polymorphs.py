"""Public SiO2 polymorph corpus in CASTEP coreloss format.

The reference operated on a private CASTEP/EELS corpus (ref
data_preparation.py:412, make_dataset.py:61-66 take private paths); its
schema — one sample directory per excited-oxygen site holding a
``coreloss.cell`` and an OptaDOS ``coreloss_core_edge.dat`` — is public,
and the crystal structures of the classic silica polymorphs are published
crystallography:

  * alpha-quartz  — P3(2)21, Levien, Prewitt & Weidner 1980
    (a=4.9134 A, c=5.4052 A; Si 3a x=0.4699; O 6c 0.4141,0.2681,0.1188)
  * alpha-cristobalite — P4(1)2(1)2, Downs & Palmer 1994
    (a=4.9717 A, c=6.9223 A; Si 4a x=0.3047; O 8b 0.2381,0.1109,0.1826)
  * coesite — C2/c, Levien & Prewitt 1981 (a=7.1356, b=12.3692,
    c=7.1736 A, beta=120.34 deg; 16 Si + 32 O per cell; O1 sits on an
    inversion centre with an exactly 180-degree Si-O-Si angle)

:func:`write_corpus` expands each structure from its Wyckoff sites,
chooses successive O sites as the excited atom, computes that site's REAL
local geometry (coordination + Si-O-Si angle, minimum-image convention)
and writes a physical ELNES-like edge file whose peak positions encode
that geometry — the same spectrum model the synthetic generators use
(data/synthetic.synthetic_spectrum), so conditioning is genuinely
informative while staying fully reproducible. The output trees drive the
real ingestion end-to-end (``data.shells.build_dataset``, ref
make_dataset.py:60-143).

The port's own copy of ``diffusion_model_tpu/data/polymorphs.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

# --- published crystallography (fractional coordinates) -----------------

# alpha-quartz: full 9-atom cell, hand-expanded from the Wyckoff sites
# (identical to tests/fixtures/castep/sample_000_quartz, whose Si-O bond
# lengths 1.6075/1.6101 A are frozen golden values in tests/test_data.py)
QUARTZ = {
    "name": "quartz",
    "abc": (4.9134, 4.9134, 5.4052),
    "angles": (90.0, 90.0, 120.0),
    "sites": [
        ("Si", (0.4699, 0.0, 0.0)),
        ("Si", (0.0, 0.4699, 2.0 / 3.0)),
        ("Si", (0.5301, 0.5301, 1.0 / 3.0)),
        ("O", (0.4141, 0.2681, 0.1188)),
        ("O", (0.2681, 0.4141, 0.5479)),
        ("O", (0.7319, 0.1460, 0.7855)),
        ("O", (0.5859, 0.8540, 0.2145)),
        ("O", (0.8540, 0.5859, 0.4521)),
        ("O", (0.1460, 0.7319, 0.8812)),
    ],
}

# P4(1)2(1)2 (space group 92) general-position operators
_P41212_OPS = [
    lambda x, y, z: (x, y, z),
    lambda x, y, z: (-x, -y, z + 0.5),
    lambda x, y, z: (0.5 - y, 0.5 + x, z + 0.25),
    lambda x, y, z: (0.5 + y, 0.5 - x, z + 0.75),
    lambda x, y, z: (0.5 - x, 0.5 + y, 0.25 - z),
    lambda x, y, z: (0.5 + x, 0.5 - y, 0.75 - z),
    lambda x, y, z: (y, x, -z),
    lambda x, y, z: (-y, -x, 0.5 - z),
]

# C2/c (space group 15, unique axis b) with C-centering
_C2C_BASE = [
    lambda x, y, z: (x, y, z),
    lambda x, y, z: (-x, y, 0.5 - z),
    lambda x, y, z: (-x, -y, -z),
    lambda x, y, z: (x, -y, 0.5 + z),
]
_C2C_OPS = _C2C_BASE + [
    (lambda op: (lambda x, y, z: tuple(
        np.add(op(x, y, z), (0.5, 0.5, 0.0)))))(op)
    for op in _C2C_BASE
]

CRISTOBALITE_WYCKOFF = {
    "name": "cristobalite",
    "abc": (4.9717, 4.9717, 6.9223),
    "angles": (90.0, 90.0, 90.0),
    "ops": _P41212_OPS,
    "wyckoff": [
        ("Si", (0.3047, 0.3047, 0.0)),
        ("O", (0.2381, 0.1109, 0.1826)),
    ],
}

COESITE_WYCKOFF = {
    "name": "coesite",
    "abc": (7.1356, 12.3692, 7.1736),
    "angles": (90.0, 120.34, 90.0),
    "ops": _C2C_OPS,
    "wyckoff": [
        ("Si", (0.14033, 0.10833, 0.07227)),
        ("Si", (0.50682, 0.15799, 0.54077)),
        ("O", (0.0, 0.0, 0.0)),
        ("O", (0.5, 0.1163, 0.75)),
        ("O", (0.2660, 0.1234, 0.9401)),
        ("O", (0.3114, 0.1038, 0.3282)),
        ("O", (0.0175, 0.2117, 0.4782)),
    ],
}


def expand_wyckoff(ops, wyckoff, tol: float = 1e-3):
    """Apply space-group operators and deduplicate (mod 1).

    Special positions generate coincident images under the general
    operators; dedup keeps one copy, so multiplicities come out right
    without per-site Wyckoff bookkeeping.
    """
    def same(f, s):
        # circular (mod-1) distance per axis: robust to images landing on
        # either side of the wrap boundary (a shift-then-compare scheme
        # can miss pairs straddling the shifted boundary by ~tol)
        d = np.abs(np.mod(f - s, 1.0))
        return bool(np.all(np.minimum(d, 1.0 - d) < tol))

    out = []
    for sp, xyz in wyckoff:
        seen = []
        for op in ops:
            f = np.mod(np.asarray(op(*xyz), float), 1.0)
            if not any(same(f, s) for s in seen):
                seen.append(f)
        out.extend((sp, tuple(s)) for s in seen)
    return out


def _structure(poly):
    if "sites" in poly:
        return poly["sites"]
    return expand_wyckoff(poly["ops"], poly["wyckoff"])


def lattice_matrix(abc, angles):
    """Rows = lattice vectors a, b, c (standard crystallographic frame)."""
    a, b, c = abc
    al, be, ga = np.radians(angles)
    va = np.array([a, 0.0, 0.0])
    vb = np.array([b * np.cos(ga), b * np.sin(ga), 0.0])
    cx = np.cos(be)
    cy = (np.cos(al) - np.cos(be) * np.cos(ga)) / np.sin(ga)
    cz = np.sqrt(max(1.0 - cx * cx - cy * cy, 0.0))
    vc = c * np.array([cx, cy, cz])
    return np.stack([va, vb, vc])


def local_geometry(poly, o_index, cutoff: float = 2.0):
    """Real local geometry of the ``o_index``-th O site.

    Returns ``(cn, angle_deg)``: the number of Si neighbours within
    ``cutoff`` (minimum-image convention) and the Si-O-Si angle (mean over
    Si pairs; 180 for linear sites, NaN-free for cn < 2).
    """
    sites = _structure(poly)
    lat = lattice_matrix(poly["abc"], poly["angles"])
    return local_geometry_sites(sites, lat, o_index, cutoff)


def local_geometry_sites(sites, lat, o_index, cutoff: float = 2.0):
    """`local_geometry` on an explicit (possibly rattled) site list."""
    fracs = np.array([xyz for _, xyz in sites])
    specs = [sp for sp, _ in sites]
    o_sites = [i for i, sp in enumerate(specs) if sp == "O"]
    oi = o_sites[o_index]
    d = fracs - fracs[oi]
    d -= np.round(d)  # minimum image (cells are wide enough for 2 A)
    cart = d @ lat
    dist = np.linalg.norm(cart, axis=1)
    nbrs = [i for i in range(len(sites))
            if specs[i] == "Si" and 0.1 < dist[i] < cutoff]
    cn = len(nbrs)
    angles = []
    for i in range(cn):
        for j in range(i + 1, cn):
            u, v = cart[nbrs[i]], cart[nbrs[j]]
            cosang = np.dot(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
            angles.append(np.degrees(np.arccos(np.clip(cosang, -1, 1))))
    return cn, (float(np.mean(angles)) if angles else 180.0)


def physical_edge_curve(cn, angle_deg, rng, ev):
    """ELNES-like intensity on the writer's eV grid.

    Same peak parameterisation as data/synthetic.synthetic_spectrum (two
    CN-keyed Gaussians + one angle-keyed peak) so the spectrum genuinely
    encodes the real local geometry; evaluated on the raw OptaDOS-style
    grid here because ``fitted_intensity`` (data/spectra.py) re-splines to
    the model's -1..19 eV grid downstream.
    """
    c1 = 5.0 + 1.2 * cn + rng.normal(0, 0.15)
    c2 = 11.0 + 0.8 * cn + rng.normal(0, 0.2)
    w1 = 1.2 + 0.1 * cn
    a2 = 0.5 + 0.1 * cn
    y = (np.exp(-0.5 * ((ev - c1) / w1) ** 2)
         + a2 * np.exp(-0.5 * ((ev - c2) / 2.5) ** 2))
    c3 = -0.5 + 4.0 * (angle_deg / 180.0) + rng.normal(0, 0.05)
    y = y + 0.7 * np.exp(-0.5 * ((ev - c3) / 0.6) ** 2)
    y = y + np.abs(rng.normal(0, 0.005, ev.shape))  # positive noise floor
    return y


def write_sample(sample_dir, poly, o_index, rng, rattle_sigma_A=0.0):
    """One sample directory: coreloss.cell (chosen O as O:ex) +
    coreloss_core_edge.dat keyed to that site's real geometry.

    ``rattle_sigma_A > 0`` perturbs every atom with isotropic Gaussian
    CARTESIAN noise (a thermal-ensemble snapshot, the disorder any real
    EELS corpus carries) and then measures the excited site's geometry
    FROM the perturbed cell, so the written spectrum still encodes the
    true local structure of the written positions — the rattle widens
    conditioning diversity without breaking spectrum↔geometry fidelity.
    """
    os.makedirs(sample_dir, exist_ok=True)
    sites = _structure(poly)
    lat = lattice_matrix(poly["abc"], poly["angles"])
    if rattle_sigma_A > 0.0:
        fracs = np.array([xyz for _, xyz in sites], dtype=float)
        cart_noise = rng.normal(0.0, rattle_sigma_A, fracs.shape)
        fracs = np.mod(fracs + cart_noise @ np.linalg.inv(lat), 1.0)
        sites = [(sp, tuple(f)) for (sp, _), f in zip(sites, fracs)]
    o_seen = -1
    lines = [
        f"# {poly['name']} SiO2 polymorph, public crystallography",
        "",
        "%BLOCK LATTICE_ABC",
        "ang",
        "  {:.6f} {:.6f} {:.6f}".format(*poly["abc"]),
        "  {:.6f} {:.6f} {:.6f}".format(*poly["angles"]),
        "%ENDBLOCK LATTICE_ABC",
        "",
        "%BLOCK POSITIONS_FRAC",
    ]
    for sp, xyz in sites:
        label = sp
        if sp == "O":
            o_seen += 1
            if o_seen == o_index:
                label = "O:ex"
        lines.append(
            f"{label:5s} {xyz[0]:.6f} {xyz[1]:.6f} {xyz[2]:.6f}")
    lines += ["%ENDBLOCK POSITIONS_FRAC", ""]
    with open(os.path.join(sample_dir, "coreloss.cell"), "w") as f:
        f.write("\n".join(lines))

    cn, angle = local_geometry_sites(sites, lat, o_index)
    ev = np.arange(-5.0, 25.0, 0.1)
    y = physical_edge_curve(cn, angle, rng, ev)
    with open(os.path.join(sample_dir, "coreloss_core_edge.dat"),
              "w") as f:
        f.write("# OptaDOS core-loss spectrum\n#\n"
                "# ion  n    edge    site\n"
                "#  O 1    K1      O:ex\n")
        for e, v in zip(ev, y):
            f.write(f"  {e:12.6f}  {v:.8e}\n")
    return cn, angle


POLYMORPHS = (QUARTZ, CRISTOBALITE_WYCKOFF, COESITE_WYCKOFF)


def write_corpus(corpus_dir, seed: int = 0, polymorphs=POLYMORPHS,
                 max_sites_per_polymorph: int | None = None,
                 n_rattles: int = 0, rattle_sigma_A: float = 0.03):
    """The full corpus: one sample per (polymorph, O site).

    ``n_rattles > 0`` additionally writes that many thermally-rattled
    snapshots per site (see :func:`write_sample`), named
    ``sample_NNN_<poly>_oK_rJ`` so downstream per-polymorph grouping
    (``id.split("_")[2]``) still resolves. The rattles turn the corpus's
    discrete per-site angle values into a continuous thermal spread —
    the conditioning-diversity widening
    (measured gap: docs/quality/real_data_angle_diagnosis.json).

    Returns a manifest list of (sample_name, polymorph, cn, angle_deg).
    """
    rng = np.random.default_rng(seed)
    manifest = []
    idx = 0
    for poly in polymorphs:
        sites = _structure(poly)
        n_o = sum(1 for sp, _ in sites if sp == "O")
        if max_sites_per_polymorph is not None:
            n_o = min(n_o, max_sites_per_polymorph)
        for o_index in range(n_o):
            variants = [("", 0.0)] + [
                (f"_r{j}", rattle_sigma_A) for j in range(n_rattles)]
            for suffix, sigma in variants:
                name = f"sample_{idx:03d}_{poly['name']}_o{o_index}{suffix}"
                cn, angle = write_sample(
                    os.path.join(corpus_dir, name), poly, o_index, rng,
                    rattle_sigma_A=sigma)
                manifest.append((name, poly["name"], cn, angle))
                idx += 1
    return manifest
