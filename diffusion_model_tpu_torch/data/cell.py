"""CASTEP ``.cell`` structure ingestion — pure numpy, no pymatgen.

Mirrors ``read_castep_output_structure`` (ref data_preparation.py:14-50 and
the exO->'C' marker variant in make_dataset.py:12-48): the file carries
lattice lengths (line 2), lattice angles (line 3), then fractional positions
until ``%ENDBLOCK POSITIONS_FRAC``, with the excited oxygen tagged ``O:ex``.

The reference leans on pymatgen ``Lattice``/``Structure``; here the lattice
matrix, cartesian conversion, supercell expansion and distance matrices are
small numpy routines (they feed the host pipeline only — device code never
sees them).

The port's own copy of ``diffusion_model_tpu/data/cell.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CellStructure:
    lattice: np.ndarray          # [3,3] row-vector lattice matrix
    frac_coords: np.ndarray      # [N,3]
    species: list                # element symbols, exO recorded as 'O'
    exo_index: int               # index of the excited oxygen

    @property
    def cart_coords(self) -> np.ndarray:
        return self.frac_coords @ self.lattice

    @property
    def num_sites(self) -> int:
        return self.frac_coords.shape[0]


def lattice_from_parameters(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Standard crystallographic lattice matrix (row vectors), matching
    pymatgen ``Lattice.from_parameters`` conventions:

        gamma* = arccos((cos(alpha) cos(beta) - cos(gamma)) /
                        (sin(alpha) sin(beta)))
        va = (a sin(beta), 0, a cos(beta))
        vb = (-b sin(alpha) cos(gamma*), b sin(alpha) sin(gamma*),
              b cos(alpha))
        vc = (0, 0, c)
    """
    alpha_r, beta_r, gamma_r = np.radians([alpha, beta, gamma])
    val = (np.cos(alpha_r) * np.cos(beta_r) - np.cos(gamma_r)) / (
        np.sin(alpha_r) * np.sin(beta_r)
    )
    val = np.clip(val, -1.0, 1.0)
    gamma_star = np.arccos(val)
    va = np.array([a * np.sin(beta_r), 0.0, a * np.cos(beta_r)])
    vb = np.array([
        -b * np.sin(alpha_r) * np.cos(gamma_star),
        b * np.sin(alpha_r) * np.sin(gamma_star),
        b * np.cos(alpha_r),
    ])
    vc = np.array([0.0, 0.0, float(c)])
    return np.stack([va, vb, vc])


# CASTEP length units accepted inside lattice/position blocks.
_UNIT_TO_ANG = {
    "ANG": 1.0,
    "BOHR": 0.529177210903,
    "A0": 0.529177210903,
    "NM": 10.0,
}


def _parse_blocks(lines) -> dict:
    """``%BLOCK name`` ... ``%ENDBLOCK name`` sections, case-insensitive,
    with ``#``/``!`` comments and blank lines stripped. Top-level key-value
    directives (kpoint grids, symmetry flags, ...) are ignored."""
    blocks: dict = {}
    cur, buf = None, []
    for raw in lines:
        line = raw.split("#")[0].split("!")[0].strip()
        if not line:
            continue
        upper = line.upper()
        if upper.startswith("%BLOCK"):
            parts = upper.split(None, 1)  # any whitespace (tabs included)
            cur = parts[1].strip() if len(parts) > 1 else ""
            buf = []
        elif upper.startswith("%ENDBLOCK"):
            if cur:
                blocks[cur] = buf
            cur, buf = None, []
        elif cur is not None:
            buf.append(line)
    return blocks


def _strip_unit(rows) -> tuple:
    """(rows-without-unit-line, scale-to-angstrom)."""
    if rows and len(rows[0].split()) == 1:
        unit = rows[0].strip().upper()
        if unit in _UNIT_TO_ANG:
            return rows[1:], _UNIT_TO_ANG[unit]
        raise ValueError(f"unknown .cell unit {rows[0]!r}")
    return rows, 1.0


def read_castep_cell(path: str, require_exo: bool = True) -> CellStructure:
    """Parse a CASTEP ``.cell`` file.

    Handles the layouts real CASTEP emits (the reference's parser,
    ref data_preparation.py:14-50, is positional and only reads its own
    coreloss exports): ``LATTICE_ABC`` (lengths+angles) or ``LATTICE_CART``
    (row vectors), ``POSITIONS_FRAC`` or ``POSITIONS_ABS``, optional unit
    lines (ang / bohr / a0 / nm), ``#``/``!`` comments, blank lines and
    case-insensitive block keywords. The excited oxygen is any site whose
    species tag carries an ``:ex`` suffix (the reference writes ``O:ex``).
    """
    with open(path) as f:
        blocks = _parse_blocks(f.read().splitlines())

    if "LATTICE_ABC" in blocks:
        rows, scale = _strip_unit(blocks["LATTICE_ABC"])
        lengths = [float(x) * scale for x in rows[0].split()[:3]]
        angles = [float(x) for x in rows[1].split()[:3]]
        lattice = lattice_from_parameters(*lengths, *angles)
    elif "LATTICE_CART" in blocks:
        rows, scale = _strip_unit(blocks["LATTICE_CART"])
        lattice = np.asarray(
            [[float(x) * scale for x in r.split()[:3]] for r in rows[:3]]
        )
    else:
        raise ValueError(f"no LATTICE_ABC/LATTICE_CART block in {path}")

    frac_block = blocks.get("POSITIONS_FRAC")
    abs_block = blocks.get("POSITIONS_ABS")
    if frac_block is None and abs_block is None:
        raise ValueError(f"no POSITIONS_FRAC/POSITIONS_ABS block in {path}")
    rows, scale = _strip_unit(
        frac_block if frac_block is not None else abs_block
    )

    species, coords = [], []
    exo_index = -1
    for i, line in enumerate(rows):
        parts = line.split()
        if len(parts) < 4:
            raise ValueError(f"malformed position line {line!r} in {path}")
        sym = parts[0]
        if ":EX" in sym.upper():
            exo_index = i
            sym = sym.split(":")[0]
        species.append(sym)
        coords.append([float(x) for x in parts[1:4]])
    if exo_index < 0 and require_exo:
        raise ValueError(f"no :ex-tagged site found in {path}")

    coords = np.asarray(coords, np.float64)
    if frac_block is None:
        # absolute cartesian -> fractional
        coords = (coords * scale) @ np.linalg.inv(lattice)
    return CellStructure(
        lattice=lattice,
        frac_coords=coords,
        species=species,
        exo_index=exo_index,
    )


def supercell_333(struct: CellStructure) -> CellStructure:
    """3x3x3 supercell with the central image's exO kept as the excited atom
    (image copies become plain 'O'), as in ref make_dataset.py:79-92."""
    shifts = [
        np.array([i, j, k], np.float64)
        for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
    ]
    frac, species = [], []
    exo_new = -1
    idx = 0
    for shift in shifts:
        central = np.all(shift == 0)
        for s_i in range(struct.num_sites):
            frac.append(struct.frac_coords[s_i] + shift)
            species.append(struct.species[s_i])
            if central and s_i == struct.exo_index:
                exo_new = idx
            idx += 1
    return CellStructure(
        lattice=struct.lattice,
        frac_coords=np.asarray(frac),
        species=species,
        exo_index=exo_new,
    )


def distance_matrix(struct: CellStructure) -> np.ndarray:
    cart = struct.cart_coords
    diff = cart[:, None, :] - cart[None, :, :]
    return np.sqrt(np.sum(diff * diff, axis=-1))


_IMAGE_SHIFTS = np.array(
    [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    np.float64,
)


def mic_frac_deltas(frac_d: np.ndarray, lattice: np.ndarray) -> np.ndarray:
    """Map fractional deltas ``[..., 3]`` to their true minimum image.

    Component-wise rounding alone is only exact for orthogonal cells: in a
    skewed (triclinic/hexagonal) lattice the shortest image of a delta can
    sit one cell over in a *different* component. Round first, then search
    the 27 surrounding images in cartesian norm — exact for any cell whose
    angles stay in the crystallographically sane range (~60-120 deg).
    """
    frac_d = frac_d - np.round(frac_d)
    cand = frac_d[..., None, :] + _IMAGE_SHIFTS      # [..., 27, 3]
    cart = cand @ lattice
    d2 = np.sum(cart * cart, axis=-1)
    best = np.argmin(d2, axis=-1)
    return np.take_along_axis(
        cand, best[..., None, None], axis=-2
    )[..., 0, :]


def min_image_distance_matrix(struct: CellStructure) -> np.ndarray:
    """Minimum-image-convention distances for the periodic cell (the
    reference reaches this through pymatgen's ``distance_matrix``)."""
    frac_d = struct.frac_coords[:, None, :] - struct.frac_coords[None, :, :]
    cart_d = mic_frac_deltas(frac_d, struct.lattice) @ struct.lattice
    return np.sqrt(np.sum(cart_d * cart_d, axis=-1))
