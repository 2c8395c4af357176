"""Topological fingerprint similarity — native numpy replacement for the
reference's RDKit pipeline (ref evaluate_fingerprint.py:49-113), which this
image does not ship.

Pipeline parity:
  * bond guessing from covalent radii with a 1.2 scale factor
    (ref evaluate_fingerprint.py:58-84 — same rule, sans RDKit),
  * atom-pair fingerprint: counts of (type_i, type_j, topological distance)
    triples over the bond graph — the same invariant RDKit's
    ``GetAtomPairFingerprint`` hashes (unordered element pair + shortest
    bond-path length),
  * Tanimoto similarity on count vectors: sum(min)/sum(max), RDKit's
    count-fingerprint definition (ref :109-113).

The port's own copy of ``diffusion_model_tpu/evals/fingerprint.py`` (numpy, no JAX), with its
names: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

# Covalent radii (Angstrom) — standard Cordero values for the species the
# pipeline handles (O, Si plus the overlay stand-ins Al, F).
# Cordero covalent radii (Angstrom); O/Si/Al/F cover the SiO2 pipeline
# (ref evaluate_fingerprint.py uses RDKit's table), H/C/N complete QM9's
# H/C/N/O/F species set (data/qm9.py).
COVALENT_RADII = {"H": 0.31, "C": 0.76, "N": 0.71, "O": 0.66,
                  "Si": 1.11, "Al": 1.21, "F": 0.57}


def guess_bonds(pos: np.ndarray, symbols: list, threshold: float = 1.2
                ) -> np.ndarray:
    """Adjacency matrix: bond when distance < threshold * (r_i + r_j)."""
    pos = np.asarray(pos)
    n = pos.shape[0]
    radii = np.asarray([COVALENT_RADII[s] for s in symbols])
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    cut = threshold * (radii[:, None] + radii[None, :])
    adj = (d < cut) & ~np.eye(n, dtype=bool)
    return adj


def _shortest_paths(adj: np.ndarray, max_dist: int = 30) -> np.ndarray:
    """All-pairs shortest path lengths by BFS; unreachable = -1."""
    n = adj.shape[0]
    dist = np.full((n, n), -1, np.int32)
    for src in range(n):
        dist[src, src] = 0
        frontier = [src]
        d = 0
        while frontier and d < max_dist:
            d += 1
            nxt = []
            for u in frontier:
                for v in np.nonzero(adj[u])[0]:
                    if dist[src, v] < 0:
                        dist[src, v] = d
                        nxt.append(v)
            frontier = nxt
    return dist


def atom_pair_fingerprint(pos: np.ndarray, symbols: list,
                          threshold: float = 1.2) -> dict:
    """Count map {(sym_a, sym_b, path_len): count} with sym_a <= sym_b."""
    adj = guess_bonds(pos, symbols, threshold)
    dist = _shortest_paths(adj)
    fp: dict = {}
    n = len(symbols)
    for i in range(n):
        for j in range(i + 1, n):
            d = int(dist[i, j])
            if d <= 0:
                continue
            a, b = sorted([symbols[i], symbols[j]])
            key = (a, b, d)
            fp[key] = fp.get(key, 0) + 1
    return fp


def tanimoto_similarity(fp1: dict, fp2: dict) -> float:
    """Count-vector Tanimoto: sum(min)/sum(max) over the union of keys."""
    keys = set(fp1) | set(fp2)
    num = sum(min(fp1.get(k, 0), fp2.get(k, 0)) for k in keys)
    den = sum(max(fp1.get(k, 0), fp2.get(k, 0)) for k in keys)
    return num / den if den else 1.0


_ATOMIC_NUMBER = {"O": 8, "Si": 14, "Al": 13, "F": 9}


def _fnv_hash(items) -> int:
    """Deterministic 32-bit FNV-1a over a tuple of ints (Python's ``hash``
    of strings is salted per process, which would make fingerprints
    irreproducible across runs)."""
    h = 2166136261
    for v in items:
        v = int(v) & 0xFFFFFFFF
        for _ in range(4):
            h ^= v & 0xFF
            h = (h * 16777619) & 0xFFFFFFFF
            v >>= 8
    return h


def morgan_fingerprint(pos: np.ndarray, symbols: list, radius: int = 2,
                       fp_size: int = 2048, threshold: float = 1.2) -> dict:
    """Morgan/ECFP-style circular fingerprint on the guessed bond graph.

    Native analogue of RDKit's ``GetMorganGenerator(radius=2, fpSize=2048)``
    used by the reference (ref evaluate_fingerprint.py:87-93): each atom
    starts from an invariant of (atomic number, degree), then ``radius``
    rounds of iterated neighborhood hashing fold the sorted neighbor
    identifiers into a new identifier. All identifiers seen at every radius
    are folded modulo ``fp_size`` into a count map (count-Tanimoto scoring
    also covers RDKit's bit-vector Tanimoto up to folding collisions).
    """
    adj = guess_bonds(pos, symbols, threshold)
    n = len(symbols)
    neighbors = [np.nonzero(adj[i])[0] for i in range(n)]
    ids = [
        _fnv_hash((_ATOMIC_NUMBER[symbols[i]], len(neighbors[i])))
        for i in range(n)
    ]
    fp: dict = {}
    for i in ids:
        fp[i % fp_size] = fp.get(i % fp_size, 0) + 1
    for _ in range(radius):
        new_ids = [
            _fnv_hash((ids[i],) + tuple(sorted(ids[j] for j in neighbors[i])))
            for i in range(n)
        ]
        for i in new_ids:
            fp[i % fp_size] = fp.get(i % fp_size, 0) + 1
        ids = new_ids
    return fp


def fingerprint_similarity(pos1, symbols1, pos2, symbols2,
                           threshold: float = 1.2,
                           method: str = "atom_pair") -> float:
    """End-to-end equivalent of ``eval_by_xyz``
    (ref evaluate_fingerprint.py:96-113). ``method`` selects the fingerprint
    family: "atom_pair" (ref ``GetAtomPairFingerprint``) or "morgan"
    (ref ``GetMorganGenerator`` circular/ECFP)."""
    if method == "morgan":
        fp1 = morgan_fingerprint(pos1, symbols1, threshold=threshold)
        fp2 = morgan_fingerprint(pos2, symbols2, threshold=threshold)
    elif method == "atom_pair":
        fp1 = atom_pair_fingerprint(pos1, symbols1, threshold)
        fp2 = atom_pair_fingerprint(pos2, symbols2, threshold)
    else:
        raise ValueError(f"unknown fingerprint method: {method!r}")
    return tanimoto_similarity(fp1, fp2)
