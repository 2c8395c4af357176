"""Replayed training of the large-cell recipe at full width, the port's side:
both tracks of ``tests/jax_replay_training_full.py``'s record (float32 and
bfloat16, 150 steps) through the port's ``Trainer.train_step`` from the same
numpy start, on the same batches and draws. It imports no JAX, so it runs on
the card's machine, where the train step is the normal route (K2 forward,
``ops.edge_grad`` backward).

    python tests/torch_replay_training_full.py --device cuda \\
        --out build/train_replay_full_card.json
    python tests/torch_replay_training_full.py --device cpu --steps 2 \\
        --out build/train_replay_full_cpu.json

The record (``tests/fixtures/torch_port/train_replay_full_card.json`` for
the card's run) holds each track's loss and gradient norm at every step and,
at every record step (1, then every ``RECORD_EVERY``), the sketch's
estimate of the L2 gap to JAX's track of the same dtype, for the whole tree
and for each leaf, and the verdict of ``verdict`` (the rule of F9 in
``ROADMAP.md`` §3). On the card a 150-step run of both tracks takes a few
minutes (``seconds`` in the record).

With ``--variants`` (F9 step (d), ``ROADMAP.md`` §3) it runs the float32
track once and the bfloat16 track of each variant of ``VARIANTS``, reads
each by ``vnode_group_gaps`` and decides by ``names_the_cause`` and
``verdict`` (record ``tests/fixtures/torch_port/f9_variants_card.json``):

    python tests/torch_replay_training_full.py --device cuda --variants \\
        --out build/f9_variants_card.json

Also here, numpy only, for both sides:

  * ``numpy_start``: the start both packages train from. Each leaf is a
    seeded numpy normal with the standard deviation of that leaf in the JAX
    package's own ``init_state`` (recorded in the fixture); a leaf that JAX
    initialises to a constant keeps the constant.
  * ``Sketch``: each leaf's L2 norm and ``SKETCH_K`` seeded Gaussian
    projections of its distance from the start, from which ``gap`` estimates
    the L2 norm of the difference of two parameter trees.
  * ``verdict``: the rule.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
from jax_replay_training import (  # noqa: F401  (used by the callers too)
    GRAD_RTOL,
    LOSS_RTOL,
    drift_bounds,
    loss_bound,
)

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
FIXTURE = FIXTURES / "train_replay_full_hres_vn"   # .npz and .json
CARD_RECORD = FIXTURES / "train_replay_full_card.json"
# The ``h_residual+virtual_node`` arm of
# ``docs/quality/size192net_lever_sweep.json`` at its own widths, on eight
# network cells of 160-192 atoms at batch 4.
FLAGS = ["--generator", "network", "--train_cells", "8", "--train_min",
         "160", "--train_max", "192", "--neighbor_k", "32", "--L", "5",
         "--hidden", "1024", "--m_size", "256", "--batch_size", "4",
         "--h_init_scale", "1e-3", "--h_residual", "--virtual_node",
         "--lr", "2e-4", "--max_grad_norm", "1", "--cell_cache", ""]
TRACKS = ("float32", "bfloat16")
STEPS = 150
RECORD_EVERY = 10
START_SEED = 19
SKETCH_SEED = 1019
SKETCH_K = 128          # projections of each of the TOP_LEAVES and the tree
SKETCH_K_SMALL = 32     # projections kept of every other leaf
TOP_LEAVES = 10
# The sketch's promise: an estimated gap within this fraction of the true
# one (whole tree and the TOP_LEAVES largest leaves; K = 128 puts it at ~4
# standard deviations of the estimate).
SKETCH_TOL = 0.25
# The rule: the port's bfloat16 track may part from JAX's by this many times
# JAX's own bfloat16-to-float32 gap.
BF16_FACTOR = 1.5
# The one-step gradient tolerance of a bfloat16 step (the float32 ones and
# the drift bound they give are ``jax_replay_training``'s, which imports
# JAX only inside its functions).
BF16_GRAD_RTOL = 5e-2


def record_steps(steps: int) -> list:
    """The steps after which the sketch is taken."""
    return [1] + list(range(RECORD_EVERY, steps + 1, RECORD_EVERY))


# -- the recipe and its data (the port's modules) ---------------------------
def setup():
    """(the port's float32 config of the recipe, the train cells)."""
    from diffusion_model_tpu_torch.evals import size_gen_check

    args = size_gen_check.parser().parse_args(FLAGS)
    cfg = size_gen_check.recipe(args).replace(compute_dtype="float32")
    cells = size_gen_check.train_cells(
        args, cfg, size_gen_check.cell_maker(args, cfg.spectrum_size))
    return cfg, cells


def batch_indices(cfg, count: int, steps: int) -> np.ndarray:
    """[steps, batch] the cells of each step's batch, epoch after epoch in
    ``api.train``'s order (seed ``cfg.seed + epoch``); a filler row of an
    uneven epoch is marked -1 - index."""
    from diffusion_model_tpu_torch.data.split import batch_order

    rows, epoch = [], 0
    while len(rows) < steps:
        idx, valid = batch_order(count, cfg.batch_size, cfg.seed + epoch)
        marked = np.where(valid > 0, idx, -1 - idx)
        rows += list(marked.reshape(-1, cfg.batch_size))
        epoch += 1
    return np.stack(rows[:steps]).astype(np.int64)


def port_batches(cfg, cells: list, device="cpu"):
    """The port's batches, epoch after epoch (``data.split``)."""
    from diffusion_model_tpu_torch.data.split import batch_iterator

    epoch = 0
    while True:
        yield from batch_iterator(cells, cfg.batch_size, cfg.n_max,
                                  seed=cfg.seed + epoch, device=device)
        epoch += 1


def cell_checksum(cells: list) -> list:
    """Per cell the float64 sum of its positions and of its spectrum."""
    return [[float(np.asarray(c["pos"], np.float64).sum()),
             float(np.asarray(c["spectrum"], np.float64).sum())]
            for c in cells]


# -- the start --------------------------------------------------------------
def numpy_start(spec: list, seed: int = START_SEED) -> dict:
    """The flax tree ``{"denoiser": {"params": ...}}`` both packages start
    from: leaf ``i`` of ``spec`` (``path``, ``shape``, ``std``, ``const``)
    is ``const`` where that is set, else ``std`` times a standard normal of
    ``numpy.random.default_rng([seed, i])`` (float32)."""
    root: dict = {}
    for i, leaf in enumerate(spec):
        shape = tuple(leaf["shape"])
        if leaf.get("const") is not None:
            value = np.full(shape, leaf["const"], np.float32)
        else:
            value = (np.random.default_rng([seed, i]).standard_normal(
                shape, np.float32) * np.float32(leaf["std"]))
        node = root
        *parents, name = leaf["path"].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = value
    return {"denoiser": {"params": root}}


def port_leaves(tree: dict) -> dict:
    """A flax tree's denoiser leaves by the port's names (``denoiser.``
    and the state-dict name; float32 numpy, transposed as the port holds
    them)."""
    from diffusion_model_tpu_torch.train.checkpoint import (
        state_dict_from_flax,
    )

    return {f"denoiser.{k}": v.numpy()
            for k, v in state_dict_from_flax(tree).items()}


# -- the sketch -------------------------------------------------------------
class Sketch:
    """Seeded Gaussian projections of a parameter tree's distance from
    ``origin`` (a dict name -> array; the leaves in sorted name order).

    Leaf ``i`` has the projection matrix ``default_rng([seed, i])``'s
    standard normal of shape ``[SKETCH_K, size]`` (float32), the same on
    every machine and at every record. ``__call__`` returns the leaf norms
    of the tree, the ``SKETCH_K`` projections of the whole tree (the sum of
    the leaves'), those of each of the ``TOP_LEAVES`` largest leaves, and
    the first ``SKETCH_K_SMALL`` of every other leaf's. Products are summed
    in blocks of 1024 in float32 and the blocks in float64, so a gap much
    smaller than the distance from the origin still reads true.

    ``device`` (a torch device): where the matrices live and the products
    run. On a card they are generated once and kept (6.4 GB for 12.5 M
    parameters); on the CPU each call generates them anew, eight leaves at
    a time."""

    def __init__(self, origin: dict, seed: int = SKETCH_SEED,
                 k: int = SKETCH_K, device="cpu"):
        import torch

        self.names = sorted(origin)
        self.origin = {n: np.asarray(origin[n], np.float32)
                       for n in self.names}
        self.seed, self.k = seed, k
        self.device = torch.device(device)
        by_size = sorted(self.names, key=lambda n: (-origin[n].size, n))
        self.top = sorted(by_size[:TOP_LEAVES])
        self.keep = self.device.type == "cuda"
        self._mats: dict = {}
        self._origin_t = {n: torch.from_numpy(self.origin[n].ravel()).to(
            self.device) for n in self.names}

    def matrix(self, i: int) -> np.ndarray:
        """Leaf ``i``'s projection matrix."""
        size = self.origin[self.names[i]].size
        return np.random.default_rng([self.seed, i]).standard_normal(
            (self.k, size), np.float32)

    def head(self) -> np.ndarray:
        """The first 16 rows of the first column of the first three leaves'
        matrices: a fingerprint of the generator."""
        return np.stack([self.matrix(i)[:16, 0] for i in range(3)])

    def _matrices(self, idx: list) -> dict:
        import torch

        missing = [i for i in idx if i not in self._mats]
        with ThreadPoolExecutor(8) as ex:
            made = dict(zip(missing, ex.map(self.matrix, missing)))
        out = {}
        for i in idx:
            m = self._mats.get(i)
            if m is None:
                m = torch.from_numpy(made[i]).to(self.device)
                if self.keep:
                    self._mats[i] = m
            out[i] = m
        return out

    def _project(self, mat, d):
        import torch

        size = d.numel()
        pad = (-size) % 1024
        if pad:
            mat = torch.nn.functional.pad(mat, (0, pad))
            d = torch.nn.functional.pad(d, (0, pad))
        blocks = torch.einsum("kbj,bj->kb", mat.view(self.k, -1, 1024),
                              d.view(-1, 1024))
        return blocks.double().sum(-1)

    def __call__(self, leaves: dict) -> dict:
        import torch

        assert sorted(leaves) == self.names, "not the sketched tree"
        proj, norms = {}, []
        for lo in range(0, len(self.names), 8):
            idx = list(range(lo, min(lo + 8, len(self.names))))
            mats = self._matrices(idx)
            for i in idx:
                n = self.names[i]
                v = torch.as_tensor(leaves[n]).detach().float().to(
                    self.device).ravel()
                norms.append(float(v.double().norm()))
                proj[n] = self._project(mats[i], v - self._origin_t[n]
                                        ).cpu().numpy()
            del mats
        return {"norms": np.array(norms),
                "tree": np.sum([proj[n] for n in self.names], axis=0),
                "top": np.stack([proj[n] for n in self.top]),
                "small": np.stack([proj[n][:SKETCH_K_SMALL]
                                   for n in self.names])}

    def gap(self, a: dict, b: dict) -> dict:
        """The estimated L2 norm of the difference of the two sketched
        trees: ``tree``, each top leaf's (``top``, by name) and each leaf's
        from its first ``SKETCH_K_SMALL`` projections (``leaf``)."""
        def est(x, y):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            return float(np.sqrt(np.mean((x - y) ** 2, axis=-1)))

        return {"tree": est(a["tree"], b["tree"]),
                "top": {n: est(a["top"][j], b["top"][j])
                        for j, n in enumerate(self.top)},
                "leaf": {n: est(a["small"][j], b["small"][j])
                         for j, n in enumerate(self.names)}}


def exact_gap(a: dict, b: dict) -> dict:
    """The L2 norm of the difference of two trees of numpy leaves: the whole
    tree's and each leaf's (float64)."""
    leaf = {n: float(np.linalg.norm(np.asarray(a[n], np.float64)
                                    - np.asarray(b[n], np.float64)))
            for n in sorted(a)}
    return {"tree": float(np.sqrt(sum(v * v for v in leaf.values()))),
            "leaf": leaf}


def sketch_arrays(prefix: str, s: dict) -> dict:
    """A sketch as npz entries under ``prefix``."""
    return {f"{prefix}_{k}": np.asarray(v, np.float32 if k != "norms"
                                        else np.float64)
            for k, v in s.items()}


def sketch_from(npz, prefix: str) -> dict:
    return {k: npz[f"{prefix}_{k}"] for k in ("norms", "tree", "top",
                                              "small")}


# -- the fixture ------------------------------------------------------------
def load_fixture(path=None) -> tuple:
    """(the record's JSON, its npz) at ``path`` (default ``FIXTURE``)."""
    path = path or FIXTURE
    with open(f"{path}.json") as f:
        meta = json.load(f)
    return meta, np.load(f"{path}.npz")


def draws_at(npz, k: int) -> dict:
    """The recorded draws of step ``k`` (0-based) by the port's stream
    names, each a one-element list as ``ReplayDraws`` takes them."""
    return {name[len("draw_"):]: [npz[name][k]] for name in npz.files
            if name.startswith("draw_")}


# -- the rule ---------------------------------------------------------------
def f32_l2_bound(step: int, lr: float, size: int) -> float:
    """The float32 drift bound on the L2 norm of the whole tree's gap after
    ``step`` updates: ``sqrt(size)`` entries, each within ``drift_bounds``'
    ``param_abs`` of JAX's."""
    return size ** 0.5 * drift_bounds(step, lr)["param_abs"]


def gap_before(records: list, step: int) -> float:
    """An upper reading of the tree's L2 gap before ``step`` (1-based): 0
    before the first step, else the estimate at the first record at or
    after ``step - 1`` over ``1 - SKETCH_TOL``."""
    if step == 1:
        return 0.0
    r = next(r for r in records if r["step"] >= step - 1)
    return r["gap"]["tree"] / (1 - SKETCH_TOL)


def verdict(meta: dict, port: dict, steps: int = None) -> dict:
    """F9's rule (``ROADMAP.md`` §3) on the port's tracks ``port`` against
    JAX's ``meta``, over the first ``steps`` steps (default all recorded).

    * float32 holds when at every record from step 10 the estimated tree
      gap is within ``f32_l2_bound`` and every step's loss within
      ``loss_bound`` of JAX's (the gap before the step from ``gap_before``).
    * bfloat16 holds when at every record from step 10 the estimated tree
      gap to JAX's bfloat16 track is at most ``BF16_FACTOR`` times JAX's own
      exact bfloat16-to-float32 gap, and over each block of
      ``RECORD_EVERY`` steps the summed loss gap at most ``BF16_FACTOR``
      times JAX's summed bfloat16-to-float32 loss gap plus the summed
      ``loss_bound`` (with the float32 track's gap).

    Outcome ``i``: both hold; ``ii``: float32 holds and bfloat16 does not;
    ``iii``: float32 does not hold."""
    steps = steps or len(port["float32"]["loss"])
    size, lr = meta["parameters"], meta["lr"]
    jf, jb = meta["tracks"]["float32"], meta["tracks"]["bfloat16"]
    pf, pb = port["float32"], port["bfloat16"]
    f32_records = [r for r in pf["records"] if r["step"] <= steps]
    f32_gap_off = [r["step"] for r in f32_records if r["step"] >= 10
                   and r["gap"]["tree"] > f32_l2_bound(r["step"], lr, size)]
    f32_loss_off = [k + 1 for k in range(steps)
                    if abs(pf["loss"][k] - jf["loss"][k]) > loss_bound(
                        jf["loss"][k], jf["grad_norm"][k],
                        gap_before(f32_records, k + 1))]
    jax_gap = {r["step"]: r["exact"]["tree"] for r in meta["jax_gap"]}
    bf_gap_off = [r["step"] for r in pb["records"] if 10 <= r["step"] <= steps
                  and r["gap"]["tree"] > BF16_FACTOR * jax_gap[r["step"]]]
    bf_loss_off = []
    for lo in range(0, steps, RECORD_EVERY):
        ks = range(lo, min(lo + RECORD_EVERY, steps))
        port_off = sum(abs(pb["loss"][k] - jb["loss"][k]) for k in ks)
        jax_off = sum(abs(jb["loss"][k] - jf["loss"][k]) for k in ks)
        allow = sum(loss_bound(jb["loss"][k], jb["grad_norm"][k],
                               gap_before(f32_records, k + 1)) for k in ks)
        if port_off > BF16_FACTOR * jax_off + allow:
            bf_loss_off.append(lo + 1)
    f32 = not f32_gap_off and not f32_loss_off
    bf16 = not bf_gap_off and not bf_loss_off
    return {"steps": steps,
            "float32": {"held": f32, "gap_records_off": f32_gap_off,
                        "loss_steps_off": f32_loss_off},
            "bfloat16": {"held": bf16, "gap_records_off": bf_gap_off,
                         "loss_blocks_off": bf_loss_off},
            "outcome": "i" if f32 and bf16 else ("ii" if f32 else "iii")}


def parting_leaves(meta: dict, port: dict, factor: float = BF16_FACTOR
                   ) -> list:
    """Where the bfloat16 tracks part, leaf by leaf: for each record the
    leaves whose estimated gap to JAX's track exceeds ``factor`` times
    JAX's own exact bfloat16-to-float32 gap of that leaf, largest ratio
    first (diagnostic; the small leaves' estimates rest on
    ``SKETCH_K_SMALL`` projections, and a leaf JAX's two tracks leave
    equal, such as one behind a zero-initialised head at step 1, is
    skipped: the port's schedule-free average moves it by float32 rounding
    alone)."""
    jax_gap = {r["step"]: r["exact"]["leaf"] for r in meta["jax_gap"]}
    out = []
    for r in port["bfloat16"]["records"]:
        ref = jax_gap[r["step"]]
        ratios = {n: g / ref[n] for n, g in r["gap"]["leaf"].items()
                  if ref[n] > 0 and g > factor * ref[n]}
        out.append({"step": r["step"], "leaves": sorted(
            ratios.items(), key=lambda kv: -kv[1])[:5]})
    return out


# -- F9 step (d): the virtual-node channel's measure and rule ----------------
VNODE_GAP_LEAVES = ("vnode_in.bias", "vnode_pool.bias", "vnode_x.bias",
                    "vnode_x_head.bias", "vnode_x_head.kernel")
VNODE_GAP_STEP = 150
VNODE_GAP_BAND = 2.0      # percent; JAX's own bf16 reads -0.34..+0.98 there
AS_IS_GAPS = (-3.43, -3.41, -3.48, -3.37, -3.12)   # train_replay_full_card
AS_IS_TOL = 0.5           # points


def vnode_group_gaps(names: list, norms, f32_norms, layers: int = 5) -> list:
    """Per layer, the mean over ``VNODE_GAP_LEAVES`` of each leaf's norm
    against JAX's float32 norm, ``100 * (norm / f32_norm - 1)`` (percent).
    ``names`` is the sketch's leaf order (``meta["sketch"]["names"]``)."""
    pos = {n: i for i, n in enumerate(names)}
    return [float(np.mean([
        100.0 * (norms[i] / f32_norms[i] - 1.0)
        for i in (pos[f"denoiser.egnn.egcl_{l}.{leaf}"]
                  for leaf in VNODE_GAP_LEAVES)])) for l in range(layers)]


def names_the_cause(gaps: list) -> bool:
    """A variant names the cause when every layer's mean lies within
    ``VNODE_GAP_BAND`` points of JAX's float32 track."""
    return all(abs(g) <= VNODE_GAP_BAND for g in gaps)


# -- the variants of F9 step (d) ---------------------------------------------
# as_is: the route before F11's repair (K2 forward, the float32 reference's
# gradient at float32 copies of the primals); 2b: the repaired port (K2
# forward, the compute-dtype statement's gradient at the primals' dtype);
# 2a: the compute-dtype statement forward and backward, no kernel; 3: as_is
# with the virtual-node channel in float32.
VARIANTS = ("as_is", "2b", "2a", "3")


@functools.cache
def _f32_backward():
    """An ``ops.edge_grad.EdgeFunction`` whose backward is the float32
    reference's gradient at float32 copies of the primals, each gradient
    cast back to its primal's dtype: the port's backward before F11's
    repair."""
    from diffusion_model_tpu_torch.ops.edge_grad import (
        EdgeFunction,
        edge_vjp,
    )

    class F32Backward(EdgeFunction):
        @staticmethod
        def backward(ctx, g_m, g_x):
            needs = [need and i not in ctx.data
                     for i, need in enumerate(ctx.needs_input_grad[5:])]
            saved = ctx.saved_tensors
            lifted = [p.float() if p.is_floating_point() else p
                      for p in saved]
            grads = edge_vjp(ctx.statement, lifted, (g_m, g_x), needs,
                             ctx.sources, ctx.width)
            return (None, None, None, None, None,
                    *(g if g is None else g.to(p.dtype)
                      for g, p in zip(grads, saved)))

    return F32Backward


def variant_edge_fns(variant: str) -> dict:
    """``Trainer`` keywords of a variant's edge functions (the defaults,
    an empty dict, for ``2b``)."""
    from diffusion_model_tpu_torch.nn.egnn import plain_edges
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.ops.edge_grad import wants_grad

    def width(w2m, w2x):
        return max(w2m.shape[-1], w2x.shape[-1])

    if variant in ("as_is", "3"):
        def pair(*a):
            if not wants_grad(a):
                return egcl_pair.egcl_pair_edges(*a)
            fwd = (egcl_pair._launch if a[0].is_cuda
                   else egcl_pair.egcl_pair_edges_reference)
            return _f32_backward().apply(
                fwd, egcl_pair.egcl_pair_edges_reference, a[0].shape[1],
                width(a[8], a[12]), (5,), *a)

        def knn(*a):
            if not wants_grad(a):
                return egcl_knn.egcl_knn_edges(*a)
            fwd = (egcl_knn._launch if a[0].is_cuda
                   else egcl_knn.egcl_knn_edges_reference)
            return _f32_backward().apply(
                fwd, egcl_knn.egcl_knn_edges_reference, a[4].shape[-1],
                width(a[10], a[14]), (4, 5), *a)

        return {"edge_fn": pair, "knn_edge_fn": knn}
    if variant == "2a":
        def pair(*a):
            return plain_edges(egcl_pair.egcl_pair_edges_compute, a,
                               a[0].shape[1], width(a[8], a[12]))

        def knn(*a):
            return plain_edges(egcl_knn.egcl_knn_edges_compute, a,
                               a[4].shape[-1], width(a[10], a[14]))

        return {"edge_fn": pair, "knn_edge_fn": knn}
    return {}


class f32_virtual_channel:
    """Variant ``3``: within the block every EGCL's virtual-node channel
    runs in float32 (its input features and weights), the rest of the layer
    as it is."""
    NAMES = ("vnode_in", "vnode_pool", "vnode_out", "vnode_x", "vnode_x_head")

    def __enter__(self):
        import torch

        from diffusion_model_tpu_torch.nn.egnn import EGCL

        self.orig = orig = EGCL._virtual_channel

        def channel(layer, h_c, x_f, node_mask, w):
            f32 = torch.float32
            return orig(layer, h_c.to(f32), x_f, node_mask,
                        {n: getattr(layer, n).cast(f32) for n in self.NAMES})

        EGCL._virtual_channel = channel
        return self

    def __exit__(self, *exc):
        from diffusion_model_tpu_torch.nn.egnn import EGCL

        EGCL._virtual_channel = self.orig


# -- the port's replay ------------------------------------------------------
def replay_track(meta: dict, npz, dtype: str, steps: int, device,
                 sketch: Sketch = None, log=None,
                 variant: str = "as_is") -> dict:
    """The port's ``dtype`` track for ``steps`` steps, as ``variant``
    (``VARIANTS``; ``as_is`` the port as it is): losses, gradient norms
    and, where ``sketch`` is given, the estimated gap to JAX's track at
    every record step."""
    import contextlib

    import torch

    from diffusion_model_tpu_torch.train.trainer import Trainer
    from torch_port_fixtures import ReplayDraws

    cfg, cells = setup()
    cfg = cfg.replace(compute_dtype=dtype)
    trainer = Trainer(cfg, device=device, **variant_edge_fns(variant))
    scope = (f32_virtual_channel() if variant == "3"
             else contextlib.nullcontext())
    state = trainer.init_state(0, params=numpy_start(meta["start"]["spec"],
                                                     meta["start"]["seed"]))
    it = port_batches(cfg, cells, device)
    want = {r: sketch_from(npz, f"{dtype}_{r}") for r in meta["records"]}
    rec = {"loss": [], "grad_norm": [], "records": []}
    t0 = time.perf_counter()
    for k in range(steps):
        with scope:
            state, m = trainer.train_step(
                state, ReplayDraws(draws_at(npz, k), device), next(it))
        rec["loss"].append(float(m["loss"]))
        rec["grad_norm"].append(float(m["grad_norm"]))
        if sketch is not None and k + 1 in want:
            with torch.no_grad():
                s = sketch(state.params)
            g = sketch.gap(s, want[k + 1])
            rec["records"].append({"step": k + 1, "gap": g,
                                   "norms": s["norms"].tolist()})
            if log:
                log(f"{variant} {dtype} step {k + 1}: loss {rec['loss'][-1]:.6f} "
                    f"(JAX {meta['tracks'][dtype]['loss'][k]:.6f}), tree "
                    f"gap {g['tree']:.3e}, "
                    f"{time.perf_counter() - t0:.1f} s")
    if device != "cpu" and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t0
    return rec


def check_inputs(meta: dict, npz, sketch: Sketch) -> None:
    """The cells, batches, start and projections rebuilt here are the
    record's (numpy or the port's generators on another machine)."""
    cfg, cells = setup()
    np.testing.assert_allclose(cell_checksum(cells), meta["cells"],
                               rtol=1e-12, err_msg="train cells")
    np.testing.assert_array_equal(
        batch_indices(cfg, len(cells), meta["steps"]), npz["batches"])
    start = port_leaves(numpy_start(meta["start"]["spec"],
                                    meta["start"]["seed"]))
    np.testing.assert_allclose(
        [float(start[n].astype(np.float64).sum()) for n in sketch.names],
        meta["start"]["checksum"], rtol=1e-12, err_msg="numpy start")
    np.testing.assert_array_equal(sketch.head(), npz["sketch_head"],
                                  err_msg="projection matrices")


def replay(steps: int = STEPS, device="cuda", tracks=TRACKS,
           log=None) -> dict:
    """Both tracks from the fixture, the record described above."""
    import torch

    meta, npz = load_fixture()
    start = port_leaves(numpy_start(meta["start"]["spec"],
                                    meta["start"]["seed"]))
    sketch = Sketch(start, meta["sketch"]["seed"], meta["sketch"]["k"],
                    device=device)
    check_inputs(meta, npz, sketch)
    port = {t: replay_track(meta, npz, t, steps, device, sketch, log)
            for t in tracks}
    out = {"recipe": meta["recipe"], "flags": FLAGS, "steps": steps,
           "device": str(device), "torch": torch.__version__,
           "tracks": port}
    if torch.device(device).type == "cuda":
        from chip_smoke import card_line

        out["card"] = card_line()
        out["kind"] = torch.cuda.get_device_name(0)
    if set(tracks) == set(TRACKS):
        out["verdict"] = verdict(meta, port, steps)
        out["parting_leaves"] = parting_leaves(meta, port)
    return out


def replay_variants(variants=VARIANTS, steps: int = STEPS, device="cuda",
                    log=None) -> dict:
    """F9 step (d): the float32 track once, then the bfloat16 track of each
    of ``variants``, each read by ``vnode_group_gaps`` at every record step
    and held by ``verdict`` (with the one float32 track) and
    ``names_the_cause`` at ``VNODE_GAP_STEP``. ``decision`` is the first of
    2b, 2a, 3 that names the cause (None where none does); ``as_is_held``
    whether ``as_is`` reproduces ``AS_IS_GAPS`` within ``AS_IS_TOL``."""
    import torch

    meta, npz = load_fixture()
    names = meta["sketch"]["names"]
    start = port_leaves(numpy_start(meta["start"]["spec"],
                                    meta["start"]["seed"]))
    sketch = Sketch(start, meta["sketch"]["seed"], meta["sketch"]["k"],
                    device=device)
    check_inputs(meta, npz, sketch)
    f32 = replay_track(meta, npz, "float32", steps, device, sketch, log)
    out = {"recipe": meta["recipe"], "steps": steps, "device": str(device),
           "torch": torch.__version__, "rule": {
               "leaves": VNODE_GAP_LEAVES, "step": VNODE_GAP_STEP,
               "band_points": VNODE_GAP_BAND, "as_is_record": AS_IS_GAPS,
               "as_is_tol_points": AS_IS_TOL},
           "float32": {"loss": f32["loss"], "grad_norm": f32["grad_norm"],
                       "seconds": f32["seconds"]},
           "variants": {}}
    if torch.device(device).type == "cuda":
        from chip_smoke import card_line

        out["card"] = card_line()
        out["kind"] = torch.cuda.get_device_name(0)
    for v in variants:
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        bf = replay_track(meta, npz, "bfloat16", steps, device, sketch, log,
                          variant=v)
        gaps = {r["step"]: vnode_group_gaps(
            names, r["norms"], npz[f"float32_{r['step']}_norms"])
            for r in bf["records"]}
        last = gaps[max(gaps)]
        out["variants"][v] = {
            "gaps_by_step": gaps, "gaps": last,
            "names_the_cause": (max(gaps) == VNODE_GAP_STEP
                                and names_the_cause(last)),
            "verdict": verdict(meta, {"float32": f32, "bfloat16": bf},
                               steps),
            "loss": bf["loss"], "grad_norm": bf["grad_norm"],
            "seconds": bf["seconds"]}
        if log:
            log(f"{v}: layer means {[round(g, 3) for g in last]} at step "
                f"{max(gaps)}, outcome "
                f"{out['variants'][v]['verdict']['outcome']}, "
                f"{bf['seconds']:.1f} s")
    rec = out["variants"]
    if "as_is" in rec:
        out["as_is_held"] = (max(rec["as_is"]["gaps_by_step"])
                             == VNODE_GAP_STEP and all(
            abs(g - w) <= AS_IS_TOL
            for g, w in zip(rec["as_is"]["gaps"], AS_IS_GAPS)))
    out["decision"] = decision(rec)
    return out


def decision(variants: dict):
    """The first of 2b, 2a, 3 in ``variants`` (``replay_variants``'
    records) that names the cause with ``verdict`` at outcome (i); None
    where none does."""
    return next((v for v in ("2b", "2a", "3") if v in variants
                 and variants[v]["names_the_cause"]
                 and variants[v]["verdict"]["outcome"] == "i"), None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--out", default=str(CARD_RECORD))
    p.add_argument("--variants", nargs="*", choices=VARIANTS,
                   help="F9 step (d): the bfloat16 track of each variant "
                        "(none given: all) against one float32 track")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    log = lambda s: print(s, flush=True)  # noqa: E731
    if args.variants is not None:
        rec = replay_variants(args.variants or VARIANTS, args.steps,
                              args.device, log)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps({"out": args.out, "decision": rec["decision"],
                          "as_is_held": rec.get("as_is_held"),
                          "gaps": {v: r["gaps"] for v, r in
                                   rec["variants"].items()}}))
        return 0
    rec = replay(args.steps, args.device, log=log)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({"out": args.out, "verdict": rec.get("verdict"),
                      "seconds": {t: rec["tracks"][t]["seconds"]
                                  for t in rec["tracks"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
