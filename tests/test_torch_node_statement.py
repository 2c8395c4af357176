"""The node side of an EGCL in the compute dtype (F12 and F13 in
``ROADMAP.md`` §3), the JAX-rounded activations of ``ops.activations``, and
F9 steps (f) and (g) read from the card's records, on the CPU at small
widths.

* ``bias_silu``: the op (its CPU implementation) and the op-by-op statement
  are ``silu(v + b)`` bit for bit, forward and, where autograd records,
  backward (the op dispatched under autograd too); a float32 tensor
  reaches no kernel on the CPU either way.
* F12, bfloat16: an EGCL (``LAYER`` of ``test_torch_compute_statement.py``:
  kNN or dense, the virtual node live, ``h_residual``) whose edge work is
  the compute-dtype statement (JAX's route) against the JAX package's flax
  ``EGCL`` at bfloat16 under ``jax.jit``, input seeds 2-4. The measure of
  each output is its relative L2 distance from JAX's bfloat16 value over
  JAX's own bfloat16-to-float32 distance: the new ``h`` and the coordinate
  update of a call where autograd does not record (sampling's: the node
  MLP and the channel in JAX's rounding) each within ``OUT_RATIO`` in every
  draw, and the VJP of a training call (the channel in JAX's rounding, the
  node MLP in torch's, ``nn.egnn.node_mlp``) pooled over the leaves within
  ``VJP_RATIO``. The node side as it was before the repair (``F.linear``
  and torch's one-op SiLU in the node MLP and the virtual-node channel,
  ``one_op_node_side``) reads the new ``h`` beyond ``OUT_RATIO``, pooled
  (RMS) over the six draws.
* float32: the layer's outputs and gradients are those of the form before
  the repair, bit for bit.
* F13, bfloat16: an ``edge_rbf`` layer and a ``compat_scalar_norm`` layer,
  whose edge work takes the plain route, against JAX's bfloat16 EGCL at
  ``OUT_RATIO`` on both outputs; with the float32 statement on that route
  (the route before the repair) both read beyond it. (The VJP is not held
  here: an rbf layer's pooled VJP reads ~1.0x JAX's own gap on either
  statement, the radial-basis kernels' gradients summed over the edges in
  bfloat16 by XLA and in float32 by torch's product.)
* F9 (f) and (g): the card's records (``f9_f_timing.json``, and the
  retrains where they exist) read by the rule of ``ROADMAP.md`` §3. The
  records the rule reads are the committed tree's (``..._g.json``: the
  node MLP in torch's rounding under autograd); the ``..._f12.json``
  records ran with the node MLP in JAX's rounding in training too.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_replay_training_full as full
from diffusion_model_tpu.nn.egnn import EGCL as JaxEGCL
from diffusion_model_tpu.ops.edges import dense_pair_mask
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.egnn import EGCL, plain_edges
from diffusion_model_tpu_torch.ops import activations, egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train import checkpoint
from test_torch_compute_statement import (
    HDIM,
    K,
    LAYER,
    OUT_RATIO,
    VJP_RATIO,
    _layer_inputs,
    _rel,
)
from test_torch_rbf import RBF, RBF_LEAVES, VNODE, live

torch.set_num_threads(4)

SEEDS = (2, 3, 4)
GATE = 0.881      # F9's gate on the aggregate RDF cosine at sampling seed 2024
FIT_S = 3500.0    # (f)'s projection must fit one call of 3,600 s


# -- bias_silu: the op and its statement ----------------------------------

def _vb(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    v = torch.from_numpy((rng.normal(size=shape) * 3).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=shape[-1:]).astype(np.float32))
    return v.to(dtype), b.to(dtype)


@pytest.mark.parametrize("shape", [(80, 16, 64), (7, 13), (3, 1, 40)])
def test_bias_silu_is_silu_of_the_sum_op_by_op(shape):
    v, b = _vb(shape, torch.bfloat16)
    want = activations.silu(v + b)
    t = v + b
    by_hand = t * torch.reciprocal(1 + torch.exp(-t))
    assert torch.equal(want, by_hand)
    with torch.no_grad():
        got = activations.bias_silu(v, b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    assert torch.equal(activations.bias_silu_op(v, b), want)
    assert torch.equal(activations.bias_silu_reference(v, b), want)


def test_bias_silu_backward_is_the_statements():
    v, b = _vb((6, 5, 32), torch.bfloat16, seed=1)
    g = _vb((6, 5, 32), torch.bfloat16, seed=2)[0]
    grads = []
    for fn in (activations.bias_silu,
               lambda v, b: activations.silu(v + b)):
        vv, bb = v.clone().requires_grad_(), b.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(vv, bb), (vv, bb), g))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_bias_silu_under_autograd_is_the_op():
    """Where autograd records, ``bias_silu`` still dispatches the custom op
    (the kernel on the card), its backward the statement's."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return func(*args, **(kwargs or {}))

    v, b = _vb((5, 24), torch.bfloat16, seed=3)
    v.requires_grad_()
    with Ops():
        y = activations.bias_silu(v, b)
    assert "diffusion_model_tpu_torch.bias_silu.default" in seen
    assert y.requires_grad
    (gv,) = torch.autograd.grad(y.sum(), (v,))
    vv = v.detach().requires_grad_()
    (want,) = torch.autograd.grad(
        activations.bias_silu_reference(vv, b).sum(), (vv,))
    assert torch.equal(gv, want)


def test_bias_silu_launches_nothing_off_the_card():
    before = activations.bias_silu_launches
    v, b = _vb((4, 8), torch.bfloat16)
    with torch.no_grad():
        activations.bias_silu(v, b)
    assert activations.bias_silu_launches == before


def test_bias_silu_kernel_refuses_what_it_does_not_take():
    v, b = _vb((4, 8), torch.float32)
    with pytest.raises(TypeError, match="bfloat16"):
        activations._check(v, b)
    v, b = _vb((4, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="shape"):
        activations._check(v, b[:4])
    with pytest.raises(ValueError, match="contiguous"):
        activations._check(v.t(), torch.zeros(4, dtype=torch.bfloat16))


# -- the node side against JAX's bf16 EGCL (F12) --------------------------

def _old_node_mlp(cat, h0, h1, zeros=None):
    return F.linear(F.silu(F.linear(cat, *h0)), *h1)


def _old_silu_dense(layer, weights, *inputs):
    return F.silu(layer(*inputs, weights))


@contextlib.contextmanager
def one_op_node_side():
    """The node MLP and the virtual-node channel as they were before F12's
    repair, in every dtype: ``F.linear`` (the bias rounded into the
    product) and torch's one-op SiLU."""
    saved = egnn.node_mlp, egnn.silu_dense
    egnn.node_mlp, egnn.silu_dense = _old_node_mlp, _old_silu_dense
    try:
        yield
    finally:
        egnn.node_mlp, egnn.silu_dense = saved


def _jax_layer(params, h, x, edges, mask, cot, dtype, **kw):
    """JAX's EGCL under jit: (h', x update, VJP by the port's names)."""
    layer = JaxEGCL(**{**LAYER, **kw}, compute_dtype=dtype)

    def run(p, h, x):
        hn, xn = layer.apply(p, h, x, edges, mask)
        loss = jnp.sum(hn * cot[0]) + jnp.sum(xn * cot[1])
        return loss, (hn, xn)

    (_, (hn, xn)), (gp, gh, gx) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1, 2), has_aux=True))(params, h, x)
    grads = {k: v.numpy() for k, v in checkpoint.state_dict_from_flax(
        jax.tree.map(np.asarray, gp)).items()}
    grads.update({"input.h": np.asarray(gh), "input.x": np.asarray(gx)})
    return np.asarray(hn, np.float32), np.asarray(xn) - x, grads


def _port_layer(params, h, x, mask, topology, cot, dtype, jax_route=True,
                **kw):
    """The port's EGCL: (h', x update) of a call where autograd does not
    record (sampling's), and the VJP of a call where it does (training's).
    ``jax_route``: the edge work is the compute-dtype statement, as the JAX
    package computes it; else the layer's own route."""
    fns = {}
    if jax_route:
        fns = {"edge_fn": lambda *a: plain_edges(
                   egcl_pair.egcl_pair_edges_compute, a, a[0].shape[1], 64),
               "knn_edge_fn": lambda *a: plain_edges(
                   egcl_knn.egcl_knn_edges_compute, a, a[4].shape[-1], 64)}
    layer_kw = {**LAYER, **kw}
    layer = EGCL(HDIM, layer_kw.pop("m_hidden"), layer_kw.pop("m_out"),
                 layer_kw.pop("x_hidden"), layer_kw.pop("h_hidden"),
                 layer_kw.pop("h_out"), compute_dtype=dtype, **layer_kw,
                 **fns)
    layer.load_state_dict(checkpoint.state_dict_from_flax(params))
    ht, xt, mt = (torch.from_numpy(a) for a in (h, x, mask))
    edges = knn_edges(xt, mt, K) if topology == "knn" else None
    with torch.no_grad():
        hn, xn = layer(ht, xt, mt, edges)
    ht.requires_grad_()
    xt.requires_grad_()
    hg, xg = layer(ht, xt, mt, edges)
    ((hg.float() * torch.from_numpy(cot[0])).sum()
     + (xg * torch.from_numpy(cot[1])).sum()).backward()
    grads = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    grads.update({"input.h": ht.grad.numpy(), "input.x": xt.grad.numpy()})
    return hn.float().numpy(), (xn - xt.detach()).numpy(), grads


def _draw(topology, seed, names=VNODE, **kw):
    h, x, mask = _layer_inputs(seed)
    edges = (jax_knn_edges(jnp.asarray(x), jnp.asarray(mask), K)
             if topology == "knn" else dense_pair_mask(jnp.asarray(mask)))
    params = live(JaxEGCL(**{**LAYER, **kw}).init(
        jax.random.key(0), h, x, edges, mask), names)
    rng = np.random.default_rng(5)
    cot = (rng.normal(size=h.shape).astype(np.float32),
           rng.normal(size=x.shape).astype(np.float32))
    return h, x, mask, edges, params, cot


def _ratios(got, j16, j32) -> list:
    """Each output's distance from JAX's bf16 value over JAX's own
    bf16-to-f32 distance."""
    return [_rel(got[i], j16[i]) / _rel(j16[i], j32[i]) for i in (0, 1)]


def _pooled_vjp(got, j16, j32) -> float:
    num = den = 0.0
    for k in j16[2]:
        num += _rel(got[2][k], j16[2][k]) ** 2
        den += _rel(j16[2][k], j32[2][k]) ** 2
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def f12_draws():
    """Per draw (topology, seed): the repaired port's ratios (h', x update,
    pooled VJP) and the one-op form's h' ratio."""
    out = {}
    for topology in ("knn", "dense"):
        for seed in SEEDS:
            h, x, mask, edges, params, cot = _draw(topology, seed)
            j16 = _jax_layer(params, h, x, edges, mask, cot, jnp.bfloat16)
            j32 = _jax_layer(params, h, x, edges, mask, cot, jnp.float32)
            got = _port_layer(params, h, x, mask, topology, cot,
                              torch.bfloat16)
            with one_op_node_side():
                old = _port_layer(params, h, x, mask, topology, cot,
                                  torch.bfloat16)
            out[topology, seed] = (*_ratios(got, j16, j32),
                                   _pooled_vjp(got, j16, j32),
                                   _ratios(old, j16, j32)[0])
    return out


@pytest.mark.parametrize("topology", ["knn", "dense"])
@pytest.mark.parametrize("seed", SEEDS)
def test_node_side_matches_jax_bf16(f12_draws, topology, seed):
    h_ratio, x_ratio, vjp, _ = f12_draws[topology, seed]
    assert h_ratio <= OUT_RATIO, h_ratio
    assert x_ratio <= OUT_RATIO, x_ratio
    assert vjp <= VJP_RATIO, vjp


def test_one_op_node_side_reads_beyond_the_bound(f12_draws):
    old = [r[3] for r in f12_draws.values()]
    assert len(old) == 6
    assert float(np.sqrt(np.mean(np.square(old)))) > OUT_RATIO, old


@pytest.mark.parametrize("topology", ["knn", "dense"])
def test_float32_is_the_form_before_the_repair_bit_for_bit(topology):
    h, x, mask, edges, params, cot = _draw(topology, 2)
    for jax_route in (True, False):
        got = _port_layer(params, h, x, mask, topology, cot, torch.float32,
                          jax_route=jax_route)
        with one_op_node_side():
            want = _port_layer(params, h, x, mask, topology, cot,
                               torch.float32, jax_route=jax_route)
        for a, b in zip(got[:2], want[:2]):
            assert np.array_equal(a, b)
        for k in want[2]:
            assert np.array_equal(got[2][k], want[2][k]), k


# -- F13: the plain route's bf16 statement --------------------------------

PLAIN = {"rbf": (dict(**RBF, virtual_node=False), "knn", RBF_LEAVES),
         "rbf_dense": (dict(**RBF, virtual_node=False), "dense",
                       RBF_LEAVES),
         "compat": (dict(compat_scalar_norm=True, virtual_node=False),
                    "dense", ())}


@contextlib.contextmanager
def float32_plain_statement():
    """The plain route as it was before F13's repair: the float32
    statement in every dtype."""
    saved = (egcl_pair.egcl_pair_edges_compute,
             egcl_knn.egcl_knn_edges_compute)
    egcl_pair.egcl_pair_edges_compute = egcl_pair.egcl_pair_edges_reference
    egcl_knn.egcl_knn_edges_compute = egcl_knn.egcl_knn_edges_reference
    try:
        yield
    finally:
        (egcl_pair.egcl_pair_edges_compute,
         egcl_knn.egcl_knn_edges_compute) = saved


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_plain_route_matches_jax_bf16(case):
    kw, topology, names = PLAIN[case]
    h, x, mask, edges, params, cot = _draw(topology, 2, names, **kw)
    j16 = _jax_layer(params, h, x, edges, mask, cot, jnp.bfloat16, **kw)
    j32 = _jax_layer(params, h, x, edges, mask, cot, jnp.float32, **kw)
    before = egnn.plain_edge_calls
    got = _port_layer(params, h, x, mask, topology, cot, torch.bfloat16,
                      jax_route=False, **kw)
    assert egnn.plain_edge_calls == before + 2    # sampling's call, training's
    with float32_plain_statement():
        old = _port_layer(params, h, x, mask, topology, cot,
                          torch.bfloat16, jax_route=False, **kw)
    for name, r, o in zip(("h'", "x update"), _ratios(got, j16, j32),
                          _ratios(old, j16, j32)):
        assert r <= OUT_RATIO, (name, r)
        assert o > OUT_RATIO, (name, o)


# -- F9 steps (f) and (g): the card's records by the rule -----------------

def test_the_card_record_of_the_variants_with_f12():
    """F9 step (d)'s replay run again with F12 (``f9_variants_card_f12.
    json``), made with the node MLP in JAX's rounding in training too (a
    form the committed tree leaves out, ``training_form``): the port (2b)
    keeps the virtual-node channel within the band around JAX's float32
    track at step 150, every tree gap within the rule, and its loss parts
    from JAX's bfloat16 loss over steps 91-100 (outcome ii), as every
    variant's does in that form, and as 2a's (JAX's route) did before F12
    (``f9_variants_card.json``)."""
    with open(full.FIXTURES / "f9_variants_card_f12.json") as f:
        rec = json.load(f)
    assert "node MLP in JAX's rounding" in rec["training_form"]
    assert rec["card"].startswith("NVIDIA H100")
    variants = rec["variants"]
    assert sorted(variants) == sorted(full.VARIANTS)
    for v, r in variants.items():
        assert r["gaps"] == r["gaps_by_step"][str(full.VNODE_GAP_STEP)]
        assert r["names_the_cause"] == full.names_the_cause(r["gaps"]), v
        assert r["verdict"]["float32"]["held"], v
        assert r["verdict"]["bfloat16"]["gap_records_off"] == [], v
        assert r["verdict"]["bfloat16"]["loss_blocks_off"] == [91], v
    port = variants["2b"]
    assert full.names_the_cause(port["gaps"])
    assert port["verdict"]["outcome"] == "ii"
    assert full.decision(variants) is None
    assert not rec["as_is_held"]
    with open(full.FIXTURES / "f9_variants_card.json") as f:
        before = json.load(f)["variants"]
    assert before["2a"]["verdict"]["bfloat16"]["loss_blocks_off"] == [91]


def test_the_card_record_of_the_variants_on_the_committed_tree():
    """The variants on the committed tree (``f9_variants_card_g.json``,
    the virtual-node channel in JAX's rounding in training, the node MLP
    in torch's), before the (g) that F9's rule reads: the port (2b) names
    the cause at outcome (i), so ``decision`` is 2b, as the rule asks. The
    route before F11 (as_is) now reads inside the band too, its loss off
    JAX's bf16 over steps 91-100 (outcome ii): since F12 the measure no
    longer separates F11."""
    with open(full.FIXTURES / "f9_variants_card_g.json") as f:
        rec = json.load(f)
    assert rec["card"].startswith("NVIDIA H100")
    assert rec["steps"] == full.VNODE_GAP_STEP
    variants = rec["variants"]
    assert sorted(variants) == sorted(full.VARIANTS)
    for v, r in variants.items():
        assert r["gaps"] == r["gaps_by_step"][str(full.VNODE_GAP_STEP)]
        assert r["names_the_cause"] == full.names_the_cause(r["gaps"]), v
        assert r["names_the_cause"], v
        assert r["verdict"]["float32"]["held"], v
        assert r["verdict"]["bfloat16"]["gap_records_off"] == [], v
    port = variants["2b"]
    assert port["verdict"]["outcome"] == "i"
    assert port["verdict"]["bfloat16"]["loss_blocks_off"] == []
    assert full.decision(variants) == rec["decision"] == "2b"
    assert variants["as_is"]["verdict"]["outcome"] == "ii"
    assert not rec["as_is_held"]


def decide_f9(f_score, g_score) -> str:
    """``ROADMAP.md`` §3's rule on the aggregate RDF cosine at sampling
    seed 2024 of (f) (None if not run) and (g)."""
    if g_score is not None and g_score >= GATE:
        return "closed"
    if f_score is None:
        return "open: (f) next"
    if f_score >= GATE:
        return "open: bf16 training"
    return "not reachable here"


def _record(name):
    path = full.FIXTURES / f"{name}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def test_the_card_records_decide_f9():
    timing = _record("f9_f_timing")
    assert timing["compute_dtype"] == "float32"
    assert timing["card"].startswith("NVIDIA H100")
    assert timing["segment"]["to_epoch"] - timing["segment"][
        "from_epoch"] == 20
    fits = timing["projected_call_s"] <= FIT_S
    f_rec = _record("size_gen_192_hres_vn_seed2024_f32")
    # (f) runs only where its projection fits one call
    assert (f_rec is not None) == fits
    # (g) on the committed tree (its node MLP in torch's rounding under
    # autograd); the _f12 record ran with it in JAX's rounding in training
    # too, and stays as that form's record
    g_rec = _record("size_gen_192_hres_vn_seed2024_g")
    assert "torch's (F.linear, F.silu) in training" in g_rec["repair"]
    other = _record("size_gen_192_hres_vn_seed2024_f12")
    assert "node MLP in JAX's rounding" in other["training_form"]
    scores = []
    for rec, dtype in ((f_rec, "float32"), (g_rec, "bfloat16")):
        if rec is None:
            scores.append(None)
            continue
        assert rec["compute_dtype"] == dtype
        assert rec["seed"] == 2024 and rec["sample_seed"] == 2024
        assert rec["epochs_done"] == 2000
        score = rec["sizes"]["n192"]["aggregate_rdf_cos"]
        assert rec["sample_seeds"]["2024"]["aggregate_rdf_cos"] == score
        assert rec["gate_met_at_2024"] == (score >= GATE)
        scores.append(score)
    assert decide_f9(*scores) == F9_OUTCOME


def test_the_rule_reads_each_outcome():
    assert decide_f9(None, 0.90) == "closed"
    assert decide_f9(0.85, 0.881) == "closed"
    assert decide_f9(0.90, 0.86) == "open: bf16 training"
    assert decide_f9(0.85, 0.86) == "not reachable here"
    assert decide_f9(None, 0.86) == "open: (f) next"
    assert decide_f9(None, None) == "open: (f) next"


# The outcome ROADMAP.md §3 states for F9 after steps (f) and (g).
F9_OUTCOME = "open: (f) next"


def readings() -> dict:
    """The ratios these tests hold, for the record (``ROADMAP.md`` §3 F12,
    F13): per draw the port's and the one-op form's h' and x-update ratios
    and pooled VJP; per plain-route case the port's and the float32
    statement's."""
    out = {}
    for topology in ("knn", "dense"):
        for seed in SEEDS:
            h, x, mask, edges, params, cot = _draw(topology, seed)
            j16 = _jax_layer(params, h, x, edges, mask, cot, jnp.bfloat16)
            j32 = _jax_layer(params, h, x, edges, mask, cot, jnp.float32)
            got = _port_layer(params, h, x, mask, topology, cot,
                              torch.bfloat16)
            with one_op_node_side():
                old = _port_layer(params, h, x, mask, topology, cot,
                                  torch.bfloat16)
            out[f"{topology}_{seed}"] = {
                "port": _ratios(got, j16, j32) + [_pooled_vjp(got, j16, j32)],
                "one_op": _ratios(old, j16, j32) + [_pooled_vjp(old, j16,
                                                                j32)]}
    for case, (kw, topology, names) in sorted(PLAIN.items()):
        h, x, mask, edges, params, cot = _draw(topology, 2, names, **kw)
        j16 = _jax_layer(params, h, x, edges, mask, cot, jnp.bfloat16, **kw)
        j32 = _jax_layer(params, h, x, edges, mask, cot, jnp.float32, **kw)
        got = _port_layer(params, h, x, mask, topology, cot, torch.bfloat16,
                          jax_route=False, **kw)
        with float32_plain_statement():
            old = _port_layer(params, h, x, mask, topology, cot,
                              torch.bfloat16, jax_route=False, **kw)
        out[case] = {"port": _ratios(got, j16, j32)
                     + [_pooled_vjp(got, j16, j32)],
                     "float32_statement": _ratios(old, j16, j32)
                     + [_pooled_vjp(old, j16, j32)]}
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu PYTHONPATH=.:tests python \
    #     tests/test_torch_node_statement.py
    # (h' ratio, x-update ratio, pooled VJP ratio) of each form
    jax.config.update("jax_platforms", "cpu")
    print(json.dumps({k: {f: [round(r, 3) for r in v] for f, v in d.items()}
                      for k, d in readings().items()}, indent=1))

