"""The compute-dtype edge statements (``ops.egcl_knn.egcl_knn_edges_compute``,
``ops.egcl_pair.egcl_pair_edges_compute``), the statement the JAX package's
training differentiates, and F11's repair (``ROADMAP.md`` §3), on the CPU at
small widths; then F9 step (d)'s measure read from the committed fixtures.

* float32: each statement is its float32 reference (kNN with and without a
  radial-basis term, dense with a radial-basis term and with the per-graph
  norm), outputs and VJP at 1e-6 of their scale (``F32_TOL``).
* bfloat16: an EGCL whose edge work is the compute-dtype statement under
  plain autograd (JAX's route: no kernel) against the JAX package's flax
  ``EGCL`` at bfloat16 under ``jax.jit``, kNN with the virtual node and
  ``h_residual``, and dense. The measure of each quantity is its relative
  L2 distance from JAX's bfloat16 value over JAX's own bfloat16-to-float32
  distance. The message sum that reaches the node MLP (read from inside
  the flax module) and the coordinate update are held to ``OUT_RATIO``,
  the VJP (every parameter and both inputs) to ``VJP_RATIO`` pooled over
  the leaves and ``VJP_LEAF_RATIO`` leaf by leaf. These bounds are looser
  than a quarter of JAX's own gap: XLA on the CPU absorbs some bfloat16
  roundings into float32 fusions (a product whose sum is upcast) and sums
  the bias cotangents in bfloat16, which no op-by-op statement reproduces.
  On the same inputs the float32 statement (the route before F11's
  repair) and the compute statement with torch's one-op SiLU and sigmoid
  (``train_step_times.route_context("fused")``) read both outputs beyond
  ``OUT_RATIO``: the op-by-op sigmoid (``ops.egcl_pair.logistic``) is
  what brings the statement inside it.
* F11: a bfloat16 train step through the edge functions (K2's stand-in on
  the CPU: the float32 reference forward) gives the gradients of the
  compute-dtype statement's backward, to ``ROUTE_TOL``, the virtual-node
  leaves among them; the route before the repair (the float32 reference's
  gradient) lies further than that. (One train step's virtual-node
  gradients against JAX's bfloat16 step do not tell the two routes apart
  on the CPU: the forward's roundings dominate them. The shrink that F11
  names grows over ~100 steps at full width on the card.)
* the card's record of step (d) (``f9_variants_card.json``), read by the
  rule: as_is outside the band around JAX's float32 track, 2b inside it,
  the decision 2b.
* ``vnode_group_gaps`` on the committed fixtures returns the table of
  ``ROADMAP.md`` §3 at step 150, and its code there is the script's.
"""

import inspect
import json
import re
from pathlib import Path

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_replay_training_full as full
import train_step_times
from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.nn.egnn import EGCL as JaxEGCL
from diffusion_model_tpu.ops.edges import dense_pair_mask
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.nn.egnn import EGCL, plain_edges
from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train import checkpoint
from diffusion_model_tpu_torch.train.trainer import Trainer
from test_torch_rbf import VNODE, live
from test_torch_trainer import np_tree, tiny_data
from torch_port_fixtures import (
    ReplayDraws,
    edge_args,
    edge_inputs,
    jax_loss_draws,
    knn_args,
    knn_inputs,
    port_batch,
)

torch.set_num_threads(4)

F32_TOL = 1e-6
OUT_RATIO = 0.6
VJP_RATIO = 0.95
VJP_LEAF_RATIO = 1.25
ROUTE_TOL = 1e-5
K = 4
HDIM = 8
LAYER = dict(m_hidden=64, m_out=64, x_hidden=64, h_hidden=32, h_out=HDIM,
             zero_init_x=False, h_residual=True, virtual_node=True)
REPO = Path(__file__).resolve().parents[1]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# -- float32: the statement is the reference ------------------------------

def _rbf(f1: int, seed: int):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy((rng.normal(size=(6, f1)) * 0.3).astype(
        np.float32)) for _ in range(2)) + (4.0,)


def _case(case: str):
    """(compute statement, reference, args, differentiable indices,
    keywords) of one float32 case."""
    if case.startswith("knn"):
        args = knn_args(knn_inputs(3, k=K))
        diff = [i for i, n in enumerate(egcl_knn._NAMES)
                if n not in ("idx", "edge_mask")]
        kw = {"rbf": _rbf(32, 4)} if case == "knn_rbf" else {}
        return (egcl_knn.egcl_knn_edges_compute,
                egcl_knn.egcl_knn_edges_reference, args, diff, kw)
    args = edge_args(edge_inputs(5))
    diff = [i for i, n in enumerate(egcl_pair._NAMES) if n != "mask"]
    kw = {}
    if case == "pair_rbf":
        kw["rbf"] = _rbf(32, 6)
    if case == "pair_norm":
        kw["norm"] = egcl_pair.compat_norm(args[4], args[5][..., 0])
    return (egcl_pair.egcl_pair_edges_compute,
            egcl_pair.egcl_pair_edges_reference, args, diff, kw)


def _outputs_and_vjp(fn, args, diff, kw, cot=None):
    leaves = [a.clone().requires_grad_(i in diff) for i, a in enumerate(args)]
    out = fn(*leaves, **kw)
    if cot is None:
        rng = np.random.default_rng(11)
        cot = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
               for o in out]
    grads = torch.autograd.grad(out, [leaves[i] for i in diff], cot)
    return [o.detach() for o in out], list(grads), cot


@pytest.mark.parametrize("case", ["knn", "knn_rbf", "pair", "pair_rbf",
                                  "pair_norm"])
def test_compute_statement_in_float32_is_the_reference(case):
    compute, reference, args, diff, kw = _case(case)
    got_out, got_grads, cot = _outputs_and_vjp(compute, args, diff, kw)
    want_out, want_grads, _ = _outputs_and_vjp(reference, args, diff, kw,
                                               cot)
    for g, w in zip(got_out + got_grads, want_out + want_grads):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(
            g.numpy(), w.numpy(), rtol=F32_TOL,
            atol=F32_TOL * float(w.abs().max()))


def test_compute_statement_keeps_the_compute_dtype_and_float32_geometry():
    args = knn_args(knn_inputs(1, k=K), dtype=torch.bfloat16)
    m, x = egcl_knn.egcl_knn_edges_compute(*args)
    assert m.dtype == torch.bfloat16 and x.dtype == torch.float32
    args = edge_args(edge_inputs(2), dtype=torch.bfloat16)
    m, x = egcl_pair.egcl_pair_edges_compute(*args)
    assert m.dtype == torch.bfloat16 and x.dtype == torch.float32


# -- bfloat16: the statement against the JAX package's flax EGCL ----------

def _layer_inputs(seed=2, b=2, n=10):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[1, 6:] = 0.0
    h = (rng.normal(size=(b, n, HDIM)) * mask[..., None]).astype(np.float32)
    x = (rng.normal(size=(b, n, 3)) * 1.5 * mask[..., None]).astype(
        np.float32)
    return h, x, mask


def _jax_layer(params, h, x, edges, mask, cot, dtype):
    """JAX's bf16 (or f32) EGCL under jit: (message sum reaching the node
    MLP, coordinate update, VJP by the port's names, d/dh, d/dx)."""
    layer = JaxEGCL(**LAYER, compute_dtype=dtype)

    def run(p, h, x):
        seen = {}

        def spy(f, args, kwargs, ctx):
            if ctx.module.name == "mlp_h_dense0" and \
                    ctx.method_name == "__call__":
                seen["cat"] = args[0]
            return f(*args, **kwargs)

        with flax_nn.intercept_methods(spy):
            hn, xn = layer.apply(p, h, x, edges, mask)
        loss = jnp.sum(hn * cot[0]) + jnp.sum(xn * cot[1])
        return loss, (seen["cat"][..., HDIM:], xn)

    (_, (m_sum, xn)), (gp, gh, gx) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1, 2), has_aux=True))(params, h, x)
    grads = {k: v.numpy() for k, v in checkpoint.state_dict_from_flax(
        jax.tree.map(np.asarray, gp)).items()}
    grads.update({"input.h": np.asarray(gh), "input.x": np.asarray(gx)})
    return np.asarray(m_sum, np.float32), np.asarray(xn) - x, grads


def _port_layer(params, h, x, mask, topology, cot, dtype,
                statement="compute"):
    """The port's EGCL on one edge statement under plain autograd (JAX's
    route): the same readings as ``_jax_layer``. ``statement`` is
    ``compute`` (``egcl_*_edges_compute``) or ``reference`` (the float32
    statement, whose gradient a bf16 model took before F11's repair)."""
    seen = {}
    pair_fn = getattr(egcl_pair, f"egcl_pair_edges_{statement}")
    knn_fn = getattr(egcl_knn, f"egcl_knn_edges_{statement}")

    def pair(*a):
        m, xo = plain_edges(pair_fn, a, a[0].shape[1], 64)
        seen["m"] = m
        return m, xo

    def knn(*a):
        m, xo = plain_edges(knn_fn, a, a[4].shape[-1], 64)
        seen["m"] = m
        return m, xo

    layer = EGCL(HDIM, 64, 64, 64, 32, HDIM, compute_dtype=dtype,
                 zero_init_x=False, h_residual=True, virtual_node=True,
                 edge_fn=pair, knn_edge_fn=knn)
    layer.load_state_dict(checkpoint.state_dict_from_flax(params))
    channel = layer._virtual_channel

    def spy_channel(*a):
        out = channel(*a)
        seen["vn"] = out[0]
        return out

    layer._virtual_channel = spy_channel
    ht, xt, mt = (torch.from_numpy(a) for a in (h, x, mask))
    ht.requires_grad_()
    xt.requires_grad_()
    edges = knn_edges(xt.detach(), mt, K) if topology == "knn" else None
    hn, xn = layer(ht, xt, mt, edges)
    ((hn.float() * torch.from_numpy(cot[0])).sum()
     + (xn * torch.from_numpy(cot[1])).sum()).backward()
    m_sum = (seen["m"] + seen["vn"].to(seen["m"].dtype)).float()
    grads = {k: p.grad.numpy() for k, p in layer.named_parameters()}
    grads.update({"input.h": ht.grad.numpy(), "input.x": xt.grad.numpy()})
    return (m_sum.detach().numpy(), (xn - xt).detach().numpy(), grads)


@pytest.mark.parametrize("topology", ["knn", "dense"])
def test_compute_statement_layer_matches_jax_bf16(topology):
    h, x, mask = _layer_inputs()
    edges = (jax_knn_edges(jnp.asarray(x), jnp.asarray(mask), K)
             if topology == "knn" else dense_pair_mask(jnp.asarray(mask)))
    params = live(JaxEGCL(**LAYER).init(jax.random.key(0), h, x, edges,
                                        mask), VNODE)
    rng = np.random.default_rng(5)
    cot = (rng.normal(size=h.shape).astype(np.float32),
           rng.normal(size=x.shape).astype(np.float32))
    j16 = _jax_layer(params, h, x, edges, mask, cot, jnp.bfloat16)
    j32 = _jax_layer(params, h, x, edges, mask, cot, jnp.float32)
    got = _port_layer(params, h, x, mask, topology, cot, torch.bfloat16)
    # the float32 statement (the route before F11's repair) and the compute
    # statement with torch's one-op SiLU and sigmoid read the outputs
    # beyond the bound that the compute statement meets
    old = _port_layer(params, h, x, mask, topology, cot, torch.bfloat16,
                      statement="reference")
    with train_step_times.route_context("fused"):
        fused = _port_layer(params, h, x, mask, topology, cot,
                            torch.bfloat16)
    for i, name in enumerate(("m_sum", "x update")):
        gap = _rel(j16[i], j32[i])
        ratio = _rel(got[i], j16[i]) / gap
        assert ratio <= OUT_RATIO, (name, ratio)
        for form, other in (("float32", old), ("fused", fused)):
            assert _rel(other[i], j16[i]) / gap > OUT_RATIO, (name, form)
    names = sorted(j16[2])
    assert sorted(got[2]) == names
    pooled = [0.0, 0.0]
    for k in names:
        gap = _rel(j16[2][k], j32[2][k])
        ratio = _rel(got[2][k], j16[2][k]) / gap
        assert ratio <= VJP_LEAF_RATIO, (k, ratio)
        pooled[0] += _rel(got[2][k], j16[2][k]) ** 2
        pooled[1] += gap ** 2
    assert (pooled[0] / pooled[1]) ** 0.5 <= VJP_RATIO, pooled


# -- F11: the bf16 train step differentiates the compute-dtype statement --

TRAIN = dict(n_max=8, L=2, m_hidden_size=64, h_hidden_size=32,
             x_hidden_size=64, m_size=64, spectrum_size=32,
             compressed_spectrum_size=8, compressor_hidden_dim=(16,),
             num_diffusion_timestep=50, batch_size=4, lr=1e-3,
             optimizer="Adam", neighbor_k=3, virtual_node=True,
             h_residual=True, compute_dtype="bfloat16")


class _StatementBackward(torch.autograd.Function):
    """``statement``'s forward-free VJP at the primals' own dtype, whole
    (no chunks), after the float32 reference's forward: what F11's repair
    makes the edge functions compute, written out here."""

    @staticmethod
    def forward(ctx, reference, statement, data, *args):
        ctx.statement, ctx.data = statement, data
        ctx.save_for_backward(*args)
        with torch.no_grad():
            return reference(*args)

    @staticmethod
    def backward(ctx, g_m, g_x):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(i not in ctx.data)
                      for i, a in enumerate(saved)]
            out = ctx.statement(*leaves)
            wanted = [a for i, a in enumerate(leaves) if i not in ctx.data]
            grads = iter(torch.autograd.grad(
                out, wanted, (g_m.to(out[0].dtype), g_x.to(out[1].dtype)),
                allow_unused=True))
        return (None, None, None, *(
            None if i in ctx.data else next(grads)
            for i in range(len(saved))))


def _statement_fns() -> dict:
    def pair(*a):
        return _StatementBackward.apply(
            egcl_pair.egcl_pair_edges_reference,
            egcl_pair.egcl_pair_edges_compute, (5,), *a)

    def knn(*a):
        return _StatementBackward.apply(
            egcl_knn.egcl_knn_edges_reference,
            egcl_knn.egcl_knn_edges_compute, (4, 5), *a)

    return {"edge_fn": pair, "knn_edge_fn": knn}


def _train_step_grads(params, jcfg, key, jb, **edge_fns) -> dict:
    trainer = Trainer(from_dict(jcfg.to_dict()), device="cpu", **edge_fns)
    state = trainer.init_state(0, params=np_tree(params))
    *_, grads = trainer.loss_and_grads(
        state, ReplayDraws(jax_loss_draws(key, jcfg, 4, jcfg.n_max)),
        port_batch(jb))
    return {k: v.detach().numpy() for k, v in grads.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_train_step_differentiates_the_compute_statement(seed):
    jcfg = JaxConfig(**TRAIN)
    jb = next(jax_split.batch_iterator(tiny_data(jcfg, seed=seed), 4,
                                       jcfg.n_max, seed=1))
    params = JaxTrainer(jcfg).init_state(jax.random.key(seed), jb,
                                         skip_gamma_fit=True).params
    params = {**params, "denoiser": live(params["denoiser"], VNODE,
                                         seed=seed + 1)}
    key = jax.random.key(5 + seed)
    got = _train_step_grads(params, jcfg, key, jb)
    want = _train_step_grads(params, jcfg, key, jb, **_statement_fns())
    before = _train_step_grads(params, jcfg, key, jb,
                               **full.variant_edge_fns("as_is"))
    vnode = [k for k in want if ".vnode_" in k]
    assert len(vnode) == 10 * TRAIN["L"]
    for k in want:
        scale = float(np.abs(want[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=ROUTE_TOL,
                                   atol=ROUTE_TOL * scale, err_msg=k)
    # the route before the repair reads further than the bound
    assert max(_rel(before[k], want[k]) for k in vnode) > 10 * ROUTE_TOL


# -- F9 step (d)'s measure on the committed fixtures ----------------------

# ROADMAP.md §3's table at step 150, per layer (percent)
PORT_BF16_150 = (-3.43, -3.41, -3.48, -3.37, -3.12)
JAX_BF16_150 = (0.98, 0.64, 0.58, -0.13, -0.34)


def test_vnode_group_gaps_reads_the_table_from_the_fixtures():
    meta, npz = full.load_fixture()
    names = meta["sketch"]["names"]
    with open(full.CARD_RECORD) as f:
        card = json.load(f)
    step = full.VNODE_GAP_STEP
    ref = npz[f"float32_{step}_norms"]
    port = next(r for r in card["tracks"]["bfloat16"]["records"]
                if r["step"] == step)["norms"]
    got = full.vnode_group_gaps(names, port, ref)
    np.testing.assert_allclose(got, PORT_BF16_150, atol=0.01)
    got = full.vnode_group_gaps(names, npz[f"bfloat16_{step}_norms"], ref)
    np.testing.assert_allclose(got, JAX_BF16_150, atol=0.01)
    assert not full.names_the_cause(PORT_BF16_150)
    assert full.names_the_cause(JAX_BF16_150)


def test_the_card_record_decides_f11():
    """The committed record of step (d) on the card, read by the rule: the
    route before the repair (as_is) reproduces the shrink of the card's
    first record (``train_replay_full_card.json``) and lies outside the
    band around JAX's float32 track, the repaired route (2b) inside it,
    and the decision is 2b."""
    with open(full.FIXTURES / "f9_variants_card.json") as f:
        rec = json.load(f)
    variants = rec["variants"]
    assert sorted(variants) == sorted(full.VARIANTS)
    for v, r in variants.items():
        assert max(int(s) for s in r["gaps_by_step"]) == full.VNODE_GAP_STEP
        assert r["gaps"] == r["gaps_by_step"][str(full.VNODE_GAP_STEP)]
        assert r["names_the_cause"] == full.names_the_cause(r["gaps"]), v
        assert r["verdict"]["float32"]["held"], v
    assert not full.names_the_cause(variants["as_is"]["gaps"])
    np.testing.assert_allclose(variants["as_is"]["gaps"], full.AS_IS_GAPS,
                               atol=full.AS_IS_TOL)
    assert full.names_the_cause(variants["2b"]["gaps"])
    assert variants["2b"]["verdict"]["outcome"] == "i"
    assert full.decision(variants) == rec["decision"] == "2b"


def test_the_rule_in_the_roadmap_is_the_scripts():
    text = (REPO / "ROADMAP.md").read_text()
    block = re.search(r"```python\n(.*?)```", text[text.index(
        "Step (d)'s rule"):], re.S).group(1)
    block = "\n".join(line[4:] if line.startswith("    ") else line
                      for line in block.splitlines())
    source = inspect.getsource(full)
    start = source.index("VNODE_GAP_LEAVES = (")
    end = source.index("# -- the variants of F9 step (d)")
    assert block.strip() == source[start:end].strip()
