"""Gradients of the port's EGCL edge functions (``ops.edge_grad``) against
the JAX package's ``custom_vjp``\\ s run through their Pallas kernels in
interpret mode, as ``tests/test_pallas_egcl.py`` and
``tests/test_pallas_sparse.py`` run them; and the Function's own machinery
(detached forward, chunked float32 backward) against plain autograd.

On the CPU the Function's forward is the plain statement standing in for
the kernel; the card's check of the kernel forward with this backward is
``chip_smoke.py``'s ``train_grad`` phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.ops.egcl_pallas import egcl_pair_edges as jax_pair
from diffusion_model_tpu.ops.egcl_pallas_sparse import (
    egcl_knn_edges as jax_knn,
)
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.ops import edge_grad, egcl_knn, egcl_pair
from torch_port_fixtures import edge_args, edge_inputs, knn_args, knn_inputs

torch.set_num_threads(4)

PAIR_DIFF = [i for i, k in enumerate(egcl_pair._NAMES) if k != "mask"]
KNN_DIFF = [i for i, k in enumerate(egcl_knn._NAMES)
            if k not in ("idx", "edge_mask")]


def _cotangents(seed, m_sum, x_out):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=m_sum.shape).astype(np.float32),
            rng.normal(size=x_out.shape).astype(np.float32))


def _port_grads(fn, args, diff, cot):
    args = [a.clone().requires_grad_(i in diff) for i, a in enumerate(args)]
    m, x = fn(*args)
    torch.autograd.backward((m, x), tuple(torch.from_numpy(c) for c in cot))
    return [args[i].grad for i in diff]


def _jax_grads(fn, args, diff, cot):
    def loss(*d):
        full = list(args)
        for i, v in zip(diff, d):
            full[i] = v
        m, x = fn(*full)
        return jnp.sum(m * cot[0]) + jnp.sum(x * cot[1])

    return jax.grad(loss, argnums=tuple(range(len(diff))))(
        *(args[i] for i in diff))


@pytest.mark.parametrize("seed,n_real", [(0, (11, 16)), (1, (3, 9))])
def test_pair_grads_match_jax_custom_vjp(seed, n_real):
    inputs = edge_inputs(seed, n_real=n_real)
    args = edge_args(inputs)
    jargs = [jnp.asarray(inputs[k]) for k in egcl_pair._NAMES]
    m, x = egcl_pair.egcl_pair_edges_reference(*args)
    cot = _cotangents(seed + 10, m, x)
    got = _port_grads(egcl_pair.egcl_pair_edges, args, PAIR_DIFF, cot)
    want = _jax_grads(lambda *a: jax_pair(*a, 8, True), jargs, PAIR_DIFF,
                      cot)
    for i, g, w in zip(PAIR_DIFF, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-5, err_msg=egcl_pair._NAMES[i])


@pytest.mark.parametrize("seed,k", [(0, 4), (2, 15)])
def test_knn_grads_match_jax_custom_vjp(seed, k):
    inputs = knn_inputs(seed, k=k)
    args = knn_args(inputs)
    jargs = [jnp.asarray(inputs[name]) for name in egcl_knn._NAMES]
    m, x = egcl_knn.egcl_knn_edges_reference(*args)
    cot = _cotangents(seed + 20, m, x)
    got = _port_grads(egcl_knn.egcl_knn_edges, args, KNN_DIFF, cot)
    want = _jax_grads(lambda *a: jax_knn(*a, 8, True), jargs, KNN_DIFF, cot)
    for i, g, w in zip(KNN_DIFF, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-3,
                                   atol=5e-5, err_msg=egcl_knn._NAMES[i])


def test_padded_rows_get_zero_gradient():
    inputs = edge_inputs(5, n_real=(6, 12))
    args = edge_args(inputs)
    m, x = egcl_pair.egcl_pair_edges_reference(*args)
    cot = _cotangents(7, m, x)
    names = egcl_pair._NAMES
    grads = dict(zip([names[i] for i in PAIR_DIFF], _port_grads(
        egcl_pair.egcl_pair_edges, args, PAIR_DIFF, cot)))
    pad = args[5][..., 0] == 0
    for name in ("am_i", "am_j", "ax_i", "ax_j"):
        assert torch.equal(grads[name][pad],
                           torch.zeros_like(grads[name][pad])), name
    # a padded x row moves only through its own x_out = x identity
    torch.testing.assert_close(grads["x"][pad],
                               torch.from_numpy(cot[1])[pad], rtol=0, atol=0)


def test_knn_padded_targets_get_zero_gradient():
    inputs = knn_inputs(6, k=5, n_real=(7, 16))
    args = knn_args(inputs)
    m, x = egcl_knn.egcl_knn_edges_reference(*args)
    cot = _cotangents(8, m, x)
    names = egcl_knn._NAMES
    grads = dict(zip([names[i] for i in KNN_DIFF], _port_grads(
        egcl_knn.egcl_knn_edges, args, KNN_DIFF, cot)))
    pad = args[5].sum(dim=-1) == 0
    node_pad = torch.zeros_like(pad)
    node_pad[0, 7:] = True
    for name in ("am_i", "ax_i"):
        assert torch.equal(grads[name][pad],
                           torch.zeros_like(grads[name][pad])), name
    # padded nodes are nobody's neighbour: their h gets nothing
    assert torch.equal(grads["h"][node_pad],
                       torch.zeros_like(grads["h"][node_pad]))


@pytest.mark.parametrize("kind", ["pair", "knn"])
def test_function_matches_plain_autograd(kind):
    if kind == "pair":
        args, diff = edge_args(edge_inputs(9, n_real=(10, 16))), PAIR_DIFF
        fn, ref = egcl_pair.egcl_pair_edges, \
            egcl_pair.egcl_pair_edges_reference
    else:
        args, diff = knn_args(knn_inputs(9, k=6)), KNN_DIFF
        fn, ref = egcl_knn.egcl_knn_edges, egcl_knn.egcl_knn_edges_reference
    m, x = ref(*args)
    cot = _cotangents(11, m, x)
    got = _port_grads(fn, args, diff, cot)
    want = _port_grads(ref, args, diff, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,budget", [("pair", 16 * 32 * 3),
                                         ("pair", 1), ("knn", 4 * 32 * 5)])
def test_chunked_backward_equals_whole(kind, budget):
    if kind == "pair":
        args = edge_args(edge_inputs(12, n_real=(13, 16)))
        ref, sources, data = egcl_pair.egcl_pair_edges_reference, 16, {5}
    else:
        args = knn_args(knn_inputs(12, k=4))
        ref, sources, data = egcl_knn.egcl_knn_edges_reference, 4, {4, 5}
    needs = [i not in data for i in range(len(args))]
    m, x = ref(*args)
    cot = [torch.from_numpy(c) for c in _cotangents(13, m, x)]
    whole = edge_grad.edge_vjp(ref, args, cot, needs, sources, 32,
                               budget=1 << 30)
    chunks = list(edge_grad.edge_chunks(2, 16, sources, 32, budget))
    assert len(chunks) > 1
    chunked = edge_grad.edge_vjp(ref, args, cot, needs, sources, 32,
                                 budget=budget)
    for i, (c, w) in enumerate(zip(chunked, whole)):
        if needs[i]:
            # float32 sums over other chunks: 1e-6 of the gradient's scale
            torch.testing.assert_close(c, w, rtol=1e-6,
                                       atol=1e-6 * float(w.abs().max()))
        else:
            assert c is None and w is None


def test_bf16_grads_come_back_in_the_primal_dtype():
    args = list(edge_args(edge_inputs(14), dtype=torch.bfloat16))
    args = [a.requires_grad_(a.is_floating_point() and i != 5)
            for i, a in enumerate(args)]
    m, x = egcl_pair.egcl_pair_edges(*args)
    (m.sum() + x.sum()).backward()
    for i, a in enumerate(args):
        if i != 5:
            assert a.grad.dtype == a.dtype, egcl_pair._NAMES[i]
    assert args[5].grad is None


def test_no_grad_mode_takes_the_plain_forward_untracked():
    args = [a.requires_grad_(i != 5) for i, a in
            enumerate(edge_args(edge_inputs(15)))]
    with torch.no_grad():
        m, x = egcl_pair.egcl_pair_edges(*args)
    assert not m.requires_grad and not x.requires_grad


def test_plain_route_is_differentiable():
    """``plain_edges`` writes chunk by chunk into fresh tensors; autograd
    follows the writes to the same gradients as the whole statement."""
    args = [a.requires_grad_(i != 5) for i, a in
            enumerate(edge_args(edge_inputs(16, n_real=(9, 16))))]
    ref = egcl_pair.egcl_pair_edges_reference
    m, x = egnn.plain_edges(ref, tuple(args), 16, 32, budget=16 * 32 * 5)
    assert m.requires_grad and x.requires_grad
    cot = [torch.from_numpy(c) for c in _cotangents(17, m, x)]
    got = torch.autograd.grad((m, x), [args[i] for i in PAIR_DIFF], cot)
    m2, x2 = ref(*args)
    want = torch.autograd.grad((m2, x2), [args[i] for i in PAIR_DIFF], cot)
    for g, w in zip(got, want):
        # float32 sums over other chunks: 1e-6 of the gradient's scale
        torch.testing.assert_close(g, w, rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))
