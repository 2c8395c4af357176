"""The EGCL's two routes for its edge work and its cast weights.

``edge_route`` sends a layer whose widths the kernels do not take to the
plain statement (``plain_edges``, in chunks of targets); the models the JAX
package samples at such widths (``configs/tiny.yaml``'s, and the kNN model
with an uncompressed spectrum, node width 204) are held against JAX on the
CPU through that route, float32 at rtol 2e-4 / atol 2e-5 of the output
scale, as the other denoiser tests. The compute-dtype weights are cast once
per layer and kept; cached and uncached forwards are bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.ops.edges import dense_pair_mask
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu_torch.api import denoiser_from_params
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.egnn import EGCL, edge_route, plain_edges
from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from torch_port_fixtures import edge_args, edge_inputs, knn_args, knn_inputs

torch.set_num_threads(4)

BF16, F32 = torch.bfloat16, torch.float32


# --- the route ---


@pytest.mark.parametrize("widths,dtype,hdim,route", [
    ((1024, 1024, 256), BF16, None, "kernel"),   # the flagship, dense
    ((1024, 1024, 256), BF16, 48, "kernel"),     # kNN at MAX_H
    ((1024, 512, 256), F32, None, "plain"),      # first layers differ
    ((32, 32, 16), F32, None, "plain"),          # configs/tiny.yaml: F1 % 64
    ((320, 320, 96), F32, None, "plain"),        # Fm % 64
    ((256, 256, 320), F32, None, "plain"),       # Fm > 256
    ((1088, 1088, 256), BF16, None, "plain"),    # bf16 F1 > MAX_F1
    ((1088, 1088, 256), F32, None, "kernel"),    # the f32 variant takes it
    ((1024, 1024, 256), F32, 204, "plain"),      # kNN H > MAX_H
])
def test_edge_route_on_each_limit(widths, dtype, hdim, route):
    assert edge_route(*widths, dtype, hdim) == route


def _one_thread():
    """PyTorch's CPU elementwise kernels take a scalar path for the tail of
    a run (and of each thread's share), and its exp differs from the
    vectorised one in the last bit; on one thread, with widths and sources
    multiples of 64, no run has a tail, so the arithmetic of an element does
    not depend on how the work was cut."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    return threads


@pytest.mark.parametrize("budget", [2 * 64 * 64 * 64, 64 * 64 * 64,
                                    64 * 64 * 5, 1])
def test_chunked_pair_route_equals_the_whole_bit_for_bit(budget):
    args = edge_args(edge_inputs(21, b=2, n=64, f1=64, fm=64,
                                 n_real=(64, 37)))
    threads = _one_thread()
    try:
        want = egcl_pair.egcl_pair_edges_reference(*args)
        before = egnn.plain_edge_calls
        got = plain_edges(egcl_pair.egcl_pair_edges_reference, args, 64, 64,
                          budget)
    finally:
        torch.set_num_threads(threads)
    assert egnn.plain_edge_calls == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("budget", [64 * 64 * 72, 64 * 64 * 7, 1])
def test_chunked_knn_route_equals_the_whole_bit_for_bit(budget):
    args = knn_args(knn_inputs(22, b=2, n=72, k=64, hdim=60, f1=64, fm=64,
                               n_real=(72, 69)))
    threads = _one_thread()
    try:
        want = egcl_knn.egcl_knn_edges_reference(*args)
        got = plain_edges(egcl_knn.egcl_knn_edges_reference, args, 64, 64,
                          budget)
    finally:
        torch.set_num_threads(threads)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("budget,graphs,targets", [
    (10**9, 3, 10),          # everything at once
    (2 * 10 * 10 * 32, 2, 10),   # whole graphs, two at a time
    (3 * 10 * 32, 1, 3),     # one graph's targets, three at a time
])
def test_plain_route_keeps_every_intermediate_in_its_budget(budget, graphs,
                                                            targets):
    args = edge_args(edge_inputs(23, b=3, n=10, f1=32, fm=16,
                                 n_real=(10, 4, 7)))
    seen = []

    def reference(*a, targets):
        seen.append((a[0].shape[0], len(range(10)[targets])))
        return egcl_pair.egcl_pair_edges_reference(*a, targets=targets)

    got = plain_edges(reference, args, 10, 32, budget)
    assert max(seen) == (graphs, targets)
    assert all(g * t * 10 * 32 <= budget for g, t in seen)
    want = egcl_pair.egcl_pair_edges_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


# --- models the kernels do not take, against JAX through the plain route ---

TINY = dict(L=2, atom_type_size=2, compressed_spectrum_size=8,
            compressor_hidden_dim=(16,), h_hidden_size=32, m_hidden_size=32,
            m_size=16, x_hidden_size=32, spectrum_size=200,
            num_diffusion_timestep=100, n_max=12, zero_init_x=False,
            compute_dtype="float32")
WIDE_H = dict(L=2, m_hidden_size=64, m_size=64, h_hidden_size=32,
              x_hidden_size=64, spectrum_size=200,
              to_compress_spectrum=False, neighbor_k=4, n_max=12,
              zero_init_x=False, compute_dtype="float32")


def _inputs(seed=0, b=3, n=12, n_real=(12, 7, 3)):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, n), np.float32)
    for g, real in enumerate(n_real):
        mask[g, :real] = 1.0
    m3 = mask[..., None]
    exo = np.zeros((b, n, 1), np.float32)
    exo[:, 0] = 1.0
    return ((rng.normal(size=(b, n, 2)) * m3).astype(np.float32),
            (rng.normal(size=(b, n, 3)) * 1.5 * m3).astype(np.float32),
            rng.random((b, n, 200)).astype(np.float32), exo * m3,
            (0.3 * m3).astype(np.float32), mask)


@pytest.mark.parametrize("widths,knn", [(TINY, False), (WIDE_H, True)],
                         ids=["tiny_dense", "h204_knn"])
def test_models_outside_the_kernels_match_jax_through_the_plain_route(
        widths, knn):
    jcfg = JaxConfig(**widths)
    inputs = _inputs()
    j = [jnp.asarray(a) for a in inputs]
    edges = (jax_knn_edges(j[1], j[5], jcfg.neighbor_k) if knn
             else dense_pair_mask(j[5]))
    params = JaxDenoiser(jcfg).init(jax.random.key(0), *j, edges)
    want = JaxDenoiser(jcfg).apply(params, *j, edges)
    cfg = from_dict(jcfg.to_dict())
    assert cfg.h_size == (204 if knn else 12)
    model = denoiser_from_params(cfg, params, "cpu")
    t = [torch.from_numpy(a) for a in inputs]
    before = egnn.plain_edge_calls
    got = model(*t, knn_edges(t[1], t[5], cfg.neighbor_k) if knn else None)
    assert egnn.plain_edge_calls == before + cfg.L
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5 * scale)


# --- the cast weights ---


def _layer(dtype=BF16, virtual_node=True, seed=0):
    torch.manual_seed(seed)
    layer = EGCL(8, 64, 64, 64, 32, 8, compute_dtype=dtype,
                 virtual_node=virtual_node, h_residual=True)
    with torch.no_grad():
        for p in layer.parameters():
            p.add_(0.1 * torch.randn_like(p))    # biases and heads nonzero
    layer.requires_grad_(False)
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(2, 7, 8, generator=g)
    x = torch.randn(2, 7, 3, generator=g)
    mask = torch.ones(2, 7)
    mask[1, 5:] = 0
    return layer, (h, x, mask, knn_edges(x, mask, 4))


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_cached_weights_give_the_uncached_forward_bit_for_bit(dtype):
    layer, args = _layer(dtype)
    uncached = []
    for _ in range(2):
        layer.drop_compute_weights()
        uncached.append(layer(*args))
    first = layer.compute_weights(dtype)
    cached = layer(*args)
    assert layer.compute_weights(dtype) is first      # kept, not recast
    for out in (cached, uncached[1]):
        for a, b in zip(out, uncached[0]):
            assert torch.equal(a, b)


def test_load_state_dict_after_a_call_changes_the_output():
    layer, args = _layer()
    before = layer(*args)
    other, _ = _layer(seed=1)
    layer.load_state_dict(other.state_dict())
    after = layer(*args)
    want = other(*args)
    assert not torch.equal(after[0], before[0])
    for a, b in zip(after, want):
        assert torch.equal(a, b)


def test_weights_are_cast_again_after_an_inplace_write_or_a_dtype_change():
    layer, args = _layer()
    before = layer(*args)
    with torch.no_grad():
        layer.mlp_h_dense1.weight.mul_(2.0)
        layer.vnode_out.kernel.mul_(0.5)
    after = layer(*args)
    assert not torch.equal(after[0], before[0])
    fresh, _ = _layer()
    fresh.load_state_dict(layer.state_dict())
    for a, b in zip(after, fresh(*args)):
        assert torch.equal(a, b)
    layer.compute_dtype = F32
    fresh.compute_dtype = F32
    fresh.drop_compute_weights()
    assert layer.compute_weights(F32)["heads"][0].dtype == F32
    for a, b in zip(layer(*args), fresh(*args)):
        assert torch.equal(a, b)
