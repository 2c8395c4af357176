"""``compat_scalar_norm`` in the port against the JAX package, on the CPU at
tiny widths: the coordinate update divided by one Frobenius norm of each
graph's masked pair grid in place of each edge's length (JAX
``nn/egnn.py`` ``_dense_call``).

* An EGCL and the denoiser (with and without the virtual node and the
  residual update) on batches whose graphs differ in size, so the per-graph
  norm shows: float32 at rtol 1e-5 / atol 1e-5 of the output scale,
  bfloat16 in relative L2 2e-2 (``test_torch_rbf.assert_outputs_match``).
* The plain route cut into chunks of targets by a small budget equals the
  uncut one; the norm and its gradient equal JAX's.
* The kNN route raises ``NotImplementedError`` in both packages; a compat
  layer takes the plain route at any width and never calls its edge
  function; the K1 wrapper refuses a norm.
* One train step against JAX's (loss rtol 1e-5, gradients through
  ``assert_leaves_close`` at 5e-3), with a live coordinate head: at a zero
  head the norm changes nothing.

Every graph has two or more live atoms: as in JAX, the norm's sqrt has no
guard, and a graph with one live atom has an infinite gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.nn.egnn import EGCL as JaxEGCL
from diffusion_model_tpu.ops.angles import pairwise_sq_dist
from diffusion_model_tpu.ops.edges import dense_pair_mask
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.egnn import EGCL, edge_route
from diffusion_model_tpu_torch.ops import egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train import checkpoint
from test_torch_rbf import (
    SMALL,
    _layer_inputs,
    assert_outputs_match,
    denoiser_pair,
    small_inputs,
    train_step_parity,
)
from torch_port_fixtures import edge_args, edge_inputs

torch.set_num_threads(4)

COMPAT = dict(compat_scalar_norm=True)
X_HEAD = ("mlp_x_dense2",)


def _jax_layer(dtype=jnp.float32, **kw):
    return JaxEGCL(m_hidden=64, m_out=64, x_hidden=64, h_hidden=32, h_out=8,
                   zero_init_x=False, compute_dtype=dtype, **kw)


def test_config_builds_a_dense_compat_model():
    cfg = Config(**{**SMALL, **COMPAT})
    assert cfg.compat_scalar_norm
    assert from_dict({"compat_scalar_norm": True}).compat_scalar_norm
    model = DiffusionDenoiser(cfg)
    assert all(getattr(model.egnn, f"egcl_{l}").compat_scalar_norm
               for l in range(cfg.L))
    # the parameter tree is the model's without the flag
    plain = DiffusionDenoiser(cfg.replace(compat_scalar_norm=False))
    assert list(model.state_dict()) == list(plain.state_dict())


def test_compat_norm_and_its_gradient_equal_jax():
    _, x, mask = _layer_inputs()

    def jax_norm(xx):
        pm = dense_pair_mask(jnp.asarray(mask))
        return jnp.sqrt(jnp.sum(pairwise_sq_dist(xx) * pm, axis=(-1, -2)))

    want = np.asarray(jax_norm(jnp.asarray(x)))
    w = np.array([0.7, -1.3], np.float32)
    want_grad = np.asarray(jax.grad(
        lambda xx: jnp.sum(jax_norm(xx) * w))(jnp.asarray(x)))
    leaf = torch.from_numpy(x).requires_grad_()
    got = egcl_pair.compat_norm(leaf, torch.from_numpy(mask))
    assert got.shape == (2, 1, 1, 1) and got.dtype == torch.float32
    (got[:, 0, 0, 0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy()[:, 0, 0, 0], want,
                               rtol=1e-6)
    np.testing.assert_allclose(leaf.grad.numpy(), want_grad, rtol=1e-5,
                               atol=1e-6)
    # padded atoms get no gradient
    np.testing.assert_array_equal(leaf.grad.numpy()[mask == 0], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_egcl_with_compat_norm_matches_jax(dtype):
    h, x, mask = _layer_inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    layer = _jax_layer(jdt, **COMPAT)
    jedges = dense_pair_mask(jnp.asarray(mask))
    params = layer.init(jax.random.key(0), h, x, jedges, mask)
    want = [np.asarray(w, np.float32)
            for w in layer.apply(params, h, x, jedges, mask)]
    if dtype == "bfloat16":
        want = (want, [np.asarray(w) for w in _jax_layer(**COMPAT).apply(
            params, h, x, jedges, mask)])
    port = EGCL(8, 64, 64, 64, 32, 8, compute_dtype=getattr(torch, dtype),
                zero_init_x=False, **COMPAT)
    port.load_state_dict(checkpoint.state_dict_from_flax(params))
    ht, xt, mt = (torch.from_numpy(a) for a in (h, x, mask))
    before = egnn.plain_edge_calls
    with torch.no_grad():
        got = port(ht, xt, mt)
    assert egnn.plain_edge_calls == before + 1
    assert_outputs_match(want, [g.float().numpy() for g in got], dtype)
    # the norm moves the coordinates: the model without it differs
    port.compat_scalar_norm = False
    with torch.no_grad():
        other = port(ht, xt, mt)[1]
    assert not np.allclose(other.float().numpy(), got[1].float().numpy(),
                           atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levers", [dict(), dict(virtual_node=True,
                                                 h_residual=True)])
def test_denoiser_with_compat_norm_matches_jax(levers, dtype):
    want, got = denoiser_pair(COMPAT, (), "dense", dtype, **levers)
    assert_outputs_match(want, got, dtype)


def test_chunks_that_split_targets_equal_the_whole(monkeypatch):
    """A budget of one target's ``[sources, width]`` slab cuts every graph
    into chunks of one target, which see one row of the pair grid each:
    the per-graph norm computed before the cut keeps the answer."""
    h, x, mask = (torch.from_numpy(a) for a in _layer_inputs())
    torch.manual_seed(0)
    layer = EGCL(8, 64, 64, 64, 32, 8, zero_init_x=False, **COMPAT)
    with torch.no_grad():
        whole = layer(h, x, mask)
    chunks = []
    real = egcl_pair.egcl_pair_edges_reference

    def counting(*args, targets, **kw):
        chunks.append((args[0].shape[0], targets))
        return real(*args, targets=targets, **kw)

    monkeypatch.setattr(egnn, "plain_edges", functools.partial(
        egnn.plain_edges, budget=x.shape[1] * 64))
    monkeypatch.setattr(egcl_pair, "egcl_pair_edges_reference", counting)
    with torch.no_grad():
        cut = layer(h, x, mask)
    assert len(chunks) == 2 * x.shape[1]
    assert all(t.stop - t.start == 1 for _, t in chunks)
    for a, b in zip(cut, whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_knn_compat_raises_in_both_packages():
    h, x, mask = _layer_inputs()
    layer = _jax_layer(**COMPAT)
    jedges = jax_knn_edges(jnp.asarray(x), jnp.asarray(mask), 4)
    with pytest.raises(NotImplementedError, match="compat_scalar_norm"):
        layer.init(jax.random.key(0), h, x, jedges, mask)
    port = EGCL(8, 64, 64, 64, 32, 8, **COMPAT)
    ht, xt, mt = (torch.from_numpy(a) for a in (h, x, mask))
    with pytest.raises(NotImplementedError, match="compat_scalar_norm"):
        port(ht, xt, mt, knn_edges(xt, mt, 4))
    cfg = Config(**{**SMALL, **COMPAT, "neighbor_k": 4})
    t = [torch.from_numpy(a) for a in small_inputs()]
    with pytest.raises(NotImplementedError, match="compat_scalar_norm"):
        DiffusionDenoiser(cfg)(*t, knn_edges(t[1], t[5], 4))


@pytest.mark.parametrize("hdim", [None, 36])
def test_compat_takes_the_plain_route_at_any_width(hdim):
    for dtype in (torch.bfloat16, torch.float32):
        assert edge_route(1024, 1024, 256, dtype, hdim) == "kernel"
        assert edge_route(1024, 1024, 256, dtype, hdim,
                          compat_scalar_norm=True) == "plain"


def test_compat_layer_never_calls_its_edge_function():
    def refuse(*args, **kwargs):
        raise AssertionError("a compat layer reached the pair kernel")

    layer = EGCL(8, 64, 64, 64, 32, 8, edge_fn=refuse, zero_init_x=False,
                 **COMPAT)
    h, x, mask = (torch.from_numpy(a) for a in _layer_inputs())
    x.requires_grad_()
    before = egnn.plain_edge_calls
    layer(h, x, mask)[1].sum().backward()
    assert egnn.plain_edge_calls == before + 1
    assert torch.isfinite(x.grad).all()
    assert layer.mlp_x_dense2.kernel.grad.abs().sum() > 0


def test_pair_wrapper_refuses_a_norm():
    args = edge_args(edge_inputs(1))
    egcl_pair.egcl_pair_edges(*args)
    with pytest.raises(ValueError, match="per-graph norm"):
        egcl_pair.egcl_pair_edges(*args, norm=torch.ones(2, 1, 1, 1))


def test_train_step_with_compat_norm_matches_jax():
    train_step_parity(COMPAT, X_HEAD, "dense-predefined")
