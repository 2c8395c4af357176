"""The denoiser over kNN neighbour lists in the port against
``DiffusionDenoiser.apply`` of the JAX package (its XLA sparse path).

Small widths with a random JAX initialisation carried across by
``state_dict_from_flax``, for the plain layer, the virtual node, the
residual node update and both; the virtual-node heads are zero at
initialisation, so they are drawn from a numpy seed to make the channel do
work. Then the flagship weights: kNN with K = N-1 is the dense topology, in
both packages, and the port reproduces the committed kNN goldens.

Tolerances: float32 rtol 2e-4 / atol 2e-5 of the output scale (as the
dense denoiser test; the sums run in another order); bfloat16 relative L2
2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.ops.edges import dense_pair_mask
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu_torch.api import denoiser_from_params
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.egnn import EGCL
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train.checkpoint import state_dict_from_flax
from torch_port_fixtures import (
    FIXTURE,
    KNN_K,
    flagship,
    flagship_conditions,
    noisy_inputs,
)

torch.set_num_threads(4)

K = 4
VNODE = ("vnode_in", "vnode_pool", "vnode_out", "vnode_x", "vnode_x_head")


def small_cfg(**kw):
    base = dict(n_max=12, L=3, m_hidden_size=64, h_hidden_size=32,
                x_hidden_size=64, m_size=64, spectrum_size=16,
                compressed_spectrum_size=8, compressor_hidden_dim=(8,),
                neighbor_k=K, compute_dtype="float32", zero_init_x=False)
    base.update(kw)
    return JaxConfig(**base)


def small_inputs(seed=0, b=3, n=12, n_real=(12, 7, 3)):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, n), np.float32)
    for g, real in enumerate(n_real):
        mask[g, :real] = 1.0
    m3 = mask[..., None]
    exo = np.zeros((b, n, 1), np.float32)
    exo[:, 0] = 1.0
    return ((rng.normal(size=(b, n, 2)) * m3).astype(np.float32),
            (rng.normal(size=(b, n, 3)) * 1.5 * m3).astype(np.float32),
            rng.random((b, n, 16)).astype(np.float32), exo * m3,
            (0.3 * m3).astype(np.float32), mask)


def _with_vnode_weights(params, seed=1):
    """The flax tree with every virtual-node kernel and bias redrawn at std
    1/sqrt(fan_in) from a numpy seed (the heads start at zero)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, v in tree.items():
            if key in VNODE:
                std = v["kernel"].shape[0] ** -0.5
                out[key] = {leaf: jnp.asarray(rng.normal(size=a.shape) * std,
                                              jnp.float32)
                            for leaf, a in v.items()}
            else:
                out[key] = walk(v) if isinstance(v, dict) else v
        return out

    return walk(params)


@pytest.fixture(scope="module", params=[
    dict(), dict(virtual_node=True), dict(h_residual=True),
    dict(virtual_node=True, h_residual=True)],
    ids=["plain", "virtual_node", "h_residual", "both"])
def small(request):
    jcfg = small_cfg(**request.param)
    inputs = small_inputs()
    edges = jax_knn_edges(jnp.asarray(inputs[1]), jnp.asarray(inputs[5]), K)
    params = JaxDenoiser(jcfg).init(jax.random.key(0), *inputs, edges)
    if jcfg.virtual_node:
        params = _with_vnode_weights(params)
    return jcfg, params, inputs


def _run(jcfg, params, inputs, dtype):
    jcfg = jcfg.replace(compute_dtype=dtype)
    edges = jax_knn_edges(jnp.asarray(inputs[1]), jnp.asarray(inputs[5]), K)
    want = JaxDenoiser(jcfg).apply(params, *inputs, edges)
    model = denoiser_from_params(from_dict(jcfg.to_dict()), params, "cpu")
    t = [torch.from_numpy(a) for a in inputs]
    got = model(*t, knn_edges(t[1], t[5], K))
    return ([np.asarray(w, np.float32) for w in want],
            [g.float().numpy() for g in got])


def test_float32_matches_jax(small):
    want, got = _run(*small, "float32")
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5 * scale)


def test_bfloat16_matches_jax_in_relative_l2(small):
    want, got = _run(*small, "bfloat16")
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2e-2


def test_virtual_node_tree_maps_exactly(small):
    jcfg, params, _ = small
    sd = state_dict_from_flax(params)
    model = DiffusionDenoiser(from_dict(jcfg.to_dict()))
    model.load_state_dict(sd)   # strict: a vnode tree needs vnode modules
    for l in range(jcfg.L):
        lp = params["params"]["egnn"][f"egcl_{l}"]
        layer = getattr(model.egnn, f"egcl_{l}")
        assert hasattr(layer, "vnode_in") == jcfg.virtual_node
        for name in VNODE if jcfg.virtual_node else ():
            for leaf in ("kernel", "bias"):
                # [in, out] as in flax: the channel reads that layout
                np.testing.assert_array_equal(
                    getattr(getattr(layer, name), leaf).detach().numpy(),
                    np.asarray(lp[name][leaf]))


@pytest.mark.parametrize("tree_has,model_has", [(True, False),
                                                (False, True)])
def test_virtual_node_flag_must_fit_the_tree(tree_has, model_has):
    inputs = small_inputs()
    edges = jax_knn_edges(jnp.asarray(inputs[1]), jnp.asarray(inputs[5]), K)
    params = JaxDenoiser(small_cfg(virtual_node=tree_has)).init(
        jax.random.key(0), *inputs, edges)
    model = DiffusionDenoiser(from_dict(
        small_cfg(virtual_node=model_has).to_dict()))
    with pytest.raises(RuntimeError, match="vnode"):
        model.load_state_dict(state_dict_from_flax(params))


def test_residual_reaches_layer_zero():
    """The residual applies wherever the widths match, which is every
    layer of the stack, layer 0 included."""
    torch.manual_seed(0)
    plain = EGCL(8, 64, 64, 64, 32, 8)
    res = EGCL(8, 64, 64, 64, 32, 8, h_residual=True)
    res.load_state_dict(plain.state_dict())
    h = torch.randn(2, 6, 8)
    x = torch.randn(2, 6, 3)
    mask = torch.ones(2, 6)
    edges = knn_edges(x, mask, 3)
    h_plain, x_plain = plain(h, x, mask, edges)
    h_res, x_res = res(h, x, mask, edges)
    torch.testing.assert_close(h_res, h_plain + h, rtol=0, atol=1e-6)
    assert torch.equal(x_res, x_plain)


@pytest.fixture(scope="module")
def flagship_inputs():
    from diffusion_model_tpu.diffusion.process import predefined_schedule

    jcfg, params = flagship()
    batch = jax_collate(flagship_conditions(jcfg)[:6], jcfg.n_max)
    alphas = np.asarray(predefined_schedule(jcfg).alphas)
    sp, pos, tn = noisy_inputs(alphas, np.asarray(batch.pos),
                               np.asarray(batch.species),
                               np.asarray(batch.mask), 0.5, seed=3)
    arrays = (sp, pos, np.asarray(batch.spectrum), np.asarray(batch.exo), tn,
              np.asarray(batch.mask))
    return jcfg.replace(compute_dtype="float32"), params, arrays


def test_full_k_is_the_dense_topology_in_both_packages(flagship_inputs):
    jcfg, params, arrays = flagship_inputs
    n = jcfg.n_max
    j = [jnp.asarray(a) for a in arrays]
    jmodel = JaxDenoiser(jcfg)
    want_dense = jmodel.apply(params["denoiser"], *j, dense_pair_mask(j[5]))
    want_knn = jmodel.apply(params["denoiser"], *j,
                            jax_knn_edges(j[1], j[5], n - 1))
    model = denoiser_from_params(from_dict(jcfg.to_dict()), params, "cpu")
    t = [torch.from_numpy(np.array(a)) for a in arrays]
    got_dense = model(*t)
    got_knn = model(*t, knn_edges(t[1], t[5], n - 1))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want_dense)
    tol = dict(rtol=2e-4, atol=2e-5 * scale)
    for a, b in zip(want_knn, want_dense):          # JAX: kNN == dense
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)
    for a, b in zip(got_knn, got_dense):            # port: kNN == dense
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    for a, b in zip(got_knn, want_knn):             # port == JAX on kNN
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_reproduces_the_knn_goldens(dtype):
    with np.load(FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    jcfg, params = flagship()
    model = denoiser_from_params(
        from_dict(jcfg.replace(compute_dtype=dtype).to_dict()), params, "cpu")
    t = lambda a: torch.from_numpy(a)
    mask = t(fx["cond_mask"])
    for k in range(len(fx["t_frac"])):
        pos = t(fx["in_pos_t"][k])
        got = model(t(fx["in_species_t"][k]), pos, t(fx["cond_spectrum"]),
                    t(fx["cond_exo"]), t(fx["in_t_norm"][k]), mask,
                    knn_edges(pos, mask, KNN_K))
        want = (fx[f"knn{KNN_K}_eps_x_{dtype}"][k],
                fx[f"knn{KNN_K}_eps_h_{dtype}"][k])
        if dtype == "float32":
            scale = max(np.abs(w).max() for w in want)
            for g, w in zip(got, want):
                assert np.abs(g.numpy() - w).max() <= 1e-3 * scale
        else:
            for g, w in zip(got, want):
                assert (np.linalg.norm(g.float().numpy() - w)
                        / np.linalg.norm(w)) <= 2e-2
