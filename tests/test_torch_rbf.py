"""The radial-basis edge features (``edge_rbf``, ``edge_rbf_rmax``) in the
port against the JAX package, on the CPU at tiny widths.

* ``rbf_features`` against ``_rbf_features``: values, and gradients at
  d2 = 0 on real and on masked pairs (finite), float32 rtol 1e-6.
* An EGCL, dense and kNN, with ``edge_rbf=6`` and random non-zero ``rbf_m``
  / ``rbf_x`` kernels, and the denoiser with ``virtual_node``,
  ``h_residual`` and ``edge_rbf``: float32 at rtol 1e-5 / atol 1e-5 of the
  output scale, bfloat16 in relative L2 2e-2 (``assert_outputs_match``).
* Zero-initialised kernels give the model without the flag bit for bit, as
  the JAX package's ``tests/test_egnn.py`` ``test_exact_noop_at_init``.
* ``edge_rbf=1`` and ``edge_rbf_rmax <= 0`` raise in both packages; an rbf
  layer takes the plain route at any width, never its edge functions, and
  the K1/K2 wrappers refuse an RBF argument.
* The npz round trip both ways, one train step against JAX's (loss rtol
  1e-5, leaves through ``assert_leaves_close`` at 5e-3; dense with the
  polynomial schedule, kNN with the learned one) and chains replayed from
  JAX's draws (positions atol 1e-2 A, species exactly), full and strided
  grids, with guidance, eps and x0 heads.

The shared machinery (``live``, ``denoiser_pair``, ``train_step_parity``,
``chain_parity``, ``npz_round_trip``) serves ``test_torch_radius.py`` too.
Card-only cases are in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.diffusion import process as jp
from diffusion_model_tpu.diffusion import sampler as js
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.nn.egnn import EGCL as JaxEGCL
from diffusion_model_tpu.nn.egnn import _rbf_features
from diffusion_model_tpu.ops.edges import dense_pair_mask
from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu.train.checkpoint import (
    load_params_npz as jax_load_npz,
)
from diffusion_model_tpu.train.checkpoint import (
    save_params_npz as jax_save_npz,
)
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion import process as tp
from diffusion_model_tpu_torch.diffusion import sampler as ts
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.egnn import EGCL, edge_route
from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train import checkpoint
from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
from test_torch_heads_train import pin_table
from test_torch_trainer import (
    assert_leaves_close,
    np_tree,
    port_names,
    tiny_data,
)
from torch_port_fixtures import (
    Replay,
    ReplayDraws,
    edge_args,
    edge_inputs,
    jax_loss_draws,
    jax_sample_draws,
    knn_args,
    knn_inputs,
    port_batch,
)

torch.set_num_threads(4)

RBF = dict(edge_rbf=6, edge_rbf_rmax=4.0)
RBF_LEAVES = ("rbf_m", "rbf_x")
VNODE = ("vnode_in", "vnode_pool", "vnode_out", "vnode_x", "vnode_x_head")
K = 4
SMALL = dict(n_max=12, L=2, m_hidden_size=64, h_hidden_size=32,
             x_hidden_size=64, m_size=64, spectrum_size=16,
             compressed_spectrum_size=8, compressor_hidden_dim=(8,),
             zero_init_x=False, compute_dtype="float32")
TOPOLOGIES = {"dense": dict(), "knn": dict(neighbor_k=K)}
F32_TOL = 1e-5
BF16_L2 = 2e-2
POS_TOL = dict(rtol=1e-3, atol=1e-2)
X_HEAD_SCALE = 0.03


def live(tree, names, seed=1, scale=1.0):
    """The flax tree with every leaf under a module in ``names``, or a leaf
    so named, redrawn from a numpy seed at std ``scale / sqrt(fan_in)``:
    zero-initialised, these leaves would make their feature an exact
    no-op and hide any error."""
    rng = np.random.default_rng(seed)

    def draw(a):
        fan_in = a.shape[0] if a.ndim == 2 else 1
        return jnp.asarray(rng.normal(size=a.shape) * scale / np.sqrt(fan_in),
                           jnp.float32)

    def walk(t):
        out = {}
        for key, v in t.items():
            if key in names:
                out[key] = ({leaf: draw(a) for leaf, a in v.items()}
                            if isinstance(v, dict) else draw(v))
            else:
                out[key] = walk(v) if isinstance(v, dict) else v
        return out

    return walk(tree)


def small_inputs(seed=0, b=3, n=12, n_real=(12, 7, 3)):
    """Denoiser inputs (species, pos, spectrum, exo, t_norm, mask) as numpy,
    positions spread over the RBF centres (0-4 A)."""
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


def _jax_edges(jcfg, pos, mask):
    if jcfg.neighbor_k:
        return jax_knn_edges(jnp.asarray(pos), jnp.asarray(mask),
                             jcfg.neighbor_k)
    return dense_pair_mask(jnp.asarray(mask))


def _port_edges(cfg, pos, mask):
    return knn_edges(pos, mask, cfg.neighbor_k) if cfg.neighbor_k else None


def denoiser_pair(feature: dict, names, topology: str, dtype: str,
                  edit=None, **kw):
    """(JAX outputs, port outputs) of one denoiser on ``small_inputs``, its
    JAX initialisation with the leaves in ``names`` (and the virtual node's)
    redrawn (``live``) and then ``edit``-ed, carried across by
    ``state_dict_from_flax``. In bfloat16 the JAX outputs are a pair:
    (bfloat16, float32)."""
    jcfg = JaxConfig(**{**SMALL, **TOPOLOGIES[topology], **feature, **kw,
                        "compute_dtype": dtype})
    inputs = small_inputs()
    edges = _jax_edges(jcfg, inputs[1], inputs[5])
    params = JaxDenoiser(jcfg).init(jax.random.key(0), *inputs, edges)
    params = live(params, tuple(names) + (VNODE if jcfg.virtual_node
                                          else ()))
    if edit is not None:
        params = edit(params)

    def jax_out(c):
        return [np.asarray(w, np.float32)
                for w in JaxDenoiser(c).apply(params, *inputs, edges)]

    want = jax_out(jcfg)
    if dtype == "bfloat16":
        want = (want, jax_out(jcfg.replace(compute_dtype="float32")))
    cfg = from_dict(jcfg.to_dict())
    model = api.denoiser_from_params(cfg, params, "cpu")
    t = [torch.from_numpy(a) for a in inputs]
    got = model(*t, _port_edges(cfg, t[1], t[5]))
    return want, [g.float().numpy() for g in got]


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def assert_outputs_match(want, got, dtype):
    """float32: rtol / atol ``F32_TOL`` of the output scale. bfloat16
    (``want`` = JAX's bfloat16 and float32 outputs): relative L2
    ``BF16_L2`` from JAX's bfloat16 output, or, where JAX's bfloat16 output
    is itself further than that from its float32 one, from the float32 one
    (JAX rounds each add of the edge sums and MLP chains to bfloat16, the
    port's plain statement sums in float32: then the port's output lies
    nearer the float32 answer than JAX's does, as ROADMAP.md's parity
    notes record for training)."""
    if dtype == "float32":
        scale = max(float(np.abs(w).max()) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=F32_TOL,
                                       atol=F32_TOL * scale)
        return
    for g, w16, w32 in zip(got, *want):
        ref = w16 if _rel_l2(w16, w32) <= BF16_L2 else w32
        assert _rel_l2(g, ref) <= BF16_L2, (_rel_l2(g, w16),
                                            _rel_l2(w16, w32))


# -- rbf_features --------------------------------------------------------

@pytest.mark.parametrize("num,rmax", [(6, 4.0), (8, 8.0), (2, 0.5)])
def test_rbf_features_match_jax(num, rmax):
    rng = np.random.default_rng(num)
    d2 = (rng.random((3, 5, 5, 1)) * (1.2 * rmax) ** 2).astype(np.float32)
    d2[:, range(5), range(5)] = 0.0           # the diagonal: masked, d2 = 0
    d2[0, 1, 2] = 0.0                         # a real pair at d2 = 0
    valid = np.ones_like(d2, bool)
    valid[:, range(5), range(5)] = False
    valid[2, 3:] = False                      # padded targets
    want = np.asarray(_rbf_features(jnp.asarray(d2), jnp.asarray(valid),
                                    num, rmax))
    got = egnn.rbf_features(torch.from_numpy(d2), torch.from_numpy(valid),
                            num, rmax)
    assert got.dtype == torch.float32 and got.shape == (3, 5, 5, num)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # masked pairs read distance 0: the first centre's Gaussian is 1
    np.testing.assert_array_equal(got.numpy()[~valid[..., 0]][:, 0], 1.0)


def test_rbf_gradient_is_finite_at_zero_distance_and_matches_jax():
    rng = np.random.default_rng(3)
    d2 = (rng.random((2, 6, 6, 1)) * 9.0).astype(np.float32)
    d2[:, range(6), range(6)] = 0.0
    d2[1, 0, 4] = 0.0
    valid = ~np.eye(6, dtype=bool)[None, :, :, None].repeat(2, 0)
    w = rng.normal(size=(6,)).astype(np.float32)

    def jax_sum(d):
        return jnp.sum(_rbf_features(d, jnp.asarray(valid), 6, 4.0)
                       * jnp.asarray(w))

    want = np.asarray(jax.grad(jax_sum)(jnp.asarray(d2)))
    leaf = torch.from_numpy(d2).requires_grad_()
    (egnn.rbf_features(leaf, torch.from_numpy(valid), 6, 4.0)
     * torch.from_numpy(w)).sum().backward()
    got = leaf.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# -- the layer -----------------------------------------------------------

def _layer_inputs(seed=2, b=2, n=10):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[1, 6:] = 0.0
    h = (rng.normal(size=(b, n, 8)) * mask[..., None]).astype(np.float32)
    x = (rng.normal(size=(b, n, 3)) * 1.5 * mask[..., None]).astype(
        np.float32)
    return h, x, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_egcl_with_live_rbf_matches_jax(topology, dtype):
    h, x, mask = _layer_inputs()
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    layer = JaxEGCL(m_hidden=64, m_out=64, x_hidden=64, h_hidden=32,
                    h_out=8, zero_init_x=False, compute_dtype=jdt, **RBF)
    jedges = (jax_knn_edges(jnp.asarray(x), jnp.asarray(mask), K)
              if topology == "knn" else dense_pair_mask(jnp.asarray(mask)))
    params = layer.init(jax.random.key(0), h, x, jedges, mask)
    params = live(params, RBF_LEAVES)
    want = layer.apply(params, h, x, jedges, mask)
    port = EGCL(8, 64, 64, 64, 32, 8, compute_dtype=getattr(torch, dtype),
                zero_init_x=False, **RBF)
    port.load_state_dict(checkpoint.state_dict_from_flax(params))
    ht, xt, mt = (torch.from_numpy(a) for a in (h, x, mask))
    before = egnn.plain_edge_calls
    with torch.no_grad():
        got = port(ht, xt, mt, knn_edges(xt, mt, K)
                   if topology == "knn" else None)
    assert egnn.plain_edge_calls == before + 1
    want = [np.asarray(w, np.float32) for w in want]
    if dtype == "bfloat16":
        layer32 = JaxEGCL(m_hidden=64, m_out=64, x_hidden=64, h_hidden=32,
                          h_out=8, zero_init_x=False, **RBF)
        want = (want, [np.asarray(w) for w in layer32.apply(
            params, h, x, jedges, mask)])
    assert_outputs_match(want, [g.float().numpy() for g in got], dtype)


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_zero_rbf_kernels_give_the_model_without_the_flag_bit_for_bit(
        topology):
    torch.manual_seed(0)
    plain = EGCL(8, 64, 64, 64, 32, 8, zero_init_x=False)
    rbf = EGCL(8, 64, 64, 64, 32, 8, zero_init_x=False, **RBF)
    missing = rbf.load_state_dict(plain.state_dict(), strict=False)
    assert sorted(missing.missing_keys) == ["rbf_m.kernel", "rbf_x.kernel"]
    assert not rbf.rbf_m.kernel.any() and not rbf.rbf_x.kernel.any()
    h, x, mask = (torch.from_numpy(a) for a in _layer_inputs())
    edges = knn_edges(x, mask, K) if topology == "knn" else None
    with torch.no_grad():
        for a, b in zip(plain(h, x, mask, edges), rbf(h, x, mask, edges)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_denoiser_with_vnode_residual_and_rbf_matches_jax(topology, dtype):
    want, got = denoiser_pair(RBF, RBF_LEAVES, topology, dtype,
                              virtual_node=True, h_residual=True)
    assert_outputs_match(want, got, dtype)


def test_zero_rbf_denoiser_gives_the_denoiser_without_the_flag():
    cfg = from_dict({**SMALL, **TOPOLOGIES["knn"], "virtual_node": True})
    torch.manual_seed(0)
    plain = DiffusionDenoiser(cfg)
    rbf = DiffusionDenoiser(cfg.replace(**RBF))
    rbf.load_state_dict(plain.state_dict(), strict=False)
    t = [torch.from_numpy(a) for a in small_inputs()]
    edges = knn_edges(t[1], t[5], K)
    with torch.no_grad():
        for a, b in zip(plain(*t, edges), rbf(*t, edges)):
            assert torch.equal(a, b)


# -- validation and routes -------------------------------------------------

@pytest.mark.parametrize("kw", [dict(edge_rbf=1), dict(edge_rbf=-2),
                                dict(edge_rbf=8, edge_rbf_rmax=0.0),
                                dict(edge_rbf=8, edge_rbf_rmax=-1.0)])
def test_degenerate_rbf_settings_raise_in_both_packages(kw):
    with pytest.raises(ValueError, match="edge_rbf"):
        Config(**kw)
    with pytest.raises(ValueError, match="edge_rbf"):
        EGCL(8, 64, 64, 64, 32, 8, **kw)
    h, x, mask = _layer_inputs()
    layer = JaxEGCL(m_hidden=64, m_out=64, x_hidden=64, h_hidden=32,
                    h_out=8, **kw)
    with pytest.raises(ValueError, match="edge_rbf"):
        layer.init(jax.random.key(0), h, x, dense_pair_mask(
            jnp.asarray(mask)))


def test_rmax_is_read_only_with_rbf():
    """As in the JAX package, ``edge_rbf_rmax`` is free while edge_rbf is
    0, and read once it is not."""
    assert Config(edge_rbf_rmax=0.0).edge_rbf_rmax == 0.0
    a, b = (denoiser_pair({**RBF, "edge_rbf_rmax": r}, RBF_LEAVES, "dense",
                          "float32")[1] for r in (4.0, 2.5))
    assert not np.allclose(a[0], b[0])


@pytest.mark.parametrize("hdim", [None, 37, 48])
def test_rbf_takes_the_plain_route_at_any_width(hdim):
    for dtype in (torch.bfloat16, torch.float32):
        assert edge_route(1024, 1024, 256, dtype, hdim) == "kernel"
        assert edge_route(1024, 1024, 256, dtype, hdim, edge_rbf=8) == "plain"


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_rbf_layer_never_calls_its_edge_functions(topology):
    def refuse(*args, **kwargs):
        raise AssertionError("an rbf layer reached an edge kernel")

    layer = EGCL(8, 64, 64, 64, 32, 8, edge_fn=refuse, knn_edge_fn=refuse,
                 zero_init_x=False, **RBF)
    h, x, mask = (torch.from_numpy(a) for a in _layer_inputs())
    edges = knn_edges(x, mask, K) if topology == "knn" else None
    before = egnn.plain_edge_calls
    layer(h, x, mask, edges)[0].sum().backward()   # under autograd too
    with torch.no_grad():
        layer(h, x, mask, edges)
    assert egnn.plain_edge_calls == before + 2
    assert layer.rbf_m.kernel.grad is not None


@pytest.mark.parametrize("wrapper", ["pair", "knn"])
def test_kernel_wrappers_refuse_an_rbf_term(wrapper):
    w = torch.zeros(6, 32)
    if wrapper == "pair":
        args, fn = edge_args(edge_inputs(1)), egcl_pair.egcl_pair_edges
    else:
        args, fn = knn_args(knn_inputs(1)), egcl_knn.egcl_knn_edges
    fn(*args)   # the same call without the term runs
    with pytest.raises(ValueError, match="radial-basis"):
        fn(*args, rbf=(w, w, 4.0))


# -- weights, training, sampling -------------------------------------------

def npz_round_trip(tmp_path, feature: dict, names) -> None:
    """A JAX tree with live ``names`` leaves saved by the JAX package loads
    into the port (strictly, exactly) and gives JAX's outputs; the port's
    save of it loads into the JAX package array for array."""
    jcfg = JaxConfig(**{**SMALL, **feature})
    inputs = small_inputs()
    edges = _jax_edges(jcfg, inputs[1], inputs[5])
    params = live(JaxDenoiser(jcfg).init(jax.random.key(0), *inputs, edges),
                  names)
    jpath = str(tmp_path / "jax.npz")
    jax_save_npz({"denoiser": params}, jpath, dtype="float32")
    cfg = from_dict(jcfg.to_dict())
    tree = checkpoint.load_params_npz(jpath)
    model = api.denoiser_from_params(cfg, tree, "cpu")   # strict
    flat = {k: v for k, v in model.state_dict().items()
            if any(n in k for n in names)}
    assert flat, names
    t = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        got = model(*t, _port_edges(cfg, t[1], t[5]))
    assert_outputs_match(
        [np.asarray(w) for w in JaxDenoiser(jcfg).apply(params, *inputs,
                                                         edges)],
        [g.numpy() for g in got], "float32")
    ppath = str(tmp_path / "port.npz")
    named = {f"denoiser.{k}": v for k, v in model.state_dict().items()}
    checkpoint.save_params_npz(params_tree(named), ppath, dtype="float32",
                               cfg=cfg)
    back = jax_load_npz(ppath)["denoiser"]
    want = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_npz_round_trip_carries_the_rbf_kernels(tmp_path):
    npz_round_trip(tmp_path, RBF, RBF_LEAVES)


TRAIN = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
             x_hidden_size=32, m_size=16, spectrum_size=32,
             compressed_spectrum_size=8, compressor_hidden_dim=(16,),
             num_diffusion_timestep=50, batch_size=4, lr=1e-3,
             optimizer="Adam")
TRAIN_CASES = {
    "dense-predefined": dict(),
    "knn-learned": dict(neighbor_k=3, noise_schedule="learned",
                        optimizer="RAdamScheduleFree"),
}


def train_step_parity(feature: dict, names, case: str, edit=None) -> None:
    """One train step of both packages from the JAX initialisation with the
    ``names`` leaves redrawn (``live``) and ``edit``-ed, on JAX's draws:
    the loss at rtol 1e-5 and every leaf's gradient through
    ``assert_leaves_close`` at 5e-3, the new leaves included."""
    d = {**TRAIN, **TRAIN_CASES[case], **feature}
    jcfg, cfg = JaxConfig(**d), Config(**d)
    jb = next(jax_split.batch_iterator(tiny_data(jcfg), 4, jcfg.n_max,
                                       seed=1))
    key = jax.random.key(5)
    jtrainer = JaxTrainer(jcfg)
    params = jtrainer.init_state(jax.random.key(0), jb,
                                 skip_gamma_fit=True).params
    params = {**params, "denoiser": live(params["denoiser"], names)}
    if edit is not None:
        params = {**params, "denoiser": edit(params["denoiser"])}
    (loss, (sum_sq, _)), grads = jax.jit(jax.value_and_grad(
        jtrainer._loss, has_aux=True))(params, key, jb)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=np_tree(params))
    if cfg.noise_schedule == "learned":
        pin_table(trainer, jtrainer.schedule_for(params).alphas)
    got_loss, got_sq, _, got_grads = trainer.loss_and_grads(
        state, ReplayDraws(jax_loss_draws(key, jcfg, 4, jcfg.n_max)),
        port_batch(jb))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(got_sq), float(sum_sq), rtol=1e-5)
    want = port_names(grads)
    assert any(any(n in k for n in names) for k in want), names
    assert_leaves_close(got_grads, want, 5e-3)
    # the optimizer moves the new leaves
    before = {k: v.clone() for k, v in state.params.items()
              if any(n in k for n in names)}
    trainer.train_step(state, ReplayDraws(jax_loss_draws(
        key, jcfg, 4, jcfg.n_max)), port_batch(jb))
    for k, v in before.items():
        assert not torch.equal(state.params[k], v), k


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_with_rbf_matches_jax(case):
    train_step_parity(RBF, RBF_LEAVES, case)


def test_fresh_rbf_model_draws_zero_kernels_and_trains_them():
    cfg = Config(**TRAIN, **RBF)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(3)
    rbf = {k: v for k, v in state.params.items() if ".rbf_" in k}
    assert len(rbf) == 2 * cfg.L
    for k, v in rbf.items():
        assert tuple(v.shape) == (6, 32) and not v.any(), k
    jb = next(jax_split.batch_iterator(tiny_data(JaxConfig(**TRAIN)), 4,
                                       cfg.n_max, seed=1))
    from diffusion_model_tpu_torch.train.loss import TrainNoise

    # the zero coordinate head gives rbf_x no gradient at the first step;
    # the second step, after the head has moved, moves it too
    for i in range(2):
        state, m = trainer.train_step(state, TrainNoise(i, "cpu"),
                                      port_batch(jb))
        assert np.isfinite(float(m["loss"]))
    assert all(state.params[k].any() for k in rbf)


CHAIN = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
             x_hidden_size=32, m_size=16, spectrum_size=32,
             compressed_spectrum_size=8, compressor_hidden_dim=(16,),
             num_diffusion_timestep=20, noise_precision=0.05,
             zero_init_x=False)
CHAINS = {
    "dense-full-eps": dict(),
    "dense-uniform-x0-guided": dict(sample_steps=7, x_parameterization="x0",
                                    guidance_scale=1.5),
    "knn-snr-v": dict(neighbor_k=4, sample_steps=7, sample_grid="snr",
                      x_parameterization="v"),
}
COPIES = 2


def chain_parity(feature: dict, names, case: str, edit=None,
                 init_key: int = 0) -> None:
    """A chain of both packages from JAX's draws (``jax_sample_draws``) on
    a tiny model with the ``names`` leaves redrawn and the coordinate
    head's last layer scaled down (a random head at full scale drives the
    chains past 1000 A in both): positions and h at atol 1e-2 A, species
    exactly. ``api.generate`` needs nothing but the denoiser for a
    variant: the sampler is the one of every other model."""
    d = {**CHAIN, **CHAINS[case], **feature}
    jcfg, cfg = JaxConfig(**d), Config(**d)
    graphs = tiny_data(jcfg, num=2, seed=4)
    jcond = js.tile_batch(jax_collate(graphs, jcfg.n_max), COPIES)
    edges = _jax_edges(jcfg, jcond.pos, jcond.mask)
    params = JaxDenoiser(jcfg).init(
        jax.random.key(init_key), jcond.species, jcond.pos, jcond.spectrum,
        jcond.exo, jnp.zeros(jcond.mask.shape + (1,)), jcond.mask, edges)
    params = live(params, names)
    if edit is not None:
        params = edit(params)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * X_HEAD_SCALE
        if "mlp_x_dense2" in jax.tree_util.keystr(path) else a, params)
    model = JaxDenoiser(jcfg)
    key = jax.random.key(17)
    want = jax.jit(lambda k, c: js.sample(
        lambda *a: model.apply(params, *a), jp.predefined_schedule(jcfg),
        jcfg, k, c))(key, jcond)
    assert bool(np.all(want.accepted)), "a chain that fails proves nothing"
    b, n = jcond.mask.shape
    steps = cfg.sample_steps or cfg.num_diffusion_timestep
    noise = Replay(jax_sample_draws(key, b, n, cfg.atom_type_size, steps,
                                    True))
    port = api.denoiser_from_params(cfg, np_tree({"denoiser": params}),
                                    "cpu")
    cond = ts.tile_batch(collate(graphs, cfg.n_max, "cpu"), COPIES)
    got = ts.sample(port, tp.predefined_schedule(cfg), cfg, None, cond,
                    noise)
    assert not noise.draws, "the port drew fewer numbers than JAX"
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **POS_TOL)
    np.testing.assert_array_equal(got.species.numpy(),
                                  np.asarray(want.species))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **POS_TOL)


@pytest.mark.parametrize("case", list(CHAINS))
def test_rbf_chain_matches_jax(case):
    chain_parity(RBF, RBF_LEAVES, case)
