"""The global radius feature (``global_radius_feature``) in the port against
the JAX package, on the CPU at tiny widths.

The feature is ``log1p(|x - CoM|)`` of each real node, times the top-level
``radius_feature_gate``, one more node-feature column after exO and before
t/T (``h_size`` + 1). The edge math is unchanged, so a radius model takes
the edge kernels' route wherever its widths fit (K1/K2 on the card, at the
flagship's widths too: ``h_size`` 37 against K2's ``MAX_H`` 48).

* The denoiser with the gate opened (``virtual_node`` and ``h_residual``
  on), dense and kNN, against JAX: float32 rtol 1e-5 / atol 1e-5 of the
  output scale, bfloat16 relative L2 2e-2, as ``test_torch_rbf.py``.
* The feature's E(3) invariance, padded rows, a node at the centre
  (finite gradient) and a graph with no real node; the model's eps_x
  equivariant and eps_h invariant with the gate open.
* With the gate at zero the radius column is exactly zero: the model is
  the one fed a zero column, bit for bit. (It has one more node channel
  at every layer than the model without the flag, so no model without the
  flag holds its weights.)
* The route: the kernels' edge functions, never ``plain_edges``.
* The npz round trip both ways with the gate (a top-level leaf), one train
  step against JAX's (through ``ops.edge_grad.EdgeFunction`` at widths
  the kernels take) and chains replayed from JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.config import from_dict as jax_from_dict
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu_torch import config as port_config
from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.nn import denoiser as port_denoiser
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.denoiser import (
    DiffusionDenoiser,
    radius_feature,
)
from diffusion_model_tpu_torch.nn.egnn import edge_route
from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.train import checkpoint
from test_torch_rbf import (
    CHAINS,
    SMALL,
    TOPOLOGIES,
    TRAIN_CASES,
    _jax_edges,
    assert_outputs_match,
    chain_parity,
    denoiser_pair,
    npz_round_trip,
    small_inputs,
    train_step_parity,
)
from torch_port_fixtures import SNAPSHOT

torch.set_num_threads(4)

RADIUS = dict(global_radius_feature=True)
GATE = ("radius_feature_gate",)
KERNEL_WIDTHS = dict(m_hidden_size=64, x_hidden_size=64, m_size=64)


def open_gate(value=0.8):
    def edit(params):
        return {**params, "params": {**params["params"],
                                     "radius_feature_gate":
                                         jnp.asarray([value], jnp.float32)}}
    return edit


# -- the feature -----------------------------------------------------------

def _pos_mask(seed=0, b=3, n=9):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), np.float32)
    mask[1, 5:] = 0.0
    mask[2] = 0.0                       # a graph with no real node
    pos = rng.normal(size=(b, n, 3)).astype(np.float32) * 2.0
    return torch.from_numpy(pos), torch.from_numpy(mask)


def test_radius_feature_matches_the_jax_statement():
    pos, mask = _pos_mask()
    got = radius_feature(pos, mask)
    p, m = pos.numpy().astype(np.float64), mask.numpy().astype(np.float64)
    count = np.maximum(m.sum(-1, keepdims=True), 1.0)[..., None]
    com = (p * m[..., None]).sum(1, keepdims=True) / count
    r = np.sqrt(np.maximum(((p - com) ** 2).sum(-1, keepdims=True), 1e-12))
    want = np.log1p(r) * m[..., None]
    assert got.dtype == torch.float32 and got.shape == (3, 9, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[1, 5:].any() and not got[2].any()


def test_radius_feature_is_e3_invariant():
    pos, mask = _pos_mask(1)
    rng = np.random.default_rng(5)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = torch.from_numpy(q.astype(np.float32))
    moved = pos @ q.T + torch.tensor([0.5, -1.0, 2.0])
    torch.testing.assert_close(radius_feature(moved, mask),
                               radius_feature(pos, mask), rtol=1e-5,
                               atol=1e-5)
    mirrored = pos * torch.tensor([-1.0, 1.0, 1.0])
    torch.testing.assert_close(radius_feature(mirrored, mask),
                               radius_feature(pos, mask), rtol=1e-5,
                               atol=1e-5)


def test_radius_gradient_is_finite_at_the_centre():
    pos = torch.tensor([[[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0],
                         [0.0, 0.0, 0.0]]], requires_grad=True)
    mask = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    radius_feature(pos, mask).sum().backward()
    assert torch.isfinite(pos.grad).all()


# -- the denoiser ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_denoiser_with_open_gate_matches_jax(topology, dtype):
    want, got = denoiser_pair(RADIUS, GATE, topology, dtype,
                              edit=open_gate(), virtual_node=True,
                              h_residual=True)
    assert_outputs_match(want, got, dtype)


def test_the_feature_changes_the_output():
    closed = denoiser_pair(RADIUS, (), "dense", "float32",
                           edit=open_gate(0.0))[1]
    opened = denoiser_pair(RADIUS, (), "dense", "float32",
                           edit=open_gate())[1]
    assert not np.allclose(closed[0], opened[0])


def test_column_sits_after_exo_and_before_t():
    """The first layer's input is ``[species | spectrum | exO | radius |
    t/T]``: the row order of its kernels, which loaded weights fix."""
    cfg = from_dict({**SMALL, **RADIUS})
    assert cfg.h_size == from_dict(SMALL).h_size + 1 == 13
    torch.manual_seed(0)
    model = DiffusionDenoiser(cfg)
    assert model.egnn.egcl_0.mlp_m_dense0.kernel.shape[0] == 2 * 13 + 1
    with torch.no_grad():
        model.radius_feature_gate.fill_(0.5)
    seen = []
    model.egnn.register_forward_pre_hook(lambda mod, args: seen.append(
        args[0]))
    t = [torch.from_numpy(a) for a in small_inputs()]
    with torch.no_grad():
        model(*t)
    h_in = seen[0]
    assert torch.equal(h_in[..., :2], t[0])
    assert torch.equal(h_in[..., 10:11], t[3])
    assert torch.equal(h_in[..., 11:12], radius_feature(t[1], t[5]) * 0.5)
    assert torch.equal(h_in[..., 12:], t[4])


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_closed_gate_is_the_model_fed_a_zero_column(topology, monkeypatch):
    cfg = from_dict({**SMALL, **TOPOLOGIES[topology], **RADIUS})
    torch.manual_seed(0)
    model = DiffusionDenoiser(cfg)
    assert not model.radius_feature_gate.any()
    t = [torch.from_numpy(a) for a in small_inputs()]
    edges = knn_edges(t[1], t[5], cfg.neighbor_k) if cfg.neighbor_k else None
    with torch.no_grad():
        got = model(*t, edges)
        monkeypatch.setattr(port_denoiser, "radius_feature",
                            lambda pos, mask: torch.zeros_like(pos[..., :1]))
        want = model(*t, edges)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_open_gate_keeps_the_model_equivariant():
    cfg = from_dict({**SMALL, **RADIUS, "neighbor_k": 4,
                     "virtual_node": True})
    torch.manual_seed(1)
    model = DiffusionDenoiser(cfg)
    with torch.no_grad():
        model.radius_feature_gate.fill_(1.0)
        for l in range(cfg.L):
            getattr(model.egnn, f"egcl_{l}").mlp_x_dense2.kernel.normal_(
                0, 0.1)
    t = [torch.from_numpy(a) for a in small_inputs()]
    rng = np.random.default_rng(2)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = torch.from_numpy(q.astype(np.float32))
    moved = (t[1] @ q.T + torch.tensor([0.5, -1.0, 2.0])) * t[5][..., None]
    with torch.no_grad():
        ex1, eh1 = model(*t, knn_edges(t[1], t[5], 4))
        t2 = [t[0], moved, *t[2:]]
        ex2, eh2 = model(*t2, knn_edges(moved, t[5], 4))
    torch.testing.assert_close(ex1 @ q.T, ex2, rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(eh1, eh2, rtol=5e-4, atol=5e-5)
    assert not ex1[1, 7:].any() and not eh1[1, 7:].any()


# -- config, routes ------------------------------------------------------------

def test_h_size_grows_by_one_as_in_jax():
    for d in ({}, {"give_exO": False}, {"to_compress_spectrum": False}):
        got = from_dict({**d, **RADIUS})
        want = jax_from_dict({**d, **RADIUS})
        assert got.h_size == want.h_size == from_dict(d).h_size + 1
    assert port_config.from_dict(RADIUS).h_size == 37


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flagship_widths_with_radius_take_the_kernels(dtype):
    h = Config(**RADIUS).h_size
    assert h <= egcl_knn.MAX_H
    assert edge_route(1024, 1024, 256, dtype) == "kernel"
    assert edge_route(1024, 1024, 256, dtype, h) == "kernel"


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_radius_model_runs_its_edge_functions_not_the_plain_route(topology):
    calls = []

    def pair(*args):
        calls.append("pair")
        return egcl_pair.egcl_pair_edges(*args)

    def knn(*args):
        calls.append("knn")
        return egcl_knn.egcl_knn_edges(*args)

    cfg = from_dict({**SMALL, **TOPOLOGIES[topology], **RADIUS,
                     "virtual_node": True, "h_residual": True})
    model = DiffusionDenoiser(cfg, edge_fn=pair, knn_edge_fn=knn)
    t = [torch.from_numpy(a) for a in small_inputs()]
    edges = knn_edges(t[1], t[5], cfg.neighbor_k) if cfg.neighbor_k else None
    before = egnn.plain_edge_calls
    model(*t, edges)[0].sum().backward()
    assert egnn.plain_edge_calls == before
    assert calls == [topology if topology == "knn" else "pair"] * cfg.L
    assert model.radius_feature_gate.grad is not None


# -- weights, training, sampling -------------------------------------------

def test_top_level_leaf_maps_both_ways():
    """``port_name`` and ``flax_from_state_dict`` take a leaf with no module
    path (``state_dict_from_flax`` used to raise ``ValueError: not enough
    values to unpack`` on one)."""
    assert checkpoint.port_name("radius_feature_gate") == "radius_feature_gate"
    tree = {"params": {"radius_feature_gate": np.array([0.5], np.float32),
                       "egnn": {"egcl_0": {"mlp_h_dense0": {
                           "kernel": np.ones((3, 2), np.float32)}}}}}
    sd = checkpoint.state_dict_from_flax(tree)
    assert sorted(sd) == ["egnn.egcl_0.mlp_h_dense0.weight",
                          "radius_feature_gate"]
    back = checkpoint.flax_from_state_dict(sd)["params"]
    np.testing.assert_array_equal(back["radius_feature_gate"], [0.5])
    assert back["egnn"]["egcl_0"]["mlp_h_dense0"]["kernel"].shape == (3, 2)


def test_npz_round_trip_carries_the_gate(tmp_path):
    npz_round_trip(tmp_path, RADIUS, GATE)


def test_npz_round_trip_with_both_features(tmp_path):
    npz_round_trip(tmp_path, {**RADIUS, "edge_rbf": 6, "edge_rbf_rmax": 4.0},
                   GATE + ("rbf_m", "rbf_x"))


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_with_radius_matches_jax(case):
    train_step_parity({**RADIUS, **KERNEL_WIDTHS}, GATE, case)


def test_fresh_radius_model_draws_a_zero_gate_as_jax():
    from diffusion_model_tpu_torch.train.trainer import Trainer

    cfg = Config(**{**SMALL, **RADIUS})
    state = Trainer(cfg, device="cpu").init_state(3)
    gate = state.params["denoiser.radius_feature_gate"]
    assert tuple(gate.shape) == (1,) and not gate.any()
    jcfg = JaxConfig(**{**SMALL, **RADIUS})
    inputs = small_inputs()
    tree = JaxDenoiser(jcfg).init(jax.random.key(0), *inputs,
                                  _jax_edges(jcfg, inputs[1], inputs[5]))
    np.testing.assert_array_equal(tree["params"]["radius_feature_gate"],
                                  [0.0])


@pytest.mark.parametrize("case", list(CHAINS))
def test_radius_chain_matches_jax(case):
    # init key 1: from key 0 the JAX package's own 20-step eps chain of
    # this random radius model is not finite, at any gate (0 included)
    chain_parity(RADIUS, GATE, case, edit=open_gate(0.3), init_key=1)


def test_flagship_radius_model_shapes():
    """The flagship's recipe with the feature: node width 37 through every
    layer, and the gate (the shapes the card's variants phase builds)."""
    cfg = checkpoint.load_config_npz(str(SNAPSHOT)).replace(**RADIUS)
    model = DiffusionDenoiser(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes["radius_feature_gate"] == (1,)
    assert shapes["egnn.egcl_0.mlp_m_dense0.kernel"] == (2 * 37 + 1, 1024)
    assert shapes["egnn.egcl_0.mlp_h_dense1.weight"] == (37, 1024)
