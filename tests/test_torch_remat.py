"""``remat_egcl`` in the port: each EGCL called through
``torch.utils.checkpoint`` where grad mode is on (JAX ``nn/egnn.py``
``nn.remat(EGCL)``), on the CPU at tiny widths.

* With and without it the loss and every gradient are equal bit for bit,
  dense and kNN, with and without the virtual node, the residual update,
  the radial-basis term and the learned schedule, float32 and bfloat16:
  the recompute runs the same statements on the same chunks.
* The recompute calls each layer's edge function again: a train step calls
  it 2L times (the plain route adds 2L to ``plain_edge_calls``), a
  ``no_grad`` call L times.
* The state-dict keys are the model's without it; a checkpoint round trip
  and ``api.train`` work, the latter equal to the run without remat.
* One train step against the JAX package's remat train step (loss rtol
  1e-5, gradients through ``assert_leaves_close`` at 5e-3), dense and kNN.

The card's case (through K2) is in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.ops.edges import knn_edges
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges
from diffusion_model_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer
from test_torch_rbf import TRAIN_CASES, train_step_parity

torch.set_num_threads(4)

REMAT = dict(remat_egcl=True)
# widths the kernels take (edge_route "kernel"): the edge functions run
BASE = dict(n_max=10, L=3, m_hidden_size=64, h_hidden_size=32,
            x_hidden_size=64, m_size=64, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=50, batch_size=4, lr=1e-3,
            zero_init_x=False, optimizer="Adam")
TOPOLOGIES = {"dense": dict(), "knn": dict(neighbor_k=4)}
LEVERS = {"plain": dict(),
          "vn-hres-rbf": dict(virtual_node=True, h_residual=True,
                              edge_rbf=6, edge_rbf_rmax=4.0),
          "vn-hres-learned": dict(virtual_node=True, h_residual=True,
                                  noise_schedule="learned",
                                  optimizer="RAdamScheduleFree")}


def batch(cfg, seed=0):
    graphs = synthetic_sio2_dataset(seed, 4, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    return collate(graphs, cfg.n_max, "cpu")


class Counted:
    """An edge function that counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def step_grads(cfg, seed=3):
    """(loss, grads, edge-function calls, plain-route calls) of one
    ``loss_and_grads`` from the parameters drawn from ``seed``."""
    pair, knn = Counted(egcl_pair_edges), Counted(egcl_knn_edges)
    trainer = Trainer(cfg, device="cpu", edge_fn=pair, knn_edge_fn=knn)
    state = trainer.init_state(seed)
    before = egnn.plain_edge_calls
    loss, _, _, grads = trainer.loss_and_grads(state, TrainNoise(7, "cpu"),
                                               batch(cfg))
    return (loss, grads, pair.calls + knn.calls,
            egnn.plain_edge_calls - before)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("levers", list(LEVERS))
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_remat_gradients_equal_bit_for_bit(topology, levers, dtype):
    cfg = Config(**{**BASE, **TOPOLOGIES[topology], **LEVERS[levers],
                    "compute_dtype": dtype})
    loss, grads, edge_calls, plain = step_grads(cfg)
    r_loss, r_grads, r_edge_calls, r_plain = step_grads(
        cfg.replace(**REMAT))
    assert torch.equal(loss, r_loss)
    assert list(grads) == list(r_grads)
    for k, g in grads.items():
        assert torch.equal(g, r_grads[k]), k
    assert any(bool(g.any()) for k, g in grads.items() if "egcl_0" in k)
    # the recompute calls each layer's edge work again
    if cfg.edge_rbf:
        assert (edge_calls, plain) == (0, cfg.L)
        assert (r_edge_calls, r_plain) == (0, 2 * cfg.L)
    else:
        assert (edge_calls, plain) == (cfg.L, 0)
        assert (r_edge_calls, r_plain) == (2 * cfg.L, 0)


def test_remat_with_compat_norm_gradients_equal_bit_for_bit():
    cfg = Config(**{**BASE, "compat_scalar_norm": True})
    loss, grads, _, plain = step_grads(cfg)
    r_loss, r_grads, _, r_plain = step_grads(cfg.replace(**REMAT))
    assert torch.equal(loss, r_loss) and (plain, r_plain) == (3, 6)
    for k, g in grads.items():
        assert torch.equal(g, r_grads[k]), k


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_no_grad_calls_skip_the_checkpoint(topology):
    """Under ``no_grad`` (sampling, the eval step) a remat model calls each
    layer once and gives the model's outputs."""
    cfg = Config(**{**BASE, **TOPOLOGIES[topology]})
    torch.manual_seed(0)
    model = DiffusionDenoiser(cfg)
    remat = DiffusionDenoiser(cfg.replace(**REMAT), edge_fn=Counted(
        egcl_pair_edges), knn_edge_fn=Counted(egcl_knn_edges))
    remat.load_state_dict(model.state_dict())
    b = batch(cfg)
    t = torch.full((4, cfg.n_max, 1), 0.3) * b.mask.unsqueeze(-1)
    edges = (knn_edges(b.pos, b.mask, cfg.neighbor_k) if cfg.neighbor_k
             else None)
    with torch.no_grad():
        want = model(b.species, b.pos, b.spectrum, b.exo, t, b.mask, edges)
        got = remat(b.species, b.pos, b.spectrum, b.exo, t, b.mask, edges)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    fns = remat.egnn.egcl_0
    counted = fns.knn_edge_fn if cfg.neighbor_k else fns.edge_fn
    assert counted.calls == cfg.L


def test_state_dict_keys_are_unchanged():
    cfg = Config(**{**BASE, **LEVERS["vn-hres-rbf"]})
    torch.manual_seed(0)
    plain = DiffusionDenoiser(cfg)
    torch.manual_seed(0)
    remat = DiffusionDenoiser(cfg.replace(**REMAT))
    assert list(remat.state_dict()) == list(plain.state_dict())
    assert all(k.startswith(("egnn.egcl_", "spectrum_compressor."))
               for k in remat.state_dict())
    for k, v in plain.state_dict().items():
        assert torch.equal(remat.state_dict()[k], v), k


def test_checkpoint_round_trip(tmp_path):
    cfg = Config(**{**BASE, **TOPOLOGIES["knn"], **REMAT})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(1)
    state, m = trainer.train_step(state, TrainNoise(0, "cpu"), batch(cfg))
    assert np.isfinite(float(m["loss"]))
    save_checkpoint(str(tmp_path), state, cfg, step=1)
    for target in (cfg, cfg.replace(remat_egcl=False)):
        back, saved = restore_checkpoint(str(tmp_path), Trainer(target,
                                                                device="cpu"))
        assert saved.remat_egcl and back.step == 1
        for k, p in state.params.items():
            assert torch.equal(back.params[k], p), k


def test_api_train_with_remat_equals_the_run_without(tmp_path):
    cfg = Config(**{**BASE, **TOPOLOGIES["knn"], "num_epochs": 2})
    data = synthetic_sio2_dataset(2, 12, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size, shells=2)
    runs = {}
    for name, c in (("plain", cfg), ("remat", cfg.replace(**REMAT))):
        _, state, _ = api.train(c, data, str(tmp_path / name), device="cpu")
        runs[name] = state
    assert runs["remat"].step == runs["plain"].step > 0
    for k, p in runs["plain"].params.items():
        assert torch.equal(runs["remat"].params[k], p), k


# Both topologies on the polynomial schedule: a learned schedule's gamma
# ``l1`` gradient is float32 rounding at a fresh init (ROADMAP.md F8,
# held to its rounding bound in test_torch_heads_train.py), and flax's remat
# draws another initialisation than the plain model; remat does not reach
# the gamma network (the port's learned case is bit for bit above).
REMAT_CASES = {"dense-predefined": TRAIN_CASES["dense-predefined"],
               "knn-predefined": dict(neighbor_k=3,
                                      optimizer="RAdamScheduleFree")}


@pytest.mark.parametrize("case", list(REMAT_CASES))
def test_remat_train_step_matches_jax(case, monkeypatch):
    monkeypatch.setitem(TRAIN_CASES, case, REMAT_CASES[case])
    train_step_parity(REMAT, ("mlp_x_dense2",), case)
