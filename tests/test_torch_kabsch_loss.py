"""The port's Kabsch coordinate loss (``Trainer._kabsch_loss`` through
``diffusion.sampler.sample_with_grad``) against the JAX package's
``Trainer._loss`` with ``kabsch_loss``, at ``tests/test_variants.py``'s tiny
widths, on the CPU.

* From JAX's parameters, on JAX's batch and with every draw JAX's loss makes
  (``k_diff``'s and the reverse chain's from ``k_kabsch``, replayed through
  the port's streams): the loss to rtol 1e-5 and every gradient leaf through
  ``test_torch_trainer.assert_leaves_close`` at 5e-3, the float32 train
  step's tolerance; at ``kabsch_loss_steps`` 3, 5 and 0 (the full T=20),
  dense and kNN, predefined and learned schedules, and on a batch with two
  zero-mask padded rows. One case runs JAX live (and holds the fixture to
  it); the rest read ``tests/fixtures/torch_port/kabsch_loss.npz``
  (``tests/jax_kabsch_fixtures.py`` writes it).
* The checkpointed chain's gradients equal, bit for bit, those of the same
  loss with every denoiser call made plainly, with ``remat_egcl`` off and on
  (the checkpoints nest), dense and kNN, with the draws from explicit
  generators; the recompute calls each layer's edge function again.
* The eval step runs no chain and its ``sum_sq`` is the one without the
  term; ``sample`` and ``sample_with_grad`` give the same chain.
* A chain that leaves the finite range makes the loss NaN on the CPU, as in
  the JAX package and on the card (it raised here before: F10), and the
  card's own non-finite Kabsch steps of the flagship come from such chains
  (``tests/kabsch_chain_replay.py``'s records, read here).

The card's case (through K1) is in ``test_torch_cuda.py``.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion import sampler
from diffusion_model_tpu_torch.diffusion.process import predefined_schedule
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.ops.egcl_knn import egcl_knn_edges
from diffusion_model_tpu_torch.ops.egcl_pair import egcl_pair_edges
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer
from jax_kabsch_fixtures import BATCH_FIELDS, CASES, FIXTURE, TINY
from test_torch_remat import BASE, Counted
from test_torch_trainer import assert_leaves_close, np_tree, port_names
from torch_port_fixtures import ReplayDraws

torch.set_num_threads(4)

LIVE = "dense_s3"


def nested(flat: dict) -> dict:
    """A ``/``-joined leaf map as a nested tree."""
    tree = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def case_cfg(name: str) -> Config:
    return Config(**{**TINY, **CASES[name][0]})


def case_batch(fx: dict, name: str) -> GraphBatch:
    which = CASES[name][1]
    return GraphBatch(**{f: torch.from_numpy(fx[f"batch_{which}_{f}"])
                         for f in BATCH_FIELDS})


def case_draws(fx: dict, name: str) -> dict:
    draws = {}
    for k in sorted(k for k in fx if k.startswith(f"{name}:draw:")):
        stream = k.split(":")[2]
        draws.setdefault(stream, []).append(fx[k])
    return draws


def prefixed(fx: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in fx.items()
            if k.startswith(prefix)}


def port_loss_and_grads(fx: dict, name: str, draws: dict):
    cfg = case_cfg(name)
    params = nested(prefixed(fx, "param:"))
    if cfg.noise_schedule != "learned":
        params.pop("gamma")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=params)
    loss, sum_sq, _, grads = trainer.loss_and_grads(
        state, ReplayDraws(draws), case_batch(fx, name))
    return float(loss), float(sum_sq), grads


def check_case(fx: dict, name: str, loss: float, sum_sq: float,
               grads: dict) -> None:
    got_loss, got_sq, got_grads = port_loss_and_grads(
        fx, name, case_draws(fx, name))
    np.testing.assert_allclose(got_loss, loss, rtol=1e-5)
    np.testing.assert_allclose(got_sq, sum_sq, rtol=1e-5)
    assert_leaves_close(got_grads, port_names(grads), 5e-3)


@pytest.mark.parametrize("name", sorted(set(CASES) - {LIVE}))
def test_kabsch_loss_matches_jax(fixture, name):
    check_case(fixture, name, float(fixture[f"{name}:loss"]),
               float(fixture[f"{name}:sum_sq"]),
               nested(prefixed(fixture, f"{name}:grad:")))


def test_kabsch_loss_matches_jax_live(fixture):
    """JAX's loss computed now: the port against it, and the fixture
    against it (a stale fixture fails here)."""
    import jax

    from jax_kabsch_fixtures import case_draws as jax_case_draws
    from jax_kabsch_fixtures import jax_batches, jax_case
    from diffusion_model_tpu.config import Config as JaxConfig
    from torch_port_fixtures import flat_leaves

    batches = jax_batches(JaxConfig(**TINY))
    params, loss, sum_sq, grads = jax_case(LIVE, batches)
    draws = jax_case_draws(LIVE, batches)
    for stream, arrays in draws.items():
        for i, a in enumerate(arrays):
            np.testing.assert_array_equal(
                fixture[f"{LIVE}:draw:{stream}:{i:03d}"], a)
    for k, v in flat_leaves(np_tree(params)).items():
        np.testing.assert_array_equal(fixture[f"param:{k}"], v, err_msg=k)
    np.testing.assert_allclose(float(fixture[f"{LIVE}:loss"]), loss,
                               rtol=1e-6)
    for k, v in flat_leaves(np_tree(grads)).items():
        np.testing.assert_allclose(fixture[f"{LIVE}:grad:{k}"], v,
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    check_case(fixture, LIVE, loss, sum_sq, jax.tree.map(np.asarray, grads))


def test_padded_rows_keep_the_gradient_finite(fixture):
    """The template stands in for the two zero-mask rows: a finite loss,
    finite gradients, and the RMSD averaged over the two real graphs."""
    name = "padded_s3"
    batch = case_batch(fixture, name)
    assert int((batch.mask > 0).any(dim=-1).sum()) == 2
    loss, _, grads = port_loss_and_grads(fixture, name,
                                         case_draws(fixture, name))
    assert np.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


# -- the checkpoint ---------------------------------------------------

def plain_call(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint``'s signature, as a plain call."""
    kwargs.pop("use_reentrant", None)
    return fn(*args)


def step_grads(cfg: Config, plain: bool, monkeypatch):
    """(loss, grads, edge-function calls) of one ``loss_and_grads`` from
    the parameters drawn from seed 3, the draws from ``TrainNoise``."""
    pair, knn = Counted(egcl_pair_edges), Counted(egcl_knn_edges)
    trainer = Trainer(cfg, device="cpu", edge_fn=pair, knn_edge_fn=knn)
    state = trainer.init_state(3)
    fx_batch = batch_of(cfg)
    with monkeypatch.context() as m:
        if plain:
            m.setattr(sampler, "checkpoint", plain_call)
        loss, _, _, grads = trainer.loss_and_grads(
            state, TrainNoise(7, "cpu"), fx_batch)
    return loss, grads, pair.calls + knn.calls


def batch_of(cfg: Config) -> GraphBatch:
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import (
        synthetic_sio2_dataset,
    )

    graphs = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    return collate(graphs, cfg.n_max, "cpu")


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("topology", [{}, {"neighbor_k": 3}])
def test_checkpointed_chain_equals_plain_calls_bit_for_bit(topology, remat,
                                                           monkeypatch):
    # test_torch_remat's widths, which the edge functions take (at TINY's
    # the plain route runs)
    cfg = Config(**{**BASE, "zero_init_x": True, "kabsch_loss": True,
                    "kabsch_loss_steps": 3, "remat_egcl": remat,
                    **topology})
    loss, grads, calls = step_grads(cfg, False, monkeypatch)
    p_loss, p_grads, p_calls = step_grads(cfg, True, monkeypatch)
    assert torch.equal(loss, p_loss)
    assert list(grads) == list(p_grads)
    for k, g in grads.items():
        assert torch.equal(g, p_grads[k]), k
    assert any(bool(g.any()) for k, g in grads.items() if "egcl_0" in k)
    # the eps loss's forward, then 3 steps and the epilogue; remat runs
    # each layer again in the backward, the per-call checkpoint each chain
    # call (its inner checkpoints run the layer once more when they nest)
    layer = 2 if remat else 1
    assert p_calls == cfg.L * layer * (1 + 4)
    assert calls == cfg.L * (layer + (layer + 1) * 4)


def test_eval_step_runs_no_chain():
    cfg = Config(**{**TINY, "kabsch_loss_steps": 3})
    calls = []
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    plain = Trainer(cfg.replace(kabsch_loss=False), device="cpu")
    plain.init_state(0)
    batch = batch_of(cfg)
    hook = torch.nn.modules.module.register_module_forward_hook(
        lambda m, i, o: calls.append(1)
        if isinstance(m, DiffusionDenoiser) else None)
    try:
        got = trainer.eval_step(state, TrainNoise(1, "cpu"), batch)
    finally:
        hook.remove()
    want = plain.eval_step(state, TrainNoise(1, "cpu"), batch)
    assert len(calls) == 1
    assert torch.equal(got["sum_sq"], want["sum_sq"])


def test_sample_with_grad_gives_the_no_grad_chain():
    cfg = Config(**{**TINY, "sample_steps": 5, "sample_grid": "uniform"})
    torch.manual_seed(0)
    model = DiffusionDenoiser(cfg)
    batch = batch_of(cfg)
    schedule = predefined_schedule(cfg)
    want = sampler.sample(model, schedule, cfg,
                          torch.Generator().manual_seed(4), batch)
    gen = torch.Generator().manual_seed(4)
    got = sampler.sample_with_grad(
        model, schedule, cfg, batch,
        lambda shape: torch.randn(tuple(shape), generator=gen))
    assert got.pos.requires_grad
    for a, w in ((got.pos, want.pos), (got.h, want.h),
                 (got.species, want.species)):
        assert torch.equal(a.detach(), w)
    assert torch.equal(got.accepted, want.accepted)


def test_kabsch_stream_is_appended():
    """Every stream before it keeps its place, so its seed: the resume
    tests and the retrain records stay bit for bit."""
    assert TrainNoise.STREAMS[:6] == ("t", "t_band", "t_sel", "pos", "h",
                                      "drop")
    assert TrainNoise.STREAMS[6:] == ("kabsch",)
    noise = TrainNoise(11, "cpu")
    for i, name in enumerate(TrainNoise.STREAMS):
        state = np.random.SeedSequence([11, i]).generate_state(1)
        assert noise.generators[name].initial_seed() == int(state[0])


def test_ring_training_refuses_the_kabsch_loss():
    """As the JAX package's: the Kabsch term differentiates through the
    whole reverse chain every step, which the ring does not route."""
    cfg = Config(**{**TINY, "kabsch_loss": True})
    with pytest.raises(NotImplementedError,
                       match="kabsch_loss is not routed through the ring"):
        Trainer(cfg, device="cpu").ring_train_step_fn(None)


class InfChain(TrainNoise):
    """``TrainNoise`` whose reverse chain starts one graph at infinity."""

    def normal(self, stream, shape):
        x = super().normal(stream, shape)
        if stream == "kabsch" and len(shape) == 3 and shape[-1] == 3:
            x[1] = float("inf")
        return x


def test_a_chain_that_is_not_finite_makes_the_loss_nan():
    cfg = Config(**{**TINY, "kabsch_loss_steps": 3})
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    loss, _, _, _ = trainer.loss_and_grads(state, InfChain(1, "cpu"),
                                           batch_of(cfg))
    assert bool(torch.isnan(loss))


REPLAYS = sorted((Path(__file__).parent / "fixtures" / "torch_port").glob(
    "kabsch_chain_replay_draw*.json"))


@pytest.mark.parametrize("path", REPLAYS, ids=lambda p: p.stem)
def test_card_nan_kabsch_steps_come_from_the_chain(path):
    """The flagship's Kabsch steps replayed from the card's draws (bf16 and
    float32 on the card, float32 on the CPU): every non-finite step has a
    chain that leaves the finite range in float32 on the CPU too, at the
    same graphs as the card's float32 chain; no RMSD is NaN where its chain
    is finite; the finite chains' RMSDs agree between the card and the CPU
    to 1e-4 A where at most one chain leaves the range (at 50 steps, where
    31 of 64 do, the survivors part by up to 0.14 A)."""
    rec = json.loads(path.read_text())
    assert rec["card"].startswith("NVIDIA H100") and rec["batch"] == 64
    for steps, run in rec["runs"].items():
        chains = [run[k] for k in ("chain_card_bf16", "chain_card_f32",
                                   "chain_cpu_f32")]
        for c in chains:
            assert c["calls"] == int(steps) + 1
            assert c["rmsd_nan_with_finite_chain"] == 0
            assert c["finite_chains"] == c["finite_rmsd"]
        assert run["f32_nonfinite_same_graphs"]
        if chains[2]["finite_chains"] >= 63:
            assert run["f32_card_vs_cpu_rmsd_max_gap"] < 1e-4
        for side, chain in (("step_card_bf16", chains[0]),
                            ("step_card_f32", chains[1])):
            finite = math.isfinite(run[side]["loss"])
            assert finite == (chain["finite_chains"] == 64), (steps, side)
            assert finite == (chains[2]["finite_chains"] == 64), (steps,
                                                                 side)
