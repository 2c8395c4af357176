"""``generate`` of the port against ``diffusion_model_tpu.api.generate``.

Three conditions in chunks of two, so the final chunk is padded with a copy
of its last condition and trimmed. Both sides sample the flagship in
float32 over the 10-step snr grid; the port replays JAX's draws (one key
split per chunk, then the sampler's own splits). Tolerances as in
``test_torch_sampler.py``.
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu import api as jax_api
from diffusion_model_tpu.train import Trainer
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import from_dict
from torch_port_fixtures import (
    Replay,
    SnapshotState,
    flagship,
    flagship_conditions,
    jax_sample_draws,
)

torch.set_num_threads(4)

COPIES = 2
BATCH = 2


@pytest.fixture(scope="module")
def both():
    jcfg, params = flagship()
    jcfg = jcfg.replace(compute_dtype="float32", sample_steps=10,
                        sample_grid="snr")
    graphs = flagship_conditions(jcfg)[:3]
    key = jax.random.key(23)
    want = jax_api.generate(jcfg, Trainer(jcfg), SnapshotState(params),
                            graphs, key=key, gen_num_per_spectrum=COPIES,
                            batch_size=BATCH)

    draws, k = [], key
    for _ in range(0, len(graphs), BATCH):
        k, sub = jax.random.split(k)
        draws += jax_sample_draws(sub, BATCH * COPIES, jcfg.n_max,
                                  jcfg.atom_type_size, jcfg.sample_steps,
                                  stochastic=True)
    noise = Replay(draws)
    got = api.generate(from_dict(jcfg.to_dict()), params, graphs,
                       gen_num_per_spectrum=COPIES, batch_size=BATCH,
                       device="cpu", noise=noise)
    assert not noise.draws
    return want, got, graphs


def test_ids_and_shapes(both):
    want, got, graphs = both
    assert got["ids"] == want["ids"]
    assert got["ids"] == [g["id"] for g in graphs for _ in range(COPIES)]
    assert sorted(got) == sorted(want)
    for k in got:
        if k != "ids":
            assert got[k].shape == want[k].shape, k
            assert got[k].dtype == want[k].dtype, k


def test_flags_and_originals_equal(both):
    want, got, _ = both
    for k in ("finite", "accepted", "original_pos", "original_species",
              "mask", "generated_species"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["accepted"].all()


def test_positions_within_sampler_tolerance(both):
    want, got, _ = both
    np.testing.assert_allclose(got["generated_pos"], want["generated_pos"],
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(got["generated_h"], want["generated_h"],
                               rtol=1e-3, atol=1e-2)


def test_ring_sample_and_size_predictor_are_taken(monkeypatch):
    jcfg, params = flagship()
    cfg = from_dict(jcfg.to_dict())
    # ring sampling carries over (api.generate_ring runs it)
    assert from_dict({**jcfg.to_dict(), "ring_sample": True}).ring_sample
    # size_predictor is ported: generate re-sizes the conditions first
    seen = []

    def record(cfg, size_predictor, graphs):
        seen.append(size_predictor)
        raise LookupError("recorded")

    monkeypatch.setattr(api, "predict_sizes", record)
    with pytest.raises(LookupError, match="recorded"):
        api.generate(cfg, params, [], device="cpu", size_predictor="cn")
    assert seen == ["cn"]


def test_generate_samples_on_the_card_by_default(monkeypatch):
    jcfg, params = flagship()
    cfg = from_dict(jcfg.to_dict())
    graphs = flagship_conditions(jcfg)[:1]
    built = []

    def record(cfg, params, device, *args):
        built.append(torch.device(device))
        raise LookupError("recorded")

    with monkeypatch.context() as m:
        m.setattr(api, "denoiser_from_params", record)
        with pytest.raises(LookupError, match="recorded"):
            api.generate(cfg, params, graphs, gen_num_per_spectrum=1,
                         batch_size=1)
    assert built == [torch.device("cuda")]
    if not torch.cuda.is_available():
        # no card here: CUDA's own error, never a silent run on the CPU
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            api.generate(cfg, params, graphs, gen_num_per_spectrum=1,
                         batch_size=1)
