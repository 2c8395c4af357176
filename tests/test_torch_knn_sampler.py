"""Reverse chains and ``generate`` over kNN neighbour lists, the port
against the JAX package, with the JAX draws replayed (as
``test_torch_sampler.py`` and ``test_torch_api.py`` do for the dense
topology).

The lists are rebuilt from the current positions at every denoiser call.
A neighbour that one package picks and the other does not would send the
two chains apart, so the chains hold K = N-1: every real atom is a
neighbour of every other, whatever the rounding, and only the order of the
slots (and so of the sums) may differ. The flagship runs in float32 over
10 strided steps on the snr grid; tolerances as in ``test_torch_sampler.py``
(positions rtol 1e-3 / atol 1e-2 A, species exactly).
"""

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu import api as jax_api
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.diffusion import sampler as js
from diffusion_model_tpu.diffusion.process import (
    predefined_schedule as jax_schedule,
)
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.train import Trainer
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.api import denoiser_from_params
from diffusion_model_tpu_torch.config import from_dict
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion import sampler as ts
from diffusion_model_tpu_torch.diffusion.process import predefined_schedule
from torch_port_fixtures import (
    Replay,
    SnapshotState,
    flagship,
    flagship_conditions,
    jax_sample_draws,
)

torch.set_num_threads(4)

COPIES = 2
POS_TOL = dict(rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def knn_flagship():
    jcfg, params = flagship()
    jcfg = jcfg.replace(compute_dtype="float32", sample_steps=10,
                        sample_grid="snr", neighbor_k=jcfg.n_max - 1)
    return jcfg, params, flagship_conditions(jcfg)[:3]


def test_knn_chain_matches_jax(knn_flagship):
    jcfg, params, graphs = knn_flagship
    cfg = from_dict(jcfg.to_dict())
    key = jax.random.key(31)
    jcond = js.tile_batch(jax_collate(graphs[:2], jcfg.n_max), COPIES)
    denoise = lambda *a: JaxDenoiser(jcfg).apply(params["denoiser"], *a)
    want = jax.jit(lambda k, c: js.sample(denoise, jax_schedule(jcfg), jcfg,
                                          k, c))(key, jcond)
    assert bool(np.all(want.accepted)), "a chain that fails proves nothing"

    b, n = jcond.mask.shape
    noise = Replay(jax_sample_draws(key, b, n, cfg.atom_type_size,
                                    cfg.sample_steps, stochastic=True))
    seen = []

    def model(*args):
        seen.append(args[-1])
        return net(*args)

    net = denoiser_from_params(cfg, params, "cpu")
    cond = ts.tile_batch(collate(graphs[:2], cfg.n_max, "cpu"), COPIES)
    got = ts.sample(model, predefined_schedule(cfg), cfg, None, cond, noise)
    assert not noise.draws
    assert len(seen) == cfg.sample_steps + 1
    for idx, em in seen:
        assert idx.shape == em.shape == (b, n, cfg.neighbor_k)

    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               **POS_TOL)
    np.testing.assert_array_equal(got.species.numpy(),
                                  np.asarray(want.species))
    np.testing.assert_allclose(got.h.numpy(), np.asarray(want.h), **POS_TOL)
    np.testing.assert_array_equal(got.accepted.numpy(),
                                  np.asarray(want.accepted))


def test_knn_generate_matches_jax(knn_flagship):
    jcfg, params, graphs = knn_flagship
    batch = 2
    key = jax.random.key(29)
    want = jax_api.generate(jcfg, Trainer(jcfg), SnapshotState(params),
                            graphs, key=key, gen_num_per_spectrum=COPIES,
                            batch_size=batch)
    draws, k = [], key
    for _ in range(0, len(graphs), batch):
        k, sub = jax.random.split(k)
        draws += jax_sample_draws(sub, batch * COPIES, jcfg.n_max,
                                  jcfg.atom_type_size, jcfg.sample_steps,
                                  stochastic=True)
    noise = Replay(draws)
    got = api.generate(from_dict(jcfg.to_dict()), params, graphs,
                       gen_num_per_spectrum=COPIES, batch_size=batch,
                       device="cpu", noise=noise)
    assert not noise.draws
    assert got["ids"] == want["ids"]
    for key_ in ("finite", "accepted", "original_pos", "mask",
                 "generated_species"):
        np.testing.assert_array_equal(got[key_], want[key_], err_msg=key_)
    assert got["accepted"].all()
    np.testing.assert_allclose(got["generated_pos"], want["generated_pos"],
                               **POS_TOL)
