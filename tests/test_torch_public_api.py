"""Three public pieces of the JAX package's API in the port, against the JAX
package: ``Config``'s derived MLP sizes, ``GraphBatch.num_nodes`` and
``Trainer.denoise_fn``."""

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.train.trainer import Trainer

torch.set_num_threads(4)

SIZES = ("m_input_size", "m_output_size", "h_input_size", "h_output_size",
         "x_input_size", "x_output_size")
TINY = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=50, batch_size=4)


@pytest.mark.parametrize("kw", [
    {},
    dict(m_size=48, spectrum_size=200, compressed_spectrum_size=32),
    dict(to_compress_spectrum=False, spectrum_size=40),
    dict(conditional=False),
    dict(give_exO=True),
    dict(global_radius_feature=True, neighbor_k=6),
    dict(spectrum_to_latent=True, to_compress_spectrum=False, latent_dim=12),
], ids=["default", "wide", "raw_spectrum", "unconditional", "exo",
        "radius", "latent"])
def test_derived_sizes_match_jax(kw):
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    got = {k: getattr(cfg, k) for k in SIZES}
    assert got == {k: getattr(jcfg, k) for k in SIZES}
    assert got["m_input_size"] == 2 * cfg.h_size + cfg.d_size


@pytest.mark.parametrize("num", [1, 3, 5])
def test_num_nodes_matches_jax(num):
    graphs = synthetic_sio2_dataset(num, num, 12, spectrum_size=16)
    jb = jax_collate(graphs, 12)
    pb = collate(graphs, 12, "cpu")
    got = pb.num_nodes()
    assert isinstance(got, torch.Tensor) and got.ndim == 0
    assert float(got) == float(jb.num_nodes())
    assert float(got) == sum(len(g["pos"]) for g in graphs)


@pytest.mark.parametrize("neighbor_k", [0, 4])
def test_denoise_fn_matches_jax(neighbor_k):
    """Each package's ``Trainer.denoise_fn`` at the same parameters called
    on the same noisy batch (tiny widths, float32; dense and kNN)."""
    from diffusion_model_tpu.ops.edges import knn_edges as jax_knn_edges

    kw = {**TINY, "neighbor_k": neighbor_k}
    jcfg, cfg = JaxConfig(**kw), Config(**kw)
    graphs = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    jb = jax_collate(graphs, cfg.n_max)
    jtrainer = JaxTrainer(jcfg)
    jstate = jtrainer.init_state(jax.random.key(3), jb)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate.params)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=params)

    rng = np.random.default_rng(7)
    b, n, a = 4, cfg.n_max, cfg.atom_type_size
    mask = np.array(jb.mask, np.float32)
    h_t = rng.standard_normal((b, n, a)).astype(np.float32) * mask[..., None]
    pos_t = np.asarray(jb.pos, np.float32) + 0.1 * rng.standard_normal(
        (b, n, 3)).astype(np.float32) * mask[..., None]
    t_norm = np.full((b, n, 1), 0.3, np.float32) * mask[..., None]
    args = (h_t, pos_t, np.array(jb.spectrum, np.float32),
            np.array(jb.exo, np.float32), t_norm, mask)
    if neighbor_k:
        jedges = jax_knn_edges(pos_t, mask, neighbor_k)
        edges = tuple(torch.from_numpy(np.array(e)) for e in jedges)
    else:
        jedges, edges = jb.pair_mask(), None
    want = jtrainer.denoise_fn(jstate.params)(*args, jedges)
    model = trainer.denoise_fn(state.eval_params(cfg))
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in args), edges)
    assert not any(p.requires_grad for p in model.parameters())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-5)
    # bound to its parameters: a later call with others leaves it as it is
    other = {k: v + 1.0 for k, v in state.params.items()}
    trainer.denoise_fn(other)
    with torch.no_grad():
        again = model(*(torch.from_numpy(x) for x in args), edges)
    for g, w in zip(again, got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
