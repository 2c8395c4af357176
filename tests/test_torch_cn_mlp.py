"""The port's atom-count predictor (``nn.cn_mlp.CNPredictor``) and
``api.predict_sizes`` against the JAX package's, on the CPU, and
``api.generate(size_predictor=...)`` at tiny widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu import api as jax_api
from diffusion_model_tpu.nn.cn_mlp import CNPredictor as JaxCNPredictor
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.nn.cn_mlp import CNPredictor
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from torch_port_fixtures import flagship, flagship_conditions

torch.set_num_threads(4)


def flax_predictor(seed=0, spectrum_size=200, out_bias=None):
    """JAX ``CNPredictor`` params at its defaults (200 -> 100, 100, 50, 25
    -> 1), optionally with the output bias set."""
    module = JaxCNPredictor()
    params = module.init(jax.random.key(seed),
                         jnp.zeros((1, spectrum_size), jnp.float32))
    params = jax.tree.map(np.asarray, params)
    if out_bias is not None:
        params["params"]["dense_out"]["bias"] = np.full((1,), out_bias,
                                                        np.float32)
    return module, params


def test_cn_predictor_matches_flax():
    module, params = flax_predictor()
    spectra = np.random.default_rng(0).random((9, 200)).astype(np.float32)
    want = np.asarray(module.apply(params, jnp.asarray(spectra)))
    model = CNPredictor().load_flax(params)
    with torch.no_grad():
        got = model(torch.from_numpy(spectra)).numpy()
    assert got.shape == want.shape == (9, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(
        want).max())


def test_cn_predictor_refuses_another_tree():
    _, params = flax_predictor()
    with pytest.raises(RuntimeError):
        CNPredictor(hidden_dims=(100, 50)).load_flax(params)


def test_predict_sizes_matches_jax():
    jcfg, _ = flagship()
    graphs = flagship_conditions(jcfg)[:10]
    graphs[3] = dict(graphs[3])
    graphs[3]["spectrum"] = np.array(graphs[3]["spectrum"])
    graphs[3]["spectrum"][0, :] = np.nan      # a non-finite prediction
    module, params = flax_predictor(out_bias=7.0)
    want = jax_api.predict_sizes(jcfg, (module, params), graphs)
    got = api.predict_sizes(from_dict(jcfg.to_dict()),
                            (CNPredictor(), params), graphs)
    true = [len(g["pos"]) for g in graphs]
    sizes = [len(g["pos"]) for g in got]
    assert sizes == [len(g["pos"]) for g in want]
    assert sizes[3] == true[3]                      # NaN: the true size
    assert any(s < t for s, t in zip(sizes, true))  # a shrink
    assert any(s > t for s, t in zip(sizes, true))  # a growth
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                assert g[k].dtype == w[k].dtype, k
            else:
                assert g[k] == w[k], k


def test_predict_sizes_clamps_to_two_and_n_max():
    jcfg, _ = flagship()
    graphs = flagship_conditions(jcfg)[:3]
    cfg = from_dict(jcfg.to_dict())
    for bias, size in ((-50.0, 2), (500.0, cfg.n_max)):
        _, params = flax_predictor(out_bias=bias)
        got = api.predict_sizes(cfg, (CNPredictor(), params), graphs)
        assert [len(g["pos"]) for g in got] == [size] * 3


def test_generate_with_a_size_predictor_runs_on_the_cpu():
    cfg = Config(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
                 x_hidden_size=32, m_size=16, spectrum_size=32,
                 compressed_spectrum_size=8, compressor_hidden_dim=(16,),
                 num_diffusion_timestep=20, sample_steps=5)
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset

    graphs = synthetic_sio2_dataset(0, 4, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size)
    torch.manual_seed(0)
    model = DiffusionDenoiser(cfg, device="cpu").requires_grad_(False)
    _, params = flax_predictor(spectrum_size=cfg.spectrum_size, out_bias=5.0)
    predictor = CNPredictor(spectrum_size=cfg.spectrum_size).load_flax(
        params)
    sized = api.predict_sizes(cfg, (predictor, None), graphs)
    out = api.generate(cfg, model, graphs, gen_num_per_spectrum=2,
                       batch_size=2, device="cpu",
                       size_predictor=(predictor, None))
    assert out["generated_pos"].shape == (8, cfg.n_max, 3)
    np.testing.assert_array_equal(
        out["mask"].sum(axis=1),
        np.repeat([len(g["pos"]) for g in sized], 2))
    assert np.isfinite(out["generated_pos"][out["accepted"]]).all()
