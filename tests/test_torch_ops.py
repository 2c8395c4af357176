"""The port's geometry helpers and padded batches against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.data import batch as jb
from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.ops import angles as ja
from diffusion_model_tpu.ops import com as jc
from diffusion_model_tpu.ops import edges as je
from diffusion_model_tpu_torch.data import batch as tb
from diffusion_model_tpu_torch.ops import angles as ta
from diffusion_model_tpu_torch.ops import com as tc
from diffusion_model_tpu_torch.ops import edges as te

torch.set_num_threads(4)


def _padded(seed=0, b=4, n=9):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, n)) > 0.3).astype(np.float32)
    mask[0] = 0.0   # an empty graph: the mean divides by max(count, 1)
    return x, mask


@pytest.mark.parametrize("with_mask", [True, False])
def test_masked_mean_and_remove_mean(with_mask):
    x, mask = _padded()
    jm = jnp.asarray(mask) if with_mask else None
    tm = torch.from_numpy(mask) if with_mask else None
    np.testing.assert_allclose(
        tc.masked_mean(torch.from_numpy(x), tm).numpy(),
        np.asarray(jc.masked_mean(jnp.asarray(x), jm)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tc.remove_mean(torch.from_numpy(x), tm).numpy(),
        np.asarray(jc.remove_mean(jnp.asarray(x), jm)), rtol=1e-6, atol=1e-7)


def test_pairwise_sq_dist():
    x, _ = _padded(1)
    np.testing.assert_allclose(
        ta.pairwise_sq_dist(torch.from_numpy(x)).numpy(),
        np.asarray(ja.pairwise_sq_dist(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_dense_pair_mask():
    _, mask = _padded(2)
    np.testing.assert_array_equal(
        te.dense_pair_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(je.dense_pair_mask(jnp.asarray(mask))))


def test_collate_matches_jax():
    graphs = synthetic_sio2_dataset(5, 6, 16, spectrum_size=24, shells=2)
    want = jb.collate(graphs, 16)
    got = tb.collate(graphs, 16, device="cpu")
    for field in ("pos", "species", "spectrum", "exo", "mask"):
        t = getattr(got, field)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_array_equal(got.pair_mask().numpy(),
                                  np.asarray(want.pair_mask()))
    assert (got.batch_size, got.n_max, len(got)) == (6, 16, 6)


def test_pad_graph_rejects_oversized_graph():
    g = synthetic_sio2_dataset(5, 1, 16, spectrum_size=8, shells=2)[0]
    with pytest.raises(ValueError, match="n_max"):
        tb.pad_graph(g["pos"], g["species"], g["spectrum"], g["exo"], 3)
