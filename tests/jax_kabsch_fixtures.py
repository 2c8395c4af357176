"""Writes ``tests/fixtures/torch_port/kabsch_loss.npz``: the JAX package's
Kabsch coordinate loss (``diffusion_model_tpu.train.Trainer._loss`` with
``kabsch_loss``) and its gradient at ``tests/test_variants.py``'s tiny
widths, for the cases ``tests/test_torch_kabsch_loss.py`` holds the port to.

    JAX_PLATFORMS=cpu python tests/jax_kabsch_fixtures.py

Each case is one ``jax.value_and_grad`` of ``_loss`` from the parameters of
``Trainer.init_state(jax.random.key(0), .)`` on one batch of
``synthetic_sio2_dataset(0, .)`` at key ``KEY``; the file keeps the
parameters, the batches, every draw the loss makes (``k_diff``'s, the
reverse chain's from ``k_kabsch``, by the port's stream names), the loss,
``sum_sq`` and every gradient leaf. A JAX compile costs seconds a case, so
the test runs one case live and reads the rest from here. ~1 min on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "torch_port" / "kabsch_loss.npz"
KEY = 5
# tests/test_variants.py tiny_cfg
TINY = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=20, batch_size=4, lr=1e-3,
            optimizer="Adam", noise_precision=0.05, kabsch_loss=True)
LEARNED = dict(noise_schedule="learned", optimizer="RAdamScheduleFree")
# case -> (config fields, batch): "full" is 4 graphs, "padded" the last
# batch of 6 graphs, whose 2 rows past the data are zero-mask padding
CASES = {
    "dense_s3": (dict(kabsch_loss_steps=3), "full"),
    "dense_s5": (dict(kabsch_loss_steps=5), "full"),
    "dense_T": (dict(kabsch_loss_steps=0), "full"),
    "knn_s3": (dict(kabsch_loss_steps=3, neighbor_k=3), "full"),
    "knn_T": (dict(kabsch_loss_steps=0, neighbor_k=3), "full"),
    "learned_s5": (dict(kabsch_loss_steps=5, **LEARNED), "full"),
    "learned_T": (dict(kabsch_loss_steps=0, **LEARNED), "full"),
    "padded_s3": (dict(kabsch_loss_steps=3), "padded"),
}
BATCH_FIELDS = ("pos", "species", "spectrum", "exo", "mask")


def jax_batches(jcfg) -> dict:
    """The two JAX batches of the cases."""
    from diffusion_model_tpu.data.split import batch_iterator
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset

    def first(num, last=False):
        graphs = synthetic_sio2_dataset(0, num, jcfg.n_max,
                                        spectrum_size=jcfg.spectrum_size)
        batches = list(batch_iterator(graphs, jcfg.batch_size, jcfg.n_max))
        return batches[-1] if last else batches[0]

    return {"full": first(8), "padded": first(6, last=True)}


def kabsch_draws(key, jcfg, b: int, n: int) -> list:
    """The reverse chain's draws from ``_loss``'s ``k_kabsch``."""
    import jax

    from torch_port_fixtures import jax_sample_draws

    _, k_kabsch, _ = jax.random.split(key, 3)
    steps = jcfg.kabsch_loss_steps or jcfg.num_diffusion_timestep
    stochastic = (not jcfg.deterministic_sampling
                  and jcfg.sample_noise_scale != 0)
    return jax_sample_draws(k_kabsch, b, n, jcfg.atom_type_size, steps,
                            stochastic)


def jax_case(name: str, batches: dict) -> tuple:
    """(params, loss, sum_sq, grads) of one case, trees as JAX's."""
    import jax

    from diffusion_model_tpu.config import Config as JaxConfig
    from diffusion_model_tpu.train import Trainer as JaxTrainer

    fields, which = CASES[name]
    jcfg = JaxConfig(**{**TINY, **fields})
    trainer = JaxTrainer(jcfg)
    state = trainer.init_state(jax.random.key(0), batches["full"],
                               skip_gamma_fit=True)
    (loss, (sum_sq, _)), grads = jax.jit(jax.value_and_grad(
        trainer._loss, has_aux=True))(state.params, jax.random.key(KEY),
                                      batches[which])
    return state.params, float(loss), float(sum_sq), grads


def case_draws(name: str, batches: dict) -> dict:
    """Every draw of one case's ``_loss``, by stream."""
    import jax

    from diffusion_model_tpu.config import Config as JaxConfig
    from torch_port_fixtures import jax_loss_draws

    fields, which = CASES[name]
    jcfg = JaxConfig(**{**TINY, **fields})
    b, n = batches[which].mask.shape
    key = jax.random.key(KEY)
    draws = jax_loss_draws(key, jcfg, b, n)
    draws["kabsch"] = kabsch_draws(key, jcfg, b, n)
    return draws


def build() -> dict:
    from diffusion_model_tpu.config import Config as JaxConfig
    from torch_port_fixtures import flat_leaves

    batches = jax_batches(JaxConfig(**TINY))
    out = {}
    for which, batch in batches.items():
        for f in BATCH_FIELDS:
            out[f"batch_{which}_{f}"] = np.asarray(getattr(batch, f),
                                                   np.float32)
    for name in CASES:
        params, loss, sum_sq, grads = jax_case(name, batches)
        for k, v in flat_leaves(params).items():
            # every case starts from key 0: one copy of each leaf
            v = np.asarray(v, np.float32)
            np.testing.assert_array_equal(out.setdefault(f"param:{k}", v), v)
        for k, v in flat_leaves(grads).items():
            out[f"{name}:grad:{k}"] = np.asarray(v, np.float32)
        out[f"{name}:loss"] = np.float32(loss)
        out[f"{name}:sum_sq"] = np.float32(sum_sq)
        for stream, arrays in case_draws(name, batches).items():
            for i, a in enumerate(arrays):
                out[f"{name}:draw:{stream}:{i:03d}"] = np.asarray(a)
        print(f"{name}: loss {loss:.6f}", flush=True)
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **build())
    print(f"wrote {FIXTURE} ({FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    sys.exit(main())
