"""How many of the flagship's strided reverse chains stay finite, in the JAX
package and in the port, on the CPU in float32: the chain a Kabsch train
step at ``kabsch_loss_steps`` runs (the uniform grid), on the first 64
graphs of the flagship's train split, at two sampling keys / seeds each.

    JAX_PLATFORMS=cpu python tests/jax_finite_chains.py 50 100

Prints one line per (package, steps, seed). A single chain that leaves the
finite range makes a Kabsch loss over its batch NaN (neither package guards
against it), so ``chip_smoke.py`` phase kabsch_finetune takes a step count
at which every chain is finite. ~1 min a chain at 100 steps on 8 cores.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCH = 64
SEEDS = (0, 1)


def port_counts(steps_list) -> None:
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import split_dataset
    from diffusion_model_tpu_torch.data.synthetic import (
        synthetic_sio2_dataset,
    )
    from diffusion_model_tpu_torch.diffusion.sampler import sample
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    npz = str(REPO / "artifacts" / "q_predef_r5.npz")
    cfg = load_config_npz(npz).replace(compute_dtype="float32")
    params = load_params_npz(npz)
    graphs = synthetic_sio2_dataset(cfg.seed, 256, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    cond = collate(split_dataset(graphs, cfg.seed)[0][:BATCH], cfg.n_max,
                   "cpu")
    model = api.denoiser_from_params(cfg, params, "cpu")
    schedule = api.schedule_for(cfg, params, "cpu")
    for steps in steps_list:
        c = cfg.replace(sample_steps=steps, sample_grid="uniform")
        for seed in SEEDS:
            t0 = time.time()
            res = sample(model, schedule, c,
                         torch.Generator().manual_seed(seed), cond)
            print(f"port steps {steps} seed {seed}: finite "
                  f"{int(res.finite.sum())} of {BATCH} "
                  f"({time.time() - t0:.0f} s)", flush=True)


def jax_counts(steps_list) -> None:
    import jax
    import numpy as np

    from diffusion_model_tpu.data.batch import collate
    from diffusion_model_tpu.data.split import split_dataset
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
    from diffusion_model_tpu.diffusion.process import predefined_schedule
    from diffusion_model_tpu.diffusion.sampler import sample
    from diffusion_model_tpu.nn import DiffusionDenoiser
    from torch_port_fixtures import flagship

    cfg, params = flagship()
    cfg = cfg.replace(compute_dtype="float32")
    graphs = synthetic_sio2_dataset(cfg.seed, 256, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    cond = collate(split_dataset(graphs, cfg.seed)[0][:BATCH], cfg.n_max)
    model = DiffusionDenoiser(cfg)

    def fn(*args):
        return model.apply(params["denoiser"], *args)

    for steps in steps_list:
        c = cfg.replace(sample_steps=steps, sample_grid="uniform")
        run = jax.jit(lambda k: sample(fn, predefined_schedule(c), c, k,
                                       cond))
        for seed in SEEDS:
            t0 = time.time()
            res = run(jax.random.key(seed))
            print(f"jax steps {steps} seed {seed}: finite "
                  f"{int(np.sum(np.asarray(res.finite)))} of {BATCH} "
                  f"({time.time() - t0:.0f} s)", flush=True)


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    steps_list = [int(a) for a in argv] or [50, 100]
    jax_counts(steps_list)
    port_counts(steps_list)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    sys.exit(main(sys.argv[1:]))
