"""One bf16 train step of the flagship against the JAX package's, per leaf,
for several forms of the node side and the edge route: the readings behind
F12's training form (``ROADMAP.md`` §3). No JAX: JAX's step is the committed
``tests/fixtures/torch_port/train.npz`` (``chip_smoke.py`` phase
train_parity's inputs and measure).

    python tests/train_parity_forms.py            # on the card
    python tests/train_parity_forms.py --device cpu

Each form's line: the loss, the median over leaves of the gradient norm's
relative distance from JAX's bf16 norm, the leaves beyond 0.03, and the
four leaves nearest their train_parity tolerance (5e-2, or twice JAX's own
bf16-to-f32 move of the leaf) with (distance, tolerance). Forms: the port
as it is; ``f12_training``: the node MLP in JAX's rounding under autograd
too; each also on JAX's route (variant 2a of ``torch_replay_training_full``:
the compute-dtype edge statement forward and backward, no kernel); and the
port in float32.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as smoke  # noqa: E402
import torch_replay_training_full as full  # noqa: E402
from diffusion_model_tpu_torch.data.batch import collate  # noqa: E402
from diffusion_model_tpu_torch.data.split import split_dataset  # noqa: E402
from diffusion_model_tpu_torch.nn import egnn  # noqa: E402
from diffusion_model_tpu_torch.ops.activations import bias_silu  # noqa: E402
from diffusion_model_tpu_torch.train.checkpoint import (  # noqa: E402
    load_config_npz,
    load_params_npz,
    port_name,
)
from diffusion_model_tpu_torch.train.trainer import Trainer  # noqa: E402
from torch_port_fixtures import ReplayDraws  # noqa: E402


def f12_node_mlp(cat, h0, h1, zeros=None):
    """The node MLP in JAX's rounding whatever autograd does."""
    (w0, b0), (w1, b1) = h0, h1
    return F.linear(bias_silu(F.linear(cat, w0), b0), w1) + b1


@contextlib.contextmanager
def node_mlp(form):
    saved = egnn.node_mlp
    if form is not None:
        egnn.node_mlp = form
    try:
        yield
    finally:
        egnn.node_mlp = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    with np.load(smoke.TRAIN_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    draws = {k[len("draw_"):]: [v] for k, v in fx.items()
             if k.startswith("draw_")}
    cfg = load_config_npz(str(smoke.SNAPSHOT))
    params = load_params_npz(str(smoke.SNAPSHOT))
    train = split_dataset(smoke.flagship_graphs(cfg), cfg.seed)[0]
    batch = collate(train[:len(fx["draw_t"])], cfg.n_max, dev)
    names = ["denoiser." + port_name(n.split("/", 2)[2])
             for n in fx["leaf_names"]]
    want, f32 = fx["grad_norm_bfloat16"], fx["grad_norm_float32"]
    tol = np.maximum(5e-2, 2 * np.abs(want - f32) / np.abs(f32))

    def run(label, form=None, dt="bfloat16", **edge_fns):
        with node_mlp(form):
            trainer = Trainer(cfg.replace(compute_dtype=dt), device=dev,
                              **edge_fns)
            state = trainer.init_state(cfg.seed, params=params)
            loss, _, _, grads = trainer.loss_and_grads(
                state, ReplayDraws(draws, dev), batch)
        g = np.array([float(grads[k].norm()) for k in names])
        err = np.abs(g - want) / np.abs(want)
        top = np.argsort(-err / tol)[:4]
        print(label, "loss", float(loss), "median", float(np.median(err)),
              "beyond_0.03", int((err > 0.03).sum()),
              [(names[i][len("denoiser."):], round(float(err[i]), 4),
                round(float(tol[i]), 4)) for i in top], flush=True)

    jax_route = full.variant_edge_fns("2a")
    run("port")
    run("port, jax route", **jax_route)
    run("f12_training", f12_node_mlp)
    run("f12_training, jax route", f12_node_mlp, **jax_route)
    run("port float32", dt="float32")
    return 0


if __name__ == "__main__":
    sys.exit(main())
