"""The milliseconds of a flagship bf16 denoiser call and of a served call on
the card, for the package under ``--repo`` (another checkout's root, to time
two trees in one call):

  * ``denoiser``: one call of the flagship denoiser
    (``artifacts/q_predef_r5.npz``, bf16, dense route, K1) on the served
    80 x 16 chunk at t/T = 0.5 (``chip_smoke.py`` ``served_inputs``), under
    ``no_grad``: the mean of ``--reps`` calls back to back after one untimed
    call (CUDA events, host-paced where the host is the bottleneck), taken
    ``--rounds`` times; then one call under ``torch.profiler``: the card's
    busy milliseconds, its kernels and the kernels that took the most
    device time;
  * ``served``: the same weights exported by ``serve.export_sampler`` for
    16 conditions at 250 strided deterministic steps (``chip_smoke.py``
    phase served_export's dense artifact), loaded with
    ``serve.ServedSampler`` and called ``--rounds`` times after one untimed
    call, each on the host's clock.

Where the package has F12's node side (``ops.activations.node_mlp``),
``--forms port,one_op`` also times, in the same process, the node MLP and
the virtual-node channel in the form before F12 (``F.linear`` and torch's
one-op SiLU, as ``test_torch_node_statement.one_op_node_side``), the forms
in turn each round: the cost of F12's form on one host, without the spread
between processes.

    python tests/denoiser_call_times.py --out build/calls_change.json
    python tests/denoiser_call_times.py --repo build/parent \\
        --out build/calls_parent.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SERVE_B = 16
SERVE_STEPS = 250
SERVE_SEED = 7


@contextlib.contextmanager
def node_side(form: str):
    """The package's node side as ``form`` runs it: ``port`` as it is,
    ``one_op`` as before F12 (``F.linear`` and torch's one-op SiLU)."""
    if form == "port":
        yield
        return
    import torch.nn.functional as F

    from diffusion_model_tpu_torch.nn import egnn

    kept = egnn.node_mlp, egnn.silu_dense
    egnn.node_mlp = lambda cat, h0, h1, zeros=None: F.linear(
        F.silu(F.linear(cat, *h0)), *h1)
    egnn.silu_dense = lambda layer, weights, *inputs: F.silu(
        layer(*inputs, weights))
    try:
        yield
    finally:
        egnn.node_mlp, egnn.silu_dense = kept


def in_turn(calls: dict, timer, rounds: int) -> dict:
    """form -> ``timer(call)`` once a round, the forms in turn, round r
    starting at the r-th form."""
    out = {form: [] for form in calls}
    order = list(calls)
    for r in range(rounds):
        for form in order[r % len(order):] + order[:r % len(order)]:
            with node_side(form):
                out[form].append(timer(calls[form]))
    return out


def denoiser_times(cfg, params, fx, device, reps: int, rounds: int,
                   forms) -> dict:
    import torch

    from chip_smoke import served_inputs
    from diffusion_model_tpu_torch.api import denoiser_from_params
    from train_step_times import cuda_ms, device_profile

    inputs = served_inputs(fx)
    calls = {}
    for form in forms:
        model = denoiser_from_params(cfg, params, device)
        calls[form] = lambda m=model: m(*inputs)
    with torch.no_grad():
        ms = in_turn(calls, lambda call: cuda_ms(call, reps), rounds)
        rec = {}
        for form, call in calls.items():
            with node_side(form):
                rec[form] = {"ms": ms[form], **device_profile(call)}
    return rec


def served_times(cfg, params, fx, device, rounds: int, forms) -> dict:
    import torch

    from diffusion_model_tpu_torch import serve
    from diffusion_model_tpu_torch.train.trainer import Trainer

    served_cfg = cfg.replace(sample_steps=SERVE_STEPS,
                             deterministic_sampling=True)
    trainer = Trainer(served_cfg, device=device)
    state = trainer.init_state(cfg.seed, params=params,
                               skip_gamma_fit=True)
    cond = [fx[k][:SERVE_B].cpu().numpy()
            for k in ("cond_spectrum", "cond_exo", "cond_mask")]
    served, export_s = {}, {}
    with tempfile.TemporaryDirectory(dir=HERE.parent / "build") as tmp:
        for form in forms:
            path = str(Path(tmp) / f"{form}.pt2")
            t0 = time.perf_counter()
            with node_side(form):
                serve.export_sampler(served_cfg, trainer, state, path,
                                     SERVE_B)
            export_s[form] = time.perf_counter() - t0
            served[form] = serve.ServedSampler(path)
    del trainer, state
    torch.cuda.empty_cache()

    def host_ms(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(SERVE_SEED, *cond)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    for call in served.values():
        call(SERVE_SEED, *cond)
    ms = in_turn(served, host_ms, rounds)
    return {form: {"ms": ms[form], "export_s": export_s[form]}
            for form in forms} | {"batch": SERVE_B,
                                  "sample_steps": SERVE_STEPS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=str(HERE.parent),
                   help="root of the checkout whose package is timed")
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--forms", default="port",
                   help="comma-separated: port, one_op (F12's package only)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    repo = Path(args.repo).resolve()
    sys.path[:0] = [str(repo), str(HERE)]
    import torch

    if not torch.cuda.is_available():
        print("denoiser_call_times: no CUDA device", file=sys.stderr)
        return 1
    import diffusion_model_tpu_torch
    from chip_smoke import FIXTURE, card_line, load_fixture
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    forms = args.forms.split(",")
    device = torch.device("cuda", 0)
    snapshot = str(HERE.parent / "artifacts" / "q_predef_r5.npz")
    cfg = load_config_npz(snapshot).replace(compute_dtype="bfloat16")
    params = load_params_npz(snapshot)
    fx, _ = load_fixture(device)
    (HERE.parent / "build").mkdir(exist_ok=True)
    rec = {"repo": str(repo),
           "package": str(Path(diffusion_model_tpu_torch.__file__).parent),
           "fixture": str(FIXTURE), "card": card_line(), "reps": args.reps,
           "rounds": args.rounds,
           "denoiser": denoiser_times(cfg, params, fx, device, args.reps,
                                      args.rounds, forms),
           "served": served_times(cfg, params, fx, device, args.rounds,
                                  forms)}
    print(json.dumps(rec))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
