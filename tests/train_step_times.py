"""The milliseconds of two bf16 train steps on the card, for the package
under ``--repo`` (another checkout's root, to time two trees in one call):

  * ``flagship``: the flagship recipe (``artifacts/q_predef_r5.npz``'s
    config: batch 64 of 16-atom graphs, the dense route, K1 forward);
  * ``arm``: the ``h_residual+virtual_node`` arm of F9 at its own widths
    (``torch_replay_training_full.FLAGS``: batch 4 of 160-192-atom network
    cells, kNN-32, K2 forward), from the replay's numpy start.

Each is the mean of ``--reps`` steps after one untimed step (CUDA events,
as ``chip_smoke.py`` ``cuda_ms``), from one state and one batch, taken
``--rounds`` times with the routes in turn (each round starting at the
next route); then one step of each route under ``torch.profiler``: the
device's busy milliseconds, its kernels and the kernels that took the
most device time. The routes (``--routes``) are
the edge functions' backward in a bf16 model:

  * ``port``: the package's own (since F11, autograd of the compute-dtype
    statement, ``ops.egcl_*.egcl_*_edges_compute``);
  * ``as_is``: the route before F11 (autograd of the float32 statement,
    ``torch_replay_training_full.variant_edge_fns("as_is")``);
  * ``fused``: the port's with torch's one-op SiLU and sigmoid in
    ``ops.egcl_pair.compute_tail`` (one rounding each, where the JAX
    package's ``jax.nn.silu`` / ``sigmoid`` round op by op).

``as_is`` and ``fused`` need a tree that has the compute-dtype statement.

    python tests/train_step_times.py --routes port,as_is,fused \\
        --out build/steps_change.json
    python tests/train_step_times.py --repo build/parent \\
        --out build/steps_parent.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_profile(fn, top: int = 8) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the card's busy ms (the
    sum of its events' spans, as ``chip_smoke.py`` phase train_flagship),
    its kernels, and the ``top`` kernels by device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    by_name: dict = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            1e-3 * e.time_range.elapsed_us()
    return {"busy_ms": 1e-3 * sum(e.time_range.elapsed_us() for e in events),
            "kernels": len([e for e in events if not e.name.startswith(
                ("Memcpy", "Memset"))]),
            "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[
                :top])}


def _fused_tail(pre_m, pre_x, em, diff, d2, x_i, w2m, b2m, wa, ba, w2x,
                b2x, wx3, bx3, norm=None):
    """``ops.egcl_pair.compute_tail`` with torch's one-op SiLU and
    sigmoid."""
    import torch
    import torch.nn.functional as F

    dt, f32 = pre_m.dtype, torch.float32
    m = F.silu(F.silu(pre_m) @ w2m.to(dt) + b2m.to(dt))
    m = m * torch.sigmoid(m @ wa.to(dt) + ba.to(dt)) * em.to(dt)
    u = F.silu(F.silu(pre_x) @ w2x.to(dt) + b2x.to(dt))
    s = u @ wx3.to(dt) + bx3.to(dt)
    if norm is None:
        norm = torch.sqrt(torch.where(em > 0, d2.clamp_min(1e-12),
                                      torch.ones_like(d2)))
    upd = diff * (s.to(f32) / (norm + 1.0)) * em
    return m.sum(dim=2), x_i + upd.sum(dim=2)


@contextlib.contextmanager
def route_context(route: str):
    """The package's modules as ``route`` runs them (``fused`` swaps the
    compute statements' tail for ``_fused_tail``)."""
    if route != "fused":
        yield
        return
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    kept = egcl_pair.compute_tail, egcl_knn.compute_tail
    egcl_pair.compute_tail = egcl_knn.compute_tail = _fused_tail
    try:
        yield
    finally:
        egcl_pair.compute_tail, egcl_knn.compute_tail = kept


def route_edge_fns(route: str) -> dict:
    if route == "as_is":
        import torch_replay_training_full as full

        return full.variant_edge_fns("as_is")
    return {}


def flagship_steps(repo: Path, device, routes) -> dict:
    """route -> a callable that takes one flagship train step."""
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import device_batch_iterator
    from diffusion_model_tpu_torch.data.synthetic import (
        synthetic_sio2_dataset,
    )
    from diffusion_model_tpu_torch.train.checkpoint import load_config_npz
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    cfg = load_config_npz(str(repo / "artifacts" / "q_predef_r5.npz"))
    graphs = synthetic_sio2_dataset(cfg.seed, cfg.batch_size, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=2)
    batch = next(device_batch_iterator(collate(graphs, cfg.n_max, device),
                                       cfg.batch_size, seed=0))
    noise = TrainNoise((cfg.seed, 99, 0), device)
    out = {}
    for route in routes:
        trainer = Trainer(cfg, device=device, **route_edge_fns(route))
        state = trainer.init_state(cfg.seed)
        out[route] = (lambda t=trainer, s=state:
                      t.train_step(s, noise, batch))
    return out


def arm_steps(device, routes) -> dict:
    """route -> a callable that takes one train step of F9's arm."""
    import torch_replay_training_full as full
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    meta, _ = full.load_fixture()
    cfg, cells = full.setup()
    cfg = cfg.replace(compute_dtype="bfloat16")
    batch = next(full.port_batches(cfg, cells, device))
    noise = TrainNoise((cfg.seed, 99, 0), device)
    out = {}
    for route in routes:
        trainer = Trainer(cfg, device=device, **route_edge_fns(route))
        state = trainer.init_state(0, params=full.numpy_start(
            meta["start"]["spec"], meta["start"]["seed"]))
        out[route] = (lambda t=trainer, s=state:
                      t.train_step(s, noise, batch))
    return out


def time_routes(steps: dict, reps: int, rounds: int) -> dict:
    """route -> {"ms": one mean a round, the routes in turn each round,
    round r starting at the r-th route; the profiled step's readings}."""
    rec = {route: {"ms": []} for route in steps}
    order = list(steps)
    for r in range(rounds):
        for route in order[r % len(order):] + order[:r % len(order)]:
            with route_context(route):
                rec[route]["ms"].append(cuda_ms(steps[route], reps))
    for route, step in steps.items():
        with route_context(route):
            rec[route].update(device_profile(step))
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--repo", default=str(HERE.parent),
                   help="root of the checkout whose package is timed")
    p.add_argument("--routes", default="port",
                   help="comma-separated: port, as_is, fused")
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    repo = Path(args.repo).resolve()
    routes = args.routes.split(",")
    sys.path[:0] = [str(repo), str(HERE)]
    import torch

    if not torch.cuda.is_available():
        print("train_step_times: no CUDA device", file=sys.stderr)
        return 1
    import diffusion_model_tpu_torch

    device = torch.device("cuda", 0)
    from chip_smoke import card_line

    rec = {"repo": str(repo),
           "package": str(Path(diffusion_model_tpu_torch.__file__).parent),
           "card": card_line(), "reps": args.reps, "rounds": args.rounds,
           "flagship": time_routes(flagship_steps(repo, device, routes),
                                   args.reps, args.rounds),
           "arm": time_routes(arm_steps(device, routes), args.reps,
                              args.rounds)}
    print(json.dumps(rec))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
