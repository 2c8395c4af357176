"""Where a non-finite Kabsch train step comes from: the step of
``chip_smoke.py`` phase kabsch_finetune replayed from the card's own draws.

    python tests/kabsch_chain_replay.py [--steps 50 100 250] [--draw 1] \\
        [--neighbor_k 0] [--out chiprun_out/kabsch_chain_replay.json]

Runs on the card and imports no JAX. For each ``kabsch_loss_steps``: the
phase's batch (the first ``KABSCH_B`` graphs that ``device_batch_iterator``
gives from the flagship's train split) and the draws of one of its
shorter steps (``TrainNoise((seed, 15, draw))`` on the card: draws 1-3 the
dense steps, 9 the kNN-15 one), kept from one bf16
``Trainer.loss_and_grads`` on the card (the step itself: loss and gradient
norm). The same draws are then replayed, moved to each device,
through

* the float32 ``loss_and_grads`` on the card;
* the Kabsch term's reverse chain alone (``sample_with_grad`` with grad on,
  as ``Trainer._kabsch_loss`` runs it; no backward) in bf16 and float32 on
  the card and in float32 on the CPU. A hook on the denoiser reads every
  call: for each graph, the first grid step whose positions or output are
  not finite, and the largest finite |position| before it; then each
  graph's Kabsch RMSD against its ground truth.

A graph whose chain stays finite and whose RMSD is not would be the SVD's
fault; one whose chain leaves the finite range is the chain's. The card's
float32 chain against the CPU's says whether the kernels' route matters.
Prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


class Recorded:
    """A training noise source that keeps a CPU copy of each of ``src``'s
    draws, by stream, in order."""

    def __init__(self, src):
        self.src, self.draws = src, {}

    def _keep(self, stream, x):
        self.draws.setdefault(stream, []).append(x.cpu())
        return x

    def randint(self, stream, low, high, shape):
        return self._keep(stream, self.src.randint(stream, low, high, shape))

    def normal(self, stream, shape):
        return self._keep(stream, self.src.normal(stream, shape))

    def bernoulli(self, stream, p, shape):
        return self._keep(stream, self.src.bernoulli(stream, p, shape))


class Replayed:
    """The draws a ``Recorded`` source kept, in the same order, on
    ``device``."""

    def __init__(self, draws, device):
        self.draws, self.device = draws, device
        self.at = {k: 0 for k in draws}

    def _next(self, stream, shape):
        x = self.draws[stream][self.at[stream]]
        self.at[stream] += 1
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{stream}: kept {tuple(x.shape)}, asked "
                             f"{tuple(shape)}")
        return x.to(self.device)

    def randint(self, stream, low, high, shape):
        return self._next(stream, shape)

    def normal(self, stream, shape):
        return self._next(stream, shape)

    def bernoulli(self, stream, p, shape):
        return self._next(stream, shape)


def watched_chain(trainer, cfg, batch, draws, device) -> dict:
    """The Kabsch term's chain from ``draws``, each denoiser call read by a
    hook; per graph the first non-finite grid step and the RMSD."""
    import torch

    from diffusion_model_tpu_torch.diffusion.sampler import sample_with_grad
    from diffusion_model_tpu_torch.ops.kabsch import kabsch_rmsd

    steps = cfg.kabsch_loss_steps or cfg.num_diffusion_timestep
    calls = []

    def hook(module, args, out):
        b = args[1].shape[0]
        pos = args[1].detach().float().reshape(b, -1)
        outs = [o.detach().float().reshape(b, -1) for o in out]
        finite = torch.isfinite(pos).all(-1)
        for o in outs:
            finite &= torch.isfinite(o).all(-1)
        size = torch.where(torch.isfinite(pos), pos.abs(),
                           torch.zeros_like(pos)).amax(-1)
        calls.append((finite.cpu(), size.cpu()))

    noise = Replayed(draws, device)
    handle = trainer.model.register_forward_hook(hook)
    t0 = time.perf_counter()
    try:
        res = sample_with_grad(
            trainer.model, trainer.schedule_for(trainer.gamma),
            cfg.replace(sample_steps=steps, sample_grid="uniform"), batch,
            lambda shape: noise.normal("kabsch", shape))
    finally:
        handle.remove()
    real = (batch.mask > 0).any(dim=-1)
    gen = res.pos.detach().float()
    # the CPU's SVD raises on a non-finite matrix (the card's returns NaN):
    # a graph whose structure is not finite reads NaN without the SVD
    done = torch.isfinite(gen.reshape(len(real), -1)).all(-1)
    rmsd = torch.full((len(real),), float("nan"))
    if done.any():
        rmsd[done.cpu()] = kabsch_rmsd(gen[done], batch.pos[done].float(),
                                       batch.mask[done]).cpu()
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = torch.stack([c[0] for c in calls])   # [calls, B]
    size = torch.stack([c[1] for c in calls])
    # call k is grid step steps - k; call ``steps`` is the t=0 epilogue
    failing = []
    for g in range(finite.shape[1]):
        bad = (~finite[:, g]).nonzero()
        if not bool(real[g]) or len(bad) == 0:
            continue
        k = int(bad[0])
        failing.append({"graph": g, "first_nonfinite_step": steps - k,
                        "largest_abs_pos_before": float(size[:k, g].max())
                        if k else None,
                        "rmsd": float(rmsd[g])})
    ok = real.cpu() & torch.isfinite(rmsd)
    chain_ok = real.cpu() & finite.all(0) & done.cpu()
    return {"device": device.type, "compute_dtype": cfg.compute_dtype,
            "calls": len(calls), "real_graphs": int(real.sum()),
            "finite_chains": int(chain_ok.sum()),
            "finite_rmsd": int(ok.sum()),
            "rmsd_nan_with_finite_chain": int((chain_ok & ~ok).sum()),
            "mean_rmsd": float(rmsd[real.cpu()].mean()),
            "mean_rmsd_finite": float(rmsd[ok].mean()) if ok.any() else None,
            "failing": failing, "rmsd": rmsd.tolist(), "wall_s": wall}


def step_on(cfg, params, batch, noise, device) -> tuple:
    """``Trainer.loss_and_grads`` from ``noise`` (loss, gradient norm,
    seconds), and the trainer that ran it."""
    import torch

    from diffusion_model_tpu_torch.train import optim
    from diffusion_model_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(cfg.seed, params=params)
    t0 = time.perf_counter()
    loss, _, _, grads = trainer.loss_and_grads(state, noise, batch)
    rec = {"loss": float(loss), "grad_norm": float(optim.global_norm(grads)),
           "s": time.perf_counter() - t0}
    return rec, trainer


def main(argv=None) -> int:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.split import (
        device_batch_iterator,
        split_dataset,
    )
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--steps", type=int, nargs="+", default=[50, 100, 250])
    p.add_argument("--draw", type=int, default=1,
                   help="the phase's shorter step: 1-3 dense, 9 kNN")
    p.add_argument("--neighbor_k", type=int, default=0)
    p.add_argument("--out", default="chiprun_out/kabsch_chain_replay.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.set_num_threads(os.cpu_count() or 1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    base = load_config_npz(str(chip_smoke.SNAPSHOT)).replace(
        kabsch_loss=True, neighbor_k=args.neighbor_k)
    params = load_params_npz(str(chip_smoke.SNAPSHOT))
    train = split_dataset(chip_smoke.flagship_graphs(base), base.seed)[0]
    batch = next(device_batch_iterator(collate(train, base.n_max, cuda),
                                       chip_smoke.KABSCH_B, seed=0))
    batch_cpu = batch.map(lambda a: a.cpu())
    out = {"card": card, "torch": torch.__version__,
           "snapshot": str(chip_smoke.SNAPSHOT.relative_to(REPO)),
           "batch": int(batch.mask.shape[0]),
           "neighbor_k": args.neighbor_k,
           "draws": f"TrainNoise((seed, 15, {args.draw})) on the card",
           "runs": {}}
    for steps in args.steps:
        cfg = base.replace(kabsch_loss_steps=steps)
        f32 = cfg.replace(compute_dtype="float32")
        noise = Recorded(TrainNoise((base.seed, 15, args.draw), cuda))
        bf16, trainer = step_on(cfg, params, batch, noise, cuda)
        draws = noise.draws
        run = {"step_card_bf16": bf16}
        run["step_card_f32"], trainer32 = step_on(
            f32, params, batch, Replayed(draws, cuda), cuda)
        # the eps term alone: the Kabsch term is the rest of the loss
        with torch.no_grad():
            eps = trainer._loss(trainer.model, trainer.gamma,
                                Replayed(draws, cuda), batch,
                                kabsch=False)[0]
        run["eps_term_card_bf16"] = float(eps)
        run["chain_card_bf16"] = watched_chain(trainer, cfg, batch, draws,
                                               cuda)
        run["chain_card_f32"] = watched_chain(trainer32, f32, batch, draws,
                                              cuda)
        cpu_trainer = Trainer(f32, device=cpu)
        cpu_trainer.init_state(f32.seed, params=params)
        run["chain_cpu_f32"] = watched_chain(cpu_trainer, f32, batch_cpu,
                                             draws, cpu)
        a = torch.tensor(run["chain_card_f32"]["rmsd"])
        b = torch.tensor(run["chain_cpu_f32"]["rmsd"])
        both = torch.isfinite(a) & torch.isfinite(b)
        run["f32_card_vs_cpu_rmsd_max_gap"] = (
            float((a[both] - b[both]).abs().max()) if both.any() else None)
        run["f32_nonfinite_same_graphs"] = (
            sorted(f["graph"] for f in run["chain_card_f32"]["failing"])
            == sorted(f["graph"] for f in run["chain_cpu_f32"]["failing"]))
        out["runs"][str(steps)] = run
        print(json.dumps({"steps": steps, **{
            k: ({kk: vv for kk, vv in v.items() if kk != "rmsd"}
                if isinstance(v, dict) else v) for k, v in run.items()}}),
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
