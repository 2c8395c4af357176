"""Replayed reverse chains of a snapshot: the JAX package's sampler and the
port's, fed the same standard-normal draws on the CPU in float32, compared
structure by structure.

    JAX_PLATFORMS=cpu python tests/jax_replay_chains.py \\
        artifacts/q_predef_r5.npz --seed 2024 --work build/replay
    JAX_PLATFORMS=cpu python tests/jax_replay_chains.py \\
        artifacts/q_learned_r5_s2025.npz --seed 2025 --cn2 --work build/replay

The conditions are the snapshot's test split (with ``--cn2`` only its CN2
conditions), ``gen_num_per_spectrum`` samples each, chunked and keyed as
``diffusion_model_tpu.api.generate`` does from ``jax.random.key(seed)``.
For each chunk the JAX ``sample`` runs with every frame of its trajectory
kept; the port then runs, on the kept samples:

  * free-running: its ``sample`` with the JAX draws (``Replay``), every
    frame kept: per structure the final species and O fraction against
    JAX's, the largest position gap after 1, 10, 100 and all reverse steps
    and after the epilogue, and the first step where the two chains part
    by more than 0.1 A;
  * teacher-forced: each reverse step and the epilogue started from JAX's
    state with JAX's draw (``ReverseChain.step``/``epilogue``), its result
    held to JAX's next state (largest gap relative to the state's largest
    coordinate), and from JAX's last state the epilogue's species argmax
    against JAX's.

``--phase`` runs one part (``jax``, ``free``, ``forced``, ``report``) so
that the JAX chain and the port's free-running chain can run at once;
each part leaves an npz in ``--work`` for the next, and ``report`` writes
``tests/fixtures/torch_port/replay_<snapshot>_<seed>.json``. Cost on an
8-core CPU for the flagship's 135 structures, two or three parts sharing
it: JAX 67 min, free 105 min, forced 118 min.

The same draws on the card: ``--phase draws`` writes them (with the
conditions) to ``--work``; on a machine with a CUDA card, which needs no
JAX, ``--phase card`` runs the port's chain from them through K1 in
bfloat16 and in float32; ``report`` then adds the card's reading of the
same structures (``card``):

    python tests/jax_replay_chains.py artifacts/q_predef_r5.npz \
        --seed 2024 --work build/replay --phase card
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "torch_port"
PART_BY = 0.1           # A: the chains have parted
GAP_STEPS = (1, 10, 100)


def _setup(args):
    """(JAX config, params, chunks): each chunk a dict of the JAX
    conditioning batch (tiled), its key and its count of kept samples."""
    import jax

    from diffusion_model_tpu.data.batch import collate
    from diffusion_model_tpu.data.split import split_dataset
    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
    from diffusion_model_tpu.diffusion.sampler import tile_batch
    from diffusion_model_tpu.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    cfg = _cut(load_config_npz(args.npz), args)
    params = load_params_npz(args.npz)
    graphs = synthetic_sio2_dataset(cfg.seed, args.num, cfg.n_max,
                                    spectrum_size=cfg.spectrum_size,
                                    shells=args.shells)
    test = split_dataset(graphs, cfg.seed)[2]
    if args.cn2:
        test = [g for g in test if g["cn"] == 2]
    test = test[:args.limit]
    g = cfg.gen_num_per_spectrum
    key = jax.random.key(args.seed)
    chunks = []
    for start in range(0, len(test), args.batch_size):
        chunk = test[start:start + args.batch_size]
        n_real = len(chunk)
        if n_real < args.batch_size and len(test) >= args.batch_size:
            chunk = list(chunk) + [chunk[-1]] * (args.batch_size - n_real)
        key, sub = jax.random.split(key)
        chunks.append({"cond": tile_batch(collate(chunk, cfg.n_max), g),
                       "key": sub, "keep": n_real * g})
    return cfg, params, chunks


def _cut(cfg, args):
    """The snapshot's config in float32 with every frame kept (and, for a
    quick trial, ``--timesteps`` steps)."""
    cfg = cfg.replace(compute_dtype="float32", snapshot_every=1)
    if args.timesteps:
        cfg = cfg.replace(num_diffusion_timestep=args.timesteps)
    return cfg


def _tag(args) -> str:
    return f"{Path(args.npz).stem}_{args.seed}"


def _draws(chunk, cfg):
    from torch_port_fixtures import jax_sample_draws

    b, n = chunk["cond"].mask.shape
    stochastic = (not cfg.deterministic_sampling
                  and cfg.sample_noise_scale != 0)
    steps = cfg.sample_steps or cfg.num_diffusion_timestep
    return [d[:chunk["keep"]] for d in jax_sample_draws(
        chunk["key"], b, n, cfg.atom_type_size, steps, stochastic)]


def phase_jax(args, work: Path):
    """The JAX chains, every frame, and the state entering the epilogue
    (one more JAX step from the last frame with the scan's last keys)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from diffusion_model_tpu.diffusion.process import reverse_diffuse_one_step
    from diffusion_model_tpu.diffusion.sampler import sample
    from diffusion_model_tpu.train import Trainer

    cfg, params, chunks = _setup(args)
    trainer = Trainer(cfg)
    denoise = trainer.denoise_fn(params)
    schedule = trainer.schedule_for(params)
    T = cfg.num_diffusion_timestep
    run = jax.jit(partial(sample, denoise, schedule, cfg,
                          return_trajectory=True))
    out, t0 = {}, time.perf_counter()
    for c, chunk in enumerate(chunks):
        cond, keep = chunk["cond"], chunk["keep"]
        res = run(chunk["key"], cond)
        traj_pos, traj_h = (np.asarray(a) for a in res.trajectory)
        # the keys of the scan's last step, as sample splits them
        k = jax.random.split(chunk["key"], 3)[0]
        for _ in range(T):
            k, k1, k2 = jax.random.split(k, 3)
        m3 = cond.mask[..., None]
        pos, h = jnp.asarray(traj_pos[-1]), jnp.asarray(traj_h[-1])
        scale = cfg.onehot_scaling_factor
        t_norm = jnp.full(m3.shape, 1.0 / T, jnp.float32) * m3
        eps_x, eps_h = denoise(scale * h, pos, cond.spectrum, cond.exo,
                               t_norm, cond.mask, cond.pair_mask())
        pre_pos = reverse_diffuse_one_step(schedule, k1, pos, eps_x, 1,
                                           mode="pos", mask=cond.mask)
        pre_h = reverse_diffuse_one_step(schedule, k2, scale * h, eps_h, 1,
                                         mode="h", mask=cond.mask)
        for name, a in (("traj_pos", traj_pos), ("traj_h", traj_h),
                        ("pre_pos", pre_pos), ("pre_h", pre_h),
                        ("pos", res.pos), ("h", res.h),
                        ("species", res.species),
                        ("accepted", res.accepted),
                        ("orig_species", cond.species),
                        ("mask", cond.mask), ("orig_pos", cond.pos)):
            a = np.asarray(a)
            out[f"{c}_{name}"] = a[:, :keep] if name.startswith("traj") \
                else a[:keep]
        print(f"jax chunk {c}: {time.perf_counter() - t0:.0f} s", flush=True)
    out["seconds"] = time.perf_counter() - t0
    np.savez(work / f"{_tag(args)}_jax.npz", **out)


def _port(args):
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import GraphBatch
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    torch.manual_seed(0)
    cfg = _cut(load_config_npz(args.npz), args)
    params = load_params_npz(args.npz)
    model = api.denoiser_from_params(cfg, params, "cpu")
    schedule = api.schedule_for(cfg, params, "cpu")

    def cond_of(jcond, keep):
        return GraphBatch(**{
            f: torch.from_numpy(np.array(getattr(jcond, f)[:keep]))
            for f in ("pos", "species", "spectrum", "exo", "mask")})

    return cfg, model, schedule, cond_of


def phase_free(args, work: Path):
    """The port's chain from the JAX draws, every frame kept."""
    from torch_port_fixtures import Replay

    import torch

    from diffusion_model_tpu_torch.diffusion.sampler import (
        ReverseChain,
        sample,
    )

    jcfg, _, chunks = _setup(args)
    cfg, model, schedule, cond_of = _port(args)
    out, t0 = {}, time.perf_counter()
    for c, chunk in enumerate(chunks):
        cond = cond_of(chunk["cond"], chunk["keep"])
        draws = _draws(chunk, jcfg)
        res = sample(model, schedule, cfg, None, cond,
                     noise=Replay(draws), return_trajectory=True)
        # the state entering the epilogue: the last step once more, from
        # the last frame with its own draws (the same computation)
        with torch.no_grad():
            pre_pos, _ = ReverseChain(model, schedule, cfg, cond).step(
                res.trajectory[0][-1], res.trajectory[1][-1], 1,
                *(torch.from_numpy(np.array(d)) for d in draws[-4:-2]))
        for name, a in (("traj_pos", res.trajectory[0]),
                        ("traj_h", res.trajectory[1]), ("pos", res.pos),
                        ("h", res.h), ("species", res.species),
                        ("pre_pos", pre_pos)):
            out[f"{c}_{name}"] = a.numpy()
        print(f"free chunk {c}: {time.perf_counter() - t0:.0f} s", flush=True)
    out["seconds"] = time.perf_counter() - t0
    np.savez(work / f"{_tag(args)}_free.npz", **out)


def _rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def phase_forced(args, work: Path):
    """Every port step started from JAX's state with JAX's draws; with
    ``--jax_table``, over the JAX package's schedule table in place of the
    port's (a learned table differs by its gamma network's float32
    rounding, which flat stretches of the schedule amplify)."""
    import torch

    from diffusion_model_tpu_torch.diffusion.process import Schedule
    from diffusion_model_tpu_torch.diffusion.sampler import ReverseChain

    jcfg, jparams, chunks = _setup(args)
    cfg, model, schedule, cond_of = _port(args)
    if args.jax_table:
        from diffusion_model_tpu.train import Trainer

        schedule = Schedule(alphas=torch.from_numpy(np.array(
            Trainer(jcfg).schedule_for(jparams).alphas)))
    jx = np.load(work / f"{_tag(args)}_jax.npz")
    out, t0 = {}, time.perf_counter()
    for c, chunk in enumerate(chunks):
        cond = cond_of(chunk["cond"], chunk["keep"])
        chain = ReverseChain(model, schedule, cfg, cond)
        draws = [torch.from_numpy(np.array(d)) for d in _draws(chunk, jcfg)]
        traj_pos, traj_h = jx[f"{c}_traj_pos"], jx[f"{c}_traj_h"]
        steps = chain.steps
        nxt_pos = np.concatenate([traj_pos[1:], jx[f"{c}_pre_pos"][None]])
        nxt_h = np.concatenate([traj_h[1:], jx[f"{c}_pre_h"][None]])
        gap_pos, gap_h = np.zeros(steps + 1), np.zeros(steps + 1)
        with torch.no_grad():
            for k in range(steps):
                pos, h = chain.step(torch.from_numpy(traj_pos[k]),
                                    torch.from_numpy(traj_h[k]), steps - k,
                                    draws[2 + 2 * k], draws[3 + 2 * k])
                gap_pos[k] = _rel_gap(pos.numpy(), nxt_pos[k])
                gap_h[k] = _rel_gap(h.numpy(), nxt_h[k])
            pos, h, species = chain.epilogue(
                torch.from_numpy(jx[f"{c}_pre_pos"]),
                torch.from_numpy(jx[f"{c}_pre_h"]), draws[-2], draws[-1])
        gap_pos[steps] = _rel_gap(pos.numpy(), jx[f"{c}_pos"])
        gap_h[steps] = _rel_gap(h.numpy(), jx[f"{c}_h"])
        out[f"{c}_gap_pos"], out[f"{c}_gap_h"] = gap_pos, gap_h
        out[f"{c}_epilogue_species"] = species.numpy()
        print(f"forced chunk {c}: {time.perf_counter() - t0:.0f} s",
              flush=True)
    out["seconds"] = time.perf_counter() - t0
    suffix = "_jaxtable" if args.jax_table else ""
    np.savez(work / f"{_tag(args)}_forced{suffix}.npz", **out)


def phase_draws(args, work: Path):
    """JAX's draws and the conditioning arrays of the kept samples, for
    ``phase_card`` on a machine without JAX."""
    jcfg, _, chunks = _setup(args)
    out = {}
    for c, chunk in enumerate(chunks):
        draws = _draws(chunk, jcfg)
        out[f"{c}_pos_draws"] = np.stack(draws[0::2])
        out[f"{c}_h_draws"] = np.stack(draws[1::2])
        for f in ("pos", "species", "spectrum", "exo", "mask"):
            out[f"{c}_cond_{f}"] = np.asarray(
                getattr(chunk["cond"], f))[:chunk["keep"]]
    np.savez(work / f"{_tag(args)}_draws.npz", **out)


def phase_card(args, work: Path):
    """The port's chain on the card from JAX's draws (``phase_draws``),
    through K1, in bfloat16 and in float32: the final species and
    positions. Imports no JAX."""
    import subprocess

    import torch
    from torch_port_fixtures import Replay

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.data.batch import GraphBatch
    from diffusion_model_tpu_torch.diffusion.sampler import sample
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    device = torch.device("cuda")
    z = np.load(work / f"{_tag(args)}_draws.npz")
    chunks = sorted({int(k.split("_")[0]) for k in z.files})
    params = load_params_npz(args.npz)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": np.array(card)}
    for dtype in ("bfloat16", "float32"):
        cfg = load_config_npz(args.npz).replace(compute_dtype=dtype)
        model = api.denoiser_from_params(cfg, params, device)
        schedule = api.schedule_for(cfg, params, device)
        for c in chunks:
            cond = GraphBatch(**{f: torch.from_numpy(z[f"{c}_cond_{f}"]).to(
                device) for f in ("pos", "species", "spectrum", "exo",
                                  "mask")})
            draws = [d for pair in zip(z[f"{c}_pos_draws"],
                                       z[f"{c}_h_draws"]) for d in pair]
            res = sample(model, schedule, cfg, None, cond,
                         noise=Replay(draws, device))
            out[f"{dtype}_{c}_species"] = res.species.cpu().numpy()
            out[f"{dtype}_{c}_pos"] = res.pos.cpu().numpy()
    np.savez(work / f"{_tag(args)}_card.npz", **out)
    print(f"card replay written: {card}", flush=True)


def _table_gap(args) -> float:
    """The largest relative difference between the port's schedule table
    and the JAX package's for the snapshot."""
    from diffusion_model_tpu.train import Trainer

    jcfg, jparams, _ = _setup(args)
    _, _, schedule, _ = _port(args)
    want = np.asarray(Trainer(jcfg).schedule_for(jparams).alphas)
    return float(np.max(np.abs(schedule.alphas.numpy() / want - 1.0)))


def _o_fraction(species, mask):
    return (species[..., 0] * mask).sum(-1) / np.maximum(mask.sum(-1), 1)


def phase_report(args, work: Path) -> dict:
    from diffusion_model_tpu.evals.cn2 import _cn2_sample_geometry

    jcfg, _, chunks = _setup(args)
    tag = _tag(args)
    jx = np.load(work / f"{tag}_jax.npz")
    fr = np.load(work / f"{tag}_free.npz")
    fo = np.load(work / f"{tag}_forced.npz")
    cat = lambda d, name: np.concatenate(  # noqa: E731
        [d[f"{c}_{name}"] for c in range(len(chunks))],
        axis=1 if name.startswith("traj") else 0)
    mask = cat(jx, "mask")
    orig_o = _o_fraction(cat(jx, "orig_species"), mask)
    jax_sp, port_sp = cat(jx, "species"), cat(fr, "species")
    jax_o, port_o = _o_fraction(jax_sp, mask), _o_fraction(port_sp, mask)
    # position gap per structure after each reverse step; index s is the
    # state after s steps (0: the initial noise), then the epilogue
    jtraj = np.concatenate([cat(jx, "traj_pos"), cat(jx, "pre_pos")[None]])
    ptraj = np.concatenate([cat(fr, "traj_pos"), cat(fr, "pre_pos")[None]])
    gap = np.abs(jtraj - ptraj).max(axis=(-1, -2))          # [S+1, B]
    final_gap = np.abs(cat(jx, "pos") - cat(fr, "pos")).max(axis=(-1, -2))
    steps = gap.shape[0] - 1
    at = tuple(s for s in GAP_STEPS if s < steps) + (steps,)
    parted = gap > PART_BY
    first_part = np.where(parted.any(0), parted.argmax(0), -1)
    gap_pos = np.max([fo[f"{c}_gap_pos"] for c in range(len(chunks))], 0)
    gap_h = np.max([fo[f"{c}_gap_h"] for c in range(len(chunks))], 0)
    epi_sp = cat(fo, "epilogue_species")
    structures = []
    for i in range(len(mask)):
        row = {
            "o_fraction_exact_jax": bool(jax_o[i] == orig_o[i]),
            "o_fraction_exact_port": bool(port_o[i] == orig_o[i]),
            "species_equal": bool((jax_sp[i] == port_sp[i]).all()),
            "max_gap": {str(s): float(gap[s, i]) for s in at}
            | {"final": float(final_gap[i])},
            "first_step_parted": int(first_part[i]),
            "forced_epilogue_species_equal": bool(
                (epi_sp[i] == jax_sp[i]).all()),
        }
        structures.append(row)
    n = len(structures)
    summary = {
        "snapshot": args.npz, "key": args.seed, "steps": steps,
        "conditions": "cn2 test conditions" if args.cn2 else "test split",
        "structures": n, "dtype": "float32", "device": "CPU",
        "script": ("JAX_PLATFORMS=cpu python tests/jax_replay_chains.py "
                   f"{args.npz} --seed {args.seed}"
                   + (" --cn2" if args.cn2 else "")),
        "jax_accepted": int(cat(jx, "accepted").sum()),
        "o_fraction_exact_jax": int(sum(r["o_fraction_exact_jax"]
                                        for r in structures)),
        "o_fraction_exact_port": int(sum(r["o_fraction_exact_port"]
                                         for r in structures)),
        "species_equal": int(sum(r["species_equal"] for r in structures)),
        "forced_epilogue_species_equal": int(sum(
            r["forced_epilogue_species_equal"] for r in structures)),
        "parted": int((first_part >= 0).sum()),
        "first_step_parted_min": (int(first_part[first_part >= 0].min())
                                  if (first_part >= 0).any() else None),
        "free_max_gap": {str(s): float(gap[s].max()) for s in at}
        | {"final": float(final_gap.max())},
        "forced_max_rel_gap_pos": float(gap_pos.max()),
        "forced_max_rel_gap_h": float(gap_h.max()),
        "forced_rel_gap_pos_at": {str(t): float(gap_pos[steps - t])
                                  for t in sorted({steps, steps // 2,
                                                   min(100, steps),
                                                   min(10, steps), 1})}
        | {"epilogue": float(gap_pos[steps])},
        "forced_worst_step_pos": int(steps - gap_pos[:steps].argmax()),
        "seconds": {"jax": float(jx["seconds"]), "free": float(fr["seconds"]),
                    "forced": float(fo["seconds"])},
    }
    if args.cn2:
        res = lambda d, sp: {  # noqa: E731
            "mask": mask, "accepted": np.ones(n, bool),
            "generated_pos": cat(d, "pos"), "generated_species": sp,
            "original_pos": cat(jx, "orig_pos")}
        ja = _cn2_sample_geometry(res(jx, jax_sp))
        pa = _cn2_sample_geometry(res(fr, port_sp))
        for i, row in enumerate(structures):
            row["cn2_angle_jax"] = (None if ja["invalid"][i]
                                    else float(ja["angle_g"][i]))
            row["cn2_angle_port"] = (None if pa["invalid"][i]
                                     else float(pa["angle_g"][i]))
            row["cn2_angle_original"] = float(ja["angle_o"][i])
        both = [(r["cn2_angle_jax"], r["cn2_angle_port"]) for r in structures
                if r["cn2_angle_jax"] is not None
                and r["cn2_angle_port"] is not None]
        summary["cn2_angles_valid_jax"] = int((~ja["invalid"]).sum())
        summary["cn2_angles_valid_port"] = int((~pa["invalid"]).sum())
        summary["cn2_angle_max_abs_diff"] = (
            max(abs(a - b) for a, b in both) if both else None)
    jt_path = work / f"{tag}_forced_jaxtable.npz"
    if jt_path.exists():
        fj = np.load(jt_path)
        summary["forced_jax_table"] = {
            "script": summary["script"] + " --phase forced --jax_table",
            "max_rel_gap_pos": float(max(fj[f"{c}_gap_pos"].max()
                                         for c in range(len(chunks)))),
            "max_rel_gap_h": float(max(fj[f"{c}_gap_h"].max()
                                       for c in range(len(chunks)))),
            "epilogue_species_equal": int((cat(fj, "epilogue_species")
                                           == jax_sp).all((1, 2)).sum())}
        summary["table_max_rel_diff"] = _table_gap(args)
    card_path = work / f"{tag}_card.npz"
    if card_path.exists():
        cz = np.load(card_path)
        summary["card"] = {"device": str(cz["card"]),
                           "script": summary["script"] + " --phase card"}
        for dtype in ("bfloat16", "float32"):
            sp = np.concatenate([cz[f"{dtype}_{c}_species"]
                                 for c in range(len(chunks))])
            pos = np.concatenate([cz[f"{dtype}_{c}_pos"]
                                  for c in range(len(chunks))])
            summary["card"][dtype] = {
                "o_fraction_exact": int((_o_fraction(sp, mask)
                                         == orig_o).sum()),
                "species_equal_jax": int((sp == jax_sp).all((1, 2)).sum()),
                "max_final_gap": float(np.abs(pos - cat(jx, "pos")).max())}
    summary["per_structure"] = structures
    path = Path(args.out or FIXTURES / f"replay_{tag}.json")
    path.write_text(json.dumps(summary, indent=1) + "\n")
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "per_structure"}), flush=True)
    return summary


def main(argv=None) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cn2", action="store_true",
                   help="only the CN2 test conditions")
    p.add_argument("--work", default="build/replay")
    p.add_argument("--phase", default="all",
                   choices=("all", "jax", "free", "forced", "report",
                            "draws", "card"))
    p.add_argument("--num", type=int, default=256)
    p.add_argument("--shells", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--jax_table", action="store_true",
                   help="forced: step over the JAX package's table")
    p.add_argument("--limit", type=int, default=None,
                   help="only the first conditions (a quick trial)")
    p.add_argument("--timesteps", type=int, default=0,
                   help="a shorter schedule (a quick trial)")
    p.add_argument("--out", default=None,
                   help="default tests/fixtures/torch_port/replay_<tag>.json")
    args = p.parse_args(argv)
    work = Path(args.work)
    work.mkdir(parents=True, exist_ok=True)
    if args.phase == "card":   # on the card's machine, which has no JAX
        phase_card(args, work)
        return 0
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.phase == "draws":
        phase_draws(args, work)
        return 0
    for name, fn in (("jax", phase_jax), ("free", phase_free),
                     ("forced", phase_forced), ("report", phase_report)):
        if args.phase in ("all", name):
            fn(args, work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
