#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``diffusion_model_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX.
Phases, each printed as one JSON line:

  1. toolchain: the card (``nvidia-smi``), CUDA, nvcc, and the build of the
     EGCL pair kernel from ``diffusion_model_tpu_torch/csrc/``;
  2. kernel against its plain version at flagship width (F1=1024, Fm=256)
     on the inputs the main path gives it (B x N = 80 x 16 and 1 x 192),
     float32 variant and bfloat16 variant, padded rows inert, and timed;
  3. the flagship denoiser on the card against the JAX goldens of
     ``tests/fixtures/torch_port/flagship.npz``;
  4. generation through ``api.generate`` from ``artifacts/q_predef_r5.npz``
     on the 27 flagship test conditions, 5 samples each, 1000 steps, bf16,
     with the kernel's launch count taken over exactly that run;
  5. seconds per structure at the headline shape (192 atoms, B=1, 1000 and
     250 strided steps), kernel path and plain path on the same card.

Any failed check raises, and the script exits non-zero without its result
line. The last lines are the kernel table, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "torch_port" / "flagship.npz"
SNAPSHOT = ROOT / "artifacts" / "q_predef_r5.npz"
GEN_PER_CONDITION = 5
GEN_BATCH = 16         # conditions per chunk: 16 x 5 = 80 graphs of 16 nodes
SI_O_TOLERANCE = 0.1   # A, generated against conditioning median Si-O


def log(record: dict) -> None:
    print(json.dumps(record), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rel_l2(a, b) -> float:
    return float((a - b).float().norm() / b.float().norm())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls."""
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


def load_fixture(device):
    import numpy as np
    import torch

    with np.load(FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    tensors = {k: torch.from_numpy(v).to(device) for k, v in fx.items()
               if v.dtype == np.float32}
    graphs = []
    for b in range(fx["cond_mask"].shape[0]):
        n = int(fx["cond_mask"][b].sum())
        graphs.append({k: fx[f"cond_{k}"][b, :n]
                       for k in ("pos", "species", "spectrum", "exo")}
                      | {"id": str(fx["cond_id"][b])})
    cell = {k: fx[f"cell_{k}"] for k in ("pos", "species", "spectrum", "exo")}
    cell["id"] = "amorphous_0"
    return tensors, graphs, cell


def capture_edge_inputs(model_cfg, params, device, species_t, pos_t,
                        spectrum, exo, t_norm, mask):
    """The arguments the denoiser hands its edge function, layer by layer."""
    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.ops.egcl_pair import (
        egcl_pair_edges_reference,
    )

    calls = []

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return egcl_pair_edges_reference(*args)

    model = denoiser_from_params(model_cfg, params, device, edge_fn=record)
    model(species_t, pos_t, spectrum, exo, t_norm, mask)
    return calls


def check_kernel(args, dtype_name: str) -> dict:
    """Kernel against the plain version on one set of edge inputs."""
    import torch

    from diffusion_model_tpu_torch.ops.egcl_pair import (
        egcl_pair_edges,
        egcl_pair_edges_reference,
    )

    got_m, got_x = egcl_pair_edges(*args)
    want_m, want_x = egcl_pair_edges_reference(*args)
    torch.cuda.synchronize()
    err = max(float((got_m - want_m).abs().max()),
              float((got_x - want_x).abs().max()))
    rec = {"dtype": dtype_name, "shape": list(args[0].shape[:2]),
           "max_abs_err": err}
    if dtype_name == "float32":
        for got, want, name in ((got_m, want_m, "m_sum"),
                                (got_x, want_x, "x_out")):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                       msg=lambda m: f"{name}: {m}")
        rec["tolerance"] = "rtol 2e-4 / atol 2e-5"
    else:
        rec["rel_l2_m_sum"] = rel_l2(got_m, want_m)
        rec["rel_l2_x_update"] = rel_l2(got_x - args[4], want_x - args[4])
        if not max(rec["rel_l2_m_sum"], rec["rel_l2_x_update"]) <= 1e-2:
            raise AssertionError(f"bf16 kernel off the plain version: {rec}")
        rec["tolerance"] = "relative L2 1e-2"
    # padded rows: no message, coordinates unchanged, exactly
    mask = args[5][..., 0] > 0
    if bool((got_m[~mask] != 0).any()) or bool(
            (got_x[~mask] != args[4][~mask]).any()):
        raise AssertionError("padded rows of the kernel output are not inert")
    rec["padded_rows_checked"] = int((~mask).sum())
    return rec


def phase_kernels(cfg, params, fx, cell, device) -> dict:
    import torch

    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.ops.egcl_pair import (
        egcl_pair_edges,
        egcl_pair_edges_reference,
    )

    # 80 x 16: the generation chunk (16 conditions x 5 copies), noised at
    # t/T = 0.5, every layer's inputs; 1 x 192: the headline cell, noised
    # likewise, first layer only: the flagship was trained on graphs of at
    # most 16 atoms, and over 192 atoms its coordinates grow to ~1e9 by the
    # last layer, where no comparison means anything
    k = 1
    tile = lambda a: a[:GEN_BATCH].repeat_interleave(GEN_PER_CONDITION, 0)
    small = (tile(fx["in_species_t"][k]), tile(fx["in_pos_t"][k]),
             tile(fx["cond_spectrum"]), tile(fx["cond_exo"]),
             tile(fx["in_t_norm"][k]), tile(fx["cond_mask"]))
    big_batch = collate([cell], 192, device)
    g = torch.Generator(device=device).manual_seed(0)
    noisy = lambda a: (0.7 * a + 0.7 * torch.randn(
        a.shape, generator=g, device=device))
    big = (noisy(big_batch.species), noisy(big_batch.pos),
           big_batch.spectrum, big_batch.exo,
           torch.full((1, 192, 1), 0.5, device=device), big_batch.mask)

    checks, timings = [], {}
    for dtype_name in ("float32", "bfloat16"):
        dcfg = cfg.replace(compute_dtype=dtype_name)
        for name, inputs, layers in (("80x16", small, range(cfg.L)),
                                     ("1x192", big, [0])):
            calls = capture_edge_inputs(dcfg, params, device, *inputs)
            for layer in layers:
                rec = check_kernel(calls[layer], dtype_name)
                rec["layer"] = layer
                checks.append(rec)
            args = calls[0]
            timings[f"{name}_{dtype_name}"] = {
                "kernel_ms": cuda_ms(lambda: egcl_pair_edges(*args), 20),
                "plain_ms": cuda_ms(
                    lambda: egcl_pair_edges_reference(*args), 5),
            }
    main = timings["80x16_bfloat16"]
    main_err = max(r["max_abs_err"] for r in checks
                   if r["dtype"] == "bfloat16" and r["shape"] == [80, 16])
    log({"phase": "kernel_vs_plain", "checks": checks, "timings": timings})
    return {"max_abs_err": main_err, "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"]}


def phase_denoiser(cfg, params, fx, device) -> None:
    from diffusion_model_tpu_torch.api import denoiser_from_params

    rec = {"phase": "denoiser_vs_jax_golden"}
    for dtype_name in ("float32", "bfloat16"):
        model = denoiser_from_params(cfg.replace(compute_dtype=dtype_name),
                                     params, device)
        worst = 0.0
        for k in range(fx["t_frac"].shape[0]):
            eps_x, eps_h = model(fx["in_species_t"][k], fx["in_pos_t"][k],
                                 fx["cond_spectrum"], fx["cond_exo"],
                                 fx["in_t_norm"][k], fx["cond_mask"])
            gold_x = fx[f"eps_x_{dtype_name}"][k]
            gold_h = fx[f"eps_h_{dtype_name}"][k]
            if dtype_name == "float32":
                scale = max(float(gold_x.abs().max()),
                            float(gold_h.abs().max()))
                err = max(float((eps_x - gold_x).abs().max()),
                          float((eps_h - gold_h).abs().max())) / scale
                limit = 1e-3
            else:
                err = max(rel_l2(eps_x, gold_x), rel_l2(eps_h, gold_h))
                limit = 2e-2
            worst = max(worst, err)
            if not err <= limit:
                raise AssertionError(
                    f"{dtype_name} denoiser off the JAX golden at t/T="
                    f"{float(fx['t_frac'][k])}: {err} > {limit}")
        rec[dtype_name] = {"worst": worst,
                           "measure": ("max abs err / output scale"
                                       if dtype_name == "float32"
                                       else "relative L2")}
    log(rec)


def median_si_o(pos, species, mask) -> float:
    """Median over accepted samples of each Si atom's nearest-O distance."""
    import numpy as np

    dists = []
    for p, s, m in zip(pos, species, mask):
        real = m > 0
        p, s = p[real], s[real].argmax(-1)
        si, ox = p[s == 1], p[s == 0]
        if len(si) and len(ox):
            d = np.linalg.norm(si[:, None, :] - ox[None, :, :], axis=-1)
            dists.append(d.min(axis=1))
    return float(np.median(np.concatenate(dists)))


def phase_generate(cfg, params, graphs, device) -> int:
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.ops import egcl_pair

    model = api.denoiser_from_params(cfg, params, device)
    calls = [0]
    model.register_forward_pre_hook(lambda *_: calls.__setitem__(
        0, calls[0] + 1))
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    egcl_pair.egcl_pair_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = api.generate(cfg, model, graphs, generator,
                       gen_num_per_spectrum=GEN_PER_CONDITION,
                       batch_size=GEN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = egcl_pair.egcl_pair_launches

    n = len(graphs) * GEN_PER_CONDITION
    keep = out["accepted"]
    rec = {"phase": "generate", "samples": n,
           "finite": int(out["finite"].sum()), "accepted": int(keep.sum()),
           "jax_record_accepted": "135 of 135",
           "egcl_pair_launches": launches, "denoiser_calls": calls[0],
           "wall_s": wall}
    if out["generated_pos"].shape != (n, cfg.n_max, 3) or len(out["ids"]) != n:
        raise AssertionError(f"generate returned wrong shapes: {rec}")
    if not keep.all():
        raise AssertionError(f"not every sample accepted: {rec}")
    if launches == 0 or launches != cfg.L * calls[0]:
        raise AssertionError(
            f"kernel launches {launches} != L x denoiser calls: {rec}")
    si_o = median_si_o(out["generated_pos"], out["generated_species"],
                       out["mask"])
    si_o_ref = median_si_o(out["original_pos"], out["original_species"],
                           out["mask"])
    rec["median_nearest_si_o_A"] = si_o
    rec["conditions_median_nearest_si_o_A"] = si_o_ref
    rec["jax_record_si_o_A"] = "~1.6"
    log(rec)
    if not abs(si_o - si_o_ref) <= SI_O_TOLERANCE:
        raise AssertionError(
            f"median nearest Si-O {si_o} A is off the conditions' "
            f"{si_o_ref} A by more than {SI_O_TOLERANCE} A")
    return launches


def phase_headline(cfg, params, cell, device, card: str) -> None:
    import torch

    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )
    from diffusion_model_tpu_torch.diffusion.sampler import sample
    from diffusion_model_tpu_torch.ops.egcl_pair import (
        egcl_pair_edges,
        egcl_pair_edges_reference,
    )

    n_atoms = 192
    cfg = cfg.replace(n_max=n_atoms)
    cond = collate([cell], n_atoms, device)
    schedule = predefined_schedule(cfg, device=device)
    rec = {"phase": "headline_192_atoms", "card": card, "dtype":
           cfg.compute_dtype, "batch": 1}
    for route, edge_fn in (("kernel", egcl_pair_edges),
                           ("plain", egcl_pair_edges_reference)):
        model = denoiser_from_params(cfg, params, device, edge_fn=edge_fn)
        gen = torch.Generator(device=device).manual_seed(0)
        sample(model, schedule, cfg.replace(sample_steps=2), gen, cond)
        for steps in (1000, 250):
            run_cfg = cfg.replace(sample_steps=steps)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sample(model, schedule, run_cfg, gen, cond)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rec[f"{route}_{steps}"] = {
                "s_per_structure": sec,
                "atoms_steps_per_s": n_atoms * steps / sec,
                # not required: see phase_kernels on 192-atom inputs
                "finite": bool(res.finite.all()),
            }
    log(rec)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "diffusion_model_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from diffusion_model_tpu_torch.ops import _build, egcl_pair
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    device = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    egcl_pair.build()
    log({"phase": "toolchain", "nvidia_smi": card,
         "torch": torch.__version__, "torch_cuda": torch.version.cuda,
         "nvcc": _build.find_nvcc(), "kernel_build_s":
         time.perf_counter() - t0})

    cfg = load_config_npz(str(SNAPSHOT))
    params = load_params_npz(str(SNAPSHOT))
    fx, graphs, cell = load_fixture(device)
    kernel = phase_kernels(cfg, params, fx, cell, device)
    phase_denoiser(cfg, params, fx, device)
    launches = phase_generate(cfg, params, graphs, device)
    phase_headline(cfg, params, cell, device, card)

    log({"kernels": [{
        "name": "egcl_pair", "route": "cuda",
        "source": "diffusion_model_tpu_torch/csrc/egcl_pair.cu",
        "replaces": "diffusion_model_tpu/ops/egcl_pallas.py:171",
        "launches": launches, **kernel}]})
    print(card_line(), flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
