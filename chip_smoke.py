#!/usr/bin/env python3
"""GPU smoke check of the PyTorch port (``diffusion_model_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; imports nothing of JAX.
Phases, each printed as one JSON line:

  1. toolchain: the card (``nvidia-smi``), CUDA, nvcc, and the build of the
     six kernels from ``diffusion_model_tpu_torch/csrc/`` (both EGCL kernels
     and the four probes; one nvcc each, started together), with the
     tensor-core instructions of each library's SASS (``cuobjdump``): K1,
     K2, P2, P3 and P4 on warpgroup MMA (HGMMA / IGMMA) and none on HMMA /
     IMMA;
  2. the pair kernel (K1) against its plain version at flagship width
     (F1=1024, Fm=256) on the inputs the main path gives it (B x N = 80 x 16
     and 1 x 192), float32 variant and bfloat16 variant, padded rows inert,
     and timed, with the tile rows the kernel computed (held to its
     schedule, ``edge_tiles``), the live edges and the rate over them;
  3. the flagship denoiser on the card against the JAX goldens of
     ``tests/fixtures/torch_port/flagship.npz``;
  4. generation through ``api.generate`` from ``artifacts/q_predef_r5.npz``
     on the 27 flagship test conditions, 5 samples each, 1000 steps, bf16,
     with the kernels' launch counts taken over exactly that run;
  5. seconds per structure at the headline shape (192 atoms, B=1, 1000 and
     250 strided steps), kernel path and plain path on the same card;
  6. the kNN kernel (K2) against its plain version at flagship width
     (H=36), float32 and bfloat16, on the kNN route's inputs: 80 x 16 at
     K=15 (every layer), 2 x 512 and 1 x 2048 amorphous cells at K=32
     (layer 0); padded targets inert; timed, rows as in phase 2;
  7. K2 over ``knn_edges(., K=N-1)`` against K1 over the dense pair grid on
     the same layer inputs (80 x 16, every layer): the same edges;
  8. the flagship denoiser over ``knn_edges(., 6)`` against the JAX kNN
     goldens of the fixture file;
  9. generation as in phase 4 with ``neighbor_k=15``: every EGCL through K2
     and none through K1 (phases 4, 5, 9 and 10 never leave their kernel:
     ``plain_edge_calls`` stays 0, and K1 and K2 launch 10010 times each in
     the served runs);
 10. the large cell, speed only: the 512-atom model class's flags
     (``neighbor_k=32``, ``virtual_node``, ``h_residual``) at full width on
     ``amorphous_cell(seed=0, num_atoms=2048)``, B=1, with the flagship's
     EGCL weights and seeded virtual-node weights: seconds per structure at
     1000 and 250 strided steps through K2, 250 through the plain version,
     and ms per denoiser call of both routes at 2 x 512;
 10b. the plain route: a model at ``configs/tiny.yaml``'s widths (dense)
     and a kNN model with an uncompressed spectrum (node width 204), whose
     widths no kernel takes (``nn.egnn.edge_route``), run a few denoiser
     calls on the card through the plain route in chunks, held against the
     same calls on the CPU (float32, rtol 2e-4 / atol 2e-5 of the output
     scale), with no kernel launched; and the kernels a flagship denoiser
     call launches, counted by ``torch.profiler`` on its first call (which
     casts the weights to bf16) and on the next (which finds them cast);
 11-14. the hardware probes ported from ``benchmarks/probe_*.py``, each
     held against its plain version at the TPU probe's shapes and then
     driven as its ``main()`` drives it (launches counted over that run
     only), with the cuBLAS yardstick where there is one: P2 the chained
     int8/bf16 products (``probes.matmul_rate``: cluster-wide chains on
     wgmma, with the cluster and slice each launch used, its time over the
     cuBLAS chain's and over the bound, and a link's phases), P4 tensor-core
     and SFU work at once on the same SMs (``probes.overlap``: P2's int8
     chain with a y warpgroup; its mxu mode bit for bit P2's block chain,
     its times beside that chain's and beside the SFU's time on the SMs the
     plan holds, the overlap fraction at M=512 and 4224), P3 SiLU(a @ w)
     with and without an overlapped epilogue (``probes.pipeline``: TMA-fed
     wgmma, cooperative and ping-pong, beside ``F.silu(a @ w)``), P1 the
     int8 EGCL edge tile in stages at N=192 (``probes.kernel_stages``).

Any failed check raises, and the script exits non-zero without its result
line. The last lines are the kernel table (with each kernel's bound: its
operations at the published dense peak, or its bytes at 3.35 TB/s, the
larger), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import json
import re
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
SERVED_K = 15          # kNN route of the served shape: K = N-1, all pairs
GOLDEN_K = 6           # neighbours of the fixture's kNN goldens
LARGE_K = 32           # the 512-atom model class's neighbor_k
LARGE_ATOMS = 2048
MID_ATOMS = 512
SERVED_LAUNCHES = 10010   # 2 chunks x 1001 denoiser calls x 5 layers
PLAIN_ROUTE_T = (0.2, 0.5, 0.9)   # t/T of the plain-route phase's calls


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


def sass_counts(source: str) -> dict:
    """Tensor-core instructions per kernel of the library built from
    ``csrc/<source>``, from ``cuobjdump -sass``: function -> counts of
    HGMMA, IGMMA (warpgroup MMA, bf16 / int8), HMMA and IMMA (warp MMA)."""
    from diffusion_model_tpu_torch.ops import _build

    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(tool), "-sass", str(_build.library_path(source))],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, function = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            function = line.split("Function :")[1].strip()
            counts[function] = dict.fromkeys(("HGMMA", "IGMMA", "HMMA",
                                              "IMMA"), 0)
        elif function is not None:
            for tag in re.findall(r"\b(HGMMA|IGMMA|HMMA|IMMA)\b", line):
                counts[function][tag] += 1
    return {f: c for f, c in counts.items() if any(c.values())}


def check_sass(sources) -> dict:
    """Every tensor-core kernel of these libraries on warpgroup MMA and
    none on warp MMA; returns the counts."""
    report = {}
    for source in sources:
        counts = sass_counts(source)
        warpgroup = sum(c["HGMMA"] + c["IGMMA"] for c in counts.values())
        warp = sum(c["HMMA"] + c["IMMA"] for c in counts.values())
        if warpgroup == 0 or warp != 0:
            raise AssertionError(f"{source}: SASS has {warpgroup} HGMMA/IGMMA "
                                 f"and {warp} HMMA/IMMA: {counts}")
        report[source] = counts
    return report


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


def kernel_table():
    """name -> (kernel, plain version, index of x among the arguments,
    padded-target rows of the arguments)."""
    from diffusion_model_tpu_torch.ops.egcl_knn import (
        egcl_knn_edges,
        egcl_knn_edges_reference,
    )
    from diffusion_model_tpu_torch.ops.egcl_pair import (
        egcl_pair_edges,
        egcl_pair_edges_reference,
    )

    return {
        "egcl_pair": (egcl_pair_edges, egcl_pair_edges_reference, 4,
                      lambda a: a[5][..., 0] == 0),
        "egcl_knn": (egcl_knn_edges, egcl_knn_edges_reference, 3,
                     lambda a: a[5].sum(dim=-1) == 0),
    }


def recording_model(model_cfg, params, device):
    """(denoiser, calls): the denoiser's edge functions run the plain
    versions and append their arguments to ``calls[kernel name]``."""
    from diffusion_model_tpu_torch.api import denoiser_from_params

    table = kernel_table()
    calls = {name: [] for name in table}

    def recorder(name):
        def record(*args):
            calls[name].append(tuple(a.clone() for a in args))
            return table[name][1](*args)
        return record

    model = denoiser_from_params(model_cfg, params, device,
                                 edge_fn=recorder("egcl_pair"),
                                 knn_edge_fn=recorder("egcl_knn"))
    return model, calls


def capture_edge_inputs(model_cfg, params, device, species_t, pos_t,
                        spectrum, exo, t_norm, mask, k: int = 0):
    """The arguments the denoiser hands its edge function, layer by layer:
    over the dense pair grid, or over ``knn_edges(pos_t, mask, k)``."""
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    model, calls = recording_model(model_cfg, params, device)
    edges = knn_edges(pos_t, mask, k) if k else None
    model(species_t, pos_t, spectrum, exo, t_norm, mask, edges)
    return calls["egcl_knn" if k else "egcl_pair"]


def check_kernel(name: str, args, dtype_name: str) -> dict:
    """A kernel against its plain version on one set of edge inputs."""
    import torch

    kernel, plain, xi, padded = kernel_table()[name]
    got_m, got_x = kernel(*args)
    want_m, want_x = plain(*args)
    torch.cuda.synchronize()
    err = max(float((got_m - want_m).abs().max()),
              float((got_x - want_x).abs().max()))
    rec = {"kernel": name, "dtype": dtype_name,
           "shape": list(args[0].shape[:2]), "max_abs_err": err}
    if name == "egcl_knn":
        rec["k"] = int(args[4].shape[-1])
    if dtype_name == "float32":
        for got, want, what in ((got_m, want_m, "m_sum"),
                                (got_x, want_x, "x_out")):
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5,
                                       msg=lambda m: f"{name} {what}: {m}")
        rec["tolerance"] = "rtol 2e-4 / atol 2e-5"
    else:
        rec["rel_l2_m_sum"] = rel_l2(got_m, want_m)
        rec["rel_l2_x_update"] = rel_l2(got_x - args[xi], want_x - args[xi])
        if not max(rec["rel_l2_m_sum"], rec["rel_l2_x_update"]) <= 1e-2:
            raise AssertionError(f"bf16 kernel off the plain version: {rec}")
        rec["tolerance"] = "relative L2 1e-2"
    # padded targets: no message, coordinates unchanged, exactly
    pad = padded(args)
    if bool((got_m[pad] != 0).any()) or bool(
            (got_x[pad] != args[xi][pad]).any()):
        raise AssertionError(f"padded rows of {name}'s output are not inert")
    rec["padded_rows_checked"] = int(pad.sum())
    return rec


def served_inputs(fx):
    """The generation chunk (16 conditions x 5 copies, 80 x 16) noised at
    t/T = 0.5 (the fixture's middle input)."""
    k = 1
    tile = lambda a: a[:GEN_BATCH].repeat_interleave(GEN_PER_CONDITION, 0)
    return (tile(fx["in_species_t"][k]), tile(fx["in_pos_t"][k]),
            tile(fx["cond_spectrum"]), tile(fx["cond_exo"]),
            tile(fx["in_t_norm"][k]), tile(fx["cond_mask"]))


def cell_inputs(cells, device, seed=0):
    """A batch of cells noised as 0.7 * a + 0.7 * N(0, 1), at t/T = 0.5."""
    import torch

    from diffusion_model_tpu_torch.data.batch import collate

    n = max(len(c["pos"]) for c in cells)
    batch = collate(cells, n, device)
    g = torch.Generator(device=device).manual_seed(seed)
    noisy = lambda a: (0.7 * a + 0.7 * torch.randn(
        a.shape, generator=g, device=device))
    return (noisy(batch.species), noisy(batch.pos), batch.spectrum,
            batch.exo, torch.full((len(cells), n, 1), 0.5, device=device),
            batch.mask)


def time_kernel(name: str, args) -> dict:
    kernel, plain = kernel_table()[name][:2]
    return {"kernel_ms": cuda_ms(lambda: kernel(*args), 20),
            "plain_ms": cuda_ms(lambda: plain(*args), 5)}


def row_count(name: str, args) -> dict:
    """Tile rows the kernel computed on these inputs, against the rows its
    schedule (``edge_tiles``) says the bf16 kernel computes."""
    import torch

    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    kernel_table()[name][0](*args)
    torch.cuda.synchronize()
    if name == "egcl_pair":
        got, sched = int(egcl_pair.last_rows), egcl_pair.edge_tiles(args[5])
    else:
        got = int(egcl_knn.last_rows)
        sched = egcl_knn.edge_tiles(args[4], args[5])
    if args[0].dtype == torch.bfloat16 and got != sched.rows:
        raise AssertionError(f"{name} computed {got} tile rows, its schedule "
                             f"says {sched.rows}")
    return {"rows_computed": got, "rows_per_live_edge":
            got / max(sched.live_edges, 1)}


def host_us(fn, reps: int = 50) -> float:
    """Host microseconds to enqueue one ``fn()`` (checks, tensor maps and
    the launch), with the card busy behind it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * took / reps


def timed(name: str, args, bound: dict) -> dict:
    """Kernel and plain times, the bound, the row count, the rate over the
    live edges and the host time of a launch."""
    kernel = kernel_table()[name][0]
    rec = time_kernel(name, args) | bound | row_count(name, args)
    rec["live_tflops"] = rec["flops"] / (rec["kernel_ms"] * 1e9)
    rec["host_us_per_launch"] = host_us(lambda: kernel(*args))
    return rec


def phase_kernels(cfg, params, fx, cell, device) -> dict:
    # 80 x 16: every layer's inputs; 1 x 192: the headline cell, first layer
    # only: the flagship was trained on graphs of at most 16 atoms, and over
    # 192 atoms its coordinates grow to ~1e9 by the last layer, where no
    # comparison means anything
    small = served_inputs(fx)
    big = cell_inputs([cell], device)
    checks, timings = [], {}
    for dtype_name in ("float32", "bfloat16"):
        dcfg = cfg.replace(compute_dtype=dtype_name)
        for name, inputs, layers in (("80x16", small, range(cfg.L)),
                                     ("1x192", big, [0])):
            calls = capture_edge_inputs(dcfg, params, device, *inputs)
            for layer in layers:
                rec = check_kernel("egcl_pair", calls[layer], dtype_name)
                rec["layer"] = layer
                checks.append(rec)
            timings[f"{name}_{dtype_name}"] = timed(
                "egcl_pair", calls[0], pair_bound(calls[0]))
    main = timings["80x16_bfloat16"]
    main_err = max(r["max_abs_err"] for r in checks
                   if r["dtype"] == "bfloat16" and r["shape"] == [80, 16])
    log({"phase": "kernel_vs_plain", "checks": checks, "timings": timings})
    return {"max_abs_err": main_err, "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "library_ms": None,
            **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                    "live_edges", "rows_computed",
                                    "live_tflops")}}


def phase_knn_kernel(cfg, params, fx, device) -> dict:
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell

    # 80 x 16 at K = N-1: the kNN route's inputs, every layer; 2 x 512 and
    # 1 x 2048 amorphous cells at the 512-atom class's K=32, layer 0 (the
    # flagship never saw such cells; see phase_kernels)
    mids = [amorphous_cell(seed=s, num_atoms=MID_ATOMS) for s in (0, 1)]
    shapes = (
        ("80x16_k15", served_inputs(fx), SERVED_K, range(cfg.L)),
        ("2x512_k32", cell_inputs(mids, device), LARGE_K, [0]),
        ("1x2048_k32", cell_inputs(
            [amorphous_cell(seed=0, num_atoms=LARGE_ATOMS)], device),
         LARGE_K, [0]),
    )
    checks, timings = [], {}
    for dtype_name in ("float32", "bfloat16"):
        for name, inputs, k, layers in shapes:
            calls = capture_edge_inputs(cfg.replace(compute_dtype=dtype_name),
                                        params, device, *inputs, k=k)
            for layer in layers:
                rec = check_kernel("egcl_knn", calls[layer], dtype_name)
                rec["layer"] = layer
                checks.append(rec)
            timings[f"{name}_{dtype_name}"] = timed(
                "egcl_knn", calls[0], knn_bound(calls[0]))
    main = timings["80x16_k15_bfloat16"]
    main_err = max(r["max_abs_err"] for r in checks
                   if r["dtype"] == "bfloat16" and r["shape"] == [80, 16])
    log({"phase": "knn_kernel_vs_plain", "checks": checks,
         "timings": timings})
    return {"max_abs_err": main_err, "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "library_ms": None,
            **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                    "live_edges", "rows_computed",
                                    "live_tflops")}}


def phase_knn_is_dense(cfg, params, fx, device) -> None:
    """K2 over K = N-1 lists and K1 over the pair grid, on the arguments
    each route builds from the same layer input of a dense-route run."""
    import torch

    from diffusion_model_tpu_torch.ops.edges import knn_edges

    table = kernel_table()
    rec = {"phase": "knn_k_n_minus_1_vs_pair"}
    for dtype_name in ("float32", "bfloat16"):
        model, calls = recording_model(cfg.replace(compute_dtype=dtype_name),
                                       params, device)
        layer_inputs = []
        hooks = [getattr(model.egnn, f"egcl_{l}").register_forward_pre_hook(
            lambda mod, args: layer_inputs.append((mod, args[:3])))
            for l in range(cfg.L)]
        model(*served_inputs(fx))
        for hook in hooks:
            hook.remove()
        for mod, (h, x, mask) in layer_inputs:
            mod(h, x, mask, knn_edges(x, mask, SERVED_K))
        worst = 0.0
        for layer, (pair_args, knn_args) in enumerate(
                zip(calls["egcl_pair"], calls["egcl_knn"], strict=True)):
            want_m, want_x = table["egcl_pair"][0](*pair_args)
            got_m, got_x = table["egcl_knn"][0](*knn_args)
            torch.cuda.synchronize()
            if dtype_name == "float32":
                torch.testing.assert_close(got_m, want_m, rtol=2e-4,
                                           atol=2e-5)
                torch.testing.assert_close(got_x, want_x, rtol=2e-4,
                                           atol=2e-5)
                err = max(float((got_m - want_m).abs().max()),
                          float((got_x - want_x).abs().max()))
            else:
                x = pair_args[4]
                err = max(rel_l2(got_m, want_m),
                          rel_l2(got_x - x, want_x - x))
                if not err <= 1e-2:
                    raise AssertionError(
                        f"K2 at K=N-1 off K1 at layer {layer}: {err}")
            worst = max(worst, err)
        rec[dtype_name] = {
            "layers": cfg.L, "worst": worst,
            "measure": ("max abs err (rtol 2e-4 / atol 2e-5 held)"
                        if dtype_name == "float32"
                        else "relative L2 (limit 1e-2)")}
    log(rec)


def phase_denoiser(cfg, params, fx, device, k: int = 0) -> None:
    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    prefix = f"knn{k}_" if k else ""
    rec = {"phase": f"{prefix}denoiser_vs_jax_golden"}
    for dtype_name in ("float32", "bfloat16"):
        model = denoiser_from_params(cfg.replace(compute_dtype=dtype_name),
                                     params, device)
        worst = 0.0
        for t in range(fx["t_frac"].shape[0]):
            pos = fx["in_pos_t"][t]
            edges = knn_edges(pos, fx["cond_mask"], k) if k else None
            eps_x, eps_h = model(fx["in_species_t"][t], pos,
                                 fx["cond_spectrum"], fx["cond_exo"],
                                 fx["in_t_norm"][t], fx["cond_mask"], edges)
            gold_x = fx[f"{prefix}eps_x_{dtype_name}"][t]
            gold_h = fx[f"{prefix}eps_h_{dtype_name}"][t]
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
                    f"{prefix}{dtype_name} denoiser off the JAX golden at "
                    f"t/T={float(fx['t_frac'][t])}: {err} > {limit}")
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
    """Served generation; every EGCL must go through the kernel of the
    config's route (K2 with ``neighbor_k``, else K1) and none through the
    other. Returns that kernel's launch count over exactly the run."""
    import torch

    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair

    model = api.denoiser_from_params(cfg, params, device)
    calls = [0]
    model.register_forward_pre_hook(lambda *_: calls.__setitem__(
        0, calls[0] + 1))
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    egcl_pair.egcl_pair_launches = 0
    egcl_knn.egcl_knn_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = api.generate(cfg, model, graphs, generator,
                       gen_num_per_spectrum=GEN_PER_CONDITION,
                       batch_size=GEN_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"egcl_pair": egcl_pair.egcl_pair_launches,
                "egcl_knn": egcl_knn.egcl_knn_launches}
    route, other = (("egcl_knn", "egcl_pair") if cfg.neighbor_k
                    else ("egcl_pair", "egcl_knn"))

    n = len(graphs) * GEN_PER_CONDITION
    keep = out["accepted"]
    rec = {"phase": "generate_knn" if cfg.neighbor_k else "generate",
           "neighbor_k": cfg.neighbor_k, "samples": n,
           "finite": int(out["finite"].sum()), "accepted": int(keep.sum()),
           "jax_record_accepted": "135 of 135",
           **{f"{k}_launches": v for k, v in launches.items()},
           "denoiser_calls": calls[0], "wall_s": wall}
    if out["generated_pos"].shape != (n, cfg.n_max, 3) or len(out["ids"]) != n:
        raise AssertionError(f"generate returned wrong shapes: {rec}")
    if not keep.all():
        raise AssertionError(f"not every sample accepted: {rec}")
    if launches[route] != cfg.L * calls[0] or launches[route] != \
            SERVED_LAUNCHES:
        raise AssertionError(
            f"{route} launches {launches[route]} != L x denoiser calls = "
            f"{SERVED_LAUNCHES}: {rec}")
    if launches[other] != 0:
        raise AssertionError(f"{other} launched on the {route} route: {rec}")
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
    return launches[route]


def time_sample(model, schedule, cfg, cond, steps: int, seed: int = 0):
    """(seconds, all finite) of one ``sample`` of ``steps`` strided steps."""
    import torch

    from diffusion_model_tpu_torch.diffusion.sampler import sample

    gen = torch.Generator(device=cond.device).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sample(model, schedule, cfg.replace(sample_steps=steps), gen, cond)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, bool(res.finite.all())


def phase_headline(cfg, params, cell, device, card: str) -> None:
    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )

    n_atoms = 192
    cfg = cfg.replace(n_max=n_atoms)
    cond = collate([cell], n_atoms, device)
    schedule = predefined_schedule(cfg, device=device)
    rec = {"phase": "headline_192_atoms", "card": card, "dtype":
           cfg.compute_dtype, "batch": 1}
    table = kernel_table()
    for route, edge_fn in (("kernel", table["egcl_pair"][0]),
                           ("plain", table["egcl_pair"][1])):
        model = denoiser_from_params(cfg, params, device, edge_fn=edge_fn)
        time_sample(model, schedule, cfg, cond, 2)
        for steps in (1000, 250):
            sec, finite = time_sample(model, schedule, cfg, cond, steps)
            rec[f"{route}_{steps}"] = {
                "s_per_structure": sec,
                "atoms_steps_per_s": n_atoms * steps / sec,
                # not required: see phase_kernels on 192-atom inputs
                "finite": finite,
            }
    log(rec)


def with_vnode_params(params: dict, cfg, seed: int = 0) -> dict:
    """The flax tree with virtual-node arrays added to every EGCL, drawn at
    std 1/sqrt(fan_in) from a numpy seed (heads included, so the channel
    does work; the layout of ``diffusion_model_tpu/nn/egnn.py``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, mh, m, xh = (cfg.h_size, cfg.m_hidden_size, cfg.m_size,
                    cfg.x_hidden_size)
    shapes = {"vnode_in": (h + 1, mh), "vnode_pool": (mh, m),
              "vnode_out": (h + m + 1, m), "vnode_x": (h + m + 1, xh),
              "vnode_x_head": (xh, 1)}
    egnn = dict(params["denoiser"]["params"]["egnn"])
    for l in range(cfg.L):
        layer = dict(egnn[f"egcl_{l}"])
        for name, (fan_in, out) in shapes.items():
            std = fan_in ** -0.5
            layer[name] = {
                "kernel": (rng.normal(size=(fan_in, out)) * std
                           ).astype(np.float32),
                "bias": (rng.normal(size=(out,)) * std).astype(np.float32)}
        egnn[f"egcl_{l}"] = layer
    den = dict(params["denoiser"]["params"], egnn=egnn)
    return dict(params, denoiser={"params": den})


def phase_large_cell(cfg, params, device, card: str) -> None:
    import torch

    from diffusion_model_tpu_torch.api import denoiser_from_params
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.data.synthetic import amorphous_cell
    from diffusion_model_tpu_torch.diffusion.process import (
        predefined_schedule,
    )
    from diffusion_model_tpu_torch.ops import egcl_knn

    table = kernel_table()
    cfg = cfg.replace(neighbor_k=LARGE_K, virtual_node=True, h_residual=True,
                      n_max=LARGE_ATOMS)
    params = with_vnode_params(params, cfg)
    schedule = predefined_schedule(cfg, device=device)
    big = collate([amorphous_cell(seed=0, num_atoms=LARGE_ATOMS)],
                  LARGE_ATOMS, device)
    mid = collate([amorphous_cell(seed=s, num_atoms=MID_ATOMS)
                   for s in (0, 1)], MID_ATOMS, device)
    rec = {"phase": "large_cell_2048_atoms", "card": card,
           "dtype": cfg.compute_dtype, "batch": 1, "neighbor_k": LARGE_K,
           "virtual_node": True, "h_residual": True, "L": cfg.L,
           "weights": "flagship EGCL + seeded virtual node (speed only)"}
    calls = [0]
    egcl_knn.egcl_knn_launches = 0
    for route, steps_list in (("kernel", (1000, 250)), ("plain", (250,))):
        model = denoiser_from_params(cfg, params, device,
                                     knn_edge_fn=table["egcl_knn"][
                                         0 if route == "kernel" else 1])
        if route == "kernel":
            model.register_forward_pre_hook(lambda *_: calls.__setitem__(
                0, calls[0] + 1))
        time_sample(model, schedule, cfg, big, 2)
        for steps in steps_list:
            sec, finite = time_sample(model, schedule, cfg, big, steps)
            rec[f"{route}_{steps}"] = {
                "s_per_structure": sec,
                "atoms_steps_per_s": LARGE_ATOMS * steps / sec,
                "finite": finite,   # reported, not required
            }
        mid_cfg = cfg.replace(n_max=MID_ATOMS)
        steps = 50
        time_sample(model, schedule, mid_cfg, mid, 2)
        sec, finite = time_sample(model, schedule, mid_cfg, mid, steps)
        rec[f"{route}_2x512_ms_per_call"] = 1000 * sec / (steps + 1)
    torch.cuda.synchronize()
    launches = egcl_knn.egcl_knn_launches
    rec["egcl_knn_launches"] = launches
    rec["kernel_route_denoiser_calls"] = calls[0]
    log(rec)
    if launches == 0 or launches != cfg.L * calls[0]:
        raise AssertionError(
            f"large cell: {launches} K2 launches != L x {calls[0]} "
            f"kernel-route denoiser calls")


def seeded_inputs(cfg, b: int, t: float, seed: int = 0):
    """Denoiser inputs of ``b`` graphs of ``cfg.n_max`` nodes (6 to n_max
    real) from a numpy seed: noisy species and positions, a spectrum per
    node, the excited atom first, ``t/T = t``; float32 on the CPU."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = cfg.n_max
    real = rng.integers(6, n + 1, size=b)
    mask = (np.arange(n)[None] < real[:, None]).astype(np.float32)
    m3 = mask[..., None]
    exo = np.zeros((b, n, 1), np.float32)
    exo[:, 0] = 1.0
    arrays = (rng.normal(size=(b, n, cfg.atom_type_size)) * m3,
              rng.normal(size=(b, n, 3)) * 1.5 * m3,
              rng.random((b, n, cfg.spectrum_size)), exo * m3, t * m3, mask)
    return [torch.from_numpy(np.asarray(a, np.float32)) for a in arrays]


def phase_plain_route(device) -> None:
    """Models whose widths the kernels do not take, on the card through the
    plain route, held against the same calls on the CPU."""
    import torch

    from diffusion_model_tpu_torch.config import Config
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
    from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.ops.edges import knn_edges

    models = {
        "tiny_dense": Config(L=2, m_hidden_size=32, m_size=16,
                             h_hidden_size=32, x_hidden_size=32,
                             compressed_spectrum_size=8,
                             compressor_hidden_dim=(16,), n_max=16),
        "h204_knn": Config(L=2, to_compress_spectrum=False,
                           neighbor_k=SERVED_K, n_max=16),
    }
    rec = {"phase": "plain_route", "budget_elements":
           egnn.PLAIN_EDGE_ELEMENTS, "batch": GEN_BATCH * GEN_PER_CONDITION,
           "tolerance": "float32 rtol 2e-4 / atol 2e-5 of the output scale"}
    for name, cfg in models.items():
        k = cfg.neighbor_k
        route = egnn.edge_route(cfg.m_hidden_size, cfg.x_hidden_size,
                                cfg.m_size, cfg.torch_dtype,
                                cfg.h_size if k else None)
        if route != "plain":
            raise AssertionError(f"{name}: edge_route says {route}")
        torch.manual_seed(0)
        cpu_model = DiffusionDenoiser(cfg)
        card_model = DiffusionDenoiser(cfg, device=device)
        card_model.load_state_dict(cpu_model.state_dict())
        launches = (egcl_pair.egcl_pair_launches, egcl_knn.egcl_knn_launches)
        calls, worst = 0, 0.0
        for i, t in enumerate(PLAIN_ROUTE_T):
            inputs = seeded_inputs(cfg, GEN_BATCH * GEN_PER_CONDITION, t, i)
            card_in = [a.to(device) for a in inputs]
            before = egnn.plain_edge_calls
            got = card_model(*card_in, knn_edges(card_in[1], card_in[5], k)
                             if k else None)
            torch.cuda.synchronize()
            calls += egnn.plain_edge_calls - before
            want = cpu_model(*inputs, knn_edges(inputs[1], inputs[5], k)
                             if k else None)
            scale = max(float(w.abs().max()) for w in want)
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=2e-4,
                                           atol=2e-5 * scale)
                worst = max(worst, float((g.cpu() - w).abs().max()) / scale)
        if calls != cfg.L * len(PLAIN_ROUTE_T):
            raise AssertionError(f"{name}: {calls} plain-route calls on the "
                                 f"card, want L x calls")
        if (egcl_pair.egcl_pair_launches,
                egcl_knn.egcl_knn_launches) != launches:
            raise AssertionError(f"{name}: a kernel was launched on the "
                                 f"plain route")
        rec[name] = {"h_size": cfg.h_size, "f1": cfg.m_hidden_size,
                     "fm": cfg.m_size, "neighbor_k": k, "route": route,
                     "plain_edge_calls_on_card": calls,
                     "worst_abs_err_over_scale": worst}
    log(rec)


def launches_per_call(cfg, params, fx, device) -> dict:
    """Kernels one flagship denoiser call launches (bf16, the served 80 x
    16 chunk, dense route), by ``torch.profiler``: the first call of a
    fresh model casts its weights, the next finds them cast."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from diffusion_model_tpu_torch.api import denoiser_from_params

    model = denoiser_from_params(cfg, params, device)
    inputs = served_inputs(fx)

    def kernels() -> dict:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(*inputs)
            torch.cuda.synchronize()
        events = prof.events()
        device_kernels = [e for e in events
                          if e.device_type == torch.autograd.DeviceType.CUDA
                          and not e.name.startswith(("Memcpy", "Memset"))]
        runtime = [e for e in events if e.name.startswith(
            ("cudaLaunchKernel", "cuLaunchKernel"))]
        return {"device_kernels": len(device_kernels),
                "runtime_launches": len(runtime)}

    rec = {"first_call": kernels(), "next_call": kernels()}
    if not (rec["first_call"]["device_kernels"]
            > rec["next_call"]["device_kernels"] > 0):
        raise AssertionError(f"launches per denoiser call: {rec}")
    return rec


def edge_flops(f1: int, fm: int, h: int = 0) -> int:
    """Tensor-core FLOPs of one live edge: both second-layer products, and
    for K2 the j-side first layer (4 H F1)."""
    return 2 * f1 * fm + 2 * f1 * f1 + 4 * h * f1


def peak_kind(t) -> str:
    """The peak an EGCL kernel's products run at: bf16 tensor cores, or
    float32 FMAs for the float32 variant."""
    return "f32" if t.element_size() == 4 else "bf16"


def pair_bound(args) -> dict:
    """K1 at these inputs: live ordered pairs i != j of real atoms; bytes of
    every argument and of m_sum and x_out."""
    from diffusion_model_tpu_torch.probes._common import bound, nbytes

    real = args[5][..., 0].sum(dim=1)
    pairs = float((real * (real - 1)).sum())
    f1, fm = args[8].shape                  # w2m
    b, n = args[0].shape[:2]
    flops = pairs * edge_flops(f1, fm)
    return {"live_edges": pairs, "flops": flops, **bound(
        nbytes(*args) + b * n * (fm + 3) * 4, **{peak_kind(args[0]): flops})}


def knn_bound(args) -> dict:
    """K2 at these inputs: live kNN slots."""
    from diffusion_model_tpu_torch.probes._common import bound, nbytes

    h, f1 = args[6].shape                   # wm_j
    fm = args[10].shape[-1]                 # w2m
    b, n = args[0].shape[:2]
    edges = float(args[5].sum())
    flops = edges * edge_flops(f1, fm, h)
    return {"live_edges": edges, "flops": flops, **bound(
        nbytes(*args) + b * n * (fm + 3) * 4, **{peak_kind(args[0]): flops})}


def probe_kernel(name: str, source: str, replaces: str, launches: int,
                 **numbers) -> dict:
    if launches == 0:
        raise AssertionError(f"{name} was never launched on its probe's path")
    return {"name": name, "route": "cuda",
            "source": f"diffusion_model_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, **numbers}


def phase_matmul_rate(device, card: str) -> dict:
    """P2: the chain kernel against its plain version at M = 512 and at the
    card-filling M, so at every cluster shape the timings run (int8 bit for
    bit), then the probe's timings at both M, each with the cluster and
    column slice its launch used and its time over the eager cuBLAS chain's
    and over the bound, and where a link's cycles go."""
    import torch

    from diffusion_model_tpu_torch.probes import matmul_rate as mr

    checks = mr.check_on_card(device)
    plain_ms = {}
    for dtype in (torch.int8, torch.bfloat16):
        a, w = mr.make_inputs(mr.M, mr.N, dtype, device)
        plain_ms[str(dtype)[6:]] = cuda_ms(
            lambda: mr.chain_reference(a, w), 3)
    mr.probe_matmul_rate_launches = 0
    timings = mr.measure(device)
    phases = mr.measure_phases(device)
    launches = mr.probe_matmul_rate_launches
    log({"phase": "probe_matmul_rate", "card": card, "checks": checks,
         "timings": timings, "link_phases": phases,
         "plain_ms_m512": plain_ms, "launches": launches,
         "library": "torch.matmul / torch._int_mm chains (cuBLAS), eager "
                    "(library_*) and replayed from a CUDA graph "
                    "(library_graph_*)"})
    held = {(f"{r['schedule']}_{'int8' if r['dtype'] == 'int8' else 'bf16'}",
             r["m"], r["cluster"], r["ns"]) for r in checks}
    for r in timings:
        if "plan" in r and (r["variant"], r["m"], r["cluster"],
                            r["ns"]) not in held:
            raise AssertionError(
                f"{r['variant']} at M = {r['m']} was timed with a cluster "
                f"of {r['cluster']} and slices of {r['ns']} columns, which "
                f"no check held against the plain version")
    for r in timings:
        if r["shape"] == "tpu" and "over_library" in r \
                and r["over_library"] > 1:
            raise AssertionError(
                f"{r['variant']} at M = {r['m']} takes {r['ms']:.3f} ms, "
                f"{r['over_library']:.2f}x the eager cuBLAS chain")
    main = next(r for r in timings
                if (r["variant"], r["shape"]) == ("block_int8", "tpu"))
    library = next(r for r in timings
                   if (r["variant"], r["shape"]) == ("library_int8", "tpu"))
    return probe_kernel(
        "probe_matmul_rate", "probe_matmul_rate.cu",
        "benchmarks/probe_matmul_rate.py:45", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks
                        if r["dtype"] == "int8"),
        ms=main["ms"], plain_ms=plain_ms["int8"], library_ms=library["ms"],
        **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                "bound_ms_by")})


def phase_overlap(device, card: str, p2_int8_block_ms: float) -> dict:
    """P4: the three modes against the plain version at M = 512 and 4224,
    its mxu mode against P2's int8 block chain bit for bit, then the
    probe's t_mxu, t_vpu, t_both and overlap fraction at both M, each mode
    beside the SFU's time on the SMs the plan holds, and at M = 512 mxu
    over P2's int8 block chain of this run."""
    import torch

    from diffusion_model_tpu_torch.probes import matmul_rate as mr
    from diffusion_model_tpu_torch.probes import overlap as ov

    checks = ov.check_on_card(device)
    a, w, y = ov.make_inputs(ov.M, ov.N, device)
    x_p4 = ov.overlap(a, w, y, ov.STEPS, "mxu")[0]
    x_p2 = mr.chain(a, w, ov.STEPS, "block")
    torch.cuda.synchronize()
    if not torch.equal(x_p4, x_p2):
        raise AssertionError(f"P4's mxu chain differs from P2's int8 block "
                             f"chain in {int((x_p4 != x_p2).sum())} values")
    plain_ms = cuda_ms(lambda: ov.overlap_reference(a, w, y), 3)
    ov.probe_overlap_launches = 0
    timings = ov.measure(device, reps=10)
    launches = ov.probe_overlap_launches
    main = timings[0]                        # M = 512, mode "both"
    main["mxu_over_p2_int8_block"] = main["mxu_ms"] / p2_int8_block_ms
    log({"phase": "probe_overlap", "card": card, "checks": checks,
         "mxu_equals_p2_block_chain": True, "timings": timings,
         "p2_int8_block_ms": p2_int8_block_ms, "launches": launches,
         "targets_m512": {
             "both_ms <= 1.5": main["both_ms"] <= 1.5,
             "mxu <= 1.15 x P2 int8 block": main["mxu_over_p2_int8_block"]
             <= 1.15,
             "vpu <= 2 x SFU on the plan's SMs":
             main["vpu_over_sfu_on_plan_sms"] <= 2.0}})
    return probe_kernel(
        "probe_overlap", "probe_overlap.cu",
        "benchmarks/probe_overlap.py:45", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks
                        if r["steps"] != ov.STEPS),
        ms=main["both_ms"], plain_ms=plain_ms, library_ms=None,
        **{k: main[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                "bound_ms_by", "overlap_fraction")})


def phase_pipeline(device, card: str) -> dict:
    """P3: both schedules against the plain version at the probe's shape,
    then ms per call beside F.silu(a @ w) through cuBLAS, and the verdict."""
    from diffusion_model_tpu_torch.probes import pipeline as pl

    checks = pl.check_on_card(device)
    a, w = pl.make_inputs(pl.ROWS, pl.K, pl.N, device)
    plain_ms = cuda_ms(lambda: pl.silu_product_reference(a, w), 3)
    pl.probe_pipeline_launches = 0
    timings = pl.measure(device)
    launches = pl.probe_pipeline_launches
    log({"phase": "probe_pipeline", "card": card, "checks": checks,
         "timings": timings, "launches": launches,
         "targets": {
             "pipelined < 0.9 x library": timings["pipelined_ms"]
             < 0.9 * timings["library_ms"],
             "seq <= library": timings["seq_ms"] <= timings["library_ms"],
             "pipelined <= 2 x bound": timings["pipelined_ms"]
             <= 2 * timings["bound_ms"]}})
    return probe_kernel(
        "probe_pipeline", "probe_pipeline.cu",
        "benchmarks/probe_pipeline.py:66", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks),
        ms=timings["pipelined_ms"], plain_ms=plain_ms,
        library_ms=timings["library_ms"], seq_ms=timings["seq_ms"],
        **{k: timings[k] for k in ("bound_ms", "bound_by", "bound_kind",
                                   "bound_ms_by", "mufu_ops")})


def phase_kernel_stages(device, card: str) -> dict:
    """P1: every stage and x-branch variant against its plain version at
    N = 192 (int32 products bit for bit through the checksum), then ms per
    layer call of each."""
    from diffusion_model_tpu_torch.probes import kernel_stages as ks

    table = ks.variants(device)
    checks = ks.check_on_card(table)
    plain_ms = {name: cuda_ms(calls["plain"], 3)
                for name, calls in table.items()}
    ks.probe_kernel_stages_launches = 0
    timings = ks.measure(table, reps=20)
    launches = ks.probe_kernel_stages_launches
    ms = {r["mode"]: r["ms_per_layer_call"] for r in timings}
    log({"phase": "probe_kernel_stages", "card": card, "n": ks.N,
         "checks": checks, "timings": timings, "plain_ms": plain_ms,
         "launches": launches,
         "epilogue_share_of_mm_post": 1 - ms["mm"] / ms["mm_post"],
         "build_share_of_full_serial": 1 - ms["mm_post"] / ms["full_serial"],
         "int8_over_bf16_x": ms["x8"] / ms["xbf"]})
    return probe_kernel(
        "probe_kernel_stages", "probe_kernel_stages.cu",
        "benchmarks/probe_kernel_stages.py:126", launches,
        max_abs_err=max(r["max_abs_err"] for r in checks),
        ms=ms["mm"], plain_ms=plain_ms["mm"], library_ms=None, stages_ms=ms,
        **table["mm"]["bound"])


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
    from diffusion_model_tpu_torch.nn import egnn
    from diffusion_model_tpu_torch.ops import _build, egcl_knn, egcl_pair
    from diffusion_model_tpu_torch.probes import (
        kernel_stages,
        matmul_rate,
        overlap,
        pipeline,
    )
    from diffusion_model_tpu_torch.train.checkpoint import (
        load_config_npz,
        load_params_npz,
    )

    device = torch.device("cuda", 0)
    card = card_line()
    t0 = time.perf_counter()
    modules = (egcl_pair, egcl_knn, matmul_rate, overlap, pipeline,
               kernel_stages)
    _build.build_all([m._SOURCE for m in modules])
    for m in modules:
        m.build()
    build_s = time.perf_counter() - t0
    log({"phase": "toolchain", "nvidia_smi": card,
         "torch": torch.__version__, "torch_cuda": torch.version.cuda,
         "nvcc": _build.find_nvcc(), "kernel_build_s": build_s,
         "sass": check_sass([m._SOURCE for m in (egcl_pair, egcl_knn,
                                                 matmul_rate, overlap,
                                                 pipeline)])})

    cfg = load_config_npz(str(SNAPSHOT))
    params = load_params_npz(str(SNAPSHOT))
    fx, graphs, cell = load_fixture(device)
    plain_calls = {}

    def kernels_only(name, phase, *args):
        """``phase(*args)``, which must never take the plain route."""
        egnn.plain_edge_calls = 0
        out = phase(*args)
        plain_calls[name] = egnn.plain_edge_calls
        if egnn.plain_edge_calls:
            raise AssertionError(f"{name} took the plain route "
                                 f"{egnn.plain_edge_calls} times")
        return out

    pair = phase_kernels(cfg, params, fx, cell, device)
    phase_denoiser(cfg, params, fx, device)
    pair_launches = kernels_only("generate", phase_generate, cfg, params,
                                 graphs, device)
    kernels_only("headline", phase_headline, cfg, params, cell, device, card)
    knn = phase_knn_kernel(cfg, params, fx, device)
    phase_knn_is_dense(cfg, params, fx, device)
    phase_denoiser(cfg, params, fx, device, k=GOLDEN_K)
    knn_launches = kernels_only("generate_knn", phase_generate,
                                cfg.replace(neighbor_k=SERVED_K), params,
                                graphs, device)
    kernels_only("large_cell", phase_large_cell, cfg, params, device, card)
    log({"phase": "flagship_routes", "plain_edge_calls": plain_calls,
         "egcl_pair_launches_served": pair_launches,
         "egcl_knn_launches_served": knn_launches,
         "launches_per_denoiser_call": launches_per_call(
             cfg.replace(compute_dtype="bfloat16"), params, fx, device)})
    phase_plain_route(device)
    p2 = phase_matmul_rate(device, card)
    probes = [p2, phase_overlap(device, card, p2["ms"]),
              phase_pipeline(device, card),
              phase_kernel_stages(device, card)]

    log({"kernels": [
        {"name": "egcl_pair", "route": "cuda",
         "source": "diffusion_model_tpu_torch/csrc/egcl_pair.cu",
         "replaces": "diffusion_model_tpu/ops/egcl_pallas.py:171",
         "launches": pair_launches, **pair},
        {"name": "egcl_knn", "route": "cuda",
         "source": "diffusion_model_tpu_torch/csrc/egcl_knn.cu",
         "replaces": "diffusion_model_tpu/ops/egcl_pallas_sparse.py:177",
         "launches": knn_launches, **knn},
        *probes,
    ]})
    print(card_line(), flush=True)
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
