"""Chained tensor-core products, bf16 and int8 (probe P2): the CUDA kernel,
its plain PyTorch version, the launch plan and the probe.

``chain`` replaces ``benchmarks/probe_matmul_rate.py:45 pallas_chain``
(``schedule="block"``) and ``:71 pallas_chain_ilp`` (``schedule="warp"``):
the serial chain ``x <- requant(x @ w)``, ``steps`` times, with int8
products into int32 and requant ``clip(o >> 9, +-127)``, or bf16 products
into float32 and requant ``bf16(o * 0.03125)``. Each link needs the whole
previous x, so no compiler can drop one. The int8 chain is exact in float32
(every partial sum is an integer below 1024 * 127**2 < 2**24), so the
plain version, a float32 matmul with TF32 off (PyTorch's default), gives
the kernel's bits.

On the card a chain of 64 rows lives in a thread-block cluster: each block
owns a slice of the output columns, holds the whole x in shared memory,
streams its slice of w through a TMA ring (or keeps it) and multiplies with
wgmma; after a link the blocks hand their slices to each other through
distributed shared memory (``csrc/probe_matmul_rate.cu``).
``chain_plan`` states how a launch is cut (cluster, slice, ring, shared
memory); the kernel reports what it used and ``chain`` compares the two.

    python -m diffusion_model_tpu_torch.probes.matmul_rate

prints, as the TPU probe did, one JSON line per variant with its TOP/s:
the kernel's two schedules and the cuBLAS chain (``library_*`` eager,
``library_graph_*`` replayed from a CUDA graph; yardsticks that no code of
the port calls), at the TPU probe's M = 512 and at a card-filling M, where
a link's cycles go, and what a shallower ring of w costs. It needs a CUDA
card and exits non-zero without one.
"""

from __future__ import annotations

import ctypes
import functools
import sys

import torch

from diffusion_model_tpu_torch.probes import _common

M, N, STEPS = 512, 1024, 256     # the TPU probe's shape and chain length
FILL_M = 132 * 128               # rows that fill the card's 132 SMs
SCHEDULES = {"block": 1, "warp": 2}   # schedule -> chains of a cluster
ROWS = 64                        # rows of a chain (wgmma's M)
MAX_SMEM = 232448                # shared memory a block can ask for
MAX_CLUSTER = 16                 # blocks of a cluster, at most (8 portable)
MAX_STAGES = 32                  # ring stages, at most
MIN_STAGES = 3                   # and at least, unless capped lower
PLAN_KEYS = ("row_groups", "chains", "cs", "ns", "stages", "resident",
             "smem", "blocks")
PHASES = ("products", "ring_wait", "x_wait", "peers_wait", "hand_over",
          "mma_wait")

# Launches of the CUDA kernel in this process; only ``_launch`` (under
# ``chain``, ``chain_phases`` and ``check_on_card``) adds to it, right after
# a launch was accepted.
probe_matmul_rate_launches = 0

_SOURCE = "probe_matmul_rate.cu"
_ENTRY = "probe_chain"


def requant(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int32 -> int8 ``clip(o >> 9, +-127)``; float32 -> bf16 ``o / 32``."""
    if dtype == torch.int8:
        return (o >> 9).clamp_(-127, 127).to(torch.int8)
    return (o * 0.03125).to(dtype)


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in float32 (TF32 off), as int32 for int8 inputs (exact)."""
    o = x.float() @ w.float()
    return o.to(torch.int32) if x.dtype == torch.int8 else o


def chain_reference(a: torch.Tensor, w: torch.Tensor,
                    steps: int = STEPS) -> torch.Tensor:
    """Plain statement of the chain."""
    x = a
    for _ in range(steps):
        x = requant(product(x, w), a.dtype)
    return x


def _block_memory(n: int, eb: int, ns: int, max_stages: int = MAX_STAGES):
    """(ring stages, resident, shared-memory bytes) of a block that owns
    ``ns`` columns, or None where x and MIN_STAGES ring stages do not fit:
    x ``[64, n]``, a ring of stages of ``ns`` rows x 128 bytes of K, 1024
    bytes for the mbarriers and 1024 to align the base. The ring holds the
    block's whole slice of w where that fits (``resident``), else as many
    stages as there is room for, up to ``max_stages``."""
    x = ROWS * n * eb
    stage, per_link = ns * 128, n * eb // 128
    room = MAX_SMEM - 2048 - x
    if room < min(MIN_STAGES, max_stages) * stage:
        return None
    resident = per_link <= max_stages and per_link * stage <= room
    stages = min(max_stages, per_link if resident else room // stage)
    return stages, int(resident), 2048 + x + stages * stage


def chain_plan(m: int, n: int, dtype: torch.dtype, schedule: str,
               max_cluster: int = MAX_CLUSTER, max_stages: int = MAX_STAGES,
               *, active) -> dict:
    """How a launch of ``chain`` is cut; the kernel computes the same.

    A chain is 64 rows. A cluster carries ``chains`` of them (1 for
    "block", 2 for "warp"), each over ``cs`` blocks that own ``ns = n / cs``
    columns. The kernel is built for slices of 64, 128 or 256 columns that
    are whole 128-byte K-blocks. Of these shapes with at most
    ``max_cluster`` blocks the rule takes the widest whose clusters the
    card holds all at once; if none does, the narrowest, which does the
    most products per hand-over. ``active(cluster, ns, smem)`` says how many
    clusters of a shape the card holds at once: only the card knows
    (``card_plan`` asks it), so there is no default. ``max_stages`` caps the
    ring of w (2 to 32), to measure what a shallower ring costs.

    Returns a dict of PLAN_KEYS; raises ValueError where no shape fits.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of "
                         f"{tuple(SCHEDULES)}")
    if m < 1 or n < 256 or n % 256:
        raise ValueError(f"kernel takes M >= 1 and N in multiples of 256; "
                         f"got M={m}, N={n}")
    if not 2 <= max_stages <= MAX_STAGES:
        raise ValueError(f"max_stages must be 2 to {MAX_STAGES}, got "
                         f"{max_stages}")
    eb = 1 if dtype == torch.int8 else 2
    chains = SCHEDULES[schedule]
    row_groups = -(-m // ROWS)
    clusters = -(-row_groups // chains)
    best = None
    for cs in (1, 2, 4, 8, 16):
        cluster = chains * cs
        if n % cs or cluster > min(max_cluster, MAX_CLUSTER):
            continue
        ns = n // cs
        if ns not in (64, 128, 256) or ns * eb % 128:
            continue
        memory = _block_memory(n, eb, ns, max_stages)
        if memory is None:
            continue
        if best is not None and clusters > active(cluster, ns, memory[2]):
            break
        best = dict(zip(PLAN_KEYS, (row_groups, chains, cs, ns, *memory,
                                    clusters * cluster)))
    if best is None:
        raise ValueError(
            f"no cluster of at most {max_cluster} blocks carries a "
            f"{schedule} chain of N={n} ({dtype}) in {MAX_SMEM} bytes of "
            f"shared memory")
    return best


def sliced_link(x: torch.Tensor, w: torch.Tensor, cs: int) -> torch.Tensor:
    """One link as the cluster computes it: ``cs`` column slices, each block
    its own rows of the transposed w (both operands K-major), the slices
    joined. Equal to ``requant(product(x, w))`` bit for bit in int8."""
    wt = w.t().contiguous()
    ns = w.shape[1] // cs
    return torch.cat([requant(product(x, wt[s * ns:(s + 1) * ns].t()),
                              x.dtype) for s in range(cs)], dim=1)


def _check(a, w, steps, schedule) -> None:
    """Raise on anything the kernel does not take."""
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of "
                         f"{tuple(SCHEDULES)}")
    if a.dtype not in (torch.int8, torch.bfloat16):
        raise TypeError(f"a has dtype {a.dtype}: the chain is int8 or "
                        f"bfloat16")
    if a.dim() != 2:
        raise ValueError(f"a has shape {tuple(a.shape)}, want [M, N]")
    m, n = a.shape
    if m < 1 or n < 256 or n % 256:
        raise ValueError(
            f"kernel takes M >= 1 and N in multiples of 256; got M={m}, "
            f"N={n}")
    if not isinstance(steps, int) or steps < 0:
        raise ValueError(f"steps must be an int >= 0, got {steps!r}")
    for name, t, shape in (("a", a, (m, n)), ("w", w, (n, n))):
        _common.check_tensor(name, t, device=a.device, dtype=a.dtype,
                             shape=shape)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _common.load_library(
        _SOURCE, _ENTRY,
        [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3)
    lib.probe_chain_active_clusters.argtypes = [ctypes.c_int] * 4
    lib.probe_chain_active_clusters.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile and load the kernel library now (else at the first launch)."""
    _library()


@functools.cache
def _card_active(int8: bool, cluster: int, ns: int, smem: int) -> int:
    """Clusters of this shape the card holds at once
    (``cudaOccupancyMaxActiveClusters`` for the kernel that would run)."""
    return _library().probe_chain_active_clusters(int(int8), ns, cluster,
                                                  smem)


def card_plan(m: int, n: int, dtype: torch.dtype, schedule: str,
              max_cluster: int = MAX_CLUSTER,
              max_stages: int = MAX_STAGES) -> dict:
    """``chain_plan`` with the card's own answer on co-resident clusters."""
    return chain_plan(
        m, n, dtype, schedule, max_cluster, max_stages,
        active=functools.partial(_card_active, dtype == torch.int8))


def card_table(n: int = N) -> list:
    """The card's answer for every cluster shape ``chain_plan`` weighs at
    width ``n``: clusters held at once, by dtype, cluster and slice."""
    records = []
    for dtype in (torch.bfloat16, torch.int8):
        eb = dtype.itemsize
        for cluster in (1, 2, 4, 8, 16):
            for cs in {cluster, cluster // 2} - {0}:
                ns = n // cs
                memory = _block_memory(n, eb, ns)
                if ns in (64, 128, 256) and ns * eb % 128 == 0 and memory:
                    records.append({
                        "dtype": str(dtype)[6:], "cluster": cluster,
                        "ns": ns, "smem": memory[2], "active_clusters":
                        _card_active(dtype == torch.int8, cluster, ns,
                                     memory[2])})
    return records


def _launch(a, w, steps, schedule, max_cluster=MAX_CLUSTER,
            max_stages=MAX_STAGES, phases=None):
    """Check, plan, launch, count, and hold the kernel's plan to ours;
    returns (x after the last link, the plan with ``active_clusters``).
    With ``phases`` (int64 on the card) the kernel that reads the clock
    runs and fills it."""
    global probe_matmul_rate_launches
    _check(a, w, steps, schedule)
    m, n = a.shape
    with torch.cuda.device(a.device):
        lib = _library()
        want = card_plan(m, n, a.dtype, schedule, max_cluster, max_stages)
        out = torch.empty_like(a)
        wt = torch.empty_like(w)           # w transposed, the kernel's scratch
        used = (ctypes.c_int * (len(PLAN_KEYS) + 1))()
        rc = lib.probe_chain(
            int(a.dtype == torch.int8), int(schedule == "warp"),
            a.data_ptr(), w.data_ptr(), out.data_ptr(), wt.data_ptr(), m, n,
            steps, max_cluster, max_stages, ctypes.addressof(used),
            None if phases is None else phases.data_ptr(),
            _common.stream_of(a.device))
    got = dict(zip(PLAN_KEYS, used))
    if rc != 0 and used[len(PLAN_KEYS)] < 1 and got["blocks"] > 0:
        raise RuntimeError(
            f"{_ENTRY}: the card holds {used[len(PLAN_KEYS)]} clusters of "
            f"{got['chains'] * got['cs']} blocks with {got['smem']} bytes of "
            f"shared memory each (cudaOccupancyMaxActiveClusters), so the "
            f"plan {got} cannot launch")
    _common.raise_on(rc, lib, _ENTRY)
    probe_matmul_rate_launches += 1
    if got != want:
        raise RuntimeError(f"{_ENTRY} used the plan {got}, chain_plan says "
                           f"{want}")
    return out, got | {"active_clusters": used[len(PLAN_KEYS)]}


def chain(a: torch.Tensor, w: torch.Tensor, steps: int = STEPS,
          schedule: str = "block", max_cluster: int = MAX_CLUSTER,
          max_stages: int = MAX_STAGES) -> torch.Tensor:
    """``steps`` links of ``x <- requant(x @ w)`` from x = a.

    Args:
      a: ``[M, N]`` int8 or bfloat16; w: ``[N, N]`` of the same dtype.
      schedule: "block" (a cluster of blocks carries one chain of 64 rows,
        each block a slice of the columns; ``pallas_chain``) or "warp" (a
        cluster carries two independent chains, one per half, that share
        one stream of w; ``pallas_chain_ilp``). A "warp chain" is a
        half-cluster's: the name is the TPU probe's and the earlier
        kernel's, a single warp cannot start a wgmma.
      max_cluster: the most blocks a cluster may have (``chain_plan``).
      max_stages: the most stages the ring of w may have (``chain_plan``).

    Returns:
      x after the last link, ``[M, N]`` in a's dtype.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule {schedule!r} is not one of "
                         f"{tuple(SCHEDULES)}")
    if a.device.type == "cpu":
        return chain_reference(a, w, steps)
    if a.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {a.device}")
    return _launch(a, w, steps, schedule, max_cluster, max_stages)[0]


def chain_phases(a: torch.Tensor, w: torch.Tensor, steps: int = STEPS,
                 schedule: str = "block", max_cluster: int = MAX_CLUSTER,
                 max_stages: int = MAX_STAGES) -> dict:
    """Where the cycles of a chain go, read with ``clock64`` by one thread
    of block 0, in an instantiation of the kernel of its own (the kernel
    ``chain`` launches reads no clock): per link, ``products`` (of which ``ring_wait`` waiting for
    stages of w, ``x_wait`` for slices of x still on their way and
    ``mma_wait`` in ``wgmma.wait_group`` for products to finish),
    ``peers_wait`` (until every block of the chain is done with x) and
    ``hand_over`` (requant into x, issuing the copies); with the plan
    used."""
    cycles = torch.zeros(len(PHASES) + 1, dtype=torch.int64, device=a.device)
    _, plan = _launch(a, w, steps, schedule, max_cluster, max_stages, cycles)
    torch.cuda.synchronize(a.device)
    cycles = cycles.tolist()
    links = max(cycles[-1], 1)
    total = sum(cycles[i] for i in (0, 3, 4)) or 1
    return {"plan": plan,
            "cycles_per_link": {k: cycles[i] / links
                                for i, k in enumerate(PHASES)},
            "share": {k: cycles[i] / total for i, k in enumerate(PHASES)}}


def library_chain(a: torch.Tensor, w: torch.Tensor,
                  steps: int = STEPS) -> torch.Tensor:
    """The same chain through cuBLAS (``torch._int_mm`` for int8): the
    yardstick of speed, timed beside the kernel and called by no port code."""
    x = a
    for _ in range(steps):
        if a.dtype == torch.int8:
            x = requant(torch._int_mm(x, w), torch.int8)
        else:
            x = (x @ w).mul_(0.03125)    # a power of 2: the same rounding
    return x


def library_graph(a: torch.Tensor, w: torch.Tensor, steps: int = STEPS):
    """``library_chain`` captured once into a CUDA graph; returns the
    function that replays it (the yardstick without the host's launches)."""
    side = torch.cuda.Stream(a.device)
    side.wait_stream(torch.cuda.current_stream(a.device))
    with torch.cuda.stream(side):
        library_chain(a, w, 3)
    torch.cuda.current_stream(a.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        library_chain(a, w, steps)
    return graph.replay


def make_inputs(m: int, n: int, dtype: torch.dtype, device,
                seed: int = 0) -> tuple:
    """The TPU probe's inputs: standard normals, as int8 ``clip(20 v)``."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, n, generator=g)
    w = torch.randn(n, n, generator=g)
    if dtype == torch.int8:
        a, w = ((v * 20).clamp(-127, 127).to(torch.int8) for v in (a, w))
    else:
        a, w = a.to(dtype), w.to(dtype)
    return a.to(device), w.to(device)


def check_on_card(device, short: int = 3, ms=(M, FILL_M)) -> list:
    """Each schedule and dtype against the plain version at every M that
    ``measure`` times (so every instantiation it runs: the wide clusters of
    M = 512 and the 256-column slices of the card-filling M): int8 bit for
    bit over ``short`` links and over the full chain, bf16 by relative L2
    <= 1e-2 over ``short`` links and finite over the full chain. Raises on
    any miss; returns the records, each with the plan its launch used."""
    records = []
    for m in ms:
        for dtype in (torch.int8, torch.bfloat16):
            a, w = make_inputs(m, N, dtype, device)
            for steps in (short, STEPS):
                want = chain_reference(a, w, steps)
                for schedule in SCHEDULES:
                    got, plan = _launch(a, w, steps, schedule)
                    torch.cuda.synchronize()
                    rec = {"schedule": schedule, "dtype": str(dtype)[6:],
                           "m": m, "steps": steps,
                           "cluster": plan["chains"] * plan["cs"],
                           "ns": plan["ns"], "stages": plan["stages"],
                           "resident": plan["resident"],
                           "active_clusters": plan["active_clusters"],
                           "max_abs_err": float(
                               (got.float() - want.float()).abs().max())}
                    if dtype == torch.int8:
                        rec["mismatches"] = int((got != want).sum())
                        rec["tolerance"] = "bit for bit"
                        ok = rec["mismatches"] == 0
                    elif steps == short:
                        rec["rel_l2"] = _common.rel_l2(got, want)
                        rec["tolerance"] = "relative L2 1e-2"
                        ok = rec["rel_l2"] <= 1e-2
                    else:
                        rec["finite"] = bool(
                            torch.isfinite(got.float()).all())
                        ok = rec["finite"]
                    records.append(rec)
                    if not ok:
                        raise AssertionError(f"chain kernel off its plain "
                                             f"version: {rec}")
    return records


def measure(device, reps: int = 10, shapes=(("tpu", M), ("card_filling",
                                                        FILL_M))) -> list:
    """TOP/s of each variant of the full chain, CUDA events, mean of
    ``reps`` calls after a warm-up, beside the card's bound for the chain,
    the eager cuBLAS chain of the same run (``over_library``) and the plan
    the launch used."""
    records = []
    for shape, m in shapes:
        ops = 2 * m * N * N * STEPS
        for dtype in (torch.bfloat16, torch.int8):
            a, w = make_inputs(m, N, dtype, device)
            name = "int8" if dtype == torch.int8 else "bf16"
            bound = _common.bound(2 * _common.nbytes(a) + _common.nbytes(w),
                                  **{name: ops})
            library_ms = None
            for variant, fn in (
                    (f"library_{name}", lambda: library_chain(a, w)),
                    (f"library_graph_{name}", library_graph(a, w)),
                    (f"block_{name}", lambda: chain(a, w, STEPS, "block")),
                    (f"warp_{name}", lambda: chain(a, w, STEPS, "warp"))):
                ms = _common.cuda_ms(fn, reps)
                rec = {"variant": variant, "shape": shape, "m": m, "ms": ms,
                       "tops": ops / ms / 1e9, **bound,
                       "over_bound": ms / bound["bound_ms"]}
                if variant == f"library_{name}":
                    library_ms = ms
                elif not variant.startswith("library"):
                    plan = card_plan(m, N, dtype, variant.split("_")[0])
                    rec |= {"over_library": ms / library_ms,
                            "cluster": plan["chains"] * plan["cs"],
                            "ns": plan["ns"], "plan": plan}
                records.append(rec)
    return records


def measure_phases(device, m: int = M) -> list:
    """``chain_phases`` of every schedule and dtype at ``m`` rows."""
    records = []
    for dtype in (torch.bfloat16, torch.int8):
        a, w = make_inputs(m, N, dtype, device)
        for schedule in SCHEDULES:
            records.append({"phases_of": f"{schedule}_{str(dtype)[6:]}",
                            "m": m, **chain_phases(a, w, STEPS, schedule)})
    return records


def measure_ring(device, depths=(2, 3, 4), reps: int = 5,
                 shapes=((torch.bfloat16, M), (torch.int8, M),
                         (torch.bfloat16, FILL_M))) -> list:
    """What the ring of w is worth: the block chain of each (dtype, M) with
    the ring capped at each of ``depths`` stages and as planned, ms per
    chain and the plan used (int8 at M = 512 keeps w resident as planned and
    streams it through a capped ring)."""
    records = []
    for dtype, m in shapes:
        a, w = make_inputs(m, N, dtype, device)
        for depth in (*depths, MAX_STAGES):
            plan = card_plan(m, N, dtype, "block", max_stages=depth)
            records.append({
                "ring_of": f"block_{str(dtype)[6:]}", "m": m,
                "max_stages": depth, "stages": plan["stages"],
                "resident": plan["resident"], "ns": plan["ns"],
                "ms": _common.cuda_ms(
                    lambda: chain(a, w, STEPS, "block", max_stages=depth),
                    reps)})
    return records


def main(argv=None) -> int:
    device = _common.card_or_none()
    if device is None:
        return 1
    build()
    _common.emit({"devices": [torch.cuda.get_device_name(0)],
                  "card": _common.card_line(),
                  "ops_total_t": 2 * M * N * N * STEPS / 1e12,
                  "note": "one call = one chain of 256 links; tops over "
                          "mean CUDA-event time"})
    _common.emit({"clusters_held_at_once": card_table()})
    for rec in check_on_card(device):
        _common.emit({"check": rec})
    for rec in measure(device):
        _common.emit(rec)
    for rec in (*measure_phases(device), *measure_phases(device, FILL_M),
                *measure_ring(device)):
        _common.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
