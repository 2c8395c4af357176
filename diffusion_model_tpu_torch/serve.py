"""Serving export: a trained sampler written to one file that a serving
process loads and calls, as ``diffusion_model_tpu/serve.py``.

    export_sampler(cfg, trainer, state, "sampler.pt2", batch_size=16)
    served = ServedSampler("sampler.pt2")         # on the card
    pos, species, accepted = served(seed, spectrum, exo, mask)

**The artifact.** As the JAX package's (StableHLO through ``jax.export``),
the artifact is the compiled sampler: a serving process calls it without
the model code, the config system or the checkpoint machinery. ``<path>``
is one zip file of format ``FORMAT`` holding

  * ``start.pt2``, ``step.pt2`` and ``epilogue.pt2``: ``torch.export``
    programs of the reverse chain's three pieces
    (``diffusion.sampler.ReverseChain.start``, ``.step`` and ``.finish``)
    at the export's static shape. The weights (each EGCL's cast once, in
    the compute dtype), the strided grid and the schedule table (a learned
    schedule's baked in, as the JAX export bakes it) are the programs'
    constants. Each EGCL's edge work is one node of the custom op
    ``diffusion_model_tpu_torch::egcl_pair`` (K1) or ``::egcl_knn`` (K2),
    and in a model whose compute dtype is not float32 each bias-SiLU of
    the node side one node of ``::bias_silu`` (``ops/activations.py``),
    which the op modules register: the kernel on the card, its plain
    statement on the CPU. An artifact exported before that op existed
    holds no such node and runs as it did;
  * ``artifact.json``: the format, the grid length ``steps`` and the shapes
    of the draws each piece takes, in the order ``diffusion/sampler.py``
    states (the start's, then one step's, which the epilogue takes too).

The step takes its grid index as a 0-d int64 tensor on the CPU (the
program reads it with ``item``, free on the host, where a tensor on the
card would make the host wait for the card at every step) and the loader
drives the loop: the start, ``steps`` steps from index ``steps`` down to
1, the epilogue, as the JAX artifact's scan does inside StableHLO; nothing
is unrolled. The programs are traced on the export's device, stored on the
CPU, and moved to the serving device at load (``move_to_device_pass``).
Loading imports torch, numpy, this package's ``__init__`` and the three op
modules (with ``ops._build``, ``_tiles``, ``edge_grad``, ``edges``,
``angles`` and ``schedules``); ``export_sampler`` imports the rest. A file
of format 1 (a ``torch.save`` dict of parameters, which the model code
rebuilt into a sampler) is refused with a message asking for a re-export,
and a file of any other format (a JAX artifact) too. The JAX package's
four-input legacy artifacts (exported before the species input) have no
counterpart here, so no such path is kept.

``<path>.json`` is the sidecar with the keys of the JAX package's:
``batch_size``, ``n_max``, ``spectrum_size`` (the width a call takes: the
latent's for a ``spectrum_to_latent`` model), ``atom_type_size``,
``num_diffusion_timestep``, ``sample_steps``, ``deterministic_sampling``,
``platforms`` (of ``cuda`` and ``cpu``), ``diffuse_species``, ``inputs``,
``outputs``, ``in_graph_retry_rounds`` and, when measured, ``acceptance``.

**The retry rule.** With ``retry_rounds`` > 0 the served call redraws the
rejected rows (NaN, or a coordinate above 1000 A): round 0 draws from
``torch.Generator(device).manual_seed(seed)``, bit for bit the live
``diffusion.sampler.sample`` with that generator; round i > 0 draws from a
generator seeded with ``retry_seed(seed, i)`` (``numpy.random.SeedSequence
([seed, i])``'s first word), the port's counterpart of the JAX package's
``fold_in(PRNGKey(seed), i)``. A round keeps what it draws for the rows
rejected so far that it accepts (round 0 keeps every row); the loop stops
when every row is accepted or after ``retry_rounds + 1`` rounds, and the
rows still rejected come back with ``accepted`` false.
"""

from __future__ import annotations

import io
import json
import logging
import warnings
import zipfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

# registers the custom ops the programs call
from diffusion_model_tpu_torch.ops import (  # noqa: F401
    activations,
    egcl_knn,
    egcl_pair,
)

FORMAT = "diffusion_model_tpu_torch.serve/2"
FORMAT_1 = "diffusion_model_tpu_torch.serve/1"
PLATFORMS = ("cuda", "cpu")
PIECES = ("start", "step", "epilogue")

NoiseSource = Callable[[Sequence[int]], torch.Tensor]


def retry_seed(seed: int, round_index: int) -> int:
    """The seed of retry round ``round_index`` > 0 of a call at ``seed``."""
    return int(np.random.SeedSequence([seed, round_index])
               .generate_state(1)[0])


def round_generator(seed: int, round_index: int, device) -> torch.Generator:
    """Round 0: ``manual_seed(seed)``, the live sampler's generator; round
    i > 0: ``manual_seed(retry_seed(seed, i))``."""
    s = seed if round_index == 0 else retry_seed(seed, round_index)
    return torch.Generator(device=device).manual_seed(s)


def _sampler_fn(programs: dict, layout: dict, retry_rounds: int = 0,
                noise_for_round: Optional[Callable[[int], NoiseSource]] = None
                ) -> Callable:
    """``(seed, spectrum [B,N,S], exo [B,N,1], mask [B,N], species [B,N,A])
    -> (pos, species, accepted)``, tensors on the inputs' device, from the
    three pieces (``programs[name]`` callables, ``chain_programs``' modules)
    and ``layout`` (``artifact.json``).

    ``species`` is the condition's one-hots: ignored when the species are
    diffused, the fixed species channel otherwise. ``retry_rounds`` > 0
    redraws the rejected rows (module docstring). ``noise_for_round(i)``,
    where given, is round i's source of draws in place of its generator
    (``sample``'s ``noise=``), so a test can replay another
    implementation's draws."""
    start, step, epilogue = (programs[name] for name in PIECES)
    draws = layout["draws"]
    grid = torch.arange(layout["steps"], 0, -1)   # on the CPU

    def run(seed, cond, i):
        device = cond[0].device
        if noise_for_round is not None:
            noise = noise_for_round(i)
        else:
            gen = round_generator(seed, i, device)

            def noise(shape):
                return torch.randn(tuple(shape), generator=gen,
                                   device=device)

        def take(piece):
            got = [noise(s) for s in draws[piece]]
            return got + [None] * (2 - len(got))

        pos, h = start(cond, *take("start"))
        for t in grid:
            pos, h = step(cond, pos, h, t, *take("step"))
        return epilogue(cond, pos, h, *take("step"))

    def fn(seed, spectrum, exo, mask, species):
        cond = (spectrum, exo, mask, species)
        pos, sp, acc = run(seed, cond, 0)
        i = 1
        while i < retry_rounds + 1 and not bool(acc.all()):
            r_pos, r_sp, r_acc = run(seed, cond, i)
            take = ~acc & r_acc
            pos = torch.where(take[:, None, None], r_pos, pos)
            sp = torch.where(take[:, None, None], r_sp, sp)
            acc = acc | r_acc
            i += 1
        return pos, sp, acc

    return fn


def _check_platforms(platforms: Sequence[str]) -> list:
    platforms = list(platforms)
    for p in platforms:
        if p == "tpu":
            raise ValueError(
                "platform 'tpu': the port serves on the card (cuda) and the "
                "CPU; a TPU artifact is the JAX package's "
                "(diffusion_model_tpu.serve)")
        if p not in PLATFORMS:
            raise ValueError(f"platform {p!r}: the port serves on "
                             f"{PLATFORMS}")
    if not platforms:
        raise ValueError("no platform to export for")
    return platforms


class _Piece(torch.nn.Module):
    """One piece of the reverse chain (``PIECES``) as a module that
    ``torch.export`` takes: ``forward((spectrum, exo, mask, species),
    *state)`` builds the chain over that condition (``make_chain(cond)``,
    a ``ReverseChain``) and runs the piece. The denoiser is no submodule:
    the program holds as constants only the tensors the trace reads (each
    EGCL's cast weights, not its float32 parameters), and the start none."""

    def __init__(self, piece: str, make_chain: Callable):
        super().__init__()
        self.piece, self.make_chain = piece, make_chain

    def forward(self, cond, *state):
        chain = self.make_chain(cond)
        if self.piece == "start":
            return chain.start(*state)
        if self.piece == "step":
            return chain.step(*state)
        pos, _, species, _, accepted = chain.finish(*state)
        return pos, species, accepted


def chain_programs(cfg, denoise_fn: Callable, schedule, batch_size: int,
                   device) -> tuple:
    """(``{piece: ExportedProgram}``, layout): the reverse chain of
    ``denoise_fn`` (``sample``'s) over ``schedule`` (the full ``T+1``
    table) for ``batch_size`` conditions of ``cfg.n_max`` atoms, its three
    pieces exported on ``device``, and ``artifact.json``'s content. The
    EGCLs of a ``denoise_fn`` module cast their weights first, so the
    programs hold them cast (``nn.egnn.EGCL.compute_weights``)."""
    from diffusion_model_tpu_torch.data.batch import GraphBatch
    from diffusion_model_tpu_torch.diffusion.sampler import (
        ReverseChain,
        _strided,
    )
    from diffusion_model_tpu_torch.nn.egnn import EGCL

    b, n = batch_size, cfg.n_max
    grid = _strided(schedule, cfg)

    def make_chain(cond):
        spectrum, exo, mask, species = cond
        # the chain reads no positions of its condition
        return ReverseChain(denoise_fn, None, cfg,
                            GraphBatch(pos=None, species=species,
                                       spectrum=spectrum, exo=exo,
                                       mask=mask),
                            grid=grid)

    def zeros(shape):
        return torch.zeros(shape, device=device)

    cond = (zeros((b, n, cfg.spectrum_input_size)), zeros((b, n, 1)),
            torch.ones((b, n), device=device),
            zeros((b, n, cfg.atom_type_size)))
    chain = make_chain(cond)
    shapes = {"start": chain.start_shapes(), "step": chain.step_shapes()}
    state = (zeros((b, n, 3)), zeros((b, n, cfg.atom_type_size)))
    t = torch.tensor(chain.steps)   # on the CPU, as the loader gives it
    noise = chain.draws(zeros, shapes["step"])
    examples = {"start": (cond, *chain.draws(zeros, shapes["start"])),
                "step": (cond, *state, t, *noise),
                "epilogue": (cond, *state, *noise)}
    programs = {}
    with torch.no_grad():
        if isinstance(denoise_fn, torch.nn.Module):
            for layer in denoise_fn.modules():
                if isinstance(layer, EGCL):
                    layer.compute_weights(layer.compute_dtype)
        for piece in PIECES:
            programs[piece] = torch.export.export(
                _Piece(piece, make_chain), examples[piece],
                strict=False)
    layout = {"format": FORMAT, "steps": chain.steps,
              "draws": {k: [list(s) for s in v] for k, v in shapes.items()}}
    return programs, layout


def export_sampler(cfg, trainer, state, path: str, batch_size: int,
                   platforms: Sequence[str] = PLATFORMS,
                   retry_rounds: int = 0,
                   acceptance_stats: Optional[dict] = None) -> None:
    """Write the sampler of ``state.eval_params(cfg)`` for ``batch_size``
    conditions of ``cfg.n_max`` atoms to ``path`` (and the sidecar
    ``path.json``), its programs traced on ``trainer.device``.

    ``platforms``: the devices a ``ServedSampler`` may run it on, of
    ``cuda`` and ``cpu``. ``retry_rounds``: redraw rounds of each call
    (module docstring); 0 leaves the redraw of rejected rows to the caller.
    ``acceptance_stats``: measured acceptance (``cli.export --calibrate``),
    recorded in the sidecar."""
    from diffusion_model_tpu_torch import api
    from diffusion_model_tpu_torch.train.trainer import params_tree

    platforms = _check_platforms(platforms)
    tree = params_tree(state.eval_params(cfg))
    device = trainer.device
    with torch.no_grad():
        # inference only: the constants the programs keep need no grad
        model = api.denoiser_from_params(cfg, tree, device).requires_grad_(
            False)
        schedule = api.schedule_for(cfg, tree, device)
    programs, layout = chain_programs(cfg, model, schedule, batch_size,
                                      device)
    with zipfile.ZipFile(path, "w") as zf, warnings.catch_warnings():
        # some constants are views of parameters (a cast to their own
        # dtype), which the writer warns of for weights off the CPU
        warnings.filterwarnings("ignore", "No complete tensor found")
        for piece, ep in programs.items():
            buf = io.BytesIO()
            torch.export.save(move_to_device_pass(ep, "cpu"), buf)
            zf.writestr(f"{piece}.pt2", buf.getvalue())
        zf.writestr("artifact.json", json.dumps(layout))
    meta = {
        "batch_size": batch_size,
        "n_max": cfg.n_max,
        "spectrum_size": cfg.spectrum_input_size,
        "atom_type_size": cfg.atom_type_size,
        "num_diffusion_timestep": cfg.num_diffusion_timestep,
        "sample_steps": cfg.sample_steps,
        "deterministic_sampling": cfg.deterministic_sampling,
        "platforms": platforms,
        "diffuse_species": cfg.diffuse_species,
        "inputs": "seed:u32[], spectrum:f32[B,N,S], exo:f32[B,N,1], "
                  "mask:f32[B,N], species:f32[B,N,A] (condition one-hots; "
                  "ignored when diffuse_species)",
        "outputs": "pos:f32[B,N,3], species:f32[B,N,A], accepted:bool[B]",
        # 0: the caller redraws the rows with accepted=False (a fresh
        # seed); > 0: the call redraws them, and only the rows still
        # rejected after the last round come back rejected
        "in_graph_retry_rounds": retry_rounds,
    }
    if acceptance_stats:
        meta["acceptance"] = acceptance_stats
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def _refuse(path: str) -> None:
    """Raise for a file that holds no programs: a ``torch.save`` dict (of
    format 1, or another), or anything else."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{path} is not a serving artifact of the port (format "
            f"{FORMAT!r}, written by diffusion_model_tpu_torch.serve."
            "export_sampler); a JAX StableHLO artifact is served by "
            f"diffusion_model_tpu.serve ({type(e).__name__})") from e
    found = blob.get("format") if isinstance(blob, dict) else None
    if found == FORMAT_1:
        raise ValueError(
            f"{path} has format {found!r}: parameters for the model code to "
            f"rebuild, not the compiled programs of format {FORMAT!r}; "
            "re-export it (serve.export_sampler or cli.export)")
    raise ValueError(f"{path} has format {found!r}, not {FORMAT!r}")


def _load_artifact(path: str, device) -> tuple:
    """(``{piece: module}`` on ``device``, layout) of ``path``."""
    if not zipfile.is_zipfile(path):
        _refuse(path)
    with zipfile.ZipFile(path) as zf:
        if "artifact.json" not in zf.namelist():
            _refuse(path)
        layout = json.loads(zf.read("artifact.json"))
        if layout.get("format") != FORMAT:
            raise ValueError(f"{path} has format {layout.get('format')!r}, "
                             f"not {FORMAT!r}")
        # the reader warns of each symbol of an ``item`` (the grid index)
        # that the graph does not keep
        serde = logging.getLogger("torch._export.serde.serialize")
        level = serde.level
        serde.setLevel(logging.ERROR)
        try:
            programs = {}
            for piece in PIECES:
                ep = torch.export.load(io.BytesIO(zf.read(f"{piece}.pt2")))
                programs[piece] = move_to_device_pass(ep, device).module()
        finally:
            serde.setLevel(level)
    return programs, layout


class ServedSampler:
    """A sampler loaded from ``export_sampler``'s artifact, on the card
    unless ``device`` names the CPU (a device of the sidecar's
    ``platforms``); raises where it finds no card and the CPU was not
    asked for."""

    def __init__(self, path: str, device=None):
        with open(path + ".json") as f:
            self.meta = json.load(f)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"{path} was exported for {self.meta['platforms']}, not "
                f"{self.device.type}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ServedSampler runs on the card and finds "
                               "none; pass device='cpu' to run on the CPU")
        self.programs, self.layout = _load_artifact(path, self.device)
        self._fn = _sampler_fn(self.programs, self.layout,
                               self.meta["in_graph_retry_rounds"])

    def __call__(self, seed: int, spectrum, exo, mask, species=None):
        """``(pos f32[B,N,3], species f32[B,N,A], accepted bool[B])`` as
        numpy for one call at the export's shape; ``seed`` in
        ``[0, 2**32)``."""
        if not 0 <= int(seed) < 2 ** 32 or int(seed) != seed:
            raise ValueError(f"seed {seed} must be an integer in [0, 2**32)")
        meta = self.meta
        if species is None:
            if not meta["diffuse_species"]:
                raise ValueError(
                    "this artifact was exported from a position-only "
                    "(diffuse_species=False) model: the fixed species "
                    "one-hots must be supplied per request")
            species = np.zeros((meta["batch_size"], meta["n_max"],
                                meta["atom_type_size"]), np.float32)
        b, n = meta["batch_size"], meta["n_max"]
        want = {"spectrum": (b, n, meta["spectrum_size"]), "exo": (b, n, 1),
                "mask": (b, n), "species": (b, n, meta["atom_type_size"])}
        args = {}
        for name, value in (("spectrum", spectrum), ("exo", exo),
                            ("mask", mask), ("species", species)):
            t = torch.as_tensor(np.asarray(value, np.float32),
                                device=self.device)
            if tuple(t.shape) != want[name]:
                raise ValueError(
                    f"{name} has shape {tuple(t.shape)}; this artifact takes "
                    f"{want[name]} (one export per shape bucket)")
            args[name] = t
        pos, sp, acc = self._fn(int(seed), args["spectrum"], args["exo"],
                                args["mask"], args["species"])
        return pos.cpu().numpy(), sp.cpu().numpy(), acc.cpu().numpy()
