"""Serving export: a trained sampler written to one file that a serving
process loads and calls, as ``diffusion_model_tpu/serve.py``.

    export_sampler(cfg, trainer, state, "sampler.pt", batch_size=16)
    served = ServedSampler("sampler.pt")          # on the card
    pos, species, accepted = served(seed, spectrum, exo, mask)

**The artifact (a deviation from the JAX package).** The JAX package
exports the whole reverse chain as StableHLO, which runs without its model
code. The port cannot write StableHLO, and ``torch.export`` would unroll
the chain (up to 1000 steps of ~100 launches each) into one graph and
cannot trace the EGCL kernels, which are ctypes libraries. So the port's
artifact is not model-code-free: ``<path>`` is one ``torch.save`` dict read
back with ``torch.load(weights_only=True)`` (no pickled code runs) holding

  * ``format``: ``FORMAT``;
  * ``config``: the config as JSON;
  * ``params``: the denoiser's eval parameters, float32, keyed by their
    flax paths (``denoiser/params/egnn/egcl_0/mlp_m_dense0/kernel`` ...);
  * ``alphas``: the schedule table ``[T+1]`` float32, computed at export
    (a learned schedule's table baked in, as the JAX export bakes it);

and ``ServedSampler`` rebuilds the sampler from this package
(``api.denoiser_from_params``), as ``api.generate`` does. A file of
another format (a JAX artifact) is refused with a message naming the
format. The JAX package's four-input legacy artifacts (exported before the
species input) have no counterpart here, so no such path is kept.

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

import json
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.data.batch import GraphBatch
from diffusion_model_tpu_torch.diffusion.process import Schedule
from diffusion_model_tpu_torch.diffusion.sampler import NoiseSource, sample
from diffusion_model_tpu_torch.train.checkpoint import _flatten
from diffusion_model_tpu_torch.train.trainer import params_tree

FORMAT = "diffusion_model_tpu_torch.serve/1"
PLATFORMS = ("cuda", "cpu")


def retry_seed(seed: int, round_index: int) -> int:
    """The seed of retry round ``round_index`` > 0 of a call at ``seed``."""
    return int(np.random.SeedSequence([seed, round_index])
               .generate_state(1)[0])


def round_generator(seed: int, round_index: int, device) -> torch.Generator:
    """Round 0: ``manual_seed(seed)``, the live sampler's generator; round
    i > 0: ``manual_seed(retry_seed(seed, i))``."""
    s = seed if round_index == 0 else retry_seed(seed, round_index)
    return torch.Generator(device=device).manual_seed(s)


def _sampler_fn(cfg: Config, denoise_fn: Callable, schedule: Schedule,
                retry_rounds: int = 0,
                noise_for_round: Optional[Callable[[int], NoiseSource]] = None
                ) -> Callable:
    """``(seed, spectrum [B,N,S], exo [B,N,1], mask [B,N], species [B,N,A])
    -> (pos, species, accepted)``, tensors on the inputs' device.

    ``species`` is the condition's one-hots: ignored when
    ``cfg.diffuse_species``, the fixed species channel otherwise.
    ``retry_rounds`` > 0 redraws the rejected rows (module docstring).
    ``noise_for_round(i)``, where given, is round i's source of draws in
    place of its generator (``sample``'s ``noise=``), so a test can replay
    another implementation's draws."""
    def run(seed, cond, i):
        if noise_for_round is not None:
            return sample(denoise_fn, schedule, cfg, None, cond,
                          noise_for_round(i))
        return sample(denoise_fn, schedule, cfg,
                      round_generator(seed, i, cond.device), cond)

    def fn(seed, spectrum, exo, mask, species):
        b, n = mask.shape
        cond = GraphBatch(pos=spectrum.new_zeros((b, n, 3)), species=species,
                          spectrum=spectrum, exo=exo, mask=mask)
        r = run(seed, cond, 0)
        pos, sp, acc = r.pos, r.species, r.accepted
        i = 1
        while i < retry_rounds + 1 and not bool(acc.all()):
            r = run(seed, cond, i)
            take = ~acc & r.accepted
            pos = torch.where(take[:, None, None], r.pos, pos)
            sp = torch.where(take[:, None, None], r.species, sp)
            acc = acc | r.accepted
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


def export_sampler(cfg: Config, trainer, state, path: str, batch_size: int,
                   platforms: Sequence[str] = PLATFORMS,
                   retry_rounds: int = 0,
                   acceptance_stats: Optional[dict] = None) -> None:
    """Write the sampler of ``state.eval_params(cfg)`` for ``batch_size``
    conditions of ``cfg.n_max`` atoms to ``path`` (and the sidecar
    ``path.json``).

    ``platforms``: the devices a ``ServedSampler`` may run it on, of
    ``cuda`` and ``cpu``. ``retry_rounds``: redraw rounds of each call
    (module docstring); 0 leaves the redraw of rejected rows to the caller.
    ``acceptance_stats``: measured acceptance (``cli.export --calibrate``),
    recorded in the sidecar."""
    platforms = _check_platforms(platforms)
    tree = params_tree(state.eval_params(cfg))
    with torch.no_grad():
        alphas = api.schedule_for(cfg, tree, trainer.device).alphas
    flat = {k: torch.as_tensor(np.array(v, np.float32))
            for k, v in _flatten({"denoiser": tree["denoiser"]}).items()}
    torch.save({"format": FORMAT, "config": json.dumps(cfg.to_dict()),
                "params": flat,
                "alphas": alphas.detach().to("cpu", torch.float32)}, path)
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


def _load_artifact(path: str) -> dict:
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:
        raise ValueError(
            f"{path} is not a serving artifact of the port (format "
            f"{FORMAT!r}, written by diffusion_model_tpu_torch.serve."
            "export_sampler); a JAX StableHLO artifact is served by "
            f"diffusion_model_tpu.serve ({type(e).__name__})") from e
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        found = blob.get("format") if isinstance(blob, dict) else None
        raise ValueError(f"{path} has format {found!r}, not {FORMAT!r}")
    return blob


class ServedSampler:
    """A sampler loaded from ``export_sampler``'s artifact, on the card
    unless ``device`` names the CPU (a device of the sidecar's
    ``platforms``)."""

    def __init__(self, path: str, device=None):
        with open(path + ".json") as f:
            self.meta = json.load(f)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"{path} was exported for {self.meta['platforms']}, not "
                f"{self.device.type}")
        self.device = api._device(self.device, "ServedSampler")
        blob = _load_artifact(path)
        self.cfg = from_dict(json.loads(blob["config"]))
        tree: dict = {}
        for key, value in blob["params"].items():
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value.numpy()
        model = api.denoiser_from_params(self.cfg, tree, self.device)
        schedule = Schedule(alphas=blob["alphas"].to(self.device))
        self._fn = _sampler_fn(self.cfg, model, schedule,
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
