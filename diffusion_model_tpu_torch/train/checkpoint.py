"""Checkpoints of a run's full training state, pickle-free ``.npz``
parameter snapshots, and the flax-to-torch name map.

A checkpoint (``save_checkpoint``, ``latest_step``, ``restore_checkpoint``;
the JAX package's ``train/checkpoint.py`` on orbax) is the whole
``TrainState``: the parameters, the optimizer state and the step count,
with the run's config as JSON stamped with ``gamma_endpoint_scale``. The
layout is orbax's, ``<directory>/<step>/``, the format the port's own: one
``state.pt`` holding a flat dict of tensors keyed by field path
(``params/<name>``, ``opt_state/1/z/<name>``, ``opt_state/1/step_count``;
host numbers as 0-d int64 / float64 tensors, exact), read back with
``torch.load(weights_only=True)`` and rebuilt onto the structure of a
fresh state, never unpickled as objects.

A snapshot written by ``diffusion_model_tpu.train.checkpoint.save_params_npz``
holds the flattened flax parameter tree (``denoiser/params/egnn/egcl_0/
mlp_m_dense0/kernel`` ..., and ``gamma/params/...`` for a learned noise
schedule) and the run's config as a JSON string under ``__config_json__``.
Both load here with numpy alone. ``save_params_npz`` writes the same format
from the port's modules (``flax_from_state_dict`` is the inverse of
``state_dict_from_flax``), so a snapshot either package writes loads
unchanged in both.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from diffusion_model_tpu_torch.config import Config, from_dict
from diffusion_model_tpu_torch.nn.gamma import ENDPOINT_SCALE

_CONFIG_KEY = "__config_json__"
MAX_TO_KEEP = 3
_STATE_FILE = "state.pt"
_META_FILE = "config.json"
_TMP_PREFIX = ".tmp-"
_ENDPOINTS = ("gamma.gamma_0", "gamma.gamma_1")


def _flatten_state(tree: Any, prefix: str, out: dict) -> dict:
    """Tensors and host numbers of a state tree keyed by field path."""
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree.detach()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flatten_state(v, f"{prefix}/{k}", out)
    elif isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        for name, v in zip(names, tree):
            _flatten_state(v, f"{prefix}/{name}", out)
    elif isinstance(tree, int):
        out[prefix] = torch.tensor(tree, dtype=torch.int64)
    elif isinstance(tree, float):
        out[prefix] = torch.tensor(tree, dtype=torch.float64)
    else:
        raise TypeError(f"{prefix}: cannot checkpoint a {type(tree)}")
    return out


def _rebuild(template: Any, flat: dict, prefix: str, used: set) -> Any:
    """``template``'s structure holding the values of ``flat``."""
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, f"{prefix}/{k}", used)
                for k, v in template.items()}
    if isinstance(template, tuple):
        names = getattr(template, "_fields", range(len(template)))
        parts = [_rebuild(v, flat, f"{prefix}/{n}", used)
                 for n, v in zip(names, template)]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else tuple(parts)
    if prefix not in flat:
        raise KeyError(f"the checkpoint has no {prefix}")
    used.add(prefix)
    value = flat[prefix]
    if isinstance(template, torch.Tensor):
        if value.shape != template.shape or value.dtype != template.dtype:
            raise ValueError(
                f"{prefix}: the checkpoint holds {value.dtype} "
                f"{tuple(value.shape)}, the run {template.dtype} "
                f"{tuple(template.shape)}")
        return value
    return type(template)(value.item())


def _committed_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit()
        and os.path.isfile(os.path.join(directory, name, _STATE_FILE))
        and os.path.isfile(os.path.join(directory, name, _META_FILE)))


def save_checkpoint(directory: str, state, cfg: Config, step: int) -> None:
    """Save ``state`` (a ``TrainState``) as ``directory/<step>/``.

    It is written under a temporary name and renamed into place, as orbax
    commits, so a run killed mid-save leaves no half-written step that
    ``latest_step`` would read; the newest ``MAX_TO_KEEP`` steps are kept.
    The config is stamped with the gamma endpoints' storage scale
    (``nn.gamma.ENDPOINT_SCALE``), which ``restore_checkpoint`` reads.
    """
    os.makedirs(directory, exist_ok=True)
    for name in os.listdir(directory):
        if name.startswith(_TMP_PREFIX):   # a save that was killed
            shutil.rmtree(os.path.join(directory, name))
    flat = _flatten_state(state.params, "params", {})
    _flatten_state(state.opt_state, "opt_state", flat)
    flat["step"] = torch.tensor(int(state.step), dtype=torch.int64)
    meta = cfg.to_dict()
    meta["gamma_endpoint_scale"] = float(ENDPOINT_SCALE)
    tmp = os.path.join(directory, f"{_TMP_PREFIX}{step}-{os.getpid()}")
    os.makedirs(tmp)
    torch.save(flat, os.path.join(tmp, _STATE_FILE))
    with open(os.path.join(tmp, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    final = os.path.join(directory, str(step))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for old in _committed_steps(directory)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(directory, str(old)))


def latest_step(directory: str) -> Optional[int]:
    """The newest committed step in ``directory``, or None."""
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, trainer, step: Optional[int] = None):
    """``(state, cfg)`` of ``directory/<step>/`` (default the newest).

    The state is rebuilt onto the structure of a fresh state of
    ``trainer`` (``init_state(seed, skip_gamma_fit=True)``): its parameters
    are the trainer's new modules' own, holding the saved values, and every
    optimizer-state leaf and the step count are the saved ones, on the
    trainer's device. A checkpoint whose leaves, shapes or dtypes differ
    from the trainer's raises; none is skipped. Gamma endpoints saved under
    another storage scale are converted (``_rescale_gamma_endpoints``).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, str(step))
    flat = torch.load(os.path.join(path, _STATE_FILE), weights_only=True,
                      map_location=trainer.device)
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    template = trainer.init_state(trainer.cfg.seed, skip_gamma_fit=True)
    used: set = set()
    params = _rebuild(template.params, flat, "params", used)
    opt_state = _rebuild(template.opt_state, flat, "opt_state", used)
    unread = set(flat) - used - {"step"}
    if unread:
        raise KeyError(f"the checkpoint holds leaves the run has not: "
                       f"{sorted(unread)[:5]}")
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(params[k])
    state = dataclasses.replace(template, opt_state=opt_state,
                                step=int(flat["step"].item()))
    return _rescale_gamma_endpoints(state, meta), from_dict(meta)


def _rescale_gamma_endpoints(state, saved_config: dict):
    """Convert gamma endpoints stored under another scale to the current
    one, as the JAX package's ``train/checkpoint.py``: a checkpoint without
    a ``gamma_endpoint_scale`` stamp holds raw endpoints (scale 1.0). With
    ``ratio = stored / current``, the endpoints and their copies in the
    optimizer state (schedule-free's ``z``, the EMA) scale by ``ratio``,
    Adam's ``mu`` by ``1 / ratio`` and ``nu`` by ``1 / ratio**2`` (they
    track gradients, which scale inversely); every other leaf, AMSGrad's
    ``nu_max`` among them as in JAX, is kept. The parameters are scaled in
    place."""
    stored = float(saved_config.get("gamma_endpoint_scale", 1.0))
    if stored == float(ENDPOINT_SCALE) or _ENDPOINTS[0] not in state.params:
        return state
    ratio = stored / float(ENDPOINT_SCALE)
    with torch.no_grad():
        for name in _ENDPOINTS:
            state.params[name].mul_(ratio)

    def fix(tree, keys):
        if isinstance(tree, dict):
            return {k: fix(v, keys + (k,)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            names = getattr(tree, "_fields", range(len(tree)))
            parts = [fix(v, keys + (n,)) for n, v in zip(names, tree)]
            return type(tree)(*parts) if hasattr(tree, "_fields") \
                else tuple(parts)
        if not keys or keys[-1] not in _ENDPOINTS:
            return tree
        if "z" in keys or "ema" in keys:   # parameter copies
            return tree * ratio
        if "mu" in keys:                   # first gradient moment
            return tree / ratio
        if "nu" in keys:                   # second gradient moment
            return tree / ratio ** 2
        return tree

    return dataclasses.replace(state, opt_state=fix(state.opt_state, ()))


def load_params_npz(path: str, dtype="float32") -> dict:
    """Load a snapshot's parameter arrays back into a nested dict."""
    with np.load(path) as z:
        flat = {k: z[k].astype(dtype) for k in z.files if k != _CONFIG_KEY}
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_config_npz(path: str) -> Optional[Config]:
    """The Config embedded in a snapshot, or None if it has none.

    A config stored as a pickled object array fails to load here (numpy
    refuses it without ``allow_pickle``), and so does malformed JSON: both
    raise instead of being read some other way.
    """
    with np.load(path) as z:
        if _CONFIG_KEY not in z.files:
            return None
        return from_dict(json.loads(str(z[_CONFIG_KEY][()])))


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


# Modules held as ``nn.Linear`` (weight ``[out, in]``): their flax kernels
# are transposed. Every other kernel keeps the flax ``[in, out]`` layout,
# which is the layout the EGCL edge kernels and the virtual-node channel
# (``vnode_in``, ``vnode_pool``, ``vnode_out``, ``vnode_x``,
# ``vnode_x_head``) read. The match is by prefix of the module's own name.
_LINEAR_MODULES = ("mlp_h_dense0", "mlp_h_dense1", "dense")


def _is_linear(module_path: str) -> bool:
    leaf = module_path.rsplit("/", 1)[-1]
    return leaf.startswith(_LINEAR_MODULES)


def state_dict_from_flax(tree: dict) -> dict:
    """Map a flax parameter tree onto ``DiffusionDenoiser``'s state dict.

    ``tree`` is the nested dict of ``load_params_npz`` (with or without the
    top-level ``denoiser`` key). Names carry over with ``/`` read as ``.``;
    ``kernel`` becomes ``weight`` (transposed) on the ``nn.Linear`` modules
    of the spectrum compressor and the node MLP; the virtual-node channel's
    kernels stay ``[in, out]``, and so do the radial-basis kernels
    (``rbf_m``, ``rbf_x``); a top-level leaf (``radius_feature_gate``)
    keeps its name. The values are float32
    tensors; the denoiser casts to ``cfg.compute_dtype`` where it computes.
    ``DiffusionDenoiser.load_state_dict`` (strict) rejects a tree whose
    names or shapes do not fit the config.
    """
    params = tree.get("denoiser", tree)["params"]
    out = {}
    for key, value in _flatten(params).items():
        t = torch.from_numpy(np.array(value, np.float32))
        if key.endswith("/kernel") and _is_linear(key.rsplit("/", 1)[0]):
            t = t.T
        out[port_name(key)] = t.contiguous()
    return out


def port_name(path: str) -> str:
    """The ``DiffusionDenoiser`` state-dict name of a flax parameter path
    under ``params`` (``egnn/egcl_0/mlp_h_dense0/kernel`` ->
    ``egnn.egcl_0.mlp_h_dense0.weight``; the value is transposed where the
    leaf is an ``nn.Linear`` kernel; a top-level leaf such as
    ``radius_feature_gate`` keeps its name)."""
    if "/" not in path:
        return path
    module_path, leaf = path.rsplit("/", 1)
    if _is_linear(module_path) and leaf == "kernel":
        leaf = "weight"
    return f"{module_path.replace('/', '.')}.{leaf}"


def gamma_state_dict_from_flax(tree: dict) -> dict:
    """Map ``gamma/params/{l1,l2,l3}/weight`` and ``gamma/params/gamma_{0,1}``
    of a learned-schedule snapshot onto ``GammaNetwork``'s state dict.

    The weights are ``[out, in]`` in the snapshot already and stay so; the
    endpoints are the stored (pre-scaled) values: a snapshot carries no
    endpoint-scale stamp and, as the JAX package's ``load_params_npz``,
    none is applied.
    """
    return {key.replace("/", "."): torch.from_numpy(np.array(v, np.float32))
            for key, v in _flatten(tree["gamma"]["params"]).items()}


def flax_from_state_dict(state_dict: dict) -> dict:
    """The flax parameter tree ``{"params": ...}`` of a ``DiffusionDenoiser``
    state dict (or a dict of its named parameters): the inverse of
    ``state_dict_from_flax``, as float32 numpy arrays."""
    tree: dict = {}
    for key, value in state_dict.items():
        *modules, leaf = key.split(".")
        v = value.detach().to("cpu", torch.float32).numpy()
        if (modules and leaf == "weight"
                and _is_linear("/".join(modules))):
            leaf, v = "kernel", v.T
        node = tree
        for p in modules:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(v)
    return {"params": tree}


def gamma_flax_from_state_dict(state_dict: dict) -> dict:
    """The flax tree ``{"params": ...}`` of a ``GammaNetwork`` state dict:
    the inverse of ``gamma_state_dict_from_flax``."""
    tree: dict = {}
    for key, value in state_dict.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value.detach().to("cpu", torch.float32).numpy()
    return {"params": tree}


def save_params_npz(params: dict, path: str, dtype="float16",
                    cfg: Optional[Config] = None) -> int:
    """Save a nested parameter tree (``{"denoiser": {"params": ...}}`` and,
    for a learned schedule, ``"gamma"``) as a compressed flat ``.npz``, as
    the JAX package's ``save_params_npz``: ``dtype`` is the storage dtype,
    and ``cfg`` is embedded as JSON (a unicode scalar, loadable without
    pickle). Returns the number of parameter arrays."""
    flat = {k: np.asarray(v).astype(dtype) for k, v in _flatten(params).items()}
    n = len(flat)
    if cfg is not None:
        flat[_CONFIG_KEY] = np.array(json.dumps(cfg.to_dict()))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flat)
    return n
