"""Pickle-free ``.npz`` parameter snapshots, and the flax-to-torch name map.

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

import json
import os
from typing import Optional

import numpy as np
import torch

from diffusion_model_tpu_torch.config import Config, from_dict

_CONFIG_KEY = "__config_json__"


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
    kernels stay ``[in, out]``. The values are float32
    tensors; the denoiser casts to ``cfg.compute_dtype`` where it computes.
    ``DiffusionDenoiser.load_state_dict`` (strict) rejects a tree whose
    names or shapes do not fit the config.
    """
    params = tree.get("denoiser", tree)["params"]
    out = {}
    for key, value in _flatten(params).items():
        t = torch.from_numpy(np.array(value, np.float32))
        if _is_linear(key.rsplit("/", 1)[0]) and key.endswith("/kernel"):
            t = t.T
        out[port_name(key)] = t.contiguous()
    return out


def port_name(path: str) -> str:
    """The ``DiffusionDenoiser`` state-dict name of a flax parameter path
    under ``params`` (``egnn/egcl_0/mlp_h_dense0/kernel`` ->
    ``egnn.egcl_0.mlp_h_dense0.weight``; the value is transposed where the
    leaf is an ``nn.Linear`` kernel)."""
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
        module_path, leaf = key.rsplit(".", 1)
        v = value.detach().to("cpu", torch.float32).numpy()
        if _is_linear(module_path.replace(".", "/")) and leaf == "weight":
            leaf, v = "kernel", v.T
        node = tree
        for p in module_path.split("."):
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
