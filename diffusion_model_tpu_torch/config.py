"""Configuration of the PyTorch port, read from a snapshot's embedded JSON.

The fields and their defaults carry the names of ``diffusion_model_tpu.config``
so one JSON describes both packages. Every field of the JAX ``Config`` is
a field here, so a config round-trips. What the port does with each:

- it honours the fields conditional generation and training read (dense
  topology, or kNN lists with the virtual node and the residual node
  update; the radial-basis edge features ``edge_rbf`` / ``edge_rbf_rmax``
  and the global radius feature; ``compat_scalar_norm`` on the dense
  topology; the predefined or the learned noise schedule; the optimizers,
  the loss's levers and the Kabsch coordinate loss (``kabsch_loss``,
  ``kabsch_loss_steps``, ``kabsch_loss_weight``), the initialisers,
  ``remat_egcl``, ``checkpoint_every`` and ``debug_nans``; the
  spectrum-latent conditioning, ``spectrum_to_latent`` / ``latent_dim``;
  data-parallel training on a mesh, ``mesh_shape`` / ``mesh_axis_names``,
  which ``api.train`` reads; ``ring_sample``, sampling through the
  node-sharded ring, which ``api.generate_ring`` sets);
- ``Config`` raises ``NotImplementedError``, naming the field, for a value
  of ``_SUPPORTED`` the port has no code path for;
- the fields of ``JAX_ONLY`` no code of the port reads: the table says for
  each why any value is refused or cannot change a result.

``from_dict`` ignores keys that are no field (a run's extras).
``load_config`` reads a reference-style ``parameters.yaml`` or the same
keys as JSON. PyTorch does not depend on PyYAML, so yaml is imported only
to read a YAML file: the port imports on a machine that has only PyTorch
and numpy, and reads JSON there.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence

import torch

# (field, value the port supports): any other value raises.
_SUPPORTED = (
    ("x_size", 3),
    ("d_size", 1),
)

# The JAX Config's fields that no code of the port reads: "refused" ones
# are in _SUPPORTED (any value but the JAX default raises); an "inert" one
# is kept as given and cannot change a result, for the reason stated.
JAX_ONLY = {
    "x_size": ("refused", "positions are 3-D throughout the port"),
    "d_size": ("refused", "the edge MLPs take one squared-distance feature"),
    "use_pallas": ("inert", "in the JAX package it picks the implementation "
                   "of the edge function (Pallas or XLA), not the function; "
                   "the port picks its own by widths (nn.egnn.edge_route: "
                   "K1/K2 on the card wherever they fit, each held to the "
                   "plain statement it computes), for either value"),
}


@dataclasses.dataclass(frozen=True)
class Config:
    # EGNN architecture
    L: int = 5
    x_size: int = 3
    d_size: int = 1
    m_size: int = 256
    m_hidden_size: int = 1024
    h_hidden_size: int = 1024
    x_hidden_size: int = 1024

    # feature layout
    atom_type_size: int = 2
    spectrum_size: int = 200
    compressed_spectrum_size: int = 32
    compressor_hidden_dim: Sequence[int] = (150, 100, 50)
    to_compress_spectrum: bool = True
    conditional: bool = True
    give_exO: bool = True
    exO_size: int = 1
    t_size: int = 1
    onehot_scaling_factor: float = 1.0

    # diffusion process
    num_diffusion_timestep: int = 1000
    noise_schedule: str = "predefined"   # or "learned": params["gamma"]
    noise_precision: float = 1e-5
    noise_schedule_power: float = 2.0
    x_parameterization: str = "eps"   # the coordinate head: or "x0", "v"
    diffuse_species: bool = True
    seed: int = 2024
    # the learned schedule's start ("reference": VDM endpoints; "polynomial":
    # fitted to the polynomial table) and its VDM boundary terms
    gamma_init: str = "reference"
    gamma_boundary_weight: float = 1.0
    gamma_rec_floor: float = 0.01

    # training
    batch_size: int = 1
    lr: float = 1e-5
    weight_decay: float = 1e-12
    max_grad_norm: float = 100.0
    optimizer: str = "RAdamScheduleFree"   # or "Adam", "AdamW"
    ema_decay: float = 0.0
    num_epochs: int = 3000
    patience: int = 5000
    checkpoint_every: int = 0   # epochs between checkpoints; 0: at the end
    debug_nans: bool = False    # anomaly mode, raise on a non-finite step
    cond_dropout_prob: float = 0.0
    t_bias_frac: float = 0.0
    t_bias_lo: int = 100
    t_bias_hi: int = 600
    t_loss_weight: float = 1.0
    zero_init_x: bool = True
    h_init_scale: float = 1.0
    # the Kabsch coordinate loss; remat_egcl: each EGCL's forward
    # recomputed in the backward; mesh_shape (with mesh_axis_names):
    # api.train is data-parallel over a mesh of that shape (parallel.mesh)
    kabsch_loss: bool = False
    kabsch_loss_steps: int = 0
    kabsch_loss_weight: float = 1.0
    remat_egcl: bool = False
    mesh_shape: Sequence[int] = ()
    mesh_axis_names: Sequence[str] = ("data",)

    # sampling
    guidance_scale: float = 0.0
    sample_noise_scale: float = 1.0
    deterministic_sampling: bool = False
    sample_steps: int = 0
    sample_grid: str = "uniform"
    gen_num_per_spectrum: int = 5
    max_nan_retries: int = 10
    snapshot_every: int = 100   # reverse steps between trajectory frames

    # topology and numerics: neighbor_k > 0 samples over kNN lists
    n_max: int = 16
    neighbor_k: int = 0
    compute_dtype: str = "float32"
    use_pallas: bool = False

    # large-cell variants: the virtual-node channel and h + mlp_h(...)
    virtual_node: bool = False
    h_residual: bool = False
    # edge_rbf Gaussians of the edge distance (centres linspace(0,
    # edge_rbf_rmax, edge_rbf)) added to both edge-MLP pre-activations;
    # 0 is off, 1 refused (the width rmax / (K - 1) is undefined)
    edge_rbf: int = 0
    edge_rbf_rmax: float = 8.0
    # log1p of each node's distance to the masked CoM, gated, as one more
    # node feature after exO
    global_radius_feature: bool = False

    # the coordinate update divided by one Frobenius norm of the pair grid
    # per graph (dense topology only); ring_sample: the sampler's denoiser
    # runs through the ring (api.generate_ring; the dense topology only);
    # spectrum_to_latent: the graphs' spectra are latents of latent_dim on
    # node 0 (nn.spectrum_latent.encode_dataset)
    compat_scalar_norm: bool = False
    ring_sample: bool = False
    spectrum_to_latent: bool = False
    latent_dim: int = 32

    def __post_init__(self):
        for name, supported in _SUPPORTED:
            if getattr(self, name) != supported:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} has no code path in "
                    f"the port (it runs {name}={supported!r})")
        if self.edge_rbf == 1 or self.edge_rbf < 0:
            raise ValueError(
                f"edge_rbf={self.edge_rbf}: need >= 2 Gaussian centres "
                "(width = rmax / (num - 1)); use 0 to disable")
        if self.edge_rbf and not self.edge_rbf_rmax > 0:
            raise ValueError(
                f"edge_rbf_rmax={self.edge_rbf_rmax} must be > 0")
        if self.x_parameterization not in ("eps", "x0", "v"):
            raise ValueError(
                f"x_parameterization={self.x_parameterization!r} "
                "must be 'eps', 'x0' or 'v'")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r} must be 'float32' "
                "or 'bfloat16'")
        if self.noise_schedule not in ("predefined", "learned"):
            raise ValueError(
                f"noise_schedule={self.noise_schedule!r} must be "
                "'predefined' or 'learned'")
        if self.gamma_init not in ("reference", "polynomial"):
            raise ValueError(
                f"gamma_init={self.gamma_init!r} must be 'reference' or "
                "'polynomial'")
        if self.sample_grid not in ("uniform", "snr"):
            raise ValueError(
                f"sample_grid={self.sample_grid!r} must be 'uniform' or 'snr'")

    @property
    def cond_spectrum_size(self) -> int:
        """Width of the spectrum columns of the node features: the
        compressor's output, the latent (``spectrum_to_latent``: the graphs
        carry ``nn.spectrum_latent.encode_dataset``'s latents), or the raw
        spectrum."""
        if not self.conditional:
            return 0
        if self.spectrum_to_latent:
            if self.to_compress_spectrum:
                raise ValueError(
                    "spectrum_to_latent and to_compress_spectrum exclude "
                    "each other: the latent replaces the compressed "
                    "spectrum")
            return self.latent_dim
        return (self.compressed_spectrum_size if self.to_compress_spectrum
                else self.spectrum_size)

    @property
    def spectrum_input_size(self) -> int:
        """Width of the spectrum a denoiser call takes: the latent for
        ``spectrum_to_latent``, else ``spectrum_size``."""
        return self.latent_dim if self.spectrum_to_latent \
            else self.spectrum_size

    @property
    def h_size(self) -> int:
        """Node feature width ``[species | spectrum | exO | radius | t]``."""
        size = self.atom_type_size + self.cond_spectrum_size + self.t_size
        if self.give_exO:
            size += self.exO_size
        if self.global_radius_feature:
            size += 1
        return size

    @property
    def m_input_size(self) -> int:
        """Width of the edge (message) MLP's input: both ends' features and
        the distance feature."""
        return 2 * self.h_size + self.d_size

    @property
    def m_output_size(self) -> int:
        return self.m_size

    @property
    def h_input_size(self) -> int:
        """Width of the node MLP's input: the features and the summed
        messages."""
        return self.h_size + self.m_size

    @property
    def h_output_size(self) -> int:
        return self.h_size

    @property
    def x_input_size(self) -> int:
        """Width of the coordinate MLP's input, that of the edge MLP."""
        return 2 * self.h_size + self.d_size

    @property
    def x_output_size(self) -> int:
        return 1

    @property
    def torch_dtype(self) -> torch.dtype:
        """The MLP matmul dtype (geometry and reductions stay float32)."""
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)

    def replace(self, **kwargs: Any) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_FIELD_NAMES = {f.name for f in dataclasses.fields(Config)}


def from_dict(d: dict) -> Config:
    """Build a Config from a dict, ignoring keys that are no field."""
    known = {k: v for k, v in d.items() if k in _FIELD_NAMES}
    for key in ("compressor_hidden_dim", "mesh_shape", "mesh_axis_names"):
        if isinstance(known.get(key), list):
            known[key] = tuple(known[key])
    return Config(**known)


def load_config(path: str) -> Config:
    """A Config from a reference-style ``parameters.yaml`` (or ``.yml``),
    as ``diffusion_model_tpu.config.load_config`` reads it, or from a JSON
    file of the same keys; keys that are no field are ignored. A YAML file
    needs PyYAML, and without it raises ``ImportError`` saying so."""
    path = str(path)
    with open(path) as f:
        if path.endswith(".json"):
            return from_dict(json.load(f))
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs PyYAML, which is not installed; "
                "give the same keys as a .json file") from e
        return from_dict(yaml.safe_load(f))
