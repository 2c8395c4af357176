"""Configuration of the PyTorch port, read from a snapshot's embedded JSON.

The fields and their defaults carry the names of ``diffusion_model_tpu.config``
so one JSON describes both packages. The fields here are those conditional
generation and training read (dense topology, or kNN lists with the virtual
node and the residual node update; the predefined or the learned noise
schedule; the optimizers, the loss's levers and the initialisers);
``from_dict`` ignores the rest (mesh settings, orbax checkpoints, the
distillation knobs) and raises ``NotImplementedError`` for settings whose
code path the port does not have yet. ``train.Trainer`` refuses the
training settings it has no path for (``kabsch_loss``, ``remat_egcl``, a
mesh). No yaml: PyTorch does not depend on PyYAML, so a module-level
``import yaml`` would stop the port from importing on a machine that has
only PyTorch and numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

# (field, value the port supports): any other value raises.
_SUPPORTED = (
    ("edge_rbf", 0),
    ("global_radius_feature", False),
    ("compat_scalar_norm", False),
    ("ring_sample", False),
    ("x_parameterization", "eps"),
    ("spectrum_to_latent", False),
)


@dataclasses.dataclass(frozen=True)
class Config:
    # EGNN architecture
    L: int = 5
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
    x_parameterization: str = "eps"
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
    cond_dropout_prob: float = 0.0
    t_bias_frac: float = 0.0
    t_bias_lo: int = 100
    t_bias_hi: int = 600
    t_loss_weight: float = 1.0
    zero_init_x: bool = True
    h_init_scale: float = 1.0
    # training paths the port does not have (train.Trainer refuses them)
    kabsch_loss: bool = False
    remat_egcl: bool = False
    mesh_shape: Sequence[int] = ()

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

    # large-cell variants: the virtual-node channel and h + mlp_h(...)
    virtual_node: bool = False
    h_residual: bool = False

    # variants the port rejects (see _SUPPORTED)
    edge_rbf: int = 0
    global_radius_feature: bool = False
    compat_scalar_norm: bool = False
    ring_sample: bool = False
    spectrum_to_latent: bool = False

    def __post_init__(self):
        for name, supported in _SUPPORTED:
            if getattr(self, name) != supported:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet "
                    f"(the port runs {name}={supported!r})")
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
        if not self.conditional:
            return 0
        return (self.compressed_spectrum_size if self.to_compress_spectrum
                else self.spectrum_size)

    @property
    def h_size(self) -> int:
        """Node feature width ``[species | spectrum | exO | t]``."""
        size = self.atom_type_size + self.cond_spectrum_size + self.t_size
        if self.give_exO:
            size += self.exO_size
        return size

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
    """Build a Config from a dict, ignoring keys the port does not read."""
    known = {k: v for k, v in d.items() if k in _FIELD_NAMES}
    for key in ("compressor_hidden_dim", "mesh_shape"):
        if isinstance(known.get(key), list):
            known[key] = tuple(known[key])
    return Config(**known)
