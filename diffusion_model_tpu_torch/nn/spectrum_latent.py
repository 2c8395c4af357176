"""Spectrum -> latent conditioning path, as
``diffusion_model_tpu/nn/spectrum_latent.py``: a plain ReLU MLP autoencoder
whose encoder replaces each graph's spectrum with its latent on node 0 and
zeros elsewhere (``encode_dataset``). A model trained on such graphs has
``spectrum_to_latent=True`` and ``to_compress_spectrum=False``: its node
features carry ``latent_dim`` spectrum columns (``Config.cond_spectrum_size``).

The layers are ``nn.Linear`` named as the flax modules (``enc0``, ``enc1``,
``enc_out``; ``dec0``, ``dec1``, ``dec_out``) and drawn as flax draws a
``Dense`` (``lecun_normal`` kernel, zero bias); ``load_flax`` holds a flax
tree ``{"params": {"enc0": {"kernel" [in, out], "bias"}, ...}}``.

    encoder, decoder, mse = pretrain_autoencoder(spectra, latent_dim=32)
    graphs = encode_dataset(graphs, encoder)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from diffusion_model_tpu_torch.nn.egnn import flax_dense
from diffusion_model_tpu_torch.train import optim


class _ReluMLP(nn.Module):
    """``Dense -> ReLU`` per hidden width, then a linear output layer, the
    layers named ``{prefix}{i}`` and ``{prefix}_out``."""

    def __init__(self, prefix: str, in_features: int,
                 hidden_dims: Sequence[int], out_features: int, device=None):
        super().__init__()
        self.names = [f"{prefix}{i}" for i in range(len(hidden_dims))]
        width = in_features
        for name, f in zip(self.names, hidden_dims):
            setattr(self, name, flax_dense(width, f, device))
            width = f
        self.out_name = f"{prefix}_out"
        setattr(self, self.out_name, flax_dense(width, out_features, device))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            y = torch.relu(getattr(self, name)(y))
        return getattr(self, self.out_name)(y)

    def load_flax(self, variables: dict) -> "_ReluMLP":
        """Hold a flax tree ``{"params": {name: {"kernel", "bias"}}}``
        (kernels ``[in, out]``, transposed here); strict."""
        state = {}
        for name, leaves in variables["params"].items():
            state[f"{name}.weight"] = torch.as_tensor(
                np.array(leaves["kernel"], np.float32)).T.contiguous()
            state[f"{name}.bias"] = torch.as_tensor(
                np.array(leaves["bias"], np.float32))
        self.load_state_dict(state)
        return self


class SpectrumEncoder(_ReluMLP):
    """``[..., S] -> [..., latent_dim]``: ``enc0``, ``enc1`` (ReLU),
    ``enc_out``."""

    def __init__(self, spectrum_dim: int, latent_dim: int = 32,
                 hidden_dims: Sequence[int] = (128, 64), device=None):
        super().__init__("enc", spectrum_dim, hidden_dims, latent_dim, device)


class SpectrumDecoder(_ReluMLP):
    """``[..., latent_dim] -> [..., S]``: ``dec0``, ``dec1`` (ReLU),
    ``dec_out``."""

    def __init__(self, latent_dim: int, spectrum_dim: int = 200,
                 hidden_dims: Sequence[int] = (64, 128), device=None):
        super().__init__("dec", latent_dim, hidden_dims, spectrum_dim, device)


def pretrain_autoencoder(spectra: np.ndarray, latent_dim: int = 32,
                         steps: int = 500, lr: float = 1e-3, seed: int = 0,
                         device=None, init: Optional[tuple] = None):
    """Train encoder and decoder on a ``[num, S]`` spectrum matrix: ``steps``
    full-batch Adam steps (optax's ``adam(lr)``) on the reconstruction MSE,
    as the JAX package does.

    The layers are drawn from ``seed`` (or hold ``init``, a pair of flax
    trees ``(encoder, decoder)``, as the JAX package's ``init`` returns
    them). Runs on the card unless ``device`` names the CPU.

    Returns ``(encoder, decoder, final_mse)``: the MSE is the one of the
    last step, at the parameters before its update (the loss
    ``value_and_grad`` reports)."""
    device = torch.device("cuda" if device is None else device)
    x = torch.as_tensor(np.asarray(spectra, np.float32), device=device)
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        enc = SpectrumEncoder(x.shape[-1], latent_dim, device=device)
        dec = SpectrumDecoder(latent_dim, x.shape[-1], device=device)
    if init is not None:
        enc.load_flax(init[0])
        dec.load_flax(init[1])
    params = {**{f"enc.{k}": p for k, p in enc.named_parameters()},
              **{f"dec.{k}": p for k, p in dec.named_parameters()}}
    opt = optim.chain(optim.scale_by_adam(), optim.scale(-lr))
    state = opt.init(params)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss = torch.mean((dec(enc(x)) - x) ** 2)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        updates, state = opt.update(grads, state, params)
        optim.apply_updates(params, updates)
    return enc, dec, float(loss.detach())


def encode_dataset(graphs: list, encoder: SpectrumEncoder) -> list:
    """Each graph with its spectrum replaced by its latent: the encoding of
    node 0's spectrum on node 0, zeros on the other nodes (ref
    main.py:155-166). The encoder runs where its parameters are, on every
    graph's node-0 spectrum at once."""
    if not graphs:
        return []
    device = next(encoder.parameters()).device
    first = np.stack([np.asarray(g["spectrum"], np.float32)[0]
                      for g in graphs])
    with torch.no_grad():
        latents = encoder(torch.as_tensor(first, device=device)).cpu().numpy()
    out = []
    for g, latent in zip(graphs, latents):
        g = dict(g)
        new = np.zeros((np.asarray(g["spectrum"]).shape[0], latent.shape[0]),
                       np.float32)
        new[0] = latent
        g["spectrum"] = new
        out.append(g)
    return out
