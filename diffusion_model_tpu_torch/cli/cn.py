"""Atom-count predictor CLI, as ``diffusion_model_tpu/cli/cn.py`` (the
reference's ``CN.py``).

Trains ``nn.cn_mlp.CNPredictor`` (spectrum -> number of atoms in the local
environment) full-batch on the train split with Adam (``train.optim``:
``scale_by_adam`` then ``scale(-lr)``, optax's ``adam``), printing the
train MSE every 50 epochs, then the test split's MAE, the accuracy of the
rounded prediction and its macro-F1. Runs on ``--device``.

    python -m diffusion_model_tpu_torch.cli.cn --synthetic 256 --epochs 300
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.cli.common import add_device, device
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.io import load_dataset
from diffusion_model_tpu_torch.data.split import split_dataset
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.nn.cn_mlp import CNPredictor
from diffusion_model_tpu_torch.train import optim

LOG_EVERY = 50


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """Macro-averaged F1 over the integer classes present in ``y_true``."""
    classes = sorted(set(y_true.tolist()))
    f1s = []
    for c in classes:
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1s.append(2 * prec * rec / (prec + rec) if prec + rec else 0.0)
    return float(np.mean(f1s))


def graphs_to_xy(graphs, dev):
    """(exO spectra ``[G, S]``, atom counts ``[G, 1]``), float32 on
    ``dev``."""
    x = np.stack([np.asarray(g["spectrum"][0], np.float32) for g in graphs])
    y = np.asarray([[float(np.asarray(g["pos"]).shape[0])] for g in graphs],
                   np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def fit(model: CNPredictor, x: torch.Tensor, y: torch.Tensor, epochs: int,
        lr: float, log=print) -> list:
    """Full-batch Adam on the mean squared error; the loss of every epoch
    (before its update)."""
    params = dict(model.named_parameters())
    opt = optim.chain(optim.scale_by_adam(), optim.scale(-lr))
    state = opt.init(params)
    losses = []
    for epoch in range(epochs):
        loss = torch.mean((model(x) - y) ** 2)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        updates, state = opt.update(grads, state, params)
        optim.apply_updates(params, updates)
        losses.append(float(loss.detach()))
        if epoch % LOG_EVERY == 0:
            log(f"epoch {epoch}  train_mse {losses[-1]:.5f}")
    return losses


def main(argv=None, params=None):
    """``params``: a flax parameter tree the predictor starts from (as
    ``CNPredictor.load_flax`` reads it) in place of its seeded draw."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset_path", type=str, default=None)
    p.add_argument("--synthetic", type=int, default=256)
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=2024)
    add_device(p)
    args = p.parse_args(argv)
    dev = device(args.device)

    cfg = Config()
    if args.dataset_path:
        graphs = api.prepare_dataset(load_dataset(args.dataset_path), cfg)
    else:
        graphs = synthetic_sio2_dataset(args.seed, args.synthetic, 16,
                                        spectrum_size=cfg.spectrum_size)
    train_g, _, test_g = split_dataset(graphs, args.seed)
    x_tr, y_tr = graphs_to_xy(train_g, dev)
    x_te, y_te = graphs_to_xy(test_g, dev)

    torch.manual_seed(args.seed)
    model = CNPredictor(device=dev)
    if params is not None:
        model.load_flax(params)
    fit(model, x_tr, y_tr, args.epochs, args.lr)

    with torch.no_grad():
        pred = model(x_te)[:, 0].cpu().numpy()
    truth = y_te[:, 0].cpu().numpy()
    mae = float(np.mean(np.abs(pred - truth)))
    acc = float(np.mean(np.round(pred) == truth))
    f1 = macro_f1(truth.astype(int), np.round(pred).astype(int))
    print(f"test MAE {mae:.4f}  rounded accuracy {acc:.4f}  "
          f"macro-F1 {f1:.4f} (n={len(truth)})")
    return {"mae": mae, "accuracy": acc, "macro_f1": f1}


if __name__ == "__main__":
    main()
