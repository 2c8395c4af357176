"""The port and ``chip_smoke.py`` import without JAX, flax, yaml, the JAX
package or the TPU probes under ``benchmarks/``: the machine with the card
has none of the first four, and the port keeps its own copy of the rest."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import torch

import diffusion_model_tpu_torch

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "yaml", "diffusion_model_tpu",
           "benchmarks")


def port_modules():
    pkg = diffusion_model_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]


def test_every_module_is_listed():
    names = port_modules()
    for expected in ("api", "config", "data.batch", "data.split",
                     "data.synthetic", "data.xyz", "diffusion.process",
                     "diffusion.sampler", "evals", "evals.cn2", "evals.rdf",
                     "evals.density", "evals.retrain_check", "evals.rmsd",
                     "evals.restore_check", "nn.cn_mlp", "nn.compressor",
                     "nn.denoiser", "nn.egnn", "nn.gamma", "ops.angles",
                     "ops.com", "ops.kabsch", "utils.logging",
                     "ops.edge_grad", "ops.edges", "ops.egcl_knn",
                     "ops.egcl_pair", "ops.rdf", "ops.schedules",
                     "ops._build", "probes._common",
                     "probes.kernel_stages", "probes.matmul_rate",
                     "probes.overlap", "probes.pipeline",
                     "train.checkpoint", "train.loss", "train.optim",
                     "train.trainer", "data.cell", "data.spectra",
                     "data.local_env", "data.native", "data.shells",
                     "data.polymorphs", "data.frames", "data.io",
                     "data.legacy", "data.qm9", "evals.fingerprint",
                     "evals.soap", "evals.baseline", "evals.template",
                     "evals.real_data_check", "utils.profiling",
                     "utils.figures", "cli", "cli.common", "cli.main",
                     "cli.make_dataset", "cli.create_xyz",
                     "cli.template_matching", "cli.evaluate_rdf",
                     "cli.evaluate_rmsd", "cli.evaluate_cn2",
                     "cli.evaluate_si_o_si", "cli.evaluate_fingerprint",
                     "cli.generate_amorphous", "cli.cn", "serve",
                     "cli.export", "train.distill", "nn.spectrum_latent",
                     "evals.distill_check", "parallel", "parallel.mesh",
                     "parallel.ring"):
        assert f"diffusion_model_tpu_torch.{expected}" in names


def test_imports_without_jax_flax_yaml_or_the_jax_package():
    code = "\n".join([
        "import importlib, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        f"for name in {port_modules()!r} + ['chip_smoke']:",
        "    importlib.import_module(name)",
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]",
        "assert not loaded, loaded",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_the_full_width_replayer_and_its_start_import_no_jax():
    """``tests/torch_replay_training_full.py`` runs on the card's machine:
    it, the numpy start, the sketch and the batches it rebuilds load nothing
    of JAX or the JAX package."""
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "sys.path.insert(0, 'tests')",
        "import numpy as np",
        "import torch_replay_training_full as full",
        "spec = [{'path': 'a/kernel', 'shape': [3, 4], 'std': 0.5,",
        "         'const': None}, {'path': 'a/bias', 'shape': [4], 'std': 0.0,",
        "         'const': 0.0}]",
        "tree = full.numpy_start(spec, 1)",
        "leaf = tree['denoiser']['params']['a']['kernel']",
        "assert leaf.shape == (3, 4) and leaf.dtype == np.float32",
        "assert not tree['denoiser']['params']['a']['bias'].any()",
        "origin = {'x': leaf.ravel()}",
        "s = full.Sketch(origin, k=8)",
        "out = s({'x': leaf.ravel() + 1})",
        "assert out['tree'].shape == (8,)",
        "cfg, cells = full.setup()",
        "assert len(cells) == 8 and cfg.neighbor_k == 32",
        "full.batch_indices(cfg, len(cells), 3)",
        "next(full.port_batches(cfg, cells))",
        "import torch_port_fixtures",
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]",
        "assert not loaded, loaded",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_serving_loads_no_model_code():
    """``serve`` and the two op modules, all a serving process imports,
    load none of the model modules, the JAX package or JAX."""
    model = tuple(f"diffusion_model_tpu_torch.{m}" for m in (
        "api", "config", "data", "diffusion", "nn", "train", "evals", "cli",
        "parallel"))
    code = "\n".join([
        "import sys",
        "import diffusion_model_tpu_torch.serve",
        "import diffusion_model_tpu_torch.ops.egcl_pair",
        "import diffusion_model_tpu_torch.ops.egcl_knn",
        f"refused = {model + BLOCKED!r}",
        "loaded = [m for m in sys.modules if any(",
        "    m == r or m.startswith(r + '.') for r in refused)]",
        "assert not loaded, loaded",
        "print('ok')",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
