"""The port's run records (``utils.logging``) against the JAX package's
``RunLogger``: the same calls leave the same files (``config.json``,
``metrics.jsonl`` apart from ``time``, ``notes.txt``, ``figures/``,
``artifacts.json``), and ``load_run_config`` reads a run of either."""

import json

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import pytest  # noqa: E402

from diffusion_model_tpu.config import Config as JaxConfig  # noqa: E402
from diffusion_model_tpu.utils import logging as jax_logging  # noqa: E402
from diffusion_model_tpu_torch.config import Config  # noqa: E402
from diffusion_model_tpu_torch.utils import logging  # noqa: E402

SETTINGS = dict(L=3, lr=2e-4, checkpoint_every=300, neighbor_k=15,
                compressor_hidden_dim=(16, 8))


def drive(logger):
    logger.log({"train_loss": 1.5, "eval_loss": 2.0}, step=0)
    logger.log({"num_accepted": 3})
    fig, ax = plt.subplots()
    ax.plot([0, 1], [1, 0])
    path = logger.log_figure("curve", fig)
    plt.close(fig)
    logger.register_artifact("checkpoints", "/runs/x/checkpoints")
    logger.register_artifact("xyz", "/runs/x")
    logger.finish()
    return path


@pytest.fixture
def runs(tmp_path):
    out = {}
    for name, module, cfg in (("port", logging, Config(**SETTINGS)),
                              ("jax", jax_logging, JaxConfig(**SETTINGS))):
        run_dir = tmp_path / name
        logger = module.RunLogger(str(run_dir), cfg, notes="a note")
        out[name] = (run_dir, logger, drive(logger))
    return out


def test_the_same_calls_leave_the_same_files(runs):
    (port, port_logger, port_fig), (jax, _, jax_fig) = runs["port"], \
        runs["jax"]
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in jax.iterdir())
    assert json.load(open(port / "config.json")) == \
        json.load(open(jax / "config.json"))
    lines = {}
    for name, run_dir in (("port", port), ("jax", jax)):
        lines[name] = [json.loads(x) for x in open(run_dir / "metrics.jsonl")]
        assert all("time" in r for r in lines[name])
    strip = [[{k: v for k, v in r.items() if k != "time"} for r in lines[n]]
             for n in ("port", "jax")]
    assert strip[0] == strip[1] == [
        {"train_loss": 1.5, "eval_loss": 2.0, "step": 0},
        {"num_accepted": 3}]
    assert (port / "notes.txt").read_text() == (jax / "notes.txt").read_text()
    assert json.load(open(port / "artifacts.json")) == \
        json.load(open(jax / "artifacts.json"))
    assert port_fig == str(port / "figures" / "curve.png")
    assert jax_fig == str(jax / "figures" / "curve.png")
    assert (port / "figures" / "curve.png").stat().st_size > 0
    assert port_logger.artifact("xyz") == "/runs/x"


def test_load_run_config_reads_a_run_of_either_package(runs):
    for name in ("port", "jax"):
        cfg = logging.load_run_config(str(runs[name][0]))
        assert cfg == Config(**SETTINGS)


def test_wandb_is_not_imported_unless_asked(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def guarded(name, *args, **kwargs):
        if name == "wandb":
            raise AssertionError("wandb imported")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", guarded)
    drive(logging.RunLogger(str(tmp_path), Config()))
