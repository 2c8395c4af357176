"""``config.load_config`` against the JAX package's on the repo's configs,
its JSON twin of ``configs/parameters.yaml``
(``tests/fixtures/torch_port/parameters.json``, for a machine without
PyYAML), and a machine without PyYAML."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from diffusion_model_tpu.config import load_config as jax_load_config
from diffusion_model_tpu_torch.config import Config, from_dict, load_config

REPO = Path(__file__).resolve().parents[1]
TWIN = REPO / "tests" / "fixtures" / "torch_port" / "parameters.json"


@pytest.mark.parametrize("name", ["parameters.yaml", "tiny.yaml"])
def test_yaml_configs_load_as_in_jax(name):
    path = REPO / "configs" / name
    got = load_config(str(path))
    assert isinstance(got, Config)
    assert got == from_dict(jax_load_config(str(path)).to_dict())
    assert got.to_dict() == jax_load_config(str(path)).to_dict()


def test_the_json_twin_is_parameters_yaml():
    got = load_config(str(TWIN))
    assert got == load_config(str(REPO / "configs" / "parameters.yaml"))
    assert got.to_dict() == jax_load_config(
        str(REPO / "configs" / "parameters.yaml")).to_dict()
    with open(TWIN) as f:
        assert set(json.load(f)) <= set(Config().to_dict())


def test_without_pyyaml_yaml_raises_naming_it_and_json_reads():
    code = "\n".join([
        "import sys",
        "sys.modules['yaml'] = None",
        "from diffusion_model_tpu_torch.config import load_config",
        f"cfg = load_config({str(TWIN)!r})",
        "assert cfg.L == 5 and cfg.m_hidden_size == 1024",
        "try:",
        f"    load_config({str(REPO / 'configs' / 'parameters.yaml')!r})",
        "except ImportError as e:",
        "    print(e)",
    ])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "PyYAML" in proc.stdout and ".json" in proc.stdout
