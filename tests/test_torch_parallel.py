"""The port's data parallelism (``parallel.mesh``, ``Trainer.train_step(...,
mesh=)``, ``api.train`` with ``mesh_shape``) on the CPU, in gloo worlds of 2
and 4 processes, against the port's one-process step and the JAX package on
its 8-device virtual mesh (``tests/conftest.py``).

One world a size is spawned for the module (``parallel.launch``); its ranks
run every case (``torch_parallel_cases.dp_cases``) and write what the tests
below read:

* ``shard_graph_batch``: a rank's block in modes ``dp`` and ``node`` is the
  JAX function's shard on the device of the same index; ``dp`` and
  ``dp_node`` on a 2 x 2 hybrid mesh too; ``dp_node`` on a flat mesh raises.
* A data-parallel step equals the one-process step on the same global batch
  and draws (loss rtol 1e-6, every leaf atol 1e-6, float32): a batch with a
  padding graph (a rank of the world of 4 holds no real graph), and the
  learned schedule with its boundary term and ``cond_dropout_prob`` 0.5.
* From the JAX package's parameters on its draws, the port's step in either
  world equals JAX's data-parallel step over its 8 devices at the tolerances
  ``test_torch_trainer.py`` holds one step to.
* ``api.train`` in the world of 2 for 5 epochs at ``examples/
  dp_equivalence.py``'s widths: the losses within 1e-6 relative of one
  process's (JAX's record is 1.9e-7, ``docs/perf/dp_equivalence.json``),
  the first rank alone writing; 3 epochs resumed to 5 equal the 5 bit for
  bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.parallel import make_hybrid_mesh as jax_hybrid
from diffusion_model_tpu.parallel import make_mesh as jax_mesh
from diffusion_model_tpu.parallel import replicate as jax_replicate
from diffusion_model_tpu.parallel import (
    shard_graph_batch as jax_shard_graph_batch,
)
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch import api, parallel
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer
from torch_parallel_cases import FIELDS, as_batch, dp_cases
from torch_port_fixtures import jax_loss_draws

torch.set_num_threads(2)

TINY = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=50, batch_size=4, lr=1e-3,
            optimizer="Adam")
STEPS = {"padding_graph": (dict(), 3),
         "learned_dropout": (dict(optimizer="RAdamScheduleFree",
                                  noise_schedule="learned",
                                  cond_dropout_prob=0.5), 4)}
# examples/dp_equivalence.py's run, cut to 5 epochs
EQUIV = dict(n_max=16, L=2, m_hidden_size=32, h_hidden_size=32,
             x_hidden_size=32, m_size=16, spectrum_size=32,
             compressed_spectrum_size=8, compressor_hidden_dim=(16,),
             num_diffusion_timestep=50, batch_size=8, lr=1e-3,
             optimizer="RAdamScheduleFree", noise_precision=0.05,
             seed=2024)
EPOCHS = 5


def tiny_batch(b: int, n_max: int = 8, padding: int = 0):
    data = synthetic_sio2_dataset(0, b, n_max, spectrum_size=32)
    jb = next(jax_split.batch_iterator(data, b, n_max, seed=1))
    arrays = {k: np.array(getattr(jb, k), np.float32) for k in FIELDS}
    if padding:
        arrays["mask"][-padding:] = 0.0
    return jb, arrays


def jax_dp_step():
    """(config, flax params, batch arrays, draws, loss, new params) of the
    JAX package's step with the batch split over its 8 devices."""
    jcfg = JaxConfig(**{**TINY, "batch_size": 8})
    jb, arrays = tiny_batch(8)
    trainer = JaxTrainer(jcfg)
    state = trainer.init_state(jax.random.key(0), jb, skip_gamma_fit=True)
    mesh = jax_mesh()
    key = jax.random.key(5)
    new, m = trainer.train_step(jax.device_put(state, jax_replicate(mesh)),
                                key, jax_shard_graph_batch(jb, mesh, "dp"))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), state.params)
    return (Config(**{**TINY, "batch_size": 8}), tree, arrays,
            jax_loss_draws(key, jcfg, 8, jcfg.n_max), float(m["loss"]),
            jax.tree.map(np.asarray, new.params))


@pytest.fixture(scope="module")
def jax_side():
    return jax_dp_step()


_WORLDS = {}


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory, jax_side):
    return spawned(request.param, tmp_path_factory, jax_side)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_side):
    return spawned(2, tmp_path_factory, jax_side)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_side):
    return spawned(4, tmp_path_factory, jax_side)


def spawned(size, tmp_path_factory, jax_side):
    """(size, out_dir) of the module's world of ``size``, spawned once."""
    if size not in _WORLDS:
        _WORLDS[size] = spawn(size, tmp_path_factory, jax_side)
    return _WORLDS[size]


def spawn(size, tmp_path_factory, jax_side):
    out = tmp_path_factory.mktemp(f"dp{size}")
    steps = [(name, Config(**{**TINY, **kw}),
              tiny_batch(4, padding=1)[1], seed)
             for name, (kw, seed) in STEPS.items()]
    spec = {"shard_batch": tiny_batch(8)[1], "steps": steps,
            "jax_step": jax_side[:4]}
    if size == 2:
        data = synthetic_sio2_dataset(7, 64, 16, spectrum_size=32)
        spec["train"] = (Config(**EQUIV), data,
                         [str(out / "dp"), str(out / "dp_resumed")], EPOCHS)
    try:
        parallel.launch(dp_cases, size, args=(str(out), spec))
    except Exception:
        for err in sorted(out.glob("error_r*.txt")):
            print(err.read_text())
        raise
    return size, out


def load(out, name) -> dict:
    with np.load(out / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def jax_shards(batch, mesh, mode) -> dict:
    """Device id -> field -> the JAX shard there."""
    placed = jax_shard_graph_batch(batch, mesh, mode)
    out = {}
    for k in FIELDS:
        for s in getattr(placed, k).addressable_shards:
            out.setdefault(s.device.id, {})[k] = np.asarray(s.data)
    return out


@pytest.mark.parametrize("mode", ["dp", "node"])
def test_shard_graph_batch_is_the_jax_shard(world, mode):
    size, out = world
    jb, _ = tiny_batch(8)
    want = jax_shards(jb, jax_mesh((size,)), mode)
    for rank in range(size):
        got = load(out, f"shard_{mode}_r{rank}")
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[rank][k], err_msg=k)


@pytest.mark.parametrize("mode", ["dp", "dp_node"])
def test_hybrid_mesh_shards_are_the_jax_shards(world4, mode):
    _, out = world4
    jb, _ = tiny_batch(8)
    want = jax_shards(jb, jax_hybrid(2, 2, devices=jax.devices()[:4]), mode)
    for rank in range(4):
        got = load(out, f"shard_hybrid_{mode}_r{rank}")
        for k in FIELDS:
            np.testing.assert_array_equal(got[k], want[rank][k], err_msg=k)


def test_dp_node_on_a_flat_mesh_raises(world):
    _, out = world
    msg = json.loads((out / "messages.json").read_text())["flat_dp_node"]
    assert msg.startswith("ValueError") and "make_hybrid_mesh" in msg
    with pytest.raises(ValueError, match="make_hybrid_mesh"):
        jax_shard_graph_batch(tiny_batch(8)[0], jax_mesh(), "dp_node")


@pytest.mark.parametrize("name", sorted(STEPS))
def test_dp_step_equals_the_one_process_step(world, name):
    _, out = world
    kw, seed = STEPS[name]
    cfg = Config(**{**TINY, **kw})
    trainer = Trainer(cfg, device="cpu")
    state, m = trainer.train_step(trainer.init_state(0),
                                  TrainNoise(seed, "cpu"),
                                  as_batch(tiny_batch(4, padding=1)[1]))
    got = load(out, f"step_{name}")
    np.testing.assert_allclose(got["loss"], m["loss"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(got["sum_sq"], m["sum_sq"].numpy(),
                               rtol=1e-6)
    for k, p in state.params.items():
        np.testing.assert_allclose(got[k], p.detach().numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)


def test_dp_step_equals_the_jax_dp_step(world, jax_side):
    from test_torch_trainer import assert_leaves_close, port_names

    _, out = world
    got = load(out, "jax_step")
    loss, new = jax_side[4:]
    np.testing.assert_allclose(got["loss"], loss, rtol=5e-3)
    assert_leaves_close({k: torch.from_numpy(v) for k, v in got.items()
                         if k != "loss"}, port_names(new), 5e-3)


def trajectory(run_dir) -> np.ndarray:
    lines = [json.loads(x) for x in open(run_dir / "metrics.jsonl")]
    return np.asarray([(r["train_loss"], r["eval_loss"]) for r in lines
                       if "train_loss" in r])


def test_api_train_matches_one_process(world2, tmp_path):
    _, out = world2
    data = synthetic_sio2_dataset(7, 64, 16, spectrum_size=32)
    _, state, _ = api.train(Config(**EQUIV), data, str(tmp_path),
                            num_epochs=EPOCHS, device="cpu")
    want = trajectory(tmp_path)
    got = trajectory(out / "dp")
    assert got.shape == want.shape == (EPOCHS, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the first rank alone wrote, every file the one-process run writes
    assert sorted(p.name for p in (out / "dp").iterdir()) == sorted(
        p.name for p in tmp_path.iterdir())
    resumed = trajectory(out / "dp_resumed")
    np.testing.assert_array_equal(resumed, trajectory(out / "dp"))
    final = load(out, "train_r1")
    for k, p in state.params.items():
        np.testing.assert_allclose(final[k], p.detach().numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    # every rank holds the same parameters
    first = load(out, "train_r0")
    for k in first:
        np.testing.assert_array_equal(first[k], final[k], err_msg=k)


def test_mesh_shape_needs_a_process_group(tmp_path):
    cfg = Config(**{**TINY, "mesh_shape": (2,)})
    Trainer(cfg, device="cpu")   # the trainer takes the setting
    with pytest.raises(RuntimeError, match="parallel.launch"):
        api.train(cfg, synthetic_sio2_dataset(0, 8, 8, spectrum_size=32),
                  str(tmp_path), num_epochs=1, device="cpu")
    with pytest.raises(RuntimeError, match="parallel.launch"):
        parallel.make_mesh()


def test_batch_rows_draw_the_global_batch():
    from diffusion_model_tpu_torch.train.loss import BatchRows

    full = TrainNoise(3, "cpu")
    part = BatchRows(TrainNoise(3, "cpu"), slice(2, 4), 6)
    torch.testing.assert_close(part.normal("pos", (2, 5, 3)),
                               full.normal("pos", (6, 5, 3))[2:4],
                               rtol=0, atol=0)
    assert torch.equal(part.randint("t", 1, 50, (2,)),
                       full.randint("t", 1, 50, (6,))[2:4])
    with pytest.raises(ValueError, match="this rank"):
        part.normal("pos", (3, 5, 3))

