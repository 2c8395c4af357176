"""Checkpoints and resume of the port (``train.checkpoint``, ``api.train``
with ``resume`` / ``init_params_from``, ``api.load_trained``), on the CPU
at tiny widths.

A run stopped after an epoch and resumed from its checkpoint equals the
uninterrupted run bit for bit (parameters, every optimizer-state leaf and
the step count), for schedule-free RAdam, Adam with an EMA, and the learned
schedule's recipe (the gamma network in the state): an epoch's batch order
and noise streams depend on the epoch alone.
"""

import json

import pytest
import torch

from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.train import checkpoint
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer

torch.set_num_threads(4)

TINY = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=50, batch_size=4, lr=1e-3,
            checkpoint_every=1)
RECIPES = {
    "radam_schedule_free": dict(optimizer="RAdamScheduleFree"),
    "adam_ema": dict(optimizer="Adam", ema_decay=0.9),
    "learned": dict(optimizer="RAdamScheduleFree", noise_schedule="learned"),
    # the large-cell levers' new leaves (rbf_m, rbf_x, radius_feature_gate)
    "rbf_radius": dict(optimizer="RAdamScheduleFree", neighbor_k=3,
                       virtual_node=True, h_residual=True, edge_rbf=6,
                       edge_rbf_rmax=4.0, global_radius_feature=True),
}


def tiny(**kw) -> Config:
    return Config(**{**TINY, **kw})


@pytest.fixture(scope="module")
def data():
    return synthetic_sio2_dataset(0, 12, TINY["n_max"],
                                  spectrum_size=TINY["spectrum_size"])


def flat(state) -> dict:
    out = checkpoint._flatten_state(state.params, "params", {})
    checkpoint._flatten_state(state.opt_state, "opt_state", out)
    out["step"] = torch.tensor(state.step)
    return out


def assert_states_equal(got, want):
    a, b = flat(got), flat(want)
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def run(cfg, data, path, epochs, **kw):
    return api.train(cfg, data, str(path), num_epochs=epochs, device="cpu",
                     **kw)


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_resumed_run_equals_the_uninterrupted_run(recipe, data, tmp_path):
    cfg = tiny(**RECIPES[recipe])
    _, whole, _ = run(cfg, data, tmp_path / "whole", 3)
    run(cfg, data, tmp_path / "cut", 1)
    assert checkpoint.latest_step(str(tmp_path / "cut" / "checkpoints")) == 1
    _, resumed, _ = run(cfg, data, tmp_path / "cut", 3, resume=True)
    assert whole.step == resumed.step == 9
    assert_states_equal(resumed, whole)
    if recipe == "learned":
        assert "gamma.gamma_0" in whole.params
    if recipe == "rbf_radius":
        assert {"denoiser.radius_feature_gate",
                "denoiser.egnn.egcl_1.rbf_x.kernel"} <= set(whole.params)
    # the epochs of the two segments are logged once each
    lines = [json.loads(x) for x in open(tmp_path / "cut" / "metrics.jsonl")]
    assert [r["step"] for r in lines if "train_loss" in r] == [0, 1, 2]


def test_checkpoint_holds_the_config_and_the_scale_stamp(data, tmp_path):
    cfg = tiny(optimizer="RAdamScheduleFree")
    _, state, _ = run(cfg, data, tmp_path, 1)
    meta = json.load(open(tmp_path / "checkpoints" / "1" / "config.json"))
    assert meta["gamma_endpoint_scale"] == 25.0
    assert meta["checkpoint_every"] == 1
    trainer = Trainer(cfg, device="cpu")
    restored, saved_cfg = checkpoint.restore_checkpoint(
        str(tmp_path / "checkpoints"), trainer)
    assert saved_cfg == cfg
    assert_states_equal(restored, state)
    # the parameters are the trainer's own modules'
    assert restored.params["denoiser.egnn.egcl_0.mlp_m_dense1.kernel"] \
        is trainer.model.egnn.egcl_0.mlp_m_dense1.kernel


def test_only_the_newest_three_steps_are_kept(data, tmp_path):
    cfg = tiny(optimizer="Adam")
    run(cfg, data, tmp_path, 5)
    ckpt = tmp_path / "checkpoints"
    assert sorted(p.name for p in ckpt.iterdir()) == ["3", "4", "5"]
    assert checkpoint.latest_step(str(ckpt)) == 5


def test_checkpoint_every_saves_on_its_epochs_and_at_the_end(data, tmp_path):
    cfg = tiny(optimizer="Adam", checkpoint_every=2)
    saved = []
    real = checkpoint.save_checkpoint

    def record(directory, state, cfg, step):
        saved.append(step)
        real(directory, state, cfg, step)

    api_save = api.save_checkpoint
    try:
        api.save_checkpoint = record
        run(cfg, data, tmp_path, 5)
    finally:
        api.save_checkpoint = api_save
    assert saved == [2, 4, 5]


def test_latest_step_of_an_empty_or_missing_directory_is_none(tmp_path):
    assert checkpoint.latest_step(str(tmp_path)) is None
    assert checkpoint.latest_step(str(tmp_path / "nowhere")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_path),
                                      Trainer(tiny(), device="cpu"))


def test_a_save_killed_midway_is_not_read(data, tmp_path, monkeypatch):
    cfg = tiny(optimizer="Adam")
    _, state, _ = run(cfg, data, tmp_path, 1)
    ckpt = str(tmp_path / "checkpoints")

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 half a file")
        raise KeyboardInterrupt("killed")

    with monkeypatch.context() as m:
        m.setattr(torch, "save", killed)
        with pytest.raises(KeyboardInterrupt):
            checkpoint.save_checkpoint(ckpt, state, cfg, step=2)
    assert any(p.name.startswith(".tmp-")
               for p in (tmp_path / "checkpoints").iterdir())
    # a step directory without both files, as another writer could leave
    (tmp_path / "checkpoints" / "7").mkdir()
    (tmp_path / "checkpoints" / "7" / "state.pt").write_bytes(b"PK")
    assert checkpoint.latest_step(ckpt) == 1
    restored, _ = checkpoint.restore_checkpoint(
        ckpt, Trainer(cfg, device="cpu"))
    assert_states_equal(restored, state)
    # the next save clears what the killed one left
    checkpoint.save_checkpoint(ckpt, state, cfg, step=2)
    assert not any(p.name.startswith(".tmp-")
                   for p in (tmp_path / "checkpoints").iterdir())
    assert checkpoint.latest_step(ckpt) == 2


def test_a_checkpoint_of_another_model_raises(data, tmp_path):
    run(tiny(optimizer="Adam"), data, tmp_path, 1)
    ckpt = str(tmp_path / "checkpoints")
    with pytest.raises(ValueError, match="the run"):
        checkpoint.restore_checkpoint(
            ckpt, Trainer(tiny(optimizer="Adam", m_size=8), device="cpu"))
    with pytest.raises(KeyError):
        checkpoint.restore_checkpoint(
            ckpt, Trainer(tiny(optimizer="Adam", L=3), device="cpu"))
    with pytest.raises(KeyError):
        checkpoint.restore_checkpoint(
            ckpt, Trainer(tiny(optimizer="RAdamScheduleFree"),
                          device="cpu"))


def test_init_params_from_starts_at_the_sources_eval_parameters(data,
                                                                 tmp_path):
    cfg = tiny(optimizer="RAdamScheduleFree")
    _, source, _ = run(cfg, data, tmp_path / "source", 2)
    want = source.eval_params(cfg)
    trainer, state, _ = run(cfg, data, tmp_path / "init", 0,
                            init_params_from=str(tmp_path / "source"))
    assert state.step == 0
    for k, p in state.params.items():
        assert torch.equal(p.detach(), want[k]), k
    fresh = trainer.optimizer.init(state.params)
    assert_states_equal(state, type(state)(state.params, fresh, 0))
    lines = [json.loads(x) for x in open(tmp_path / "init" / "metrics.jsonl")]
    assert lines[0]["init_params_from"] == str(tmp_path / "source")
    assert lines[0]["source_step"] == source.step


def test_a_checkpoint_in_run_dir_wins_over_init_params_from(data, tmp_path):
    cfg = tiny(optimizer="RAdamScheduleFree")
    run(cfg, data, tmp_path / "source", 1)
    source = str(tmp_path / "source")
    _, whole, _ = run(cfg, data, tmp_path / "whole", 2,
                      init_params_from=source)
    run(cfg, data, tmp_path / "cut", 1, init_params_from=source)
    _, resumed, _ = run(cfg, data, tmp_path / "cut", 2, resume=True,
                        init_params_from=source)
    assert_states_equal(resumed, whole)


def test_load_trained_gives_the_saved_eval_parameters(data, tmp_path):
    cfg = tiny(optimizer="RAdamScheduleFree")
    _, state, _ = run(cfg, data, tmp_path, 2)
    trainer, loaded = api.load_trained(str(tmp_path), cfg, device="cpu")
    assert isinstance(trainer, Trainer) and trainer.device.type == "cpu"
    want, got = state.eval_params(cfg), loaded.eval_params(cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_trained_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="card"):
        api.load_trained(str(tmp_path), tiny())


def poisoned_noise(cfg, epoch_to_poison=0):
    def noise(epoch, phase):
        source = TrainNoise((cfg.seed, epoch, phase == "eval"), "cpu")
        if phase == "train" and epoch == epoch_to_poison:
            normal = source.normal

            def nan_pos(stream, shape):
                out = normal(stream, shape)
                return out * float("nan") if stream == "pos" else out

            source.normal = nan_pos
        return source
    return noise


def test_debug_nans_raises_on_a_nan_from_the_noise(data, tmp_path):
    cfg = tiny(optimizer="Adam", debug_nans=True)
    with pytest.raises(FloatingPointError, match="loss"):
        run(cfg, data, tmp_path / "debug", 1, noise=poisoned_noise(cfg))
    # without it the same epoch rolls back
    cfg = cfg.replace(debug_nans=False)
    _, state, _ = run(cfg, data, tmp_path / "plain", 2,
                      noise=poisoned_noise(cfg))
    assert state.step == 3


def test_debug_nans_names_a_non_finite_gradient(data):
    cfg = tiny(optimizer="Adam", debug_nans=True)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(cfg.seed)
    from diffusion_model_tpu_torch.data.batch import collate

    batch = collate(data[:4], cfg.n_max, "cpu")
    leaf = "denoiser.egnn.egcl_1.mlp_m_dense1.bias"
    hook = state.params[leaf].register_hook(lambda g: g * float("nan"))
    with pytest.raises(FloatingPointError, match=leaf.replace(".", r"\.")):
        trainer.train_step(state, TrainNoise(0, "cpu"), batch)
    hook.remove()
    # a clean state steps under anomaly mode and matches the plain step
    state = trainer.init_state(cfg.seed)
    plain = Trainer(cfg.replace(debug_nans=False), device="cpu")
    pstate = plain.init_state(cfg.seed)
    state, m = trainer.train_step(state, TrainNoise(0, "cpu"), batch)
    pstate, pm = plain.train_step(pstate, TrainNoise(0, "cpu"), batch)
    assert torch.equal(m["loss"], pm["loss"])
    assert_states_equal(state, pstate)


def test_mesh_training_in_a_world_of_one_is_the_plain_run(data, tmp_path):
    """``api.train`` with ``mesh_shape=(1,)`` in this process's world of one
    (gloo; the card's phase data_parallel with NCCL) writes the run without
    a mesh bit for bit: a sum over one rank is the identity."""
    import torch.distributed as dist

    from diffusion_model_tpu_torch import parallel

    cfg = tiny(optimizer="RAdamScheduleFree", noise_schedule="learned",
               cond_dropout_prob=0.5)
    _, plain, _ = api.train(cfg, data, str(tmp_path / "plain"),
                            num_epochs=2, device="cpu")
    parallel.init_single("gloo")
    try:
        _, dp, _ = api.train(cfg.replace(mesh_shape=(1,)), data,
                             str(tmp_path / "dp"), num_epochs=2,
                             device="cpu")
    finally:
        dist.destroy_process_group()
    assert_states_equal(dp, plain)

    def losses(d):
        return [(r["train_loss"], r["eval_loss"])
                for r in map(json.loads, open(tmp_path / d / "metrics.jsonl"))
                if "train_loss" in r]

    assert losses("dp") == losses("plain") and len(losses("dp")) == 2
