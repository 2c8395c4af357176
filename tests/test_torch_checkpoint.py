"""The port's snapshot loader and config against the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import from_dict as jax_from_dict
from diffusion_model_tpu.train import checkpoint as jax_ckpt
from diffusion_model_tpu_torch import config as port_config
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.train import checkpoint as port_ckpt
from torch_port_fixtures import SNAPSHOT

torch.set_num_threads(4)

LEARNED = SNAPSHOT.parent / "q_learned_r5_s2025.npz"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_every_array_loads_exactly_as_in_jax():
    want = _flat(jax_ckpt.load_params_npz(str(SNAPSHOT)))
    got = _flat(port_ckpt.load_params_npz(str(SNAPSHOT)))
    assert sorted(got) == sorted(want)
    assert len(got) == 88
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_state_dict_carries_every_flax_tensor_exactly():
    tree = port_ckpt.load_params_npz(str(SNAPSHOT))
    flat = _flat(tree["denoiser"]["params"])
    sd = port_ckpt.state_dict_from_flax(tree)
    assert len(sd) == len(flat)
    for key, value in flat.items():
        module, leaf = key.rsplit("/", 1)
        name = module.replace("/", ".")
        if port_ckpt._is_linear(module) and leaf == "kernel":
            got = sd[f"{name}.weight"].numpy().T
        else:
            got = sd[f"{name}.{leaf}"].numpy()
        np.testing.assert_array_equal(got, value, err_msg=key)


def test_state_dict_loads_strictly_into_the_denoiser():
    cfg = port_ckpt.load_config_npz(str(SNAPSHOT))
    model = DiffusionDenoiser(cfg)
    sd = port_ckpt.state_dict_from_flax(
        port_ckpt.load_params_npz(str(SNAPSHOT)))
    model.load_state_dict(sd)   # strict: names and shapes all match
    w = model.egnn.egcl_0.mlp_x_dense1.kernel
    # a fresh denoiser trains; the one api.denoiser_from_params serves
    # from the same tree is frozen
    assert tuple(w.shape) == (1024, 1024) and w.requires_grad
    from diffusion_model_tpu_torch.api import denoiser_from_params

    served = denoiser_from_params(cfg, port_ckpt.load_params_npz(
        str(SNAPSHOT)), "cpu")
    assert not any(p.requires_grad for p in served.parameters())


def test_config_matches_jax_field_for_field():
    got = port_ckpt.load_config_npz(str(SNAPSHOT))
    want = jax_ckpt.load_config_npz(str(SNAPSHOT))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.h_size == want.h_size == 36
    assert got.compute_dtype == "bfloat16" and got.L == 5
    assert got.torch_dtype == torch.bfloat16


@pytest.mark.parametrize("field,value", [
    ("neighbor_k", 32), ("virtual_node", True), ("h_residual", True),
    ("edge_rbf", 8), ("global_radius_feature", True),
    ("compat_scalar_norm", True), ("remat_egcl", True)])
def test_large_cell_settings_carry_over(field, value):
    d = {field: value}
    assert getattr(jax_from_dict(d), field) == value
    assert getattr(port_config.from_dict(d), field) == value


@pytest.mark.parametrize("field,value", [
    ("ring_sample", True), ("mesh_shape", [2]),
])
def test_parallel_settings_carry_over(field, value):
    d = {field: value}
    assert getattr(port_config.from_dict(d), field) == getattr(
        jax_from_dict(d), field)


@pytest.mark.parametrize("value", ["eps", "x0", "v", "foo"])
def test_coordinate_heads_accepted_and_others_refused(value):
    """"eps", "x0" and "v" carry over as the JAX package reads them; any
    other value raises ValueError naming the field, in the port when the
    config is built, in the JAX package when the head is first read."""
    from diffusion_model_tpu.diffusion.process import x_param_is_x0

    d = {"x_parameterization": value}
    jcfg = jax_from_dict(d)
    if value == "foo":
        with pytest.raises(ValueError, match="x_parameterization"):
            x_param_is_x0(jcfg)
        with pytest.raises(ValueError, match="x_parameterization"):
            port_config.from_dict(d)
        return
    cfg = port_config.from_dict(d)
    assert cfg.x_parameterization == jcfg.x_parameterization == value
    assert port_config.from_dict(cfg.to_dict()) == cfg


def test_learned_schedule_snapshot_is_refused():
    """The learned snapshot loads, but its denoiser alone does not sample:
    ``generate`` refuses a learned-schedule model that comes without its
    schedule, and never falls back to the polynomial table."""
    from diffusion_model_tpu_torch import api

    cfg = port_ckpt.load_config_npz(str(LEARNED))
    model = api.denoiser_from_params(
        cfg, port_ckpt.load_params_npz(str(LEARNED)), "cpu")
    with pytest.raises(ValueError, match="noise_schedule"):
        api.generate(cfg, model, [], device="cpu")


def test_learned_schedule_snapshot_loads():
    got = port_ckpt.load_config_npz(str(LEARNED))
    want = jax_ckpt.load_config_npz(str(LEARNED))
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.noise_schedule == "learned" and got.seed == 2025
    tree = port_ckpt.load_params_npz(str(LEARNED))
    want_tree = jax_ckpt.load_params_npz(str(LEARNED))
    flat, want_flat = _flat(tree), _flat(want_tree)
    assert sorted(flat) == sorted(want_flat) and len(flat) == 93
    for k in want_flat:
        np.testing.assert_array_equal(flat[k], want_flat[k], err_msg=k)
    gamma = port_ckpt.gamma_state_dict_from_flax(tree)
    assert {k: tuple(v.shape) for k, v in gamma.items()} == {
        "l1.weight": (1, 1), "l2.weight": (1024, 1), "l3.weight": (1, 1024),
        "gamma_0": (1,), "gamma_1": (1,)}
    for k, v in gamma.items():
        np.testing.assert_array_equal(
            v.numpy(), want_flat["gamma/params/" + k.replace(".", "/")])


@pytest.mark.parametrize("value", ["polynomial", "Learned", ""])
def test_unknown_noise_schedule_raises_naming_the_field(value):
    with pytest.raises(ValueError, match="noise_schedule"):
        port_config.from_dict({"noise_schedule": value})


def test_learned_schedule_settings_carry_over():
    d = {"noise_schedule": "learned", "snapshot_every": 7,
         "gamma_init": "polynomial", "gamma_boundary_weight": 2.0}
    got, want = port_config.from_dict(d), jax_from_dict(d)
    assert got.noise_schedule == want.noise_schedule == "learned"
    assert got.snapshot_every == want.snapshot_every == 7
    # the learned recipe's training settings carry over too
    assert got.gamma_init == want.gamma_init == "polynomial"
    assert got.gamma_boundary_weight == want.gamma_boundary_weight == 2.0
    assert port_config.Config().snapshot_every == 100


def test_corrupt_config_json_raises(tmp_path):
    path = tmp_path / "bad.npz"
    np.savez(path, w=np.zeros(2), __config_json__=np.array("{not json"))
    with pytest.raises(json.JSONDecodeError):
        port_ckpt.load_config_npz(str(path))


def test_pickled_config_is_not_unpickled(tmp_path):
    path = tmp_path / "legacy.npz"
    np.savez(path, w=np.zeros(2),
             __config_json__=np.array(json.dumps({"L": 2}), dtype=object))
    with pytest.raises(ValueError, match="pickle"):
        port_ckpt.load_config_npz(str(path))


def test_snapshot_without_config_gives_none(tmp_path):
    path = tmp_path / "bare.npz"
    np.savez(path, w=np.zeros(2))
    assert port_ckpt.load_config_npz(str(path)) is None


# -- F6: every field of the JAX Config -----------------------------------

HONOURED_SINCE_F6 = ("checkpoint_every", "debug_nans")


def test_every_jax_field_is_a_port_field_or_in_the_table():
    from diffusion_model_tpu.config import Config as JaxConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(port_config.Config)}
    assert set(jax_fields) == set(port_fields)
    for name, default in jax_fields.items():
        assert port_fields[name] == default, name
    # the fields no code of the port reads are each in the table, with
    # what the port does with them and why
    assert set(port_config.JAX_ONLY) == {"x_size", "d_size", "use_pallas"}
    for name, (how, why) in port_config.JAX_ONLY.items():
        assert how in ("refused", "inert") and why, name
    assert not set(HONOURED_SINCE_F6) & set(port_config.JAX_ONLY)


@pytest.mark.parametrize("field,value", [
    (name, 2) for name, (how, _) in sorted(port_config.JAX_ONLY.items())
    if how == "refused"])
def test_refused_jax_fields_raise_naming_the_field(field, value):
    jax_from_dict({field: value})   # a valid config for the JAX package
    with pytest.raises(NotImplementedError, match=field):
        port_config.from_dict({field: value})


@pytest.mark.parametrize("field,value", [
    ("kabsch_loss_steps", 50), ("kabsch_loss_weight", 0.5),
    ("latent_dim", 16), ("spectrum_to_latent", True), ("use_pallas", True),
    ("edge_rbf_rmax", 6.0),
    ("mesh_axis_names", ["batch"]), ("checkpoint_every", 7),
    ("debug_nans", True)])
def test_other_jax_fields_carry_over(field, value):
    got, want = port_config.from_dict({field: value}), jax_from_dict(
        {field: value})
    assert getattr(got, field) == getattr(want, field)
    assert port_config.from_dict(got.to_dict()) == got


def test_flagship_recipe_keeps_checkpoint_every():
    got = port_ckpt.load_config_npz(str(SNAPSHOT))
    assert got.checkpoint_every == 300 and got.num_epochs == 3000
    assert got.mesh_axis_names == ("data",) and not got.use_pallas
    assert port_ckpt.load_config_npz(str(LEARNED)).checkpoint_every == 0


# -- _rescale_gamma_endpoints against the JAX package's --------------------

def _as_jax_tree(tree):
    """The port's state tree with each name-keyed dict as the flax tree
    the JAX package's optimizer state mirrors, tensors as numpy."""
    from diffusion_model_tpu_torch.train.trainer import params_tree

    if isinstance(tree, torch.Tensor):
        return tree.detach().numpy().copy()
    if isinstance(tree, dict):
        return params_tree({k: v.detach() for k, v in tree.items()})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_as_jax_tree(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_as_jax_tree(v) for v in tree)
    return tree


@pytest.mark.parametrize("recipe", [
    dict(optimizer="RAdamScheduleFree"),
    dict(optimizer="Adam", ema_decay=0.9),
    dict(optimizer="AdamW")])
def test_rescale_gamma_endpoints_matches_jax(recipe):
    import jax

    from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
    from diffusion_model_tpu.train.trainer import TrainState as JaxState
    from diffusion_model_tpu_torch.data.batch import collate
    from diffusion_model_tpu_torch.train.loss import TrainNoise
    from diffusion_model_tpu_torch.train.trainer import Trainer

    cfg = port_config.Config(
        n_max=8, L=2, m_hidden_size=32, h_hidden_size=32, x_hidden_size=32,
        m_size=16, spectrum_size=32, compressed_spectrum_size=8,
        compressor_hidden_dim=(16,), num_diffusion_timestep=50,
        batch_size=4, lr=1e-3, noise_schedule="learned", **recipe)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(cfg.seed)
    batch = collate(synthetic_sio2_dataset(0, 4, 8, spectrum_size=32), 8,
                    "cpu")
    for step in range(2):   # nonzero moments, z apart from y, an EMA
        state, _ = trainer.train_step(state, TrainNoise(step, "cpu"), batch)
    assert all(bool(torch.isfinite(p).all()) for p in state.params.values())
    saved = {"gamma_endpoint_scale": 1.0}   # written before the rescaling
    jax_state = JaxState(params=_as_jax_tree(state.params),
                         opt_state=_as_jax_tree(state.opt_state), step=2)
    want = jax_ckpt._rescale_gamma_endpoints(jax_state, saved)
    got = port_ckpt._rescale_gamma_endpoints(state.clone(), saved)
    got_tree = (_as_jax_tree(got.params), _as_jax_tree(got.opt_state))
    want_tree = (want.params, want.opt_state)
    got_leaves = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    moved = 0
    before = dict(jax.tree_util.tree_flatten_with_path(
        (jax_state.params, jax_state.opt_state))[0])
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=str(path),
                                   equal_nan=False)
        moved += not np.array_equal(np.asarray(w), before[path])
    # the endpoints and their copies moved: y, and z / EMA, mu, nu
    assert moved >= 2 * (2 if "ema_decay" in recipe or
                         recipe["optimizer"] == "RAdamScheduleFree" else 1)
    # a checkpoint at the current scale is left as it is
    same = port_ckpt._rescale_gamma_endpoints(
        state.clone(), {"gamma_endpoint_scale": 25.0})
    assert torch.equal(same.params["gamma.gamma_0"],
                       state.params["gamma.gamma_0"])
