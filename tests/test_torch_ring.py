"""The port's ring (``parallel.ring``, ``Trainer.ring_train_step_fn``,
``api.generate_ring``, ``generate_amorphous --ring``) on the CPU, in gloo
worlds of 2 and 4 processes, against the port's dense path and the JAX
package's ring on its 8-device virtual mesh (``tests/conftest.py``): the
counterparts of ``tests/test_ring.py``.

One world a size is spawned for the module (``parallel.launch``); its ranks
run every case (``torch_parallel_cases.ring_cases``) from the JAX package's
initialisations, and the tests read what they wrote:

* the forward at n_max 32 of a 29-atom cell, ``zero_init_x`` both ways,
  and the lever stack (``h_residual``, ``virtual_node``, ``edge_rbf``,
  ``global_radius_feature``; the zero-init heads re-randomised as
  ``_liven_levers`` does): against the port's dense denoiser and the JAX
  ring at rtol 3e-4 / atol 3e-5;
* the parameter gradients of a fixed contraction of the outputs, summed
  over the ring: against the port's dense gradients at rtol 1e-2 and JAX's
  atol (1e-4, the lever stack 5e-4), and against JAX's ring gradients at
  rtol 1e-2 with ``test_torch_trainer.py``'s floor of 1e-2 rtol of each
  leaf's scale;
* one ``ring_train_step_fn`` step against the dense train step from the
  same state and draws (loss rtol 1e-4, every leaf rtol 2e-3 / atol 2e-6),
  predefined, and learned with conditioning dropout and the levers;
* the unchanged sampler through ``ring_sampler_denoise_fn`` against the
  dense sampler from the same generator (2e-4);
* ``api.generate_ring`` end to end into ``api.evaluate``, and
  ``generate_amorphous --ring`` against the same CLI without it;
* the guards: the Kabsch loss, a batch of two graphs (training and
  sampling), kNN lists, a node count that does not split over the ring.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.data.synthetic import amorphous_cell
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.parallel import make_mesh as jax_mesh
from diffusion_model_tpu.parallel.ring import ring_denoise_apply as jax_apply
from diffusion_model_tpu.parallel.ring import ring_denoise_fn as jax_ring_fn
from diffusion_model_tpu_torch import api, parallel
from diffusion_model_tpu_torch.cli import generate_amorphous
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.diffusion.process import predefined_schedule
from diffusion_model_tpu_torch.diffusion.sampler import sample
from diffusion_model_tpu_torch.parallel import ring
from diffusion_model_tpu_torch.train.checkpoint import state_dict_from_flax
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer
from torch_parallel_cases import FIELDS, _model, as_batch, ring_cases

torch.set_num_threads(2)

SMALL = dict(n_max=32, L=2, m_hidden_size=32, h_hidden_size=32,
             x_hidden_size=32, m_size=16, spectrum_size=16,
             compressed_spectrum_size=8, compressor_hidden_dim=(8,))
LEVERS = dict(h_residual=True, virtual_node=True, edge_rbf=6,
              global_radius_feature=True)
FORWARDS = {"zero_init_x": (dict(zero_init_x=True), 1),
            "live_x": (dict(zero_init_x=False), 1),
            "levers": (dict(zero_init_x=False, **LEVERS), 11)}
GRADS = {"plain": (dict(zero_init_x=False), 3, 1e-4),
         "levers": (dict(zero_init_x=False, **LEVERS), 13, 5e-4)}
TRAIN = {"predefined": (dict(batch_size=1, optimizer="Adam", lr=1e-3), 5,
                        (7,)),
         "learned": (dict(batch_size=1, optimizer="Adam", lr=1e-3,
                          noise_schedule="learned", cond_dropout_prob=0.5,
                          h_residual=True, virtual_node=True, edge_rbf=6),
                     17, (7, 8))}
SAMPLER = dict(SMALL, num_diffusion_timestep=8, zero_init_x=True,
               gen_num_per_spectrum=2, noise_precision=0.05)
RUN = dict(SAMPLER, n_max=16, batch_size=4, optimizer="Adam", lr=1e-3,
           spectrum_size=16)


def cell_arrays(seed: int, atoms: int, n_max: int = 32) -> dict:
    cell = amorphous_cell(seed=seed, num_atoms=atoms, spectrum_size=16)
    jb = jax_collate([cell], n_max)
    return {k: np.array(getattr(jb, k), np.float32) for k in FIELDS}


def liven_levers(params, rng):
    """``tests/test_ring.py``'s ``_liven_levers``: the zero-init virtual
    node and RBF heads (and the radius gate) re-randomised."""
    p = params["params"]
    for lp in p["egnn"].values():
        for name in ("vnode_out", "vnode_x_head", "rbf_m", "rbf_x"):
            if name in lp:
                k = lp[name]["kernel"]
                lp[name]["kernel"] = jnp.asarray(
                    rng.normal(size=k.shape) * 0.3, k.dtype)
    if "radius_feature_gate" in p:
        p["radius_feature_gate"] = jnp.asarray([0.7], jnp.float32)
    return params


def denoiser_inputs(kw: dict, seed: int, t: float):
    """(port config, JAX config, flax params as numpy, the one-graph inputs
    ``[N, ...]``) of a JAX initialisation."""
    rng = np.random.default_rng(2024)
    d = {**SMALL, **kw}
    jcfg = JaxConfig(**d)
    a = cell_arrays(seed, 29)
    species = rng.normal(size=(1, 32, 2)).astype(np.float32)
    t_norm = (np.full((1, 32, 1), t) * a["mask"][..., None]).astype(
        np.float32)
    args = (species, a["pos"], a["spectrum"], a["exo"], t_norm, a["mask"])
    model = JaxDenoiser(jcfg)
    mask = jnp.asarray(a["mask"])
    pair = (mask[:, :, None] * mask[:, None, :]) * (1 - jnp.eye(32))
    params = model.init(jax.random.key(0), *args, pair)
    if kw.get("virtual_node"):
        params = liven_levers(params, rng)
    tree = jax.tree.map(lambda v: np.asarray(v, np.float32), params)
    return Config(**d), jcfg, tree, tuple(x[0] for x in args), rng


def port_dense(cfg, tree, args):
    model = _model(cfg, tree)
    return model(*(torch.from_numpy(x)[None] for x in args)), model


@pytest.fixture(scope="module")
def cases():
    """The spec the ranks run, and the JAX package's side of each case."""
    mesh = jax_mesh()
    spec, want = {"forwards": [], "grads": [], "train_steps": []}, {}
    for name, (kw, seed) in FORWARDS.items():
        cfg, jcfg, tree, args, _ = denoiser_inputs(kw, seed, 0.4)
        spec["forwards"].append((name, cfg, tree, args))
        fn = jax_ring_fn(jcfg, jax.tree.map(jnp.asarray, tree), mesh)
        want[f"forward_{name}"] = [np.asarray(v) for v in jax.jit(fn)(*args)]
    for name, (kw, seed, _) in GRADS.items():
        cfg, jcfg, tree, args, rng = denoiser_inputs(kw, seed, 0.3)
        tx = rng.normal(size=(32, 3)).astype(np.float32)
        th = rng.normal(size=(32, 2)).astype(np.float32)
        spec["grads"].append((name, cfg, tree, args, (tx, th)))
        app = jax_apply(jcfg, mesh)

        def ring_loss(p):
            ex, eh = app(p, *args)
            return jnp.sum(ex * tx) + jnp.sum(eh * th)

        g = jax.jit(jax.grad(ring_loss))(jax.tree.map(jnp.asarray, tree))
        want[f"grads_{name}"] = state_dict_from_flax(
            jax.tree.map(lambda v: np.asarray(v, np.float32), g))
    for name, (kw, seed, seeds) in TRAIN.items():
        spec["train_steps"].append((name, Config(**{**SMALL, **kw}),
                                    cell_arrays(seed, 32), seeds))
    two = {k: np.concatenate([cell_arrays(1, 16, 16)[k],
                              cell_arrays(2, 16, 16)[k]]) for k in FIELDS}
    spec["train_b2"] = (Config(**{**SMALL, "n_max": 16, "batch_size": 1}),
                        two)
    cfg, _, tree, _, _ = denoiser_inputs(dict(zero_init_x=True), 1, 0.4)
    cfg = Config(**SAMPLER)
    spec["sampler"] = (cfg, tree, cell_arrays(3, 29), 7)
    spec["generate"] = (cfg, tree, [
        dict(amorphous_cell(seed=3, num_atoms=29, spectrum_size=16),
             id="first"),
        dict(amorphous_cell(seed=4, num_atoms=29, spectrum_size=16),
             id="second")])
    icfg = Config(**{**SMALL, "n_max": 27, "L": 1})
    _, _, itree, iargs, _ = denoiser_inputs(dict(L=1), 1, 0.4)
    iargs = tuple(a[:27] for a in iargs)
    spec["indivisible"] = (icfg, itree, iargs)
    return spec, want


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A run directory of ``RUN``'s config, one epoch on the CPU."""
    from diffusion_model_tpu_torch.data.synthetic import (
        synthetic_sio2_dataset,
    )

    d = tmp_path_factory.mktemp("run")
    cfg = Config(**RUN)
    api.train(cfg, synthetic_sio2_dataset(0, 16, 16, spectrum_size=16),
              str(d), num_epochs=1, device="cpu")
    return d


CLI = ["--amorphous", "1", "--num_atoms", "16", "--gen_num_per_spectrum",
       "1", "--device", "cpu"]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory, cases, trained_run):
    size = request.param
    out = tmp_path_factory.mktemp(f"ring{size}")
    run = out / "run"
    shutil.copytree(trained_run, run)
    spec = dict(cases[0], cli=["--run_dir", str(run), *CLI, "--ring"])
    try:
        parallel.launch(ring_cases, size, args=(str(out), spec))
    except Exception:
        for err in sorted(out.glob("error_r*.txt")):
            print(err.read_text())
        raise
    return size, out


def load(out, name) -> dict:
    with np.load(out / f"{name}.npz") as f:
        return {k: f[k] for k in f.files}


def messages(out) -> dict:
    return json.loads((out / "messages.json").read_text())


@pytest.mark.parametrize("name", sorted(FORWARDS))
def test_forward_matches_dense_and_the_jax_ring(world, cases, name):
    _, out = world
    spec, want = cases
    _, cfg, tree, args = next(f for f in spec["forwards"] if f[0] == name)
    got = load(out, f"forward_{name}")
    with torch.no_grad():
        (dx, dh), _ = port_dense(cfg, tree, args)
    for key, dense, jax_ring in (("eps_x", dx, want[f"forward_{name}"][0]),
                                 ("eps_h", dh, want[f"forward_{name}"][1])):
        np.testing.assert_allclose(got[key], dense[0].numpy(), rtol=3e-4,
                                   atol=3e-5, err_msg=key)
        np.testing.assert_allclose(got[key], jax_ring, rtol=3e-4, atol=3e-5,
                                   err_msg=key)


@pytest.mark.parametrize("name", sorted(GRADS))
def test_gradients_match_dense_and_the_jax_ring(world, cases, name):
    from test_torch_trainer import assert_leaves_close

    _, out = world
    spec, want = cases
    _, cfg, tree, args, (tx, th) = next(g for g in spec["grads"]
                                        if g[0] == name)
    atol = GRADS[name][2]
    (ex, eh), model = port_dense(cfg, tree, args)
    loss = (ex[0] * torch.from_numpy(tx)).sum() + (
        eh[0] * torch.from_numpy(th)).sum()
    names = [k for k, _ in model.named_parameters()]
    dense = dict(zip(names, torch.autograd.grad(loss,
                                                list(model.parameters()))))
    got = load(out, f"grads_{name}")
    assert sorted(got) == sorted(names) == sorted(want[f"grads_{name}"])
    for k in names:
        np.testing.assert_allclose(got[k], dense[k].numpy(), rtol=1e-2,
                                   atol=atol, err_msg=k)
    # two rings, each ~1e-2 off the exact gradient on a few near-cancelled
    # entries: held as test_torch_trainer.py holds the port's gradients to
    # JAX's (rtol, with a floor of 1e-2 rtol of the leaf's scale)
    assert_leaves_close({k: torch.from_numpy(v) for k, v in got.items()},
                        want[f"grads_{name}"], 1e-2)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_ring_train_step_matches_the_dense_step(world, cases, name):
    _, out = world
    spec, _ = cases
    _, cfg, arrays, seeds = next(s for s in spec["train_steps"]
                                 if s[0] == name)
    for seed in seeds:
        trainer = Trainer(cfg, device="cpu")
        state, m = trainer.train_step(trainer.init_state(0),
                                      TrainNoise(seed, "cpu"),
                                      as_batch(arrays))
        got = load(out, f"train_{name}_{seed}")
        assert np.isfinite(got["loss"])
        np.testing.assert_allclose(got["loss"], m["loss"].numpy(),
                                   rtol=1e-4)
        for k, p in state.params.items():
            np.testing.assert_allclose(got[k], p.detach().numpy(),
                                       rtol=2e-3, atol=2e-6, err_msg=k)


def test_ring_sampler_matches_the_dense_sampler(world, cases):
    _, out = world
    cfg, tree, arrays, seed = cases[0]["sampler"]
    model = _model(cfg, tree).requires_grad_(False)
    want = sample(model, predefined_schedule(cfg, device="cpu"), cfg,
                  torch.Generator().manual_seed(seed), as_batch(arrays))
    got = load(out, "sampler")
    assert got["finite"].all()
    np.testing.assert_allclose(got["pos"], want.pos.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["h"], want.h.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_generate_ring_end_to_end_into_evaluate(world, cases, tmp_path):
    _, out = world
    cfg = cases[0]["generate"][0]
    res = load(out, "generate_ring")
    g = cfg.gen_num_per_spectrum
    assert list(res["ids"]) == ["first"] * g + ["second"] * g
    assert res["generated_pos"].shape == (2 * g, cfg.n_max, 3)
    assert res["finite"].all()
    res["ids"] = list(res["ids"])
    got = api.evaluate(res, str(tmp_path), device="cpu")
    assert got["num_accepted"] == 2 * g


def test_generate_amorphous_ring_matches_the_dense_cli(world, trained_run,
                                                       tmp_path):
    _, out = world
    dense = tmp_path / "run"
    shutil.copytree(trained_run, dense)
    generate_amorphous.main(["--run_dir", str(dense), *CLI])
    got, want = (np.load(d / "generated_amorphous.npz")
                 for d in (out / "run", dense))
    assert sorted(got.files) == sorted(want.files)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["generated_pos"], want["generated_pos"],
                               rtol=2e-4, atol=2e-4)
    assert (out / "run" / "figures" /
            "atom_type_eval_amorphous.png").exists()


def test_guards(world):
    _, out = world
    msg = messages(out)
    assert msg["train_b2"].startswith("ValueError") and \
        "one node-sharded graph" in msg["train_b2"]
    assert "batch_size=2" in msg["sampler_b2"]
    assert msg["indivisible"].startswith("ValueError") and \
        "N=27" in msg["indivisible"]


def test_guards_before_any_collective():
    cfg = Config(**{**SMALL, "kabsch_loss": True})
    with pytest.raises(NotImplementedError, match="kabsch_loss"):
        Trainer(cfg, device="cpu").ring_train_step_fn(None)
    with pytest.raises(ValueError, match="ring_sample"):
        ring.ring_sampler_denoise_fn(Config(**{**SMALL, "neighbor_k": 4}),
                                     None, None)
    with pytest.raises(RuntimeError, match="parallel.launch"):
        api.generate_ring(Config(**SAMPLER), {}, [])
