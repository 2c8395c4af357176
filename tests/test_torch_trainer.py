"""The port's trainer (``train.trainer``, ``api.train``) against the JAX
package: one train step from the same parameters on the same draws (tiny
widths, and the flagship's trained weights), the learned recipe's gamma fit,
the initialisers, the repair of the cast cache (F5), the batch iterators'
order, npz snapshots written by either package, and a short run of
``api.train`` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.data import split as jax_split
from diffusion_model_tpu.data.batch import collate as jax_collate
from diffusion_model_tpu.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu.diffusion.process import (
    learned_schedule as jax_learned_schedule,
)
from diffusion_model_tpu.diffusion.process import (
    predefined_schedule as jax_predefined,
)
from diffusion_model_tpu.nn import DiffusionDenoiser as JaxDenoiser
from diffusion_model_tpu.nn.gamma import GammaNetwork as JaxGamma
from diffusion_model_tpu.nn.gamma import (
    fit_gamma_to_schedule as jax_fit_gamma,
)
from diffusion_model_tpu.train import EarlyStopping as JaxEarlyStopping
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu.train.checkpoint import (
    load_params_npz as jax_load_npz,
)
from diffusion_model_tpu.train.checkpoint import (
    save_params_npz as jax_save_npz,
)
from diffusion_model_tpu_torch import api
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data import split
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.diffusion import process
from diffusion_model_tpu_torch.nn import egnn
from diffusion_model_tpu_torch.nn.denoiser import DiffusionDenoiser
from diffusion_model_tpu_torch.nn.gamma import (
    GammaNetwork,
    fit_gamma_to_schedule,
)
from diffusion_model_tpu_torch.train import checkpoint
from diffusion_model_tpu_torch.train.trainer import EarlyStopping, Trainer
from torch_port_fixtures import (
    ReplayDraws,
    flagship,
    flagship_train_batch,
    jax_loss_draws,
    port_batch,
)

torch.set_num_threads(4)

TINY = dict(n_max=8, L=2, m_hidden_size=32, h_hidden_size=32,
            x_hidden_size=32, m_size=16, spectrum_size=32,
            compressed_spectrum_size=8, compressor_hidden_dim=(16,),
            num_diffusion_timestep=50, batch_size=4, lr=1e-3,
            optimizer="Adam")


def cfgs(**kw):
    d = {**TINY, **kw}
    return JaxConfig(**d), Config(**d)


def tiny_data(jcfg, num=8, seed=0):
    return synthetic_sio2_dataset(seed, num, jcfg.n_max,
                                  spectrum_size=jcfg.spectrum_size)


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def port_names(tree: dict) -> dict:
    """A JAX params-shaped tree (``{"denoiser": ..., "gamma": ...}``) by the
    port's parameter names."""
    out = {f"denoiser.{k}": v for k, v in
           checkpoint.state_dict_from_flax(np_tree(tree)).items()}
    if "gamma" in tree:
        out.update({f"gamma.{k}": v for k, v in
                    checkpoint.gamma_state_dict_from_flax(
                        np_tree(tree)).items()})
    return out


def jax_step(jcfg, jb, key, init_key=0):
    """(params, loss, sum_sq, grads, new params) of one JAX train step."""
    trainer = JaxTrainer(jcfg)
    state = trainer.init_state(jax.random.key(init_key), jb,
                               skip_gamma_fit=True)
    (loss, (sum_sq, _)), grads = jax.jit(jax.value_and_grad(
        trainer._loss, has_aux=True))(state.params, key, jb)
    new, _ = trainer.train_step(state, key, jb)
    return state.params, float(loss), float(sum_sq), grads, new.params


def assert_leaves_close(got: dict, want: dict, rtol):
    """Leaf by leaf at ``rtol``, with an absolute floor of 1e-2 rtol of the
    leaf's scale; the gamma network's leaves at 1e-6 of the largest gamma
    leaf (its shape weights get gradients at float32 rounding of the
    endpoints' at a fresh init: JAX's own jitted and eager gradients of
    them differ by tens of percent)."""
    assert sorted(got) == sorted(want)
    gamma_scale = max([float(np.abs(np.asarray(w)).max())
                       for k, w in want.items() if k.startswith("gamma.")]
                      or [0.0])
    for k, w in want.items():
        w = np.asarray(w)
        atol = rtol * 1e-2 * float(np.abs(w).max())
        if k.startswith("gamma."):
            atol = max(atol, 1e-6 * gamma_scale)
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(optimizer="RAdamScheduleFree", noise_schedule="learned"),
    dict(optimizer="AdamW", neighbor_k=3, cond_dropout_prob=0.5,
         t_bias_frac=0.5, t_bias_lo=5, t_bias_hi=30, t_loss_weight=2.0),
])
def test_train_step_matches_jax(kw):
    jcfg, cfg = cfgs(**kw)
    jb = next(jax_split.batch_iterator(tiny_data(jcfg), 4, jcfg.n_max,
                                       seed=1))
    key = jax.random.key(5)
    params, loss, sum_sq, grads, new = jax_step(jcfg, jb, key)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0, params=np_tree(params))
    draws = jax_loss_draws(key, jcfg, 4, jcfg.n_max)
    batch = port_batch(jb)
    got_loss, got_sq, _, got_grads = trainer.loss_and_grads(
        state, ReplayDraws(draws), batch)
    np.testing.assert_allclose(float(got_loss), loss, rtol=5e-3)
    np.testing.assert_allclose(float(got_sq), sum_sq, rtol=5e-3)
    assert_leaves_close(got_grads, port_names(grads), 5e-3)
    state, metrics = trainer.train_step(state, ReplayDraws(draws), batch)
    assert state.step == 1 and float(metrics["grad_norm"]) > 0
    assert_leaves_close(state.params, port_names(new), 5e-3)


def test_flagship_step_matches_jax():
    """The flagship's trained weights at n_max 16, B=4, float32."""
    jcfg, params = flagship()
    jcfg = jcfg.replace(compute_dtype="float32")
    jb = flagship_train_batch(jcfg, 4)
    key = jax.random.key(9)
    trainer = JaxTrainer(jcfg)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        trainer._loss, has_aux=True))(params, key, jb)
    cfg = checkpoint.load_config_npz(str(checkpoint_path())).replace(
        compute_dtype="float32")
    port = Trainer(cfg, device="cpu")
    state = port.init_state(0, params=params)
    got_loss, _, _, got = port.loss_and_grads(
        state, ReplayDraws(jax_loss_draws(key, jcfg, 4, jcfg.n_max)),
        port_batch(jb))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-3)
    for k, w in port_names(grads).items():
        np.testing.assert_allclose(float(got[k].norm()),
                                   float(np.linalg.norm(w)), rtol=5e-3,
                                   err_msg=k)


def checkpoint_path():
    from torch_port_fixtures import SNAPSHOT

    return SNAPSHOT


def test_gamma_fit_matches_jax_over_200_steps():
    """From JAX's initial gamma parameters, 200 steps of the fit in both
    packages. The alpha tables agree within 1e-4, not closer: the l3
    weights' gradients are sums that nearly cancel, and JAX's float32
    gradients of them lie 7e-8 from their float64 values where the port's
    lie 2e-8 (their largest is 1.8e-7), so Adam's first, sign-sized step
    already parts the tables by 4e-5; the fit's final error agrees to
    1e-3 of itself."""
    jcfg, cfg = cfgs(noise_schedule="learned", num_diffusion_timestep=1000)
    key = jax.random.key(2025)
    init = JaxGamma().init(key, jnp.zeros((1, 1)))
    fitted, jax_err = jax_fit_gamma(JaxGamma(), jax_predefined(jcfg).alphas,
                                    key, steps=200)
    want = np.asarray(jax_learned_schedule(JaxGamma().apply, fitted,
                                           1000).alphas)
    gamma = GammaNetwork()
    gamma.load_state_dict(checkpoint.gamma_state_dict_from_flax(
        {"gamma": np_tree(init)}))
    err = fit_gamma_to_schedule(gamma, process.predefined_schedule(
        cfg).alphas, steps=200)
    with torch.no_grad():
        got = process.learned_schedule(gamma, 1000).alphas.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(err, float(jax_err), rtol=1e-3)


ZERO_LEAVES = ("mlp_x_dense2.kernel", "vnode_out.kernel",
               "vnode_x_head.kernel")


def test_fresh_model_draws_as_flax():
    """Names and shapes of the JAX init tree; each leaf's mean and std
    within sampling error of JAX's draw of the same shape; the
    zero-initialised leaves exactly zero."""
    jcfg, params = flagship()
    jcfg = jcfg.replace(virtual_node=True, h_init_scale=0.25)
    jb = flagship_train_batch(jcfg, 2)
    tree = JaxDenoiser(jcfg).init(
        jax.random.key(1), jb.species, jb.pos, jb.spectrum, jb.exo,
        jnp.zeros((2, jcfg.n_max, 1)), jb.mask, jb.pair_mask())
    want = checkpoint.state_dict_from_flax(np_tree(tree))
    torch.manual_seed(1)
    model = DiffusionDenoiser(Config(**{
        k: v for k, v in jcfg.to_dict().items()
        if k in Config.__dataclass_fields__}))
    got = model.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert all(p.requires_grad for p in model.parameters())
    for k, w in want.items():
        g = got[k].numpy()
        w = w.numpy()
        if k.endswith("bias") or k.endswith(ZERO_LEAVES):
            assert not g.any() and not w.any(), k
            continue
        n = w.size
        sd = float(w.std())
        assert abs(float(g.mean()) - float(w.mean())) <= 6 * sd * np.sqrt(
            2 / n), k
        assert abs(float(g.std()) - sd) <= 6 * sd * np.sqrt(1 / n), k


def test_fresh_gamma_draws_as_flax():
    init = JaxGamma().init(jax.random.key(4), jnp.zeros((1, 1)))["params"]
    torch.manual_seed(4)
    gamma = GammaNetwork()
    for name in ("l2", "l3"):
        w = np.asarray(init[name]["weight"])
        g = getattr(gamma, name).weight.detach().numpy()
        assert g.shape == w.shape
        assert abs(g.mean() - w.mean()) <= 6 * w.std() * np.sqrt(2 / w.size)
        assert abs(g.std() - w.std()) <= 6 * w.std() * np.sqrt(1 / w.size)
        assert g.max() <= -2.0 + 1.0 and g.min() >= -2.0 - 1.0
    assert float(gamma.gamma_0) == float(init["gamma_0"][0])
    assert float(gamma.gamma_1) == float(init["gamma_1"][0])


def _f5_setup(dtype="float32"):
    _, cfg = cfgs(L=2, compute_dtype=dtype)
    jcfg, _ = cfgs(L=2)
    torch.manual_seed(3)
    model = DiffusionDenoiser(cfg)
    with torch.no_grad():      # heads and biases nonzero: every leaf moves
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    batch = collate(tiny_data(jcfg, 4), cfg.n_max, "cpu")
    g = torch.Generator().manual_seed(0)
    sp = torch.randn(batch.species.shape, generator=g)
    pos = batch.pos + 0.3 * torch.randn(batch.pos.shape, generator=g)
    t = torch.full((4, cfg.n_max, 1), 0.3) * batch.mask[..., None]
    return model, (sp, pos, batch.spectrum, batch.exo, t, batch.mask)


def _egcl_grads(model, args):
    model.zero_grad(set_to_none=True)
    eps_x, eps_h = model(*args)
    ((eps_x ** 2).sum() + (eps_h ** 2).sum()).backward()
    return {k: p.grad for k, p in model.named_parameters()
            if k.startswith("egnn.")}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f5_no_grad_forward_leaves_training_gradients_intact(dtype):
    """A forward under ``no_grad`` (an eval epoch after a step) and then a
    training forward with the same parameters: every EGCL leaf gets the
    gradient of a model that never ran under ``no_grad``."""
    model, args = _f5_setup(dtype)
    with torch.no_grad():
        model(*args)
    got = _egcl_grads(model, args)
    want = _egcl_grads(_f5_setup(dtype)[0], args)
    for k, w in want.items():
        assert got[k] is not None, k
        assert float(w.abs().max()) > 0, k
        assert torch.equal(got[k], w), k


def test_f5_two_forwards_and_backwards_before_a_step():
    model, args = _f5_setup("bfloat16")
    first = {k: g.clone() for k, g in _egcl_grads(model, args).items()}
    second = _egcl_grads(model, args)
    for k in first:
        assert torch.equal(first[k], second[k]), k


def test_served_model_keeps_its_cast():
    _, cfg = cfgs()
    model = DiffusionDenoiser(cfg).requires_grad_(False)
    layer = model.egnn.egcl_0
    w = layer.compute_weights(torch.float32)
    assert layer.compute_weights(torch.float32) is w


@pytest.mark.parametrize("count,batch,seed,drop", [(13, 4, 3, False),
                                                   (13, 4, None, True),
                                                   (3, 8, 1, False),
                                                   (16, 4, 2, False)])
def test_batch_iterators_follow_jax_order(count, batch, seed, drop):
    jcfg, cfg = cfgs()
    graphs = tiny_data(jcfg, count, seed=4)
    want = list(jax_split.batch_iterator(graphs, batch, jcfg.n_max, seed,
                                         drop))
    got = list(split.batch_iterator(graphs, batch, cfg.n_max, seed, drop))
    jdata = jax_collate(graphs, jcfg.n_max)
    want_dev = list(jax_split.device_batch_iterator(jdata, batch, seed, drop))
    got_dev = list(split.device_batch_iterator(
        collate(graphs, cfg.n_max, "cpu"), batch, seed, drop))
    assert len(got) == len(want) == len(got_dev) == len(want_dev)
    for g, w, gd, wd in zip(got, want, got_dev, want_dev):
        for f in ("pos", "species", "spectrum", "exo", "mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))
            np.testing.assert_array_equal(getattr(gd, f).numpy(),
                                          np.asarray(getattr(wd, f)))


def test_port_npz_loads_in_jax_and_back(tmp_path):
    jcfg, cfg = cfgs(noise_schedule="learned")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(7, skip_gamma_fit=True)
    with torch.no_grad():          # a trained-looking zero-init head
        state.params["denoiser.egnn.egcl_0.mlp_x_dense2.kernel"].add_(0.1)
    path = str(tmp_path / "port.npz")
    from diffusion_model_tpu_torch.train.trainer import params_tree

    n = checkpoint.save_params_npz(params_tree(state.eval_params(cfg)), path,
                                   dtype="float32", cfg=cfg)
    assert n == len(state.params)
    jparams = jax_load_npz(path)
    from diffusion_model_tpu.train.checkpoint import load_config_npz

    assert load_config_npz(path).L == cfg.L
    jb = next(jax_split.batch_iterator(tiny_data(jcfg), 4, jcfg.n_max,
                                       seed=1))
    t_norm = jnp.full((4, jcfg.n_max, 1), 0.4) * jb.mask[..., None]
    want = JaxDenoiser(jcfg).apply(jparams["denoiser"], jb.species, jb.pos,
                                   jb.spectrum, jb.exo, t_norm, jb.mask,
                                   jb.pair_mask())
    b = port_batch(jb)
    model = api.denoiser_from_params(cfg, checkpoint.load_params_npz(path),
                                     "cpu")
    with torch.no_grad():
        got = model(b.species, b.pos, b.spectrum, b.exo,
                    torch.from_numpy(np.asarray(t_norm)), b.mask)
        eval_model = api.denoiser_from_params(cfg, params_tree(
            state.eval_params(cfg)), "cpu")
        direct = eval_model(b.species, b.pos, b.spectrum, b.exo,
                            torch.from_numpy(np.asarray(t_norm)), b.mask)
    for g, d, w in zip(got, direct, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(g, d)
    # and a JAX-written npz back into the port
    path2 = str(tmp_path / "jax.npz")
    jax_save_npz(jparams, path2, dtype="float32")
    back = checkpoint.load_params_npz(path2)
    sd = checkpoint.state_dict_from_flax(back)
    for k, v in checkpoint.state_dict_from_flax(
            checkpoint.load_params_npz(path)).items():
        assert torch.equal(sd[k], v), k
    gamma = checkpoint.gamma_state_dict_from_flax(back)
    for k, v in gamma.items():
        assert torch.equal(v, state.eval_params(cfg)[f"gamma.{k}"]), k


def test_early_stopping_follows_jax():
    losses = [5.0, 4.0, 4.5, 4.2, 3.0, 3.5, 3.6, 3.7, 3.8]
    for patience in (0, 1, 2):
        a, b = EarlyStopping(patience), JaxEarlyStopping(patience)
        assert [a.validate(x) for x in losses] == [b.validate(x)
                                                  for x in losses]


class NanEpoch:
    """Noise sources for ``api.train``: position noise all NaN in the
    epochs listed, plain generator draws otherwise."""

    def __init__(self, cfg, bad_epochs):
        self.cfg, self.bad, self.calls = cfg, set(bad_epochs), []

    def __call__(self, epoch, phase):
        from diffusion_model_tpu_torch.train.loss import TrainNoise

        self.calls.append((epoch, phase))
        noise = TrainNoise((self.cfg.seed, epoch, phase == "eval"), "cpu")
        if phase == "train" and epoch in self.bad:
            normal = noise.normal

            def poisoned(stream, shape):
                out = normal(stream, shape)
                return out * float("nan") if stream == "pos" else out

            noise.normal = poisoned
        return noise


def test_api_train_runs_rolls_back_and_stops(tmp_path):
    jcfg, cfg = cfgs(optimizer="RAdamScheduleFree", patience=0)
    data = tiny_data(jcfg, 12)
    noise = NanEpoch(cfg, bad_epochs={1})
    trainer, state, (tr, va, te) = api.train(
        cfg, data, str(tmp_path), num_epochs=6, device="cpu", noise=noise)
    assert (len(tr), len(va), len(te)) == (9, 1, 2)
    import json

    lines = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert {k: v for k, v in lines[1].items() if k != "time"} == {
        "nan_recovery": 1, "step": 1}
    epochs = [r for r in lines if "train_loss" in r]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["eval_loss"])
               for r in epochs)
    # the NaN epoch took no step: 3 batches of 4 an epoch
    assert state.step == 3 * len(epochs)
    assert all(bool(torch.isfinite(p).all()) for p in state.params.values())
    stopper = JaxEarlyStopping(0)
    stops = [stopper.validate(r["eval_loss"]) for r in epochs]
    assert stops[-1] == (len(epochs) + 1 < 6)
    assert not any(stops[:-1])
    saved = checkpoint.load_params_npz(str(tmp_path / "params.npz"))
    assert checkpoint.load_config_npz(str(tmp_path / "params.npz")) == cfg
    model = api.denoiser_from_params(cfg, saved, "cpu")
    assert not any(p.requires_grad for p in model.parameters())


def test_trainer_takes_a_mesh_shape(tmp_path):
    """The trainer takes the setting; ``api.train`` reads it and, without a
    process group, says how to start one."""
    _, cfg = cfgs(mesh_shape=(2,))
    Trainer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="parallel.launch"):
        api.train(cfg, tiny_data(cfgs()[0]), str(tmp_path), num_epochs=1,
                  device="cpu")


def test_ring_training_in_a_world_of_one():
    """``ring_train_step_fn`` in this process's world of one (gloo, the
    card's layout with NCCL): one block, no point-to-point call, the dense
    step at the ring's tolerances (loss rtol 1e-4, leaves 2e-3 / 2e-6)."""
    import torch.distributed as dist

    from diffusion_model_tpu_torch import parallel
    from diffusion_model_tpu_torch.train.loss import TrainNoise

    _, cfg = cfgs(batch_size=1, noise_schedule="learned",
                  cond_dropout_prob=0.5)
    batch = collate(tiny_data(cfgs()[0], 1), cfg.n_max, "cpu")
    parallel.init_single("gloo")
    try:
        ring = Trainer(cfg, device="cpu")
        step = ring.ring_train_step_fn(parallel.make_mesh())
        got, gm = step(ring.init_state(0), TrainNoise(7, "cpu"), batch)
    finally:
        dist.destroy_process_group()
    dense = Trainer(cfg, device="cpu")
    want, wm = dense.train_step(dense.init_state(0), TrainNoise(7, "cpu"),
                                batch)
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=1e-4)
    for k, p in want.params.items():
        np.testing.assert_allclose(got.params[k].detach().numpy(),
                                   p.detach().numpy(), rtol=2e-3, atol=2e-6,
                                   err_msg=k)


def test_api_train_needs_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = cfgs()
    with pytest.raises(RuntimeError, match="card"):
        api.train(cfg, [], str(tmp_path), num_epochs=1)


def test_fit_n_max_and_prepare_dataset_follow_jax():
    from diffusion_model_tpu import api as jax_api

    jcfg, cfg = cfgs(spectrum_size=20)
    graphs = tiny_data(cfgs()[0], 6)
    graphs.append({**graphs[0], "pos": graphs[0]["pos"][:1],
                   "species": graphs[0]["species"][:1]})
    got, want = api.prepare_dataset(graphs, cfg), jax_api.prepare_dataset(
        graphs, jcfg)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["spectrum"], w["spectrum"])
    assert api.fit_n_max(graphs) == jax_api.fit_n_max(graphs)


def test_plain_edge_route_counts_under_autograd():
    """A layer off the kernels' widths trains through ``plain_edges``."""
    layer = egnn.EGCL(12, 32, 16, 32, 32, 12)
    h = torch.randn(2, 5, 12)
    x = torch.randn(2, 5, 3)
    mask = torch.ones(2, 5)
    before = egnn.plain_edge_calls
    h_out, x_out = layer(h, x, mask)
    (h_out.sum() + x_out.sum()).backward()
    assert egnn.plain_edge_calls == before + 1
    assert layer.mlp_m_dense1.kernel.grad is not None
