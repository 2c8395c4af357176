"""The serving artifact as a compiled program: ``serve.export_sampler``'s
three ``torch.export`` programs loaded and called in a process that cannot
import the model code (bit for bit the live ``sample``), the EGCL custom
ops under ``torch.library.opcheck``, the artifact against the JAX
package's own artifact from the same parameters on JAX's draws, and the
refusal of a format-1 artifact.

Widths of 64 put every EGCL on the kernel route, so the programs hold the
custom op (its plain statement on the CPU, the kernel on the card)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from diffusion_model_tpu import serve as jax_serve
from diffusion_model_tpu.config import Config as JaxConfig
from diffusion_model_tpu.train import Trainer as JaxTrainer
from diffusion_model_tpu_torch import api, serve
from diffusion_model_tpu_torch.config import Config
from diffusion_model_tpu_torch.data.batch import collate
from diffusion_model_tpu_torch.data.synthetic import synthetic_sio2_dataset
from diffusion_model_tpu_torch.diffusion.sampler import sample
from diffusion_model_tpu_torch.nn.egnn import EGCL
from diffusion_model_tpu_torch.ops import egcl_knn, egcl_pair
from diffusion_model_tpu_torch.train.loss import TrainNoise
from diffusion_model_tpu_torch.train.trainer import Trainer, params_tree
from torch_port_fixtures import (
    Replay,
    SnapshotState,
    edge_args,
    edge_inputs,
    jax_sample_draws,
    knn_args,
    knn_inputs,
)

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(n_max=6, L=2, m_hidden_size=64, h_hidden_size=32,
             x_hidden_size=64, m_size=64, spectrum_size=32,
             compressed_spectrum_size=8, compressor_hidden_dim=(16,),
             num_diffusion_timestep=10, batch_size=4, lr=1e-3,
             optimizer="Adam", noise_precision=0.05)
SEED = 7
CASES = {
    "dense": dict(),
    "knn3": dict(neighbor_k=3),
    "learned": dict(noise_schedule="learned"),
    "hres_vn": dict(h_residual=True, virtual_node=True,
                    compute_dtype="bfloat16"),
    "pos_only": dict(diffuse_species=False),
    "stochastic_strided": dict(sample_steps=5),
    "retry2": dict(sample_steps=5, deterministic_sampling=True,
                   retry_rounds=2),
}
# the modules a serving process must not need
REFUSED = tuple(f"diffusion_model_tpu_torch.{m}" for m in (
    "api", "config", "data", "diffusion", "nn", "train", "evals", "cli",
    "parallel")) + ("diffusion_model_tpu", "jax")
# run in the serving process: argv[1] is a JSON job of artifacts, inputs
# and an output directory
CHILD = f"""
import importlib.abc, json, sys

REFUSED = {REFUSED!r}


def refused(name):
    return any(name == r or name.startswith(r + ".") for r in REFUSED)


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(name + " is refused in the serving process")
        return None


sys.meta_path.insert(0, Refuse())
import numpy as np
import torch

from diffusion_model_tpu_torch.serve import ServedSampler

torch.set_num_threads(4)
job = json.loads(sys.argv[1])
for name, spec in job.items():
    served = ServedSampler(spec["path"], device="cpu")
    with np.load(spec["inputs"]) as f:
        args = [f[k] for k in ("spectrum", "exo", "mask", "species")]
    if served.meta["diffuse_species"]:
        args = args[:3]
    pos, species, accepted = served({SEED}, *args)
    np.savez(spec["out"], pos=pos, species=species, accepted=accepted)
print(json.dumps(sorted(m for m in sys.modules if refused(m))))
"""


def small(**kw):
    return Config(**{**SMALL, **kw})


def trained(cfg):
    """(trainer, state, cond) of a model a train step from init."""
    data = synthetic_sio2_dataset(0, 8, cfg.n_max,
                                  spectrum_size=cfg.spectrum_size)
    cond = collate(data[:2], cfg.n_max, "cpu")
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    state, _ = trainer.train_step(state, TrainNoise(3, "cpu"), cond)
    return trainer, state, cond


def live_sample(cfg, state, cond):
    params = params_tree(state.eval_params(cfg))
    return sample(api.denoiser_from_params(cfg, params, "cpu"),
                  api.schedule_for(cfg, params, "cpu"), cfg,
                  torch.Generator().manual_seed(SEED), cond)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each case exported in this process and called in one serving
    process that refuses the model code: {case: (cfg, live result, served
    (pos, species, accepted), the step program's op targets)}, and the
    refused modules that process loaded."""
    tmp = tmp_path_factory.mktemp("served")
    job, cases = {}, {}
    for name, kw in CASES.items():
        kw = dict(kw)
        rounds = kw.pop("retry_rounds", 0)
        cfg = small(**kw)
        trainer, state, cond = trained(cfg)
        path = str(tmp / f"{name}.pt2")
        serve.export_sampler(cfg, trainer, state, path, batch_size=2,
                             platforms=("cpu",), retry_rounds=rounds)
        programs, _ = serve._load_artifact(path, "cpu")
        targets = {str(n.target) for n in programs["step"].graph.nodes
                   if n.op == "call_function"}
        np.savez(tmp / f"{name}_in.npz", spectrum=cond.spectrum.numpy(),
                 exo=cond.exo.numpy(), mask=cond.mask.numpy(),
                 species=cond.species.numpy())
        job[name] = {"path": path, "inputs": str(tmp / f"{name}_in.npz"),
                     "out": str(tmp / f"{name}_out.npz")}
        cases[name] = (cfg, live_sample(cfg, state, cond), targets)
    proc = subprocess.run([sys.executable, "-c", CHILD, json.dumps(job)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    out = {}
    for name, (cfg, live, targets) in cases.items():
        with np.load(job[name]["out"]) as f:
            got = (f["pos"], f["species"], f["accepted"])
        out[name] = (cfg, live, got, targets)
    return out, loaded


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_served_without_model_code_is_the_live_sampler(served,
                                                                 case):
    out, loaded = served
    assert loaded == []
    cfg, live, (pos, species, accepted), targets = out[case]
    assert live.accepted.all()   # the retry rounds then never run
    np.testing.assert_array_equal(pos, live.pos.numpy())
    np.testing.assert_array_equal(species, live.species.numpy())
    np.testing.assert_array_equal(accepted, live.accepted.numpy())
    op = "egcl_knn" if cfg.neighbor_k else "egcl_pair"
    assert f"diffusion_model_tpu_torch.{op}.default" in targets


@pytest.mark.parametrize("op,args", [
    (egcl_pair.egcl_pair_op, lambda: edge_args(edge_inputs(3), "cpu")),
    (egcl_knn.egcl_knn_op, lambda: knn_args(knn_inputs(3), "cpu")),
], ids=["egcl_pair", "egcl_knn"])
def test_opcheck(op, args):
    torch.library.opcheck(op, args())


@pytest.mark.parametrize("op,reference,args", [
    (egcl_pair.egcl_pair_op, egcl_pair.egcl_pair_edges_reference,
     lambda: edge_args(edge_inputs(4), "cpu")),
    (egcl_knn.egcl_knn_op, egcl_knn.egcl_knn_edges_reference,
     lambda: knn_args(knn_inputs(4), "cpu")),
], ids=["egcl_pair", "egcl_knn"])
def test_ops_run_the_plain_statement_on_the_cpu(op, reference, args):
    args = args()
    for got, want in zip(op(*args), reference(*args)):
        assert torch.equal(got, want)


def test_artifact_matches_the_jax_artifact_on_its_draws(tmp_path):
    """The port's artifact, its loader replaying the draws of JAX's
    ``PRNGKey(seed)``, against ``diffusion_model_tpu.serve``'s artifact of
    the same parameters: positions within 1e-2 A (the 10-step chains'
    tolerance of the sampler's parity tests), species and acceptance
    equal."""
    cfg, jcfg = small(), JaxConfig(**SMALL)
    trainer, state, cond = trained(cfg)
    params = params_tree(state.eval_params(cfg))
    jpath, path = str(tmp_path / "jax.bin"), str(tmp_path / "port.pt2")
    jax_serve.export_sampler(jcfg, JaxTrainer(jcfg), SnapshotState(params),
                             jpath, batch_size=2, platforms=("cpu",))
    serve.export_sampler(cfg, trainer, state, path, batch_size=2,
                         platforms=("cpu",))
    args = (cond.spectrum.numpy(), cond.exo.numpy(), cond.mask.numpy())
    jpos, jspecies, jacc = jax_serve.ServedSampler(jpath)(SEED, *args)

    programs, layout = serve._load_artifact(path, "cpu")
    key = jax.random.PRNGKey(SEED)
    draws = Replay(jax_sample_draws(key, 2, cfg.n_max, cfg.atom_type_size,
                                    cfg.num_diffusion_timestep, True))
    fn = serve._sampler_fn(programs, layout, 0, lambda i: draws)
    pos, species, acc = fn(SEED, *(torch.from_numpy(a) for a in args),
                           torch.zeros_like(cond.species))
    assert not draws.draws
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    assert acc.all()
    np.testing.assert_array_equal(species.numpy(), np.asarray(jspecies))
    np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), atol=1e-2,
                               rtol=0)


def test_a_format_1_artifact_is_refused(tmp_path):
    path = str(tmp_path / "old.pt")
    torch.save({"format": "diffusion_model_tpu_torch.serve/1",
                "config": json.dumps(small().to_dict()), "params": {},
                "alphas": torch.ones(11)}, path)
    with open(path + ".json", "w") as f:
        json.dump({"platforms": ["cpu"], "in_graph_retry_rounds": 0}, f)
    with pytest.raises(ValueError, match="serve/1.*re-export"):
        serve.ServedSampler(path, device="cpu")


def test_no_card_and_no_cpu_asked_for_raises(tmp_path, monkeypatch):
    cfg = small(L=1)
    trainer = Trainer(cfg, device="cpu")
    path = str(tmp_path / "s.pt2")
    serve.export_sampler(cfg, trainer, trainer.init_state(0), path, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="finds none"):
        serve.ServedSampler(path)


def test_an_egcl_exports_only_with_its_weights_cast_first():
    """Under export a layer uses the weights it cast before the trace, as
    constants; without them it raises rather than cast in the graph."""
    class Layer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.__dict__["egcl"] = EGCL(4, 64, 64, 64, 8,
                                         4).requires_grad_(False)

        def forward(self, h, x, mask):
            return self.egcl(h, x, mask)

    args = (torch.randn(2, 5, 4), torch.randn(2, 5, 3), torch.ones(2, 5))
    layer = Layer()
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="no weights kept"):
            torch.export.export(layer, args, strict=False)
        want = layer(*args)   # casts and keeps them
        ep = torch.export.export(layer, args, strict=False)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert "aten._to_copy.default" not in targets   # no cast in the graph
    assert not ep.state_dict   # the weights are the program's constants
    for got, w in zip(ep.module()(*args), want):
        assert torch.equal(got, w)
