"""The port's synthetic generators against the JAX package's, bit for bit
(numpy both sides): ``amorphous_network_cell`` at 48, 192 and 512 atoms over
seeds and keyword arguments, ``synthetic_molecule_dataset`` at
``atom_type_size`` 5, ``cached_cell`` entries read across the packages, and
the large-cell recipe's 96 training cells (seed 2024, 160-192 atoms) drawn
as ``examples/size_generalization.py`` draws them."""

import os

import numpy as np
import pytest

from diffusion_model_tpu.data import synthetic as jax_synthetic
from diffusion_model_tpu_torch.data import synthetic
from diffusion_model_tpu_torch.evals import size_gen_check


def assert_same_graph(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert type(got[k]) is type(v) and got[k] == v, k


@pytest.mark.parametrize("num_atoms", [48, 192, 512])
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 5])
def test_network_cell_equals_jax(num_atoms, seed):
    got = synthetic.amorphous_network_cell(seed, num_atoms)
    assert_same_graph(got, jax_synthetic.amorphous_network_cell(
        seed, num_atoms))
    assert got["pos"].shape == (num_atoms, 3)
    np.testing.assert_array_equal(got["pos"][0], 0.0)   # the exO
    assert got["species"][0, 0] == 1.0 and got["exo"][0, 0] == 1.0


@pytest.mark.parametrize("kw", [
    dict(spectrum_size=64),
    dict(bond_length=1.58, si_o_si_deg=140.0),
    dict(jitter=0.0),
    dict(jitter=0.3, si_o_si_deg=160.0, spectrum_size=100),
])
def test_network_cell_kwargs_equal_jax(kw):
    for seed in (3, 11):
        assert_same_graph(synthetic.amorphous_network_cell(seed, 96, **kw),
                          jax_synthetic.amorphous_network_cell(seed, 96,
                                                               **kw))


def test_network_cell_has_silica_short_range_order():
    """Nine in ten Si of the ball's core have four O within 2.2 A, nine in
    ten O two Si (the network the generator builds, before its 0.12 A
    jitter), and the species split is ~1:2."""
    cell = synthetic.amorphous_network_cell(5, 512)
    pos, is_o = cell["pos"], cell["species"][:, 0] > 0.5
    r = np.linalg.norm(pos, axis=-1)
    core = r < 0.6 * r.max()
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    bonded = (d < 2.2) & (is_o[:, None] != is_o[None, :])
    cn = bonded.sum(1)
    assert (cn[core & ~is_o] == 4).mean() > 0.9
    assert (cn[core & is_o] == 2).mean() > 0.9
    assert 0.6 < is_o.mean() < 0.72


@pytest.mark.parametrize("seed,n_max", [(0, 9), (5, 6), (42, 16)])
def test_molecule_dataset_equals_jax(seed, n_max):
    got = synthetic.synthetic_molecule_dataset(seed, 12, n_max)
    want = jax_synthetic.synthetic_molecule_dataset(seed, 12, n_max)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert_same_graph(g, w)
        assert g["species"].shape[-1] == 5
        assert 3 <= g["pos"].shape[0] <= min(n_max, 9)


def test_molecule_dataset_widths_equal_jax():
    got = synthetic.synthetic_molecule_dataset(1, 4, 8, atom_type_size=3,
                                               spectrum_size=50)
    want = jax_synthetic.synthetic_molecule_dataset(1, 4, 8, atom_type_size=3,
                                                    spectrum_size=50)
    for g, w in zip(got, want):
        assert_same_graph(g, w)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("maker", ["amorphous_network_cell",
                                   "amorphous_cell"])
def test_cache_entries_are_read_across_the_packages(tmp_path, writer, reader,
                                                    maker):
    mods = {"jax": jax_synthetic, "port": synthetic}
    kw = dict(seed=17, num_atoms=48, spectrum_size=200)
    fresh = getattr(mods[writer], maker)(**kw)
    written = mods[writer].cached_cell(getattr(mods[writer], maker),
                                       str(tmp_path), **kw)
    assert_same_graph(written, fresh)
    files = sorted(os.listdir(tmp_path))
    assert files == [f"{maker}_num_atoms=48_seed=17_spectrum_size=200.npz"]

    def refuse(**_):
        raise AssertionError("a cached cell was made again")

    refuse.__name__ = maker
    read = mods[reader].cached_cell(refuse, str(tmp_path), **kw)
    assert_same_graph(read, fresh)
    assert sorted(os.listdir(tmp_path)) == files   # no .tmp file left


def test_cache_write_leaves_no_partial_entry(tmp_path, monkeypatch):
    """An interrupted write leaves only its temporary file, which no read
    takes for an entry."""
    def fail(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(synthetic.os, "replace", fail)
    with pytest.raises(KeyboardInterrupt):
        synthetic.cached_cell(synthetic.amorphous_network_cell,
                              str(tmp_path), seed=1, num_atoms=24)
    assert not any(f.endswith(".npz") for f in os.listdir(tmp_path))
    monkeypatch.undo()
    got = synthetic.cached_cell(synthetic.amorphous_network_cell,
                                str(tmp_path), seed=1, num_atoms=24)
    assert_same_graph(got, synthetic.amorphous_network_cell(1, 24))


def test_recipe_train_cells_equal_jax(tmp_path):
    """The size-gen recipe's 96 training cells (seed 2024, 160-192 atoms),
    the port's through ``size_gen_check`` and its cache, the JAX package's
    drawn as the example draws them."""
    args = size_gen_check.parser().parse_args(
        ["--generator", "network", "--train_min", "160", "--train_max",
         "192", "--cell_cache", str(tmp_path)])
    cfg = size_gen_check.recipe(args)
    got = size_gen_check.train_cells(
        args, cfg, size_gen_check.cell_maker(args, cfg.spectrum_size))
    rng = np.random.default_rng(2024)
    want = [jax_synthetic.amorphous_network_cell(
        seed=int(s), num_atoms=int(rng.integers(160, 193)))
        for s in rng.integers(0, 2**31, 96)]
    assert cfg.seed == 2024 and len(got) == 96
    sizes = [g["pos"].shape[0] for g in got]
    assert min(sizes) >= 160 and max(sizes) <= 192
    for g, w in zip(got, want):
        assert_same_graph(g, w)
    assert len(os.listdir(tmp_path)) == 96
