"""The port's data readers (``data/cell.py``, ``spectra.py``,
``local_env.py``, ``native.py``, ``shells.py``, ``polymorphs.py``,
``frames.py``, ``io.py``, ``legacy.py``, ``qm9.py``) and the legacy beta
schedules (``ops/schedules.py``) against the JAX package's, on the CPU.

Both sides are numpy (and scipy) for the readers, so every output is held
bit for bit, on ``tests/fixtures/castep/`` and on texts and files the tests
write. Two exceptions, each with its tolerance:

* the native shell builder: the port builds its own library from
  ``native/graphbuild.cpp`` (without ``-march=native``) and selects the same
  sites in the same order as the numpy route and as the JAX package's
  library; positions agree to 1e-6 A (the JAX package's own native test's
  tolerance: the library computes them in double before the cast);
* ``beta_schedule``: JAX builds the grid with ``jnp.linspace`` in float32,
  the port with ``linspace_f32``, so the tables agree to rtol 1e-6;
  ``ddpm_alpha_bar`` of one table is bit for bit (``jnp.cumprod``'s order).

The JAX package's library is compared through a copy these tests build
themselves (``jax_library``: ``native/graphbuild.cpp`` with the flags of
``native/Makefile``, into a temporary directory), never through
``native/libgraphbuild.so``. That file is built in place by ``make`` on
first use, and test processes started together race for it: a process
that finds it half written loads nothing, and the JAX module keeps that
failure for the life of the process.
"""

import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusion_model_tpu.data import cell as jax_cell
from diffusion_model_tpu.data import frames as jax_frames
from diffusion_model_tpu.data import io as jax_io
from diffusion_model_tpu.data import legacy as jax_legacy
from diffusion_model_tpu.data import local_env as jax_local_env
from diffusion_model_tpu.data import native as jax_native
from diffusion_model_tpu.data import polymorphs as jax_polymorphs
from diffusion_model_tpu.data import qm9 as jax_qm9
from diffusion_model_tpu.data import shells as jax_shells
from diffusion_model_tpu.data import spectra as jax_spectra
from diffusion_model_tpu_torch.data import (
    cell,
    frames,
    io,
    legacy,
    local_env,
    native,
    polymorphs,
    qm9,
    shells,
    spectra,
)
from diffusion_model_tpu_torch.ops import schedules

torch.set_num_threads(4)

CASTEP = Path(__file__).resolve().parent / "fixtures" / "castep"
NATIVE = Path(__file__).resolve().parents[1] / "native"

CUBIC = """%BLOCK LATTICE_ABC
5.0 5.0 5.0
90.0 90.0 90.0
%ENDBLOCK LATTICE_ABC

%BLOCK POSITIONS_FRAC
O:ex 0.5 0.5 0.5
Si 0.2 0.5 0.5
Si 0.8 0.5 0.5
O 0.5 0.2 0.5
%ENDBLOCK POSITIONS_FRAC
"""

HEXAGONAL = """%BLOCK LATTICE_ABC
4.9 4.9 5.4
90.0 90.0 120.0
%ENDBLOCK LATTICE_ABC

%BLOCK POSITIONS_FRAC
O:ex 0.4 0.27 0.21
Si 0.47 0.0 0.0
Si 0.0 0.47 0.33
O 0.41 0.14 0.55
%ENDBLOCK POSITIONS_FRAC
"""

# units, comments, tabs, lower case and absolute positions
UNITS = """# a comment line
%block\tlattice_cart
bohr
 9.0 0.0 0.0   ! trailing comment
 0.5 9.5 0.0
 0.0 0.3 10.0
%endblock lattice_cart
kpoint_mp_grid 2 2 2

%BLOCK POSITIONS_ABS
nm
O:ex 0.25 0.26 0.27
Si 0.40 0.26 0.27
Si 0.10 0.26 0.27
O 0.25 0.10 0.30
%ENDBLOCK POSITIONS_ABS
"""

TEXTS = {"cubic": CUBIC, "hexagonal": HEXAGONAL, "units": UNITS}
FIXTURE_CELLS = sorted(str(p / "coreloss.cell") for p in CASTEP.iterdir())


def cell_paths(tmp_path):
    paths = list(FIXTURE_CELLS)
    for name, text in TEXTS.items():
        p = tmp_path / f"{name}.cell"
        p.write_text(text)
        paths.append(str(p))
    return paths


def same_structure(got, want):
    np.testing.assert_array_equal(got.lattice, want.lattice)
    np.testing.assert_array_equal(got.frac_coords, want.frac_coords)
    assert got.species == want.species
    assert got.exo_index == want.exo_index


def same_graph(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def test_cells_parse_as_the_jax_package_parses_them(tmp_path):
    for path in cell_paths(tmp_path):
        got, want = cell.read_castep_cell(path), jax_cell.read_castep_cell(
            path)
        same_structure(got, want)
        np.testing.assert_array_equal(got.cart_coords, want.cart_coords)
        same_structure(cell.supercell_333(got), jax_cell.supercell_333(want))
        np.testing.assert_array_equal(cell.distance_matrix(got),
                                      jax_cell.distance_matrix(want))
        np.testing.assert_array_equal(
            cell.min_image_distance_matrix(got),
            jax_cell.min_image_distance_matrix(want))


@pytest.mark.parametrize("text,match", [
    (CUBIC.replace("O:ex", "O"), "no :ex-tagged site"),
    (CUBIC.replace("Si 0.2 0.5 0.5", "Si 0.2 0.5"), "malformed"),
    (CUBIC.replace("LATTICE_ABC", "LATTICE_X"), "no LATTICE"),
    (CUBIC.replace("POSITIONS_FRAC", "POSITIONS_X"), "no POSITIONS"),
    (UNITS.replace("bohr", "furlong"), "unknown .cell unit"),
])
def test_malformed_cells_raise_as_in_jax(tmp_path, text, match):
    p = tmp_path / "bad.cell"
    p.write_text(text)
    for read in (cell.read_castep_cell, jax_cell.read_castep_cell):
        with pytest.raises(ValueError, match=match):
            read(str(p))


def test_lattices_and_min_image_deltas():
    rng = np.random.default_rng(0)
    for abc, angles in [((5, 6, 7), (90, 90, 90)), ((4.9, 4.9, 5.4),
                        (90, 90, 120)), ((6, 6.5, 7), (80, 95, 100))]:
        got = cell.lattice_from_parameters(*abc, *angles)
        want = jax_cell.lattice_from_parameters(*abc, *angles)
        np.testing.assert_array_equal(got, want)
        d = rng.uniform(-2, 2, (50, 3))
        np.testing.assert_array_equal(cell.mic_frac_deltas(d, got),
                                      jax_cell.mic_frac_deltas(d, want))


@pytest.mark.parametrize("normalize", [True, False])
def test_edge_spectra_fit_as_in_jax(tmp_path, normalize):
    edges = sorted(str(p / "coreloss_core_edge.dat")
                   for p in CASTEP.iterdir())
    for path in edges:
        np.testing.assert_array_equal(
            spectra.fitted_intensity(path, normalize=normalize),
            jax_spectra.fitted_intensity(path, normalize=normalize))
    np.testing.assert_array_equal(spectra.GRID, jax_spectra.GRID)
    np.testing.assert_array_equal(
        spectra.fitted_intensity_wo_normalize(edges[0]),
        jax_spectra.fitted_intensity_wo_normalize(edges[0]))
    bad = tmp_path / "no_header.dat"
    bad.write_text("1 2\n3 4\n")
    with pytest.raises(ValueError, match="header"):
        spectra.fitted_intensity(str(bad))


# -- local environments ----------------------------------------------

LATTICES = {
    "cubic": ((6.0, 6.0, 6.0), (90, 90, 90)),
    "hexagonal": ((6.0, 6.0, 7.0), (90, 90, 120)),
    "triclinic": ((6.0, 6.5, 7.0), (80, 95, 100)),
}


def random_cells(lattice: str, count: int = 3, n_si: int = 6, n_o: int = 8):
    abc, angles = LATTICES[lattice]
    lat = cell.lattice_from_parameters(*abc, *angles)
    rng = np.random.default_rng(sorted(LATTICES).index(lattice))
    species = ["O"] + ["Si"] * n_si + ["O"] * n_o
    for _ in range(count):
        frac = rng.uniform(0, 1, size=(1 + n_si + n_o, 3))
        yield (cell.CellStructure(lat, frac, species, 0),
               jax_cell.CellStructure(lat, frac, species, 0))


def same_shell(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert (g["index"], g["species"]) == (w["index"], w["species"])
            np.testing.assert_array_equal(g["vector"], w["vector"])
        else:
            assert g[:2] == w[:2]
            np.testing.assert_array_equal(g[2], w[2])


@pytest.mark.parametrize("rule", ["covalent", "voronoi"])
@pytest.mark.parametrize("lattice", sorted(LATTICES))
def test_local_environments_match_jax(lattice, rule):
    for got, want in random_cells(lattice):
        np.testing.assert_array_equal(local_env.mic_vectors(got, 3),
                                      jax_local_env.mic_vectors(want, 3))
        same_shell(local_env.ex_o_vectors(got, rule=rule),
                   jax_local_env.ex_o_vectors(want, rule=rule))
        g_env = local_env.local_env_coords(got, rule=rule)
        w_env = jax_local_env.local_env_coords(want, rule=rule)
        assert sorted(g_env) == sorted(w_env)
        for k in w_env:
            np.testing.assert_array_equal(np.asarray(g_env[k]),
                                          np.asarray(w_env[k]))
    same_shell(local_env.bonded_neighbors(got, 0, scale=1.4),
               jax_local_env.bonded_neighbors(want, 0, scale=1.4))
    same_shell(local_env.voronoi_neighbors(got, 0, tol=0.2),
               jax_local_env.voronoi_neighbors(want, 0, tol=0.2))


def test_local_env_reads_the_ports_radii():
    from diffusion_model_tpu_torch.evals.fingerprint import COVALENT_RADII

    assert local_env.COVALENT_RADII is COVALENT_RADII
    with pytest.raises(ValueError, match="bond rule"):
        local_env.ex_o_vectors(next(random_cells("cubic"))[0], rule="x")


# -- shells ---------------------------------------------------------

def test_native_library_builds_in_the_ports_build_dir():
    path = native.build_library()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.parent.parent.name == "build"
    assert native.available()
    assert not str(path).startswith(str(Path(jax_native._LIB_PATH).parent))


def test_native_library_builds_anew_in_a_given_dir(tmp_path):
    lib = native.require_library(build_dir=tmp_path / "native")
    assert native.library_path(tmp_path / "native").exists()
    assert native.load_library() is lib
    pos = np.random.default_rng(0).random((5, 3))
    np.testing.assert_allclose(
        native.distance_matrix_native(pos),
        np.linalg.norm(pos[:, None] - pos[None], axis=-1), atol=1e-12)
    # back to the checkout's library for the tests that follow
    assert native.require_library(build_dir=native.BUILD_DIR) is not lib


def shell_cases(tmp_path):
    """(name, port structure, JAX structure): random cubic cells, the
    fixtures and the texts above."""
    rng = np.random.default_rng(3)
    lat = cell.lattice_from_parameters(6.0, 6.0, 6.0, 90, 90, 90)
    for i in range(2):
        frac = rng.random((12, 3))
        species = ["O" if i % 3 else "Si" for i in range(12)]
        yield (f"random{i}", cell.CellStructure(lat, frac, species, 0),
               jax_cell.CellStructure(lat, frac, species, 0))
    for p in cell_paths(tmp_path):
        yield p, cell.read_castep_cell(p), jax_cell.read_castep_cell(p)


def close_graphs(got: dict, want: dict):
    """The same sites in the same order; positions to 1e-6 A."""
    assert sorted(got) == sorted(want)
    for k in ("species", "spectrum", "exo", "id"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["pos"], want["pos"], rtol=0, atol=1e-6)


def makefile_flags() -> list:
    """The compiler flags ``native/Makefile`` builds the JAX package's
    library with."""
    text = (NATIVE / "Makefile").read_text()
    return re.search(r"^CXXFLAGS\s*\?=(.*)$", text, re.M).group(1).split()


@pytest.fixture(scope="session")
def jax_flags_library(tmp_path_factory) -> str:
    """The JAX package's library as its Makefile builds it, compiled by this
    process under a temporary name and renamed into place."""
    out = tmp_path_factory.mktemp("jax_native") / "libgraphbuild.so"
    tmp = out.with_suffix(".tmp.so")
    subprocess.run([shutil.which("g++") or "g++", *makefile_flags(),
                    str(NATIVE / "graphbuild.cpp"), "-o", str(tmp)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)
    return str(out)


def use_jax_library(monkeypatch, path: str) -> None:
    """Point the JAX module at the library ``path``, loaded afresh."""
    monkeypatch.setattr(jax_native, "_LIB_PATH", path)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_load_failed", False)


@pytest.fixture
def jax_library(jax_flags_library, monkeypatch) -> str:
    use_jax_library(monkeypatch, jax_flags_library)
    assert jax_native.available()
    return jax_flags_library


@pytest.mark.parametrize("n_shells", [1, 2, 3])
def test_shells_match_jax_and_native_matches_numpy(tmp_path, n_shells,
                                                   jax_library):
    """The numpy routes bit for bit; the port's library selects as both
    numpy routes do. In ``CUBIC`` two Si images lie exactly 2.0 A apart,
    the cutoff: there the JAX package's own library (built with
    ``-march=native``, whose fused multiply-adds round the distance below
    2.0) takes one more site than its numpy route, and the port's follows
    the numpy route."""
    spectrum = np.linspace(0, 1, 16, dtype=np.float32)
    apart = set()
    for name, got, want in shell_cases(tmp_path):
        port_np = shells.build_graph(got, n_shells, spectrum, "x",
                                     use_native=False)
        jax_np = jax_shells.build_graph(want, n_shells, spectrum, "x",
                                        use_native=False)
        same_graph(port_np, jax_np)
        port_native = shells.build_graph(got, n_shells, spectrum, "x",
                                         use_native=True)
        close_graphs(port_native, port_np)
        jax_lib = jax_shells.build_graph(want, n_shells, spectrum, "x",
                                         use_native=True)
        if jax_lib["pos"].shape == jax_np["pos"].shape:
            close_graphs(port_native, jax_lib)
        else:
            apart.add(Path(name).stem)
    assert apart <= {"cubic"}


def test_native_distance_and_knn_match_jax(jax_library):
    rng = np.random.default_rng(4)
    pos = rng.normal(0, 2, (20, 3))
    got = native.distance_matrix_native(pos)
    diff = pos[:, None] - pos[None, :]
    np.testing.assert_array_equal(got, np.sqrt((diff * diff).sum(-1)))
    # the JAX package's library contracts to fused multiply-adds
    np.testing.assert_allclose(got, jax_native.distance_matrix_native(pos),
                               rtol=1e-15, atol=0)
    np.testing.assert_array_equal(native.knn_indices_native(pos, 5),
                                  jax_native.knn_indices_native(pos, 5))


def test_a_half_written_jax_library_does_not_fail_the_comparison(
        tmp_path, monkeypatch, jax_flags_library):
    """The race: the JAX module finds a library cut short (its ELF header
    written and no more: another process's linker still at work), fails
    to load it and keeps the failure, so its native routines raise. The
    comparison then runs against the library ``jax_library`` builds, and
    passes."""
    cut = tmp_path / "libgraphbuild.so"
    cut.write_bytes(Path(jax_flags_library).read_bytes()[:64])
    use_jax_library(monkeypatch, str(cut))
    assert not jax_native.available()
    assert jax_native._load_failed
    with pytest.raises(RuntimeError, match="native library unavailable"):
        jax_native.distance_matrix_native(np.zeros((3, 3)))
    use_jax_library(monkeypatch, jax_flags_library)
    test_native_distance_and_knn_match_jax(jax_flags_library)


@pytest.mark.parametrize("nn_range", ["1NN", "2NN", "3NN", "4NN"])
def test_build_dataset_matches_jax(tmp_path, nn_range):
    corpus = tmp_path / "corpus"
    shutil.copytree(CASTEP, corpus)
    (corpus / "not_a_sample").mkdir()
    for use_native in (False, True):
        got = shells.build_dataset(str(corpus), nn_range,
                                   use_native=use_native)
        want = jax_shells.build_dataset(str(corpus), nn_range,
                                        use_native=False)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            if use_native:
                np.testing.assert_allclose(g["pos"], w["pos"], atol=1e-6)
                g = {**g, "pos": w["pos"]}
            same_graph(g, w)
    with pytest.raises(ValueError, match="range"):
        shells.build_dataset(str(corpus), "5NN")


# -- the polymorph corpus -------------------------------------------

def read_tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kw", [dict(), dict(seed=3, n_rattles=1,
                                             max_sites_per_polymorph=2)])
def test_corpus_is_the_jax_packages_byte_for_byte(tmp_path, kw):
    got = polymorphs.write_corpus(str(tmp_path / "port"), **kw)
    want = jax_polymorphs.write_corpus(str(tmp_path / "jax"), **kw)
    assert got == want
    if not kw:
        assert len(got) == 46
    assert read_tree(tmp_path / "port") == read_tree(tmp_path / "jax")


def test_polymorph_geometry_matches_jax():
    for poly, jpoly in zip(polymorphs.POLYMORPHS, jax_polymorphs.POLYMORPHS):
        assert polymorphs._structure(poly) == jax_polymorphs._structure(jpoly)
        np.testing.assert_array_equal(
            polymorphs.lattice_matrix(poly["abc"], poly["angles"]),
            jax_polymorphs.lattice_matrix(jpoly["abc"], jpoly["angles"]))
        for o in range(3):
            assert (polymorphs.local_geometry(poly, o)
                    == jax_polymorphs.local_geometry(jpoly, o))


# -- frames, io, legacy, qm9 ----------------------------------------

def test_frames_match_jax():
    rng = np.random.default_rng(5)
    symbols = ["O", "Si", "Si", "O", "O"]
    for _ in range(4):
        pos = rng.normal(0, 1.5, (5, 3))
        np.testing.assert_array_equal(
            frames.center_of_mass(pos, symbols),
            jax_frames.center_of_mass(pos, symbols))
        np.testing.assert_array_equal(frames.align_exo_frame(pos, symbols),
                                      jax_frames.align_exo_frame(pos,
                                                                 symbols))
        np.testing.assert_array_equal(frames.pad_and_flatten(pos[:3]),
                                      jax_frames.pad_and_flatten(pos[:3]))
    for v in ([1.0, 0, 0], [-2.0, 0, 0], [0.3, -0.2, 0.9]):
        np.testing.assert_array_equal(frames.rotation_matrix_to_x(v),
                                      jax_frames.rotation_matrix_to_x(v))


def graphs_of(seed: int, count: int = 5) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = int(rng.integers(2, 7))
        out.append({"pos": rng.normal(size=(n, 3)).astype(np.float32),
                    "species": np.eye(2, dtype=np.float32)[
                        rng.integers(0, 2, n)],
                    "spectrum": rng.random((n, 12)).astype(np.float32),
                    "exo": np.eye(n, 1, dtype=np.float32),
                    "id": f"g{i}"})
    return out


def test_datasets_round_trip_between_the_packages(tmp_path):
    graphs = graphs_of(6)
    io.save_dataset(graphs, str(tmp_path / "port.npz"))
    jax_io.save_dataset(graphs, str(tmp_path / "jax.npz"))
    for path in ("port.npz", "jax.npz"):
        got = io.load_dataset(str(tmp_path / path))
        want = jax_io.load_dataset(str(tmp_path / path))
        assert len(got) == len(want) == len(graphs)
        for g, w in zip(got, want):
            same_graph(g, w)
        small = io.resize_spectra(got, 5)
        for g, w in zip(small, jax_io.resize_spectra(want, 5)):
            same_graph(g, w)
            assert g["spectrum"].shape[1] == 5


def legacy_records(seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    records = []
    for i in range(5):
        n = 1 if i == 2 else int(rng.integers(2, 6))
        atoms = [[list(np.eye(2)[rng.integers(0, 2)]),
                  list(rng.normal(size=3))] for _ in range(n)]
        records.append([f"mp-{i}", list(rng.random(10)), atoms])
    arr = np.empty(len(records), dtype=object)
    arr[:] = records
    return arr


def test_legacy_npy_matches_jax(tmp_path):
    records = legacy_records()
    got, want = legacy.npy_to_graphs(records), jax_legacy.npy_to_graphs(
        records)
    assert len(got) == len(want) == 4   # the one-atom record is dropped
    for g, w in zip(got, want):
        same_graph(g, w)
    np.save(tmp_path / "legacy.npy", records, allow_pickle=True)
    for g, w in zip(legacy.load_npy_dataset(str(tmp_path / "legacy.npy")),
                    want):
        same_graph(g, w)


GDB9 = """{na}
gdb {idx}\t157.7\t157.7\t157.7\t0.\t13.21\t-0.3877\t0.1171\t0.5048\t35.36\t0.044749\t-40.47893\t-40.476062\t-40.475117\t-40.498597\t6.469
{atoms}
100.1\t200.2\t300.3
C\tC
InChI=1S/CH4/h1H4\tInChI=1S/CH4/h1H4
"""


def write_qm9(root: Path, count: int = 6) -> Path:
    root.mkdir()
    rng = np.random.default_rng(8)
    for i in range(count):
        n = int(rng.integers(3, 7))
        elems = [qm9.QM9_SPECIES[j] for j in rng.integers(0, 5, n)]
        coords = np.round(rng.normal(0, 1.2, (n, 3)), 6)
        lines = [f"{e}\t{x}\t{y}\t{z}\t-0.5" for e, (x, y, z)
                 in zip(elems, coords)]
        # the *^ exponent of the raw files
        lines[0] = lines[0].split("\t")[0] + "\t1.6991*^-6\t0.5\t-0.25\t0.1"
        (root / f"dsgdb9nsd_{i:06d}.xyz").write_text(GDB9.format(
            na=n, idx=i + 1, atoms="\n".join(lines)))
    return root


def test_qm9_matches_jax(tmp_path):
    root = write_qm9(tmp_path / "qm9")
    files = sorted(os.listdir(root))
    for f in files:
        same_graph(qm9.read_qm9_xyz(str(root / f), 16),
                   jax_qm9.read_qm9_xyz(str(root / f), 16))
    assert qm9.read_qm9_xyz(str(root / files[0]))["pos"][0, 0] == \
        np.float32(1.6991e-6)
    for kw in (dict(), dict(limit=3, seed=11)):
        got = qm9.load_qm9_dataset(str(root), **kw)
        want = jax_qm9.load_qm9_dataset(str(root), **kw)
        assert [g["id"] for g in got] == [w["id"] for w in want]
        for g, w in zip(got, want):
            same_graph(g, w)
    bad = tmp_path / "bad.xyz"
    bad.write_text(GDB9.format(na=1, idx=1, atoms="Xe\t0\t0\t0\t0"))
    with pytest.raises(ValueError, match="element"):
        qm9.read_qm9_xyz(str(bad))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        qm9.load_qm9_dataset(str(tmp_path / "empty"))


# -- legacy beta schedules ------------------------------------------

@pytest.mark.parametrize("kind", ["sigmoid", "linear"])
@pytest.mark.parametrize("timesteps", [20, 1000])
def test_beta_schedules_match_jax(kind, timesteps):
    import jax.numpy as jnp

    from diffusion_model_tpu.ops import schedules as jax_schedules

    for lo, hi in ((1e-4, 2e-2), (1e-7, 2e-3)):
        want = np.asarray(jax_schedules.beta_schedule(kind, lo, hi,
                                                      timesteps))
        got = schedules.beta_schedule(kind, lo, hi, timesteps)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(
            schedules.ddpm_alpha_bar(torch.from_numpy(want.copy())).numpy(),
            np.asarray(jax_schedules.ddpm_alpha_bar(jnp.asarray(want))))
    with pytest.raises(ValueError, match="beta schedule"):
        schedules.beta_schedule("cosine", 1e-4, 2e-2, timesteps)
