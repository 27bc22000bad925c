"""Port parity of the native DLC reader (``native/``, a copy of the JAX
package's C++ source with its own build) and of ``data/io.load_dlc_points``'
two reads.

Tolerances: none. Both packages' C++ parsers run the same code, so their
float32 parses are equal to the bit, NaNs included, on tables whose floats
are float32-exact and on tables rendered in float64 (as the port renders
them). The port's exact reader equals pandas' (JAX ``use_native=False``,
and JAX's read of ``.h5`` tables) within pandas' round-off
(``tests/test_torch_io.py``, 4e-15 normwise).
"""
import os

import numpy as np
import pytest

from cheetah_pose_estimation_tpu import native as jnative
from cheetah_pose_estimation_tpu.data import io as jio
from cheetah_pose_estimation_tpu.models.skeleton import MARKERS
from cheetah_pose_estimation_tpu_torch import native as tnative
from cheetah_pose_estimation_tpu_torch.data import io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed, n=100, L=24, float32=False):
    """Pixels around 900 +- 500 with missing detections and likelihoods."""
    rng = np.random.default_rng(seed)
    xy = rng.normal(size=(n, L, 2)) * 500 + 900
    lik = rng.uniform(size=(n, L))
    xy[rng.uniform(size=(n, L)) < 0.02] = np.nan
    if float32:
        xy, lik = (a.astype(np.float32).astype(np.float64) for a in (xy, lik))
    return xy, lik


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Two 4-camera DLC directories: written by the JAX package from
    float32-exact arrays, and by the port from float64 arrays."""
    root = tmp_path_factory.mktemp("native")
    for c in range(4):
        xy, lik = _arrays(c, float32=True)
        jio.save_dlc_table(str(root / "jax" / f"cam{c + 1}.h5"), xy, lik,
                           start_frame=3)
        os.remove(root / "jax" / f"cam{c + 1}.h5")
        xy, lik = _arrays(10 + c)
        tio.save_dlc_table(str(root / "port" / f"cam{c + 1}.csv"), xy, lik,
                           start_frame=5 + c)
    return {k: str(root / k) for k in ("jax", "port")}


def _paths(d):
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.endswith(".csv"))


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_parse_equals_jax_to_the_bit(trees, tree):
    for p in _paths(trees[tree]):
        assert tnative.probe_csv(p) == jnative.probe_csv(p)
        for a, b in zip(tnative.parse_dlc_csv(p), jnative.parse_dlc_csv(p)):
            _bits(a, b)
        xy = tnative.parse_dlc_csv(p)[0]
        assert xy.dtype == np.float32 and np.isnan(xy).any()


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_load_tables_threads_equal_single_parses(trees, tree):
    paths = _paths(trees[tree])
    tables = tnative.load_tables(paths, n_threads=4)
    assert len(tables) == 4
    for p, t in zip(paths, tables):
        for a, b in zip(t, tnative.parse_dlc_csv(p)):
            _bits(a, b)
    for t, j in zip(tables, jnative.load_tables(paths, n_threads=4)):
        for a, b in zip(t, j):
            _bits(a, b)


def test_gate_weights_equal_jax(trees):
    lik = tnative.parse_dlc_csv(_paths(trees["port"])[0])[1]
    inv_R = np.random.default_rng(1).uniform(0.1, 1.0, 24).astype(np.float32)
    for thresh in (0.0, 0.5, 0.9):
        w = tnative.gate_weights(lik, inv_R, thresh)
        _bits(w, jnative.gate_weights(lik, inv_R, thresh))
        assert np.array_equal(w, np.where(lik > thresh, inv_R[None], 0.0)
                              .astype(np.float32))


@pytest.mark.parametrize("tree", ["jax", "port"])
def test_load_dlc_points_equals_jax_reads(trees, tree):
    """The default read is JAX's default (native) read to the bit; the
    exact read is JAX's pandas read (within pandas' round-off); on the
    float64-rendered tree the two reads differ by float32 rounding."""
    d = trees[tree]
    tn, jn = tio.load_dlc_points(d, 4), jio.load_dlc_points(d, 4)
    assert tn[2] == jn[2] == list(MARKERS)
    for a, b in zip(tn[:2], jn[:2]):
        _bits(a, b)
    te = tio.load_dlc_points(d, 4, use_native=False)
    je = jio.load_dlc_points(d, 4, use_native=False)
    assert te[2] == je[2]
    for a, b in zip(te[:2], je[:2]):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(a)
        assert np.abs(a[m] - b[m]).max() <= 4e-15 * np.abs(b[m]).max()
    gap = np.nanmax(np.abs(tn[0] - te[0]))
    if tree == "jax":
        assert gap == 0.0 and np.array_equal(tn[1], te[1])
    else:
        # float32 rounding: at most half a float32 ulp of the largest pixel
        half_ulp = np.spacing(np.float32(np.nanmax(np.abs(te[0])))) / 2
        assert 0.0 < gap <= half_ulp


def test_tree_with_h5_tables_reads_as_jax_does(tmp_path):
    """Beside ``.h5`` tables (a tree the JAX package wrote) JAX's default
    read takes the ``.h5`` tables exactly, so the port's default read does
    too: float64 arrays equal to JAX's."""
    for c in range(2):
        xy, lik = _arrays(20 + c, n=30)
        jio.save_dlc_table(str(tmp_path / f"cam{c + 1}.h5"), xy, lik)
    assert (tmp_path / "cam1.h5").exists()
    tn, jn = tio.load_dlc_points(str(tmp_path), 2), \
        jio.load_dlc_points(str(tmp_path), 2)
    te = tio.load_dlc_points(str(tmp_path), 2, use_native=False)
    for a, b, e in zip(tn[:2], jn[:2], te[:2]):
        assert np.array_equal(a, e, equal_nan=True)
        assert np.array_equal(np.isnan(a), np.isnan(b))
        m = ~np.isnan(a)
        assert np.abs(a[m] - b[m]).max() <= 4e-15 * np.abs(b[m]).max()
    assert not np.array_equal(tn[0].astype(np.float32).astype(float),
                              tn[0], equal_nan=True)


def test_failed_build_raises_without_fallback(trees, tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="no-such-g"):
        tnative.get_lib()
    assert tnative.available() is False
    with pytest.raises(RuntimeError, match="C\\+\\+ compiler"):
        tio.load_dlc_points(trees["port"], 4)
    with pytest.raises(RuntimeError):
        tnative.gate_weights(np.ones((2, 3)), np.ones(3), 0.5)
    assert not list((tmp_path / "build").glob("*.so"))
    # the exact reader does not need the library
    assert tio.load_dlc_points(trees["port"], 4, use_native=False)[0].shape \
        == (108, 4, 24, 2)


def test_compiler_error_is_reported(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        tnative.build()


def test_library_lands_under_build_native():
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR
    assert tnative.BUILD_DIR == __import__("pathlib").Path(
        REPO, "build", "native")
    assert path.exists() and path.suffix == ".so"
    assert tnative.available()
    assert not [f for f in os.listdir(os.path.dirname(tnative.__file__))
                if f.endswith(".so")]


def test_load_reprojection_table(tmp_path):
    xy = np.random.default_rng(2).uniform(0, 500, size=(6, 24, 2))
    pos = np.concatenate([xy, np.ones((6, 24, 1))], -1)
    ident = lambda X, K, D, R, t: X[..., :2]
    for pkg in (jio, tio):
        pkg.save_3d_cheetah_as_2d([pos], str(tmp_path / pkg.__name__),
                                  [np.eye(3)], [np.zeros(4)], [np.eye(3)],
                                  [np.zeros(3)], (600, 600), ident, 4)
    jt = jio.load_reprojection_table(
        str(tmp_path / jio.__name__ / "cam1_fte.csv"))
    for name in (jio.__name__, tio.__name__):
        for ext in (".csv", ".h5"):
            t = tio.load_reprojection_table(
                str(tmp_path / name / f"cam1_fte{ext}"))
            assert t.names == ("bodyparts", "coords")
            assert t.columns == list(jt.columns)
            assert list(t.index) == list(jt.index) == list(range(4, 10))
            assert np.array_equal(np.isnan(t.values), np.isnan(jt.to_numpy()))
            assert np.allclose(t.values, jt.to_numpy(), rtol=4e-15, atol=0,
                               equal_nan=True)
    with pytest.raises(FileNotFoundError, match="cam1_fte.csv"):
        tio.load_reprojection_table(str(tmp_path / "none" / "cam1_fte.h5"))
