"""Port parity of the AcinoSet interchange IO: each file written by one
package is read by the other. DLC tables, scene and metadata JSON,
fte.pickle and the per-camera reprojection CSV.

Tolerances: the port writes floats as ``repr`` and parses them exactly, as
the JAX writer (pandas) writes them, so files written from the same arrays
are byte-identical and the port reads the JAX files exactly. pandas' default
CSV parser is not exact (observed 3.6e-15 normwise on pose tables; 2e-14
elementwise on a value of 1.9e-4), so the JAX reader of a port file is held
to 4e-15 normwise: max |a - b| / max |b|.
"""
import os

import numpy as np
import pandas as pd
import pytest

from cheetah_pose_estimation_tpu.data import io as jio
from cheetah_pose_estimation_tpu.models.skeleton import MARKERS
from cheetah_pose_estimation_tpu_torch.data import io as tio

TOL = 4e-15


def _tables(seed, n=12, L=24):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-50.0, 2800.0, size=(n, L, 2))
    lik = rng.uniform(0.0, 1.0, size=(n, L))
    xy[3, 5] = np.nan                      # a missing detection
    xy[0, 0, 0] = 1e-300
    xy[1, 1, 1] = -0.0
    return xy, lik


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(a)
    assert np.abs(a[m] - b[m]).max() <= tol * np.abs(b[m]).max()


def test_dlc_table_written_by_each_read_by_other(tmp_path):
    xy, lik = _tables(0)
    jio.save_dlc_table(str(tmp_path / "jax" / "cam1.h5"), xy, lik,
                       start_frame=7)
    tio.save_dlc_table(str(tmp_path / "port" / "cam1.h5"), xy, lik,
                       start_frame=7)
    jtxt = (tmp_path / "jax" / "cam1.csv").read_text()
    ptxt = (tmp_path / "port" / "cam1.csv").read_text()
    assert ptxt.splitlines()[:3] == jtxt.splitlines()[:3]
    assert ptxt == jtxt
    # the port reads the JAX file exactly
    t = tio.load_dlc_table(str(tmp_path / "jax" / "cam1.csv"))
    assert t.names == tio.DLC_LEVELS
    assert t.columns == [(jio.DLC_SCORER, bp, c) for bp in MARKERS
                         for c in ("x", "y", "likelihood")]
    assert list(t.index) == list(range(7, 19))
    data = np.concatenate([xy, lik[..., None]], 2).reshape(12, -1)
    assert np.array_equal(np.isnan(t.values), np.isnan(data))
    assert np.array_equal(np.nan_to_num(t.values), np.nan_to_num(data))
    # the JAX (pandas) reader reads the port file
    df = jio.load_dlc_table(str(tmp_path / "port" / "cam1.csv"))
    assert list(df.columns) == t.columns
    _close(df.to_numpy(), data)


def test_dlc_points_across_packages(tmp_path):
    for c in range(3):
        xy, lik = _tables(c + 1)
        jio.save_dlc_table(str(tmp_path / "jax" / f"cam{c + 1}.h5"), xy, lik)
        tio.save_dlc_table(str(tmp_path / "port" / f"cam{c + 1}.csv"), xy,
                           lik)
    # the JAX tree also holds .h5 tables; the port reads them, as JAX does
    assert (tmp_path / "jax" / "cam1.h5").exists()
    pj = tio.load_dlc_points(str(tmp_path / "jax"), 3, use_native=False)
    jp = jio.load_dlc_points(str(tmp_path / "port"), 3, use_native=False)
    jj = jio.load_dlc_points(str(tmp_path / "jax"), 3, use_native=False)
    assert pj[2] == jp[2] == jj[2] == list(MARKERS)
    for a, b in ((pj[0], jj[0]), (pj[1], jj[1])):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.nan_to_num(a), np.nan_to_num(b))
    _close(jp[0], jj[0])
    _close(jp[1], jj[1])


def test_h5_only_directory_names_the_missing_reader(tmp_path):
    """An ``.h5``-only directory (the JAX writer's table, no ``.csv``) reads
    through the port's own HDF5 reader as JAX reads it; a ``.h5`` path with
    neither form on disk names the missing file."""
    xy, lik = _tables(0)
    jio.save_dlc_table(str(tmp_path / "cam1.h5"), xy, lik, write_csv=False)
    a = tio.load_dlc_points(str(tmp_path))
    b = jio.load_dlc_points(str(tmp_path))
    for x, y in zip(a[:2], b[:2]):
        assert np.array_equal(x, y, equal_nan=True)
    assert a[2] == list(b[2])
    t = tio.load_dlc_table(str(tmp_path / "cam1.h5"))
    assert np.array_equal(t.values, jio.load_dlc_table(
        str(tmp_path / "cam1.h5")).to_numpy(), equal_nan=True)
    with pytest.raises(FileNotFoundError, match="cam2.csv"):
        tio.load_dlc_table(str(tmp_path / "cam2.h5"))


def test_scene_and_metadata_json(tmp_path):
    rng = np.random.default_rng(3)
    K = rng.normal(size=(4, 3, 3))
    D = rng.normal(size=(4, 4))
    R = rng.normal(size=(4, 3, 3))
    t = rng.normal(size=(4, 3))
    for pkg, root in ((jio, tmp_path / "jax"), (tio, tmp_path / "port")):
        pkg.save_scene(str(root / "extrinsic_calib" / "4_cam_scene_sba.json"),
                       K, D, R, t, (2704, 1520))
        pkg.save_metadata(str(root / "trial"), 3, 51,
                          ground_plane_height=-0.0123456789,
                          monocular_cam=2)
    for name in ("extrinsic_calib/4_cam_scene_sba.json",
                 "trial/metadata.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    # found walking up from the trial directory, read by the other package
    for a, b in ((tio, tmp_path / "jax"), (jio, tmp_path / "port")):
        k, d, r, tt, res, n, path = a.find_scene_file(str(b / "trial"))
        assert n == 4 and tuple(res) == (2704, 1520)
        for x, y in ((k, K), (d.reshape(4, 4), D), (r, R),
                     (tt.reshape(4, 3), t)):
            assert np.array_equal(x, y)
        assert a.load_metadata(str(b / "trial")) == {
            "start_frame": 3, "end_frame": 51, "cam_sync": [],
            "ground_plane_height": -0.0123456789, "monocular_cam": 2}


def _fte_payload(seed):
    rng = np.random.default_rng(seed)
    n = 9
    return dict(
        positions=rng.normal(size=(n, 24, 3)), x=rng.normal(size=(n, 28)),
        dx=rng.normal(size=(n, 28)), ddx=rng.normal(size=(n, 28)),
        q=rng.normal(size=(n, 54)), dq=rng.normal(size=(n, 54)),
        ddq=rng.normal(size=(n, 54)), com_pos=rng.normal(size=(n, 3)),
        com_vel=rng.normal(size=(n - 1, 3)),
        tau={"neck": rng.normal(size=(n, 2))},
        meas_err=rng.normal(size=(n, 6, 24, 2, 1)), obj_cost=12.5,
        processing_time_s=0.25, start_frame=4)


def test_fte_pickle_across_packages(tmp_path):
    p = _fte_payload(0)
    jio.save_fte_pickle(str(tmp_path / "jax" / "fte.pickle"),
                        p["positions"], **{k: v for k, v in p.items()
                                           if k != "positions"})
    tio.save_fte_pickle(str(tmp_path / "port" / "fte.pickle"),
                        p["positions"], **{k: v for k, v in p.items()
                                           if k != "positions"})
    a = tio.load_fte_pickle(str(tmp_path / "jax" / "fte.pickle"))
    b = jio.load_fte_pickle(str(tmp_path / "port" / "fte.pickle"))
    assert list(a) == list(b) == list(p)
    for k, v in p.items():
        if isinstance(v, dict):
            assert a[k].keys() == b[k].keys() == v.keys()
            for kk in v:
                assert np.array_equal(a[k][kk], v[kk])
                assert np.array_equal(b[k][kk], v[kk])
        else:
            assert np.array_equal(a[k], v) and np.array_equal(b[k], v)


def _project(X, k, d, r, t):
    """A plain numpy pinhole projection, the same function for both
    packages (the IO is under test here, not the camera model)."""
    Xc = X @ np.asarray(r).T + np.asarray(t).reshape(3)
    ab = Xc[:, :2] / Xc[:, 2:3]
    return ab * np.diag(k)[:2] + k[:2, 2]


def test_reprojection_csv_across_packages(tmp_path):
    rng = np.random.default_rng(4)
    n, C = 7, 3
    pos = [rng.normal(scale=2.0, size=(n, 24, 3)) + np.array([0, 0, 8.0])
           for _ in range(C)]
    K = np.tile(np.array([[1400.0, 0, 1352], [0, 1400.0, 760], [0, 0, 1]]),
                (C, 1, 1))
    D = np.zeros((C, 4))
    R = np.tile(np.eye(3), (C, 1, 1))
    t = rng.normal(scale=0.1, size=(C, 3, 1))
    for pkg, name in ((jio, "jax"), (tio, "port")):
        pkg.save_3d_cheetah_as_2d(pos, str(tmp_path / name), K, D, R, t,
                                  (2704, 1520), _project, 5, [0, 2, 0])
    for c in range(C):
        f = f"cam{c + 1}_fte.csv"
        jtxt = (tmp_path / "jax" / f).read_text()
        assert (tmp_path / "port" / f).read_text() == jtxt
        tab = tio.read_table(str(tmp_path / "jax" / f), 2)
        df = jio.load_reprojection_table(str(tmp_path / "port" / f))
        assert tab.columns == list(df.columns)
        assert list(tab.index) == list(df.index)
        _close(df.to_numpy(), tab.values)
        # out-of-frame points are NaN, and the likelihood column is empty
        assert np.isnan(tab.values[:, 2::3]).all()
        assert np.isnan(tab.values).any()
    assert isinstance(df, pd.DataFrame)
    assert not os.path.exists(tmp_path / "port" / "cam1_fte.h5")
