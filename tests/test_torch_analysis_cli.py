"""Port parity of the dataset CLI's ``--run_analysis`` against the JAX
package, in float64, on a small JAX-made tree (one trial of 24 frames seen
by 6 fisheye cameras):

* ``run_monocular_all(batched=True)``: the multi-view ground truth once,
  then every camera as one lane of the default mode (6 lanes), both
  packages' schedules shortened alike: q of each (trial, camera) within
  1e-8 (the bar of the batched CLI's parity tests for these modes);
* ``run_monocular_all(batched=False)``: the same (trial, camera) list and
  modes handed to ``run_monocular``;
* the analysis functions fed the same pickles (the JAX run's solutions,
  with data-driven and physics-based ones made up from them):
  ``distance_from_camera``, ``is_outlier``, ``distance_vs_error``'s rows
  and the bytes of ``dist_vs_error.csv``, and
  ``results.example_robustness``'s values, all equal to 1e-9.
"""
import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.pipeline import batched as jpb
from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import results as jres
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu_torch.pipeline import results as tres
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd

from test_torch_cli import _short_schedules

torch.set_num_threads(1)
TRIAL = ("jules", "2019_03_09", "flick1")
PATH = os.path.join(TRIAL[1], TRIAL[0], TRIAL[2])
CAMS = 6


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """The tree, and ``run_monocular_all(batched=True)`` of both packages
    on it (default mode), in float64."""
    tmp = tmp_path_factory.mktemp("analysis")
    root = str(tmp / "videos")
    c, _, _ = TRIAL
    subject = jparams.get_subject(c)
    q = jsyn.gallop_trajectory(24, fps=120.0, seed=1)
    markers = np.asarray(jsyn.sk.fk_markers(q, subject))
    scene = jsyn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=CAMS,
                              fps=120.0, seed=1)
    tr = jsyn.synthesize(q, subject, scene, seed=1, subject_name=c,
                         occlusion_rate=2.0, confusion_rate=1.2)
    jsyn.write_trial_dir(tr, root, PATH, monocular_cam=2,
                         ground_plane_height=jcon.estimate_ground_height(
                             q, subject))
    jout, tout = str(tmp / "jax"), str(tmp / "port")
    orig = jpb.run_monocular_batched
    with pytest.MonkeyPatch.context() as mp:
        _short_schedules(mp)
        mp.setattr(jpb, "run_monocular_batched",
                   lambda *a, **k: orig(*a, dtype=jnp.float64, mesh=None,
                                        **k))
        jrd.run_monocular_all(root, jout, (TRIAL,), modes=("default",),
                              batched=True)
        rep = {}
        trd.run_monocular_all(root, tout, (TRIAL,), modes=("default",),
                              batched=True, dtype=torch.float64,
                              device="cpu", report=rep)
    return dict(root=root, jout=jout, tout=tout, rep=rep, tmp=tmp)


def _q(base, sub):
    with open(os.path.join(base, PATH, sub, "fte.pickle"), "rb") as f:
        return pickle.load(f)["q"]


@pytest.mark.parametrize("sub", ["fte_kinematic"] + [
    f"fte_kinematic_orig_{c}" for c in range(CAMS)])
def test_run_monocular_all_batched_matches_jax(sweep, sub):
    rep = sweep["rep"]
    assert rep["ground-truth"]["trials"] == [PATH]
    assert rep["default"]["trials"] == [PATH] * CAMS
    a, b = _q(sweep["jout"], sub), _q(sweep["tout"], sub)
    assert np.abs(a - b).max() <= 1e-8 * max(1.0, np.abs(a).max())


def test_run_monocular_all_serial_combinations(sweep, monkeypatch):
    """The serial form hands ``run_monocular`` the same (trial, camera)
    combinations and modes in both packages."""
    calls = {"jax": [], "port": []}

    def record(name):
        def run(root, prefix, test_set, cam_overrides=None, modes=(), **k):
            calls[name].append((tuple(test_set), list(cam_overrides),
                                tuple(modes)))
        return run

    monkeypatch.setattr(jrd, "run_monocular", record("jax"))
    monkeypatch.setattr(trd, "run_monocular", record("port"))
    test_set = (TRIAL, ("phantom", "2019_03_03", "run"))   # one is absent
    jrd.run_monocular_all(sweep["root"], "unused", test_set)
    trd.run_monocular_all(sweep["root"], "unused", test_set, device="cpu")
    assert calls["port"] == calls["jax"]
    assert [c[1] for c in calls["port"]] == [[c] for c in range(CAMS)]


@pytest.fixture(scope="module")
def solutions(sweep):
    """The JAX run's solutions, with data-driven (cameras 0-3) and
    physics-based (cameras 1-3) ones made up from them, in one directory
    that both packages' analysis functions read."""
    out = str(sweep["tmp"] / "solutions")
    shutil.copytree(sweep["jout"], out)
    rng = np.random.default_rng(0)
    for cam in range(4):
        for sub, scale in (("fte_kinematic", 0.01), ("fte_kinetic", 0.02)):
            if sub == "fte_kinetic" and cam == 0:
                continue
            e = jest.init_trajectory(sweep["root"], PATH, TRIAL[0],
                                     monocular_enable=True,
                                     override_monocular_cam=cam)
            q = _q(sweep["jout"], f"fte_kinematic_orig_{cam}")
            e.q = q + rng.normal(scale=scale, size=q.shape)
            e.obj_cost, e.opt_time_s = 1.0, 0.5
            e.save(f"{sub}_{cam}", out_dir_prefix=out)
    return out


@pytest.mark.parametrize("cam", range(CAMS))
def test_distance_from_camera_matches_jax(sweep, solutions, cam):
    with open(os.path.join(solutions, PATH, "fte_kinematic", "fte.pickle"),
              "rb") as f:
        com = np.asarray(pickle.load(f)["com_pos"])
    trial_dir = os.path.join(sweep["root"], PATH)
    for a, b in zip(jrd.distance_from_camera(trial_dir, com, cam),
                    trd.distance_from_camera(trial_dir, com, cam)):
        assert a.shape == b.shape == (24,)
        assert np.abs(a - b).max() <= 1e-9 * max(1.0, np.abs(a).max())


@pytest.mark.parametrize("thresh", [1.0, 3.5, 5.0])
def test_is_outlier_matches_jax(thresh):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=40), [9.0, -7.0, 30.0]])
    for pts in (x, x.reshape(-1, 1), np.stack([x, x[::-1]], 1),
                np.zeros(5)):
        a, b = jrd.is_outlier(pts, thresh), trd.is_outlier(pts, thresh)
        assert a.dtype == b.dtype == bool and np.array_equal(a, b)


def test_distance_vs_error_matches_jax(sweep, solutions):
    """The same rows (default for the 6 cameras, data-driven for 4,
    physics-based for 3) within 1e-9; the port's ``dist_vs_error.csv`` is
    the bytes pandas writes for its rows (the JAX file's floats come from
    another float64 camera model and differ in their last digits)."""
    import pandas as pd

    csv_path = os.path.join(solutions, "dist_vs_error.csv")
    df = jrd.distance_vs_error(sweep["root"], solutions, (TRIAL,))
    shutil.move(csv_path, csv_path + ".jax")
    rows = trd.distance_vs_error(sweep["root"], solutions, (TRIAL,))
    assert len(rows) == 13
    jrows = df.to_dict("records")
    assert [(r["trial"], r["cam"], r["mode"]) for r in rows] == \
        [(r["trial"], r["cam"], r["mode"]) for r in jrows]
    for a, b in zip(jrows, rows):
        for k in ("mpe_mm", "distance_m", "angle_deg"):
            assert abs(a[k] - b[k]) <= 1e-9 * max(1.0, abs(a[k]))
    with open(csv_path, encoding="utf-8") as f:
        assert f.read() == pd.DataFrame(rows).to_csv(index=False)
    with open(csv_path + ".jax", encoding="utf-8") as f:
        assert f.readline().strip() == ",".join(trd.DIST_COLUMNS)
    assert os.path.exists(os.path.join(solutions, "dist_vs_error.pdf"))


def test_rows_csv_is_pandas_bytes(tmp_path):
    """``write_rows_csv`` gives pandas' ``to_csv(index=False)`` bytes, also
    for floats that print in exponent form or without a fraction."""
    import pandas as pd

    rng = np.random.default_rng(5)
    rows = [dict(trial=PATH, cam=c, mode=m,
                 mpe_mm=float(rng.uniform(0, 500)),
                 distance_m=float(rng.uniform(5, 12)),
                 angle_deg=float(rng.uniform(0, 30)))
            for c in range(3) for m in ("default", "data-driven")]
    rows[1]["mpe_mm"], rows[2]["distance_m"] = 1e-05, 123456789.0
    rows[3]["angle_deg"] = 0.0
    path = str(tmp_path / "rows.csv")
    trd.write_rows_csv(path, rows, trd.DIST_COLUMNS)
    with open(path, "rb") as f:
        assert f.read() == pd.DataFrame(rows).to_csv(
            index=False).encode()


def test_example_robustness_matches_jax(sweep, solutions, capsys):
    """Cameras 1-3 have all three solutions: the same values per camera."""
    a = jres.example_robustness(sweep["root"], solutions, test_run=TRIAL)
    b = tres.example_robustness(solutions, test_run=TRIAL)
    assert sorted(a) == sorted(b)
    for k in a:
        assert len(a[k]) == len(b[k]) == 3
        assert np.abs(np.subtract(a[k], b[k])).max() <= 1e-9 * max(
            1.0, np.abs(a[k]).max())
    assert os.path.exists(os.path.join(solutions,
                                       "example-cam-robustness.pdf"))
