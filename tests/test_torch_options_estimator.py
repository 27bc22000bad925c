"""Port parity of the estimator's options against the JAX package, float64,
with both packages' schedules shortened alike:

* ``estimate_kinematics`` with ``shutter_delay_estimation`` on a written
  3-camera, 18-frame trial directory whose camera 2 sees the scene 0.4
  frame periods late: the live-shutter solve and the joint (q, tau) solve.
  The delays (camera 0 exactly 0) within 1e-6 h, q and the objective
  within 1e-6, the saved files with the JAX writer's layout (the same
  names, pickle keys and shapes, CSV header lines byte for byte) and the
  delay-corrected reprojections within 1e-6 px, ``solution_details``;
* the rolling AR refinement (``motion_prior_rolling=1``) of the serial
  path's data-driven mode (``estimate_kinematics``) on the first trial of
  ``test_torch_cli.py``'s tree, and of the batched path
  (``run_monocular_batched``; slow, with a port-only twin).
"""
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.pipeline import batched as jpb
from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

from test_torch_cli import CAM, PATHS, TRIALS, _short_schedules, tree  # noqa
from test_torch_serial_kinematics import (SHORT, check_estimate_kinematics,
                                          pose_tables)

torch.set_num_threads(1)
PATH = os.path.join("2019_03_07", "phantom", "run")
TAU_H = 0.4


def render_delayed(root, n_frames=18, n_cams=3, seed=3):
    """A trial directory (the JAX package's writer) whose camera 2's
    detections are moved along their image velocity by TAU_H frame
    periods. Returns h."""
    subject = jparams.get_subject("phantom")
    q = jsyn.gallop_trajectory(n_frames, seed=seed)
    markers = np.asarray(jsyn.sk.fk_markers(q, subject))
    scene = jsyn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=n_cams,
                              seed=seed)
    tr = jsyn.synthesize(q, subject, scene, noise_px=1.0, outlier_frac=0.0,
                         drop_frac=0.0, seed=seed, subject_name="phantom")
    h = 1.0 / scene.fps
    meas = np.array(tr.meas)
    vel = np.zeros_like(meas[..., 0])
    vel[1:] = (meas[1:, ..., 0] - meas[:-1, ..., 0]) / h
    meas[:, 2, :, :, 0] += TAU_H * h * vel[:, 2]
    jsyn.write_trial_dir(tr._replace(meas=meas), root, PATH,
                         ground_plane_height=jcon.estimate_ground_height(
                             q, subject))
    return h


def _csv_rows(path):
    with open(path, encoding="utf-8") as f:
        lines = f.read().splitlines()
    head = [ln for ln in lines if not ln[:1].isdigit()]
    vals = np.array([[float(x) if x else np.nan for x in ln.split(",")[1:]]
                     for ln in lines if ln[:1].isdigit()])
    return head, vals


def test_estimate_kinematics_shutter_matches_jax(tmp_path, monkeypatch):
    from chip_smoke import describe

    root = str(tmp_path / "videos")
    h = render_delayed(root)
    for fte in (jkin.KinematicFTE, tkin.KinematicFTE):
        monkeypatch.setattr(fte.make_solver, "__defaults__",
                            (SHORT,) + fte.make_solver.__defaults__[1:])
        monkeypatch.setattr(fte.make_joint_shutter_solver, "__defaults__",
                            (10,) + fte.make_joint_shutter_solver
                            .__defaults__[1:])
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    ej = jest.init_trajectory(root, PATH, "phantom",
                              shutter_delay_estimation=True)
    assert jest.estimate_kinematics(ej, out_dir_prefix=jout)
    et = test_.init_trajectory(root, PATH, "phantom",
                               shutter_delay_estimation=True)
    assert test_.estimate_kinematics(et, out_dir_prefix=tout,
                                     dtype=torch.float64, device="cpu")
    tj, tt = np.asarray(ej.shutter_delay), et.shutter_delay
    assert tj[0] == tt[0] == 0.0
    assert np.abs(tj - tt).max() <= 1e-6 * h
    assert np.array_equal(et.data.sd_tau, tt)
    assert np.abs(ej.q - et.q).max() <= 1e-6 * max(1.0, np.abs(ej.q).max())
    assert abs(ej.obj_cost - et.obj_cost) <= 1e-6 * max(1.0,
                                                         abs(ej.obj_cost))
    # the saved files
    dj, dt = (os.path.join(o, PATH, "fte_kinematic") for o in (jout, tout))
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    with open(os.path.join(dj, "fte.pickle"), "rb") as f:
        a = pickle.load(f)
    with open(os.path.join(dt, "fte.pickle"), "rb") as f:
        b = pickle.load(f)
    assert describe(a) == describe(b)
    for name in sorted(os.listdir(dj)):
        if name.endswith(".csv"):
            (hj, vj), (ht, vt) = (_csv_rows(os.path.join(d, name))
                                  for d in (dj, dt))
            assert hj == ht
            assert np.array_equal(np.isnan(vj), np.isnan(vt))
            assert np.nanmax(np.abs(vj - vt)) <= 1e-6, name
    # the delay moves camera 2's reprojections (the shift is saved)
    _, v2 = _csv_rows(os.path.join(dt, "cam3_fte.csv"))
    et.shutter_delay = None
    et.save("no_shift", out_dir_prefix=tout)
    _, v0 = _csv_rows(os.path.join(tout, PATH, "no_shift", "cam3_fte.csv"))
    assert np.nanmax(np.abs(v2 - v0)) > 0.1
    details = et.solution_details()
    assert sorted(details) == ["cost", "limit", "measurement", "model",
                               "motion", "pose"]
    ej.fte = jkin.KinematicFTE(ej.fte.config, ej.subject)
    jd = ej.solution_details()
    for k, v in jd.items():
        assert abs(details[k] - v) <= 1e-6 * max(1.0, abs(v)), k


def test_rolling_ar_serial_matches_jax(tree, tmp_path, monkeypatch):
    check_estimate_kinematics(tree, tmp_path, monkeypatch, "data-driven",
                              motion_prior_rolling=1)


def _batched_dd(tree, tmp_path, monkeypatch):
    """The batched data-driven mode's setup of ``test_torch_cli.py``:
    priors on small procedural tables, schedules shortened alike."""
    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda

    dset = pose_tables(tmp_path)
    _short_schedules(monkeypatch)
    scan = ((1.0, 4),)
    d = jda.make_depth_linescan.__defaults__
    monkeypatch.setattr(jda.make_depth_linescan, "__defaults__",
                        d[:2] + (scan,) + d[3:])
    monkeypatch.setattr(tpb.run_data_driven, "__defaults__",
                        (((10.0, 3), (3.0, 3), (1.0, 8)), scan, None))
    return tree[0], dset


def _saved_q(out, p):
    with open(os.path.join(out, p, f"fte_kinematic_{CAM}", "fte.pickle"),
              "rb") as f:
        return pickle.load(f)["q"]


@pytest.mark.slow
def test_rolling_ar_batched_matches_jax(tree, tmp_path, monkeypatch):
    """Slow (the JAX package compiles the batched data-driven mode); its
    tier-1 twin is :func:`test_rolling_ar_batched_moves_the_anchors`."""
    root, dset = _batched_dd(tree, tmp_path, monkeypatch)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jpb.run_monocular_batched(root, jout, TRIALS, modes=("data-driven",),
                              data_driven_dataset=dset, dtype=jnp.float64,
                              motion_prior_rolling=1, mesh=None,
                              verbose=False)
    tpb.run_monocular_batched(root, tout, TRIALS, modes=("data-driven",),
                              data_driven_dataset=dset, dtype=torch.float64,
                              motion_prior_rolling=1, device="cpu",
                              verbose=False)
    for p in PATHS:
        a, b = _saved_q(jout, p), _saved_q(tout, p)
        assert np.abs(a - b).max() <= 1e-6 * max(1.0, np.abs(a).max()), p


def test_rolling_ar_batched_moves_the_anchors(tree, tmp_path, monkeypatch):
    """The port's batched data-driven mode with one rolling refinement:
    the dd solve runs once more, from its own solution, with the anchors
    recomputed from that solution on every real frame; the results are
    finite and differ from those without the refinement."""
    root, dset = _batched_dd(tree, tmp_path, monkeypatch)
    calls = []
    orig = tpb._anchors

    def anchors(mm, qs, fv):
        calls.append(qs.copy())
        return orig(mm, qs, fv)

    monkeypatch.setattr(tpb, "_anchors", anchors)
    outs = {}
    for r in (0, 1):
        calls.clear()
        outs[r] = str(tmp_path / f"port{r}")
        tpb.run_monocular_batched(root, outs[r], TRIALS,
                                  modes=("data-driven",),
                                  data_driven_dataset=dset,
                                  dtype=torch.float64,
                                  motion_prior_rolling=r, device="cpu",
                                  verbose=False)
        n_calls = len(calls)
        if r == 0:
            base_calls = n_calls
    assert n_calls == base_calls + 1
    moved = 0.0
    for p in PATHS:
        a, b = _saved_q(outs[0], p), _saved_q(outs[1], p)
        assert np.isfinite(b).all()
        moved = max(moved, np.abs(a - b).max())
    assert moved > 0.0
