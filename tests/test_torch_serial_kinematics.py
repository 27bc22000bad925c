"""Port parity of the dataset CLI's serial per-trial kinematic path against
the JAX package, in float64, on the small JAX-made tree of
``test_torch_cli.py`` (2 trials of 24 frames, 3 cameras), with both
packages' schedules shortened alike (annealed solves (10, 3), (3, 3),
(1, 8); the polish and the line-scan 4 steps each):
``multistart_single``, ``prior_gate_accept`` with a guard ratio, and
``estimate_kinematics`` in the ground-truth and default modes (q within
1e-8, the bar of ``test_torch_cli.py``; the same polish decisions; the same
artifacts). The data-driven mode is in ``test_torch_serial_dd.py``, which
shares this file's helpers (the JAX package compiles every solve of every
trial anew, so the two files are spread over two workers)."""
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import io as jio
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.priors import dataset as jds
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch.parallel import batch as tbatch
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.priors import dataset as tds
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

from test_torch_cli import CAM, PATHS, TRIALS, tree  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "data"))
from jax_serial_reference import instrumented  # noqa: E402

torch.set_num_threads(1)
SHORT = ((10.0, 3), (3.0, 3), (1.0, 8))
MODES = {"ground-truth": (False, False), "default": (True, False),
         "data-driven": (True, True)}
KIN_MODES = ("ground-truth", "default")
TOL_Q = {"ground-truth": 1e-8, "default": 1e-8, "data-driven": 1e-6}


def serial_schedules(mp):
    """Both packages' serial schedules, shortened alike."""
    for fte in (jkin.KinematicFTE, tkin.KinematicFTE):
        mp.setattr(fte.make_solver, "__defaults__",
                   (SHORT,) + fte.make_solver.__defaults__[1:])
    for da in (jda, tda):
        mp.setattr(da, "POLISH_STAGES", ((1.0, 4),))
    d = jda.make_depth_linescan.__defaults__
    mp.setattr(jda.make_depth_linescan, "__defaults__",
               d[:2] + (((1.0, 4),),) + d[3:])
    mp.setattr(tda.make_depth_linescan, "__defaults__", (((1.0, 4),),))


def pose_tables(tmp_path):
    """Small procedural training and validation tables (the JAX package
    reads its validation table as .h5)."""
    priors = tmp_path / "priors"
    dset = str(priors / "dataset_full_pose.csv")
    tds.save_pose_dataset(dset, bench_lib.procedural_pose_table(
        (100, 101, 102), n_frames=80))
    tds.save_pose_dataset(str(priors / "validation_dataset.csv"),
                          bench_lib.procedural_pose_table((200,),
                                                          n_frames=80))
    jio._write_pandas_h5_table(str(priors / "validation_dataset.h5"),
                               jds.load_pose_dataset(
                                   str(priors / "validation_dataset.csv")))
    return dset


def _one_trial(root, i, monocular):
    (c, _, _), p = TRIALS[i], PATHS[i]
    kw = dict(monocular_enable=monocular)
    return (jest.init_trajectory(root, p, c, **kw),
            test_.init_trajectory(root, p, c, **kw))


def test_multistart_single_matches_jax(tree, monkeypatch):
    """The three heading restarts of one trial's default solve (the 120 fps
    trial) as one 3-lane batch: the same restart picked, q within 1e-8."""
    root, _ = tree
    monkeypatch.setattr(tkin.KinematicFTE.make_solver, "__defaults__",
                        (SHORT,) + tkin.KinematicFTE.make_solver
                        .__defaults__[1:])
    i = 1
    ej, _ = _one_trial(root, i, True)
    # the monocular initialisation of this trial
    et = tpb._prepare(root, PATHS[i], TRIALS[i][0], None, True)
    q0 = et.q0
    jrun = jkin.KinematicFTE(jkin.KinematicConfig(), ej.subject) \
        .make_solver(stages=SHORT)
    sj = jbatch.multistart_single(jrun, jnp.asarray(q0), ej.data)
    trun = tkin.KinematicFTE(tkin.KinematicConfig(), et.subject) \
        .make_solver()
    d1, _ = tbatch.pad_and_stack([et.data], [q0], dtype=torch.float64,
                                 device="cpu")
    st = tbatch.multistart_single(trun, torch.as_tensor(q0), d1)
    assert st.q.shape == (1,) + q0.shape
    # every restart of both, and the one each picked
    lanes = trun(tbatch._perturbed(torch.as_tensor(q0)[None],
                                   tbatch.HEADING_RESTARTS),
                 tbatch._repeat(d1, 3))
    picked = [int(np.argmin([np.abs(lanes.q[r].numpy() - x).max()
                             for r in range(3)]))
              for x in (np.asarray(sj.q), st.q[0].numpy())]
    assert picked[0] == picked[1]
    assert np.abs(np.asarray(sj.q) - st.q[0].numpy()).max() <= 1e-8
    assert abs(float(sj.cost) - float(st.cost[0])) <= 1e-8 * max(
        1.0, abs(float(sj.cost)))


@pytest.mark.parametrize("ratio", [None, 1.05, 1.3, 2.0])
def test_prior_gate_accept_with_ratio(ratio):
    rng = np.random.default_rng(7)
    c_free = np.concatenate([rng.normal(scale=3.0, size=40),
                             [-0.5, 0.0, 0.5, 1e3]])
    c_chain = c_free + rng.normal(scale=2.0, size=c_free.shape)
    a = jest.prior_gate_accept(c_chain, c_free, ratio)
    b = test_.prior_gate_accept(c_chain, c_free, ratio)
    assert a.dtype == b.dtype == bool and np.array_equal(a, b)
    assert 0 < b.sum() < b.size
    assert bool(test_.prior_gate_accept(1.2, 1.0, ratio)) == (
        (1.3 if ratio is None else ratio) >= 1.2)


def same_decisions(port, jax_rec):
    """The port's reported decisions equal the JAX run's: the same keys,
    flags and counts, shifts within 1e-6 m (computed from trajectories that
    agree to the mode's bar)."""
    jax_rec = {k: v for k, v in jax_rec.items()
               if k not in ("ok", "obj_cost_repolish")}
    assert sorted(port) == sorted(jax_rec), (port, jax_rec)
    for k, v in jax_rec.items():
        if isinstance(v, float):
            assert abs(port[k] - v) <= 1e-6, (k, port[k], v)
        else:
            assert port[k] == v, (k, port[k], v)


def _pickle(out, path, sub):
    with open(os.path.join(out, path, sub, "fte.pickle"), "rb") as f:
        return pickle.load(f)


def _sub(mode):
    return {"ground-truth": "fte_kinematic",
            "default": f"fte_kinematic_orig_{CAM}",
            "data-driven": f"fte_kinematic_{CAM}"}[mode]


def check_estimate_kinematics(tree, tmp_path, monkeypatch, mode, **options):
    """One mode of ``estimate_kinematics`` in both packages on the first
    trial (each trial costs the JAX package a compile of every solve), with
    ``options`` passed to both: the same decisions, the same artifacts, q
    within the mode's bar."""
    from chip_smoke import describe

    root, _ = tree
    monocular, priors = MODES[mode]
    serial_schedules(monkeypatch)
    dset = pose_tables(tmp_path) if priors else None
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    rec = {}
    i, p = 0, PATHS[0]
    ej, et = _one_trial(root, i, monocular)
    kw = dict(monocular_constraints=priors, data_driven_dataset=dset,
              **options)
    with instrumented(rec):
        assert jest.estimate_kinematics(ej, out_dir_prefix=jout, **kw)
    rep = {}
    assert test_.estimate_kinematics(et, out_dir_prefix=tout,
                                     dtype=torch.float64, device="cpu",
                                     report=rep, **kw)
    same_decisions(rep, rec[mode][p])
    a, b = _pickle(jout, p, _sub(mode)), _pickle(tout, p, _sub(mode))
    assert describe(a) == describe(b)
    assert np.abs(a["q"] - b["q"]).max() <= TOL_Q[mode] * max(
        1.0, np.abs(a["q"]).max()), p
    assert abs(a["obj_cost"] - b["obj_cost"]) <= TOL_Q[mode] * max(
        1.0, abs(a["obj_cost"]))
    assert sorted(os.listdir(os.path.join(jout, p, _sub(mode)))) == \
        sorted(os.listdir(os.path.join(tout, p, _sub(mode))))
    if monocular:
        # the ground-plane depth correction was evaluated
        assert "polish_ray_shift" in rec[mode][PATHS[0]]


@pytest.mark.parametrize("mode", KIN_MODES)
def test_estimate_kinematics_matches_jax(tree, tmp_path, monkeypatch, mode):
    check_estimate_kinematics(tree, tmp_path, monkeypatch, mode)


@pytest.mark.parametrize("extend_by", [0, 3])
def test_reset_trajectory_matches_jax(tree, extend_by):
    """Re-windowing a trial rebuilds the same problem in both packages
    (frames past the DLC tables are unweighted zeros)."""
    root, _ = tree
    for monocular in (False, True):
        ej, et = _one_trial(root, 1, monocular)
        n = et.params.end_frame - et.params.start_frame
        jest.reset_trajectory(ej, extend_by)
        assert test_.reset_trajectory(et, extend_by) is et
        assert et.params.total_length == ej.params.total_length == \
            n + extend_by
        for f in ("meas", "weight", "frame_valid"):
            a, b = np.asarray(getattr(ej.data, f)), getattr(et.data, f)
            assert a.shape[0] == n + extend_by
            assert np.array_equal(a, b), f
        assert np.array_equal(ej.likelihood, et.likelihood)
