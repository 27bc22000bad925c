"""Port parity of the dataset CLI's batched path against the JAX package, in
float64, on a small tree made by the JAX package (2 trials of 24 frames
with 3 cameras and the correlated DLC failures, one subject, 90 and 120 fps,
padded to 32 frames): ``init_trajectory``, ``CheetahEstimator.save``,
``determine_contacts``, the physics batch that ``run_physics_batched``
assembles, ``dataset_post_process``, and ``run_monocular_batched`` over the
ground-truth and default modes and over the data-driven mode.

Tolerances: the loaded problems are identical (the port parses the CSV
tables exactly); the saved artifacts go through two float64 forward
kinematics and camera models (<= 1e-10); the contact files, stance matrices
and the results table are identical; the two modes' trajectories, with both
packages' schedules shortened alike (14 LM steps per solve), agree within
1e-8: steps through factorizations whose float64 rounding differs.
"""
import json
import os
import pickle
import shutil

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import batched as jpb
from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch.parallel import batch as tbatch
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

torch.set_num_threads(1)
TRIALS = (("jules", "2017_12_09/bottom", "flick2"),
          ("jules", "2019_03_09", "flick1"))
PATHS = [os.path.join(d, c, t) for c, d, t in TRIALS]
CAM = 1


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX-made tree, and the true trajectories."""
    root = tmp_path_factory.mktemp("cli") / "videos"
    subject = jparams.get_subject("jules")
    qs = []
    for i, (c, d, t) in enumerate(TRIALS):
        fps = 120.0 if "2019" in d else 90.0
        q = jsyn.gallop_trajectory(24, fps=fps, seed=i)
        markers = np.asarray(jsyn.sk.fk_markers(q, subject))
        scene = jsyn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=3,
                                  fps=fps, seed=i)
        tr = jsyn.synthesize(q, subject, scene, seed=i, subject_name=c,
                             occlusion_rate=2.0, confusion_rate=1.2)
        jsyn.write_trial_dir(tr, str(root), os.path.join(d, c, t),
                             monocular_cam=CAM,
                             ground_plane_height=jcon.estimate_ground_height(
                                 q, subject))
        qs.append(q)
    return str(root), qs


@pytest.mark.parametrize("monocular", [False, True])
def test_init_trajectory(tree, monocular):
    root, _ = tree
    for (c, d, t), p in zip(TRIALS, PATHS):
        ej = jest.init_trajectory(root, p, c, monocular_enable=monocular)
        et = test_.init_trajectory(root, p, c, monocular_enable=monocular)
        assert et.scene.fps == ej.scene.fps == (120.0 if "2019" in d
                                                else 90.0)
        assert et.scene.cam_idx == ej.scene.cam_idx == (CAM if monocular
                                                        else None)
        assert et.params.ground_plane_height == \
            ej.params.ground_plane_height
        assert (et.params.start_frame, et.params.end_frame) == \
            (ej.params.start_frame, ej.params.end_frame)
        assert np.array_equal(et.xy, ej.xy)
        assert np.array_equal(et.likelihood, ej.likelihood)
        for f in ("meas", "weight", "h", "acc_weight", "frame_valid"):
            assert np.array_equal(np.asarray(getattr(et.data, f)),
                                  np.asarray(getattr(ej.data, f))), f
        for a, b in zip(et.data.cam, ej.data.cam):
            assert np.array_equal(np.asarray(a),
                                  np.asarray(b).reshape(np.shape(a)))
        for f in ("k_arr", "d_arr", "r_arr", "t_arr"):
            assert np.array_equal(getattr(et.scene, f), getattr(ej.scene, f))


def _estimators(root, p, cheetah, q, tau=None):
    ej = jest.init_trajectory(root, p, cheetah, monocular_enable=True)
    et = test_.init_trajectory(root, p, cheetah, monocular_enable=True)
    for e in (ej, et):
        e.q = q
        e.tau = tau
        e.obj_cost, e.opt_time_s = 12.25, 0.5
    return ej, et


def _cmp_pickles(a, b, tol=1e-10):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            assert a[k].keys() == b[k].keys()
            for kk in a[k]:
                assert np.abs(a[k][kk] - b[k][kk]).max() <= tol
        elif isinstance(a[k], np.ndarray):
            assert a[k].shape == b[k].shape, k
            assert np.abs(a[k] - b[k]).max() <= tol * max(
                1.0, np.abs(a[k]).max()), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("with_tau", [False, True])
def test_save_artifacts(tree, tmp_path, with_tau):
    root, qs = tree
    tau = np.random.default_rng(0).normal(size=(24, 22)) if with_tau \
        else None
    for (c, _, _), p, q in zip(TRIALS, PATHS, qs):
        ej, et = _estimators(root, p, c, q + 0.01, tau)
        ej.save("fte_kinetic_1", out_dir_prefix=str(tmp_path / "jax"))
        et.save("fte_kinetic_1", out_dir_prefix=str(tmp_path / "port"))
        dj, dt = (tmp_path / s / p / "fte_kinetic_1" for s in ("jax",
                                                               "port"))
        with open(dj / "fte.pickle", "rb") as f:
            a = pickle.load(f)
        with open(dt / "fte.pickle", "rb") as f:
            b = pickle.load(f)
        _cmp_pickles(a, b)
        for i in range(1, 4):
            ja = pd.read_csv(dj / f"cam{i}_fte.csv", header=[0, 1],
                             index_col=0)
            pa = pd.read_csv(dt / f"cam{i}_fte.csv", header=[0, 1],
                             index_col=0)
            assert list(ja.columns) == list(pa.columns)
            assert list(ja.index) == list(pa.index)
            x, y = ja.to_numpy(), pa.to_numpy()
            assert np.array_equal(np.isnan(x), np.isnan(y))
            m = ~np.isnan(x)
            assert np.abs(x[m] - y[m]).max() <= 1e-9


def _dd_artifacts(root, qs, out, pkg):
    """The data-driven mode's artifacts of the true trajectories (plus
    noise), written by ``pkg``'s estimator."""
    rng = np.random.default_rng(1)
    for (c, _, _), p, q in zip(TRIALS, PATHS, qs):
        e = pkg.init_trajectory(root, p, c, monocular_enable=True)
        e.q = q + rng.normal(scale=0.003, size=q.shape)
        e.obj_cost, e.opt_time_s = 1.0, 0.25
        e.save(f"fte_kinematic_{CAM}", out_dir_prefix=out)


def test_determine_contacts_and_physics_batch(tree, tmp_path, monkeypatch):
    root, qs = tree
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    _dd_artifacts(root, qs, jout, jest)
    _dd_artifacts(root, qs, tout, test_)
    for (c, _, _), p in zip(TRIALS, PATHS):
        ej = jest.init_trajectory(root, p, c, monocular_enable=True)
        et = test_.init_trajectory(root, p, c, monocular_enable=True)
        jest.determine_contacts(ej, monocular=True, out_dir_prefix=jout)
        test_.determine_contacts(et, monocular=True, out_dir_prefix=tout)
        for f in ("autogen-contact.json", "autogen-contact-02.json"):
            with open(os.path.join(jout, p, "grf", f)) as fh:
                a = json.load(fh)
            with open(os.path.join(tout, p, "grf", f)) as fh:
                b = json.load(fh)
            assert a == b, f
    # the physics batch each package assembles (stopped before the solve)
    seen = {}

    class Stop(Exception):
        pass

    def jstack(kds, q_warms, **k):
        seen["jax"] = ([np.asarray(kd.stance) for kd in kds],
                       [np.asarray(q) for q in q_warms],
                       [float(kd.ground_z) for kd in kds])
        raise Stop

    def trun(q_warm, datas, fpss, subject, gp, ground_heights=None,
             stances=None, **k):
        seen["port"] = (stances, [q_warm[i, :np.asarray(d.meas).shape[0]]
                                  .numpy() for i, d in enumerate(datas)],
                        list(ground_heights))
        raise Stop

    dset = tmp_path / "priors"
    dset.mkdir()
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.priors import dataset
    table = bench_lib.procedural_pose_table((100, 101), n_frames=60)
    dataset.save_pose_dataset(str(dset / "dataset_full_pose.csv"), table)
    monkeypatch.setattr(jbatch, "pad_and_stack_kinetic", jstack)
    monkeypatch.setattr(tpb, "run_physics", trun)
    monkeypatch.setattr(tpb, "_train_gmm", lambda d, dev: None)
    monkeypatch.setattr(jpb.gmm_mod, "fit", lambda *a, **k: None)
    monkeypatch.setattr(jpb.gmm_mod, "to_solver_prior", lambda p: None)
    with pytest.raises(Stop):
        jpb.run_physics_batched(root, jout, TRIALS,
                                data_driven_dataset=str(
                                    dset / "dataset_full_pose.csv"),
                                dtype=jnp.float64, mesh=None, verbose=False)
    with pytest.raises(Stop):
        tpb.run_physics_batched(root, tout, TRIALS, dtype=torch.float64,
                                device="cpu", verbose=False)
    (sj, wj, gj), (st, wt, gt) = seen["jax"], seen["port"]
    assert len(sj) == len(st) == 2
    for a, b in zip(sj, st):
        assert np.array_equal(a, b)
    for a, b in zip(wj, wt):
        assert np.array_equal(a, b)
    assert gj == gt


def test_dataset_post_process(tree, tmp_path):
    root, qs = tree
    out = str(tmp_path / "out")
    rng = np.random.default_rng(2)
    for (c, _, _), p, q in zip(TRIALS, PATHS, qs):
        for i, sub in enumerate(("fte_kinematic", f"fte_kinematic_orig_{CAM}",
                                 f"fte_kinematic_{CAM}",
                                 f"fte_kinetic_{CAM}")):
            e = jest.init_trajectory(root, p, c, monocular_enable=True)
            e.q = q + rng.normal(scale=0.02 * (i > 0), size=q.shape)
            e.obj_cost, e.opt_time_s = 1.0, 0.37 * i
            e.save(sub, out_dir_prefix=out)
    jres = jrd.dataset_post_process(root, out, TRIALS, save_plots=False)
    csv_path = os.path.join(out, "dataset_results.csv")
    shutil.move(csv_path, csv_path + ".jax")
    tres = trd.dataset_post_process(root, out, TRIALS)
    with open(csv_path) as f:
        ptxt = f.read()
    with open(csv_path + ".jax") as f:
        jtxt = f.read()
    assert ptxt == jtxt
    a = pd.read_csv(csv_path, header=[0, 1], index_col=0)
    b = pd.read_csv(csv_path + ".jax", header=[0, 1], index_col=0)
    pd.testing.assert_frame_equal(a, b)
    pd.testing.assert_frame_equal(
        pd.concat({t: pd.DataFrame(v) for t, v in tres.items()}, axis=1),
        jres)


def _short_schedules(mp):
    """Both packages' production schedules, shortened alike: the annealed
    solve (10, 3), (3, 3), (1, 8); the multistart probe (10, 3) and finish
    (3, 3), (1, 8); the polish (1, 4)."""
    short = ((10.0, 3), (3.0, 3), (1.0, 8))
    for fte in (jkin.KinematicFTE, tkin.KinematicFTE):
        mp.setattr(fte.make_solver, "__defaults__",
                   (short,) + fte.make_solver.__defaults__[1:])
    for batch in (jbatch, tbatch):
        mp.setattr(batch, "PROBE_STAGES", short[:1])
        mp.setattr(batch, "FULL_STAGES", short[1:])
    for pb in (jpb, tpb):
        mp.setattr(pb._anchor_polish, "__defaults__",
                   (((1.0, 4),),) + pb._anchor_polish.__defaults__[1:])


def test_run_monocular_batched_matches_jax(tree, tmp_path, monkeypatch):
    root, _ = tree
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    modes = ("ground-truth", "default")
    _short_schedules(monkeypatch)
    jpb.run_monocular_batched(root, jout, TRIALS, modes=modes,
                              dtype=jnp.float64, mesh=None, verbose=False)
    rep = {}
    tpb.run_monocular_batched(root, tout, TRIALS, modes=modes,
                              dtype=torch.float64, device="cpu",
                              verbose=False, report=rep)
    assert rep["default"]["trials"] == PATHS
    for p in PATHS:
        for sub in ("fte_kinematic", f"fte_kinematic_orig_{CAM}"):
            with open(os.path.join(jout, p, sub, "fte.pickle"), "rb") as f:
                a = pickle.load(f)
            with open(os.path.join(tout, p, sub, "fte.pickle"), "rb") as f:
                b = pickle.load(f)
            assert a.keys() == b.keys()
            assert np.abs(a["q"] - b["q"]).max() <= 1e-8, (p, sub)
            assert abs(a["obj_cost"] - b["obj_cost"]) <= 1e-8 * max(
                1.0, abs(a["obj_cost"]))


def test_data_driven_mode_matches_jax(tree, tmp_path, monkeypatch):
    """The data-driven mode of both packages on the same tree, float64:
    priors trained from the same small procedural tables (written by the
    port, read by both; the JAX CLI reads its validation table as .h5), the
    prior-free multistart, then the data-driven stage with its line-scan,
    all schedules shortened alike. The gate decisions, scan shifts and
    trajectories agree (q within 1e-6, the bound of the data-driven stage's
    own parity test, tests/test_torch_dd.py)."""
    from cheetah_pose_estimation_tpu.data import io as jio
    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
    from cheetah_pose_estimation_tpu.priors import dataset as jds
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.priors import dataset

    root, _ = tree
    priors = tmp_path / "priors"
    dset = str(priors / "dataset_full_pose.csv")
    dataset.save_pose_dataset(dset, bench_lib.procedural_pose_table(
        (100, 101, 102), n_frames=80))
    dataset.save_pose_dataset(str(priors / "validation_dataset.csv"),
                              bench_lib.procedural_pose_table((200,),
                                                              n_frames=80))
    jio._write_pandas_h5_table(str(priors / "validation_dataset.h5"),
                               jds.load_pose_dataset(
                                   str(priors / "validation_dataset.csv")))
    _short_schedules(monkeypatch)
    scan = ((1.0, 4),)
    d = jda.make_depth_linescan.__defaults__
    monkeypatch.setattr(jda.make_depth_linescan, "__defaults__",
                        d[:2] + (scan,) + d[3:])
    monkeypatch.setattr(tpb.run_data_driven, "__defaults__",
                        (((10.0, 3), (3.0, 3), (1.0, 8)), scan, None))
    gate = {}
    orig = jest.prior_gate_accept
    monkeypatch.setattr(jest, "prior_gate_accept",
                        lambda *a, **k: gate.setdefault("jax", orig(*a, **k)))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jpb.run_monocular_batched(root, jout, TRIALS, modes=("data-driven",),
                              data_driven_dataset=dset, dtype=jnp.float64,
                              mesh=None, verbose=False)
    rep = {}
    tpb.run_monocular_batched(root, tout, TRIALS, modes=("data-driven",),
                              data_driven_dataset=dset, dtype=torch.float64,
                              device="cpu", verbose=False, report=rep)
    assert rep["data-driven"]["prior_ok"] == list(gate["jax"])
    for p in PATHS:
        with open(os.path.join(jout, p, f"fte_kinematic_{CAM}",
                               "fte.pickle"), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(tout, p, f"fte_kinematic_{CAM}",
                               "fte.pickle"), "rb") as f:
            b = pickle.load(f)
        assert np.abs(a["q"] - b["q"]).max() <= 1e-6 * max(
            1.0, np.abs(a["q"]).max()), p
