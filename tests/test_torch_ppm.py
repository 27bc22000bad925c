"""Port parity of the pairwise pseudo-measurements (PPMs, W = 3) and of the
dataset CLI's ``--run_acinoset`` against the JAX package, in float64.

* ``data/ppm``: ``synthesize_ppm``, the pickle both ways (the same bytes;
  each package reads the other's), ``normalize_pw_frames`` on every layout
  and ``assemble_ppm_measurements``: equal to 1e-12 (the same numpy
  arithmetic).
* ``write_trial_dir(write_ppm=True)`` of the same trial rendered by each
  package: the same pickles within 1e-9 px (two float64 camera models).
* ``init_trajectory(enable_ppm=True)`` on a JAX-made flick trial (24
  frames, 3 cameras): identical W = 3 measurements and weights.
* ``run_dataset --run_acinoset --clean --device cpu`` (the port, in float64)
  and the JAX package's ``run_acinoset`` on that one-flick tree, both
  packages' schedules shortened alike: the same trials done, q and the
  saved objective of each mode (ground truth, default, data-driven, all
  three W = 3) within 1e-6 (the bar of the data-driven mode's parity
  tests), the same artifacts with the same keys and shapes, and an equal
  ``validate_dataset`` dict.
"""
import functools
import os
import pickle

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import ppm as jppm
from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu_torch.data import ppm as tppm
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd

from test_torch_serial_kinematics import (pose_tables, same_gmm_draw,
                                          serial_schedules)

torch.set_num_threads(1)
FLICK = ("jules", "2017_12_09/bottom", "flick2")
PATH = os.path.join(FLICK[1], FLICK[0], FLICK[2])
MODE_SUBS = {"ground-truth": "fte_kinematic",
             "default": "fte_kinematic_orig_1",
             "data-driven": "fte_kinematic_1"}


def _markers(n=7, seed=0):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1500, size=(n, 24, 2))
    lik = rng.uniform(0, 1, size=(n, 24))
    return xy, lik


def _same(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nan_to_num(np.abs(a - b)).max(initial=0.0) <= tol


def _same_frames(fa, fb):
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])


def test_synthesize_ppm_matches_jax():
    xy, lik = _markers()
    for j, t in zip(jppm.synthesize_ppm(xy, lik, seed=3),
                    tppm.synthesize_ppm(xy, lik, seed=3)):
        _same(j, t)


def test_ppm_pickle_both_ways(tmp_path):
    """The same bytes; each package reads the other's file."""
    pose, lik, pws = tppm.synthesize_ppm(*_markers(), seed=1)
    jp, tp = str(tmp_path / "jax.pickle"), str(tmp_path / "port.pickle")
    jppm.save_ppm_pickle(jp, pose, lik, pws)
    tppm.save_ppm_pickle(tp, pose, lik, pws)
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    _same_frames(tppm.load_ppm_pickle(jp), jppm.load_ppm_pickle(tp))
    _same_frames(tppm.load_ppm_pickle(tp), jppm.load_ppm_pickle(jp))


def _layout(name, frames):
    """One pairwise pickle's frames in one of the layouts seen in the
    wild."""
    if name == "list":
        return frames
    if name == "int_keys_with_gap":
        return {i: f for i, f in enumerate(frames) if i != 2}
    if name == "frame_strings":
        out = {f"frame{i:04d}": f for i, f in enumerate(frames)}
        out["metadata"] = {"nframes": len(frames)}
        return out
    # DLC's full-pickle form: coordinates and confidence, offsets under an
    # alias and without the leading singleton axis
    out = {}
    for i, f in enumerate(frames):
        flat = np.asarray(f["pose"])
        out[f"frame{i:04d}"] = {
            "coordinates": np.stack([flat[0::3], flat[1::3]], 1)[None],
            "confidence": flat[2::3],
            "pairwise": np.asarray(f["pws"])[0]}
    return out


@pytest.mark.parametrize("layout", ["list", "int_keys_with_gap",
                                    "frame_strings", "dlc_full_pickle"])
def test_normalize_pw_frames_layouts(layout):
    pose, lik, pws = tppm.synthesize_ppm(*_markers(n=5), seed=2)
    frames = [{"pose": np.concatenate([pose[t], lik[t][:, None]],
                                      1).reshape(-1), "pws": pws[t][None]}
              for t in range(5)]
    a = jppm.normalize_pw_frames(_layout(layout, frames))
    b = tppm.normalize_pw_frames(_layout(layout, frames))
    assert len(b) == 5
    _same_frames(a, b)


@pytest.mark.parametrize("kinetic_dataset", [False, True])
def test_assemble_ppm_measurements_matches_jax(kinetic_dataset):
    rng = np.random.default_rng(4)
    F, C = 9, 2
    xy = rng.uniform(0, 1500, size=(F, C, 24, 2))
    xy[rng.uniform(size=xy.shape[:3]) < 0.1] = np.nan
    lik = rng.uniform(0, 1, size=(F, C, 24))
    frames = [[{"pose": np.concatenate([p, lk[:, None]], 1).reshape(-1),
                "pws": w[None]}
               for p, lk, w in zip(*tppm.synthesize_ppm(
                   np.nan_to_num(xy[:, c]), lik[:, c], seed=c))]
              for c in range(C)]
    a = jppm.assemble_ppm_measurements(xy, lik, frames, 2, 6, 0.5,
                                       kinetic_dataset)
    b = tppm.assemble_ppm_measurements(xy, lik, frames, 2, 6, 0.5,
                                       kinetic_dataset)
    assert b[0].shape == (6, C, 24, 2, 3) and b[1].shape == (6, C, 24, 3)
    for x, y in zip(a, b):
        _same(x, y)
    assert 0 < np.count_nonzero(b[1][..., 1:]) < b[1][..., 1:].size


def test_write_trial_dir_ppm_matches_jax(tmp_path):
    """The same trial rendered by each package, written with its PPMs: the
    same pickles within 1e-9 px."""
    q = jsyn.gallop_trajectory(12, fps=90.0, seed=5)
    jsub, tsub = jparams.get_subject("jules"), tparams.get_subject("jules")
    markers = tsyn.fk_markers_np(q, tsub)
    scene = tsyn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=2,
                              fps=90.0, seed=5)
    kw = dict(seed=5, subject_name="jules", occlusion_rate=2.0,
              confusion_rate=1.2)
    j = jsyn.synthesize(q, jsub, jsyn.SyntheticScene(*scene), **kw)
    t = tsyn.synthesize(q, tsub, scene, **kw)
    jsyn.write_trial_dir(j, str(tmp_path / "jax"), PATH, write_ppm=True)
    tsyn.write_trial_dir(t, str(tmp_path / "port"), PATH, write_ppm=True)
    for c in (1, 2):
        f = os.path.join(PATH, "dlc_pw", f"cam{c}.pickle")
        with open(tmp_path / "jax" / f, "rb") as fj, \
                open(tmp_path / "port" / f, "rb") as ft:
            a, b = pickle.load(fj), pickle.load(ft)
        assert len(a) == len(b) == 12
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y) == ["pose", "pws"]
            for k in x:
                _same(x[k], y[k], tol=1e-9)


@pytest.fixture(scope="module")
def flick_tree(tmp_path_factory):
    """One JAX-made flick trial (24 frames, 3 cameras, the correlated DLC
    failures) with its PPMs; the JAX package reads its .h5 tables, the port
    their .csv siblings (the same numbers)."""
    root = tmp_path_factory.mktemp("acinoset") / "videos"
    c, d, t = FLICK
    subject = jparams.get_subject(c)
    q = jsyn.gallop_trajectory(24, fps=90.0, seed=0)
    markers = np.asarray(jsyn.sk.fk_markers(q, subject))
    scene = jsyn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=3,
                              fps=90.0, seed=0)
    tr = jsyn.synthesize(q, subject, scene, seed=0, subject_name=c,
                         occlusion_rate=2.0, confusion_rate=1.2)
    jsyn.write_trial_dir(tr, str(root), PATH, monocular_cam=1,
                         write_ppm=True,
                         ground_plane_height=jcon.estimate_ground_height(
                             q, subject))
    return str(root)


@pytest.mark.parametrize("monocular", [False, True])
def test_init_trajectory_ppm_matches_jax(flick_tree, monocular):
    kw = dict(monocular_enable=monocular, enable_ppm=True)
    ej = jest.init_trajectory(flick_tree, PATH, FLICK[0], **kw)
    et = test_.init_trajectory(flick_tree, PATH, FLICK[0], **kw)
    C = 1 if monocular else 3
    assert et.data.meas.shape == (24, C, 24, 2, 3)
    assert et.data.weight.shape == (24, C, 24, 3)
    assert et.params.enable_ppms
    for f in ("meas", "weight"):
        assert np.array_equal(np.asarray(getattr(et.data, f)),
                              np.asarray(getattr(ej.data, f))), f
    assert np.array_equal(et.xy, ej.xy)


@pytest.fixture(scope="module")
def acinoset_runs(flick_tree, tmp_path_factory):
    """The JAX package's ``run_acinoset`` and ``validate_dataset``, and the
    port's CLI ``--run_acinoset --clean --device cpu`` in float64, on the
    one-flick tree with the schedules shortened alike."""
    from chip_smoke import artifacts

    tmp = tmp_path_factory.mktemp("acinoset_out")
    jout, tout = str(tmp / "jax"), str(tmp / "port")
    with pytest.MonkeyPatch.context() as mp:
        serial_schedules(mp)
        same_gmm_draw(mp)
        dset = pose_tables(tmp)
        mp.setattr(jest, "DATA_DRIVEN_DATASET", dset)
        mp.setenv("CHEETAH_DATA_DRIVEN_DATASET", dset)
        mp.setattr(trd, "run_acinoset", functools.partial(
            trd.run_acinoset, dtype=torch.float64))
        jdone = jrd.run_acinoset(flick_tree, jout)
        jvalid = jrd.validate_dataset(jout)
        rep = trd.main(["--run_acinoset", "--clean", "--device", "cpu",
                        "--root_dir", flick_tree, "--out_dir_prefix", tout],
                       report={})
    return dict(jdone=jdone, jvalid=jvalid, rep=rep, jout=jout, tout=tout,
                jart=artifacts(jout), tart=artifacts(tout))


@pytest.mark.parametrize("mode", list(MODE_SUBS))
def test_run_acinoset_w3_solve_matches_jax(acinoset_runs, mode):
    """Each mode of the one flick trial, with W = 3: q and the saved
    objective within 1e-6."""
    r = acinoset_runs
    assert r["jdone"] == [PATH]
    tr = r["rep"]["acinoset"][mode]
    assert tr["trials"] == [PATH] and tr["per_trial"][PATH]["W"] == 3
    out = []
    for base in (r["jout"], r["tout"]):
        with open(os.path.join(base, PATH, MODE_SUBS[mode], "fte.pickle"),
                  "rb") as f:
            out.append(pickle.load(f))
    a, b = out
    assert b["meas_err"].shape[-1] == 3
    assert np.abs(a["q"] - b["q"]).max() <= 1e-6 * max(
        1.0, np.abs(a["q"]).max())
    assert abs(a["obj_cost"] - b["obj_cost"]) <= 1e-6 * max(
        1.0, abs(a["obj_cost"]))


def test_run_acinoset_artifacts_and_validation_match_jax(acinoset_runs):
    r = acinoset_runs
    assert r["rep"]["validate"] == r["jvalid"]
    assert sorted(r["jvalid"]) == sorted(f"{PATH}/{s}"
                                         for s in MODE_SUBS.values())
    # the JAX writer adds .h5 siblings of its CSV tables; the port writes
    # CSV only
    assert {k: v for k, v in r["jart"].items() if not k.endswith(".h5")} \
        == r["tart"]
