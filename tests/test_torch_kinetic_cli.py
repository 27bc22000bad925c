"""Port parity of the force-plate pipeline (``run_dataset --run_kinetic``)
against the JAX package, in float64 on the CPU.

The synthetic kinetic test set rendered by both packages is the same to
1e-9 px. On its first trial (50 frames, 4 pinhole cameras at 200 fps,
with hand labels written by the port's DLC writer), both packages'
``run_kinetic`` with their schedules shortened alike (kinematic (10, 3),
(3, 3), (1, 8); kinetic (3, 3), (1, 5)) and their stance pruning's speed
limits raised alike (the procedural gallop's feet slide faster than the
pruning allows, which would leave no stance and no GRF to solve for):

* the multi-view pinhole ``estimate_kinematics``: q and objective within
  1e-6;
* ``estimate_kinetics`` with synthesized GRFs and ``estimate_grf`` with
  the torque anchor: the same pruned stance, q and objective within 1e-6,
  torques and GRFs within 1e-6 of their scale;
* ``estimate_static_grf`` on the same saved solution within 1e-10;
* ``contact_json_conversion``, ``gait_analysis``, ``check_grf`` and
  ``reprojection_errors`` on the same files within 1e-12;
* ``run_dataset.main(["--run_kinetic", "--clean", "--device", "cpu"])``
  writes every artifact the JAX run wrote with the same keys and shapes,
  the two plots, and returns the analysis dict with JAX's keys and
  counts.

The runs are made once for the module: the JAX package compiles each of
its three solvers anew."""
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import io as jio
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import results as jres
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch.data import io as tio
from cheetah_pose_estimation_tpu_torch.dynamics import eom as tdyn
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.pipeline import results as tres
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd

from test_torch_serial_kinematics import serial_schedules
from test_torch_serial_kinetics import keep_stances, kinetic_schedules

torch.set_num_threads(1)
CHEETAH, DATE, TRIAL = trd.KINETIC_SET[0]
PATH = trd.kinetic_path(CHEETAH, DATE, TRIAL)
STAGES = ("kinematic", "kinetic", "grf")
DIRS = {"kinematic": "fte_kinematic", "kinetic": "fte_kinetic",
        "grf": "fte_grf"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(a).max())


def _hand_labels(root):
    """Hand labels of the trial's cameras (the true markers through each
    camera plus 1 px noise, every other frame), in the port's DLC layout."""
    from cheetah_pose_estimation_tpu_torch.ops import camera as tcam

    base = os.path.join(root, PATH)
    with open(os.path.join(base, "synthetic_gt.pickle"), "rb") as f:
        pos = np.asarray(pickle.load(f)["positions"], np.float64)
    k, d, r, t, _, n_cams, _ = tio.find_scene_file(base)
    d = d.reshape(-1, 4)
    rng = np.random.default_rng(5)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    for c in range(n_cams):
        uv = tcam.project_pinhole(T(pos[::2].reshape(-1, 3)), T(k[c]),
                                  T(d[c]), T(r[c]),
                                  T(t[c]).reshape(3)).numpy()
        uv = uv.reshape(-1, pos.shape[1], 2) + rng.normal(size=(len(uv) //
                                                         pos.shape[1],
                                                         pos.shape[1], 2))
        tio.save_dlc_table(os.path.join(base, "dlc_hand_labeled",
                                        f"cam{c + 1}.csv"), uv,
                           np.ones(uv.shape[:2]), start_frame=0)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Both packages' renderings of the kinetic test set, and a one-trial
    tree (the port's rendering of the first trial, with hand labels)."""
    work = tmp_path_factory.mktemp("kinetic")
    roots = {"jax": str(work / "jax"), "port": str(work / "port")}
    made = {"jax": jrd.materialize_synthetic_kinetic_testset(roots["jax"]),
            "port": trd.materialize_synthetic_kinetic_testset(roots["port"])}
    one = str(work / "one")
    shutil.copytree(os.path.join(roots["port"], PATH),
                    os.path.join(one, PATH))
    _hand_labels(one)
    return roots, made, one


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    """``run_kinetic`` of both packages on the one-trial tree (the port in
    float64, with each stage's report), JAX's ``kinetic_analysis``, and
    the port's CLI (float32, as it runs) on the same tree."""
    _, _, one = trees
    work = tmp_path_factory.mktemp("kinetic_runs")
    out = {"jax": str(work / "jax"), "port": str(work / "port"),
           "cli": str(work / "cli")}
    kset = trd.KINETIC_SET[:1]
    with pytest.MonkeyPatch.context() as mp:
        serial_schedules(mp)
        kinetic_schedules(mp)
        keep_stances(mp)
        jrec, stance = {}, {}
        orig = {n: getattr(jest, n) for n in ("estimate_kinetics",
                                              "estimate_grf")}
        prune = jkn.prune_stance

        def keep(name):
            def run(est, *a, **k):
                ok = orig[name](est, *a, **k)
                jrec[name] = (np.asarray(est.tau), np.asarray(est.grf_z),
                              np.asarray(est.grf_xy), stance.pop("last"))
                return ok
            return run

        def recorded_prune(*a, **k):
            s = prune(*a, **k)
            stance["last"] = np.asarray(s).astype(int).tolist()
            return s

        for n in orig:
            mp.setattr(jest, n, keep(n))
        mp.setattr(jkn, "prune_stance", recorded_prune)
        jrd.run_kinetic(one, out["jax"], kinetic_set=kset, verbose=False)
        janalysis = jrd.kinetic_analysis(one, out["jax"], kinetic_set=kset)
        trep = {}
        trd.run_kinetic(one, out["port"], kinetic_set=kset, verbose=False,
                        dtype=torch.float64, device="cpu", report=trep)
        # the GRF re-estimation again from the JAX run's physics solution
        out["grf"] = str(work / "grf")
        shutil.copytree(out["jax"], out["grf"])
        shutil.rmtree(os.path.join(out["grf"], PATH, "fte_grf"))
        est = test_.init_trajectory(one, PATH, CHEETAH, kinetic_dataset=True,
                                    kinematic_model=False)
        grf = {}
        grf["ok"] = test_.estimate_grf(est, out_dir_prefix=out["grf"],
                                       dtype=torch.float64, device="cpu",
                                       report=grf)
        grf.update(tau=est.tau, grf_z=est.grf_z, grf_xy=est.grf_xy)
        cli = trd.main(["--run_kinetic", "--clean", "--device", "cpu",
                        "--root_dir", one, "--out_dir_prefix", out["cli"]],
                       report={})
    return {"out": out, "jax": jrec, "jax_analysis": janalysis,
            "port": trep, "grf": grf, "cli": cli, "root": one}


def _fte(out, stage):
    with open(os.path.join(out, PATH, DIRS[stage], "fte.pickle"), "rb") as f:
        return pickle.load(f)


def test_kinetic_tree_matches_jax(trees):
    roots, made, _ = trees
    assert made["jax"] == made["port"] == [trd.kinetic_path(*k)
                                           for k in trd.KINETIC_SET]
    for p in made["port"]:
        xa, la, _ = jio.load_dlc_points(os.path.join(roots["jax"], p, "dlc"),
                                        use_native=False)
        xb, lb, _ = tio.load_dlc_points(os.path.join(roots["port"], p, "dlc"),
                                        use_native=False)
        assert xa.shape == xb.shape == (50, 4, 24, 2)
        assert np.array_equal(np.isnan(xa), np.isnan(xb))
        assert np.nanmax(np.abs(xa - xb)) <= 1e-9
        assert np.array_equal(la, lb)
        assert jio.load_metadata(os.path.join(roots["jax"], p)) == \
            tio.load_metadata(os.path.join(roots["port"], p))
        scene_a = jio.find_scene_file(os.path.join(roots["jax"], p))
        scene_b = tio.find_scene_file(os.path.join(roots["port"], p))
        for a, b in zip(scene_a[:4], scene_b[:4]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        with open(os.path.join(roots["port"], p, "synthetic_gt.pickle"),
                  "rb") as f:
            assert pickle.load(f)["q"].shape == (50, 54)


@pytest.mark.parametrize("stage", STAGES)
def test_stage_matches_jax(runs, stage):
    """Each stage's saved solution, from the same input as JAX's (the
    port's previous stage for the kinematic and kinetic stages, which
    agree far inside the bar; the JAX run's physics solution for the GRF
    re-estimation, whose torque anchor and warm start would otherwise
    carry the kinetic stage's difference): q and the objective within
    1e-6; for the physics stages the same pruned stance, torques and GRFs
    within 1e-6 of their scale."""
    tr = runs["port"][stage]["per_trial"][PATH]
    assert tr["ok"] and tr["wall_s"] > 0
    out = runs["out"]["grf" if stage == "grf" else "port"]
    a, b = _fte(runs["out"]["jax"], stage), _fte(out, stage)
    assert sorted(a) == sorted(b)
    assert _rel(a["q"], b["q"]) <= 1e-6
    assert abs(a["obj_cost"] - b["obj_cost"]) <= 1e-6 * max(
        1.0, abs(float(a["obj_cost"])))
    if stage == "kinematic":
        return
    if stage == "grf":
        tr = runs["grf"]
        assert tr["ok"]
    name = {"kinetic": "estimate_kinetics", "grf": "estimate_grf"}[stage]
    tau_j, gz_j, gxy_j, stance_j = runs["jax"][name]
    assert tr["stance"] == stance_j
    assert np.sum(tr["stance"]) > 0
    assert _rel(tau_j, tr["tau"]) <= 1e-6
    assert _rel(gz_j, tr["grf_z"]) <= 1e-6
    assert _rel(gxy_j, tr["grf_xy"]) <= 1e-6
    assert _rel(tdyn.tau_from_dict(a["tau"], 50), tau_j) == 0.0
    if stage == "grf":
        assert np.abs(gz_j).max() > 0.0


def test_static_grf_estimator_matches_jax(runs):
    """Both packages' ``estimate_static_grf`` on the JAX run's saved
    kinematic solution and contact file."""
    out = runs["out"]["jax"]
    ej = jest.init_trajectory(runs["root"], PATH, CHEETAH,
                              kinetic_dataset=True, kinematic_model=False)
    et = test_.init_trajectory(runs["root"], PATH, CHEETAH,
                               kinetic_dataset=True, kinematic_model=False)
    with pytest.MonkeyPatch.context() as mp:
        keep_stances(mp)
        gz_j, gxy_j = jest.estimate_static_grf(ej, out_dir_prefix=out)
        gz_t, gxy_t = test_.estimate_static_grf(
            et, out_dir_prefix=out, dtype=torch.float64, device="cpu")
    assert gz_t.shape == (50, 4) and gxy_t.shape == (50, 4, 4)
    np.testing.assert_allclose(gz_t, np.asarray(gz_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(gxy_t, np.asarray(gxy_j), rtol=0, atol=1e-10)
    assert gz_t.max() > 0.0


def test_gait_analysis_matches_jax(runs):
    """``contact_json_conversion``, ``gait_analysis`` and ``check_grf`` of
    both packages on the JAX run's physics solution and contact file."""
    base = os.path.join(runs["out"]["jax"], PATH)
    cj = os.path.join(base, "grf", "autogen-contact.json")
    assert jres.contact_json_conversion(cj) == \
        tres.contact_json_conversion(cj)
    d = _fte(runs["out"]["jax"], "kinetic")
    tau = tdyn.tau_from_dict(d["tau"], 50)
    a = jres.gait_analysis(d["q"], tau, cj, fps=200.0)
    b = tres.gait_analysis(d["q"], tau, cj, fps=200.0, device="cpu")
    assert a["contacts"] == b["contacts"]
    for key in ("angle", "torque", "power"):
        assert sorted(a[key]) == sorted(b[key])
        for k in a[key]:
            np.testing.assert_allclose(b[key][k], a[key][k], rtol=1e-12,
                                       atol=1e-12)
    assert a["angle"]
    for _, gz, gxy, _ in runs["jax"].values():
        assert jres.check_grf(gxy) == tres.check_grf(gxy)
    bad = np.zeros((3, 4, 4))
    bad[1, 2, [0, 2]] = 0.5
    assert jres.check_grf(bad) == tres.check_grf(bad) == {"n_invalid": 1,
                                                          "ok": False}


def test_reprojection_errors_match_jax(runs, tmp_path):
    """On the JAX run's reprojections and the port-written hand labels,
    both packages give the same numbers; with no hand labels, none."""
    fte_dir = os.path.join(runs["out"]["jax"], PATH, "fte_kinetic")
    hand = os.path.join(runs["root"], PATH, "dlc_hand_labeled")
    a = jres.reprojection_errors(fte_dir, hand)
    b = tres.reprojection_errors(fte_dir, hand)
    assert sorted(a) == sorted(b) and a["n"] == b["n"] > 0
    for k in ("mean_px", "median_px", "std_px"):
        assert abs(a[k] - b[k]) <= 1e-12 * max(1.0, abs(a[k]))
    assert tres.reprojection_errors(fte_dir, str(tmp_path))["n"] == 0


def test_run_kinetic_cli_writes_the_jax_artifacts(runs):
    """The port's CLI on the one-trial tree: every artifact the JAX run
    wrote, with the same keys and shapes, the two plots, the analysis dict
    with the JAX analysis' keys, and each stage launched."""
    from chip_smoke import artifacts

    jax_art = artifacts(runs["out"]["jax"])
    cli_art = artifacts(runs["out"]["cli"])
    assert jax_art and {p: jax_art[p] for p in jax_art} == {
        p: cli_art.get(p) for p in jax_art}
    assert sorted(jax_art) == sorted(cli_art)
    base = os.path.join(runs["out"]["cli"], PATH)
    for pdf in ("torques.pdf", "gait.pdf"):
        assert os.path.getsize(os.path.join(base, pdf)) > 0
    rep = runs["cli"]
    assert rep["kinetic_analysis"][PATH]["plots"]["skipped"] == []
    assert sorted(rep["kinetic_results"]) == sorted(runs["jax_analysis"]) \
        == [PATH]
    a, b = runs["jax_analysis"][PATH], rep["kinetic_results"][PATH]
    assert sorted(a) == sorted(b) and a["n"] == b["n"] > 0
    assert all(np.isfinite(v) for v in b.values())
    for stage in STAGES:
        assert rep["kinetic"][stage]["trials"] == [PATH]
        assert rep["kinetic"][stage]["per_trial"][PATH]["ok"]
