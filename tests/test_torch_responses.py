"""Port parity of the three response studies (``run_forced_vs_gated_bench``,
``run_deadband_sweep``, ``run_physics_lever_sweep``) and of the bench
anchor polish (``bench_lib.make_anchor_polish``) against the JAX package,
in float64 on the CPU, at the fixture size of
``tests/data/jax_responses_reference.py`` (``small``: 2 procedural bench
trials at 48 frames, every schedule shortened alike, the stance pruning
speeds raised alike, the priors trained on the small procedural tables;
the forced-vs-gated bench cut to 2 trials by patching
``bench_lib.load_reference_trajectories`` and ``reference_trial_paths``).

The tier-1 tests hold the port to the JAX run recorded in
``tests/data/jax_responses_f64.json`` (``small``; its rows unrounded): no
JAX solver is compiled here. The ``slow`` test makes the same record with
the JAX package live and holds the port to it. Last, chip_smoke's phase
17 agreement rules (``fvg_agree``, ``sweep_rows_agree``) on made-up
values.

Tolerances: the scores (MPE, MPJPE, CoM-vel RMSE, the cost ratio) within
1e-6 relative; a derived difference (the improvement in %, the change from
the warm start) within 1e-6 of the scale of what it is the difference of;
the gate decisions, the accepted LM steps and the anchor's acceptance
equal; the anchor's q within 1e-6 of its scale. Two places within 1e-5
(``TOL_KINK``), measured 1.6e-6 and 2.2e-6 while everything upstream of
them agrees within 1e-11: the data-driven variants' anchored scores (the
ray correction puts the stance feet exactly on the ground plane, where
the polish's penetration hinge switches, so round-off picks its side) and
the lever sweep's override row (guard off, damping 0.5 from a perturbed
start: the kinetic elimination's GRF clamps, whose active set round-off
decides at zero forces, then large steps).
"""
import csv
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.parallel import batch as tbatch
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib as tbl
from cheetah_pose_estimation_tpu_torch.pipeline import contacts as tcon
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "jax_responses_reference", os.path.join(HERE, "data",
                                            "jax_responses_reference.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
FVG_SCORES = [f"{m}_{v}{a}" for v in tst.FVG_VARIANTS for a in ("", "_anch")
              for m in ("mpe", "mpjpe", "cvr")]
TOL_KINK = 1e-5


def _tol(column):
    """The bar of a score column (see the module's docstring)."""
    kinked = column.startswith("overrides") or (
        column.endswith("_anch") and "_dd_" in column)
    return TOL_KINK if kinked else 1e-6


def _close(a, b, tol=1e-6, scale=None):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    s = np.abs(b).max() if scale is None else scale
    return np.abs(a - b).max() <= tol * max(s, 1e-300)


@pytest.fixture(scope="module")
def record():
    with open(os.path.join(HERE, "data", "jax_responses_f64.json"),
              encoding="utf-8") as f:
        rec = json.load(f)["small"]
    assert rec["trials"] == ref.SMALL_TRIALS
    assert rec["n_frames"] == ref.SMALL_FRAMES
    return rec


def port_small(mp, tmp_path):
    """The port set up as the fixture's JAX run was: schedules, stance
    pruning, the small tables as the default training table, the bench cut
    to the fixture's trials."""
    ref.small_schedules(mp.setattr, tkin.KinematicFTE, tkn.KineticFTE,
                        tbatch, tda, tkn)
    dset = ref.small_tables(str(tmp_path / "priors"))
    mp.setenv("CHEETAH_DATA_DRIVEN_DATASET", dset)
    loads, paths = tbl.load_reference_trajectories, tbl.reference_trial_paths
    mp.setattr(tbl, "load_reference_trajectories",
               lambda m=None: loads(ref.SMALL_TRIALS))
    mp.setattr(tbl, "reference_trial_paths",
               lambda m=None: paths(ref.SMALL_TRIALS))
    return dset


def _header(path):
    with open(path, encoding="utf-8") as f:
        return list(csv.reader(f))


def check_fvg(jrec, tmp_path):
    out = str(tmp_path / "fvg" / "forced_vs_gated.csv")
    rep = {}
    rows = tst.run_forced_vs_gated_bench(
        out_csv=out, n_frames=ref.SMALL_FRAMES, dtype=torch.float64,
        device="cpu", verbose=False, report=rep)
    jrows = jrec["rows"]
    assert [r["trial"] for r in rows] == [r["trial"] for r in jrows] \
        == tbl.reference_trial_paths(ref.SMALL_TRIALS)
    assert [r["gate"] for r in rows] == [r["gate"] for r in jrows]
    for r, j in zip(rows, jrows):
        assert _close(r["ratio"], j["ratio"]), (r["ratio"], j["ratio"])
        for k in FVG_SCORES:
            assert _close(r[k], j[k], _tol(k)), (r["trial"], k, r[k], j[k])
    head, *body = _header(out)
    assert head == jrec["columns"] == list(rows[0])
    assert [float(v) for v in body[0][3:]] == [rows[0][k] for k in head[3:]]
    # the gate's own arithmetic
    assert np.allclose([r["ratio"] for r in rows],
                       np.divide(rep["c_chain"], rep["c_free"]), rtol=0,
                       atol=0)
    for i, r in enumerate(rows):
        if not r["gate"]:
            assert all(r[f"{m}_dd_gated"] == r[f"{m}_default"]
                       for m in ("mpe", "mpjpe", "cvr"))
        for v in tst.FVG_VARIANTS:
            if not rep["anchor"][v]["accept"][i]:
                assert all(r[f"{m}_{v}_anch"] == r[f"{m}_{v}"]
                           for m in ("mpe", "mpjpe", "cvr"))


def check_deadband(jrecs, tmp_path):
    rep = {}
    rows = tst.run_deadband_sweep(out_dir=str(tmp_path / "deadband"),
                                  dtype=torch.float64, device="cpu",
                                  verbose=False, report=rep,
                                  **ref.SMALL_DEADBAND)
    jrows = [j["rows"][0] for j in jrecs]
    assert len(rows) == len(jrows) == len(rep["rows"])
    for raw, j, r in zip(rep["rows"], jrows, rows):
        assert raw["base_deadband"] == j["base_deadband"] \
            == r["base_deadband"]
        for k in ("comvel_rmse", "comvel_warm", "mpe_mm", "mpe_warm_mm"):
            assert _close(raw[k], j[k]), (k, raw[k], j[k])
            assert r[k] == round(raw[k], 4 if "comvel" in k else 1)
        assert _close(raw["comvel_improvement_pct"],
                      j["comvel_improvement_pct"], scale=100.0)
    head, *body = _header(str(tmp_path / "deadband" / "deadband_sweep.csv"))
    assert head == jrecs[0]["columns"]
    assert [b[0] for b in body] == ["floor", "0.05"]


def check_levers(jrecs, tmp_path):
    rep = {}
    out = str(tmp_path / "levers" / "physics_lever_sweep.csv")
    rows = tst.run_physics_lever_sweep(
        n_frames=ref.SMALL_FRAMES, max_trials=ref.SMALL_TRIALS, out_csv=out,
        variants=ref.SMALL_LEVERS, dtype=torch.float64, device="cpu",
        verbose=False, report=rep)
    jrows = [j["rows"][0] for j in jrecs]
    assert [r["variant"] for r in rows] == [j["variant"] for j in jrows] \
        == list(ref.SMALL_LEVERS)
    for j in jrecs:      # the warm start's per-trial scores
        assert _close(rep["warm"], j["scores"][0])
    for raw, j, r in zip(rep["rows"], jrows, rows):
        tol = _tol(raw["variant"])
        for k in ("mpe_mm", "mpjpe_mm", "comvel_rmse"):
            assert _close(raw[k], j[k], tol), (raw["variant"], k, raw[k],
                                                j[k])
        for k, base in (("dmpe_mm", "mpe_mm"), ("dmpjpe_mm", "mpjpe_mm")):
            assert _close(raw[k], j[k], tol, scale=j[base])
        assert _close(raw["comvel_improvement_pct"],
                      j["comvel_improvement_pct"], tol, scale=100.0)
        assert raw["mean_accepted_iters"] == j["mean_accepted_iters"]
        assert r["mean_accepted_iters"] == round(j["mean_accepted_iters"], 1)
    for sc, j, v in zip(rep["per_trial"], jrecs, ref.SMALL_LEVERS):
        assert _close(sc, j["scores"][1], _tol(v))
    assert _header(out)[0] == jrecs[0]["columns"] == list(rows[0])


def check_anchor(jrec):
    subject = tparams.get_subject("acinoset")
    datas, q0s, trials, fpss = tst._bench_trials(
        tbl.load_reference_trajectories(ref.SMALL_TRIALS))
    bat, _ = tbatch.pad_and_stack(datas, q0s, n_frames=ref.SMALL_FRAMES,
                                  dtype=torch.float64, device="cpu")
    qs = ref.anchor_inputs(trials, bat.cam.R[0, 0].numpy(),
                           bat.cam.t[0, 0].numpy(), ref.SMALL_FRAMES)
    gphs = [tcon.estimate_ground_height(tr.q_gt, subject) for tr in trials]
    assert _close(gphs, jrec["gphs"], 1e-12)
    rep = {}
    q = tbl.make_anchor_polish(subject, torch.float64, "cpu")(
        torch.as_tensor(qs), bat, trials, fpss, gphs, report=rep).numpy()
    changed = [bool(np.any(q[i] != qs[i])) for i in range(len(trials))]
    assert changed == jrec["changed"]
    assert changed[0] and rep["shifts"][0] != 0.0
    assert _close(q, jrec["q"])


def test_reference_trial_paths():
    assert tbl.reference_trial_paths() == [f"synthetic_gallop_{i}"
                                           for i in range(10)]
    assert tbl.reference_trial_paths(3) == tbl.reference_trial_paths()[:3]
    assert len(tbl.load_reference_trajectories(3)) == 3


def test_forced_vs_gated_matches_jax(record, tmp_path, monkeypatch):
    port_small(monkeypatch, tmp_path)
    check_fvg(record["fvg"], tmp_path)


def test_deadband_sweep_matches_jax(record, tmp_path, monkeypatch):
    port_small(monkeypatch, tmp_path)
    check_deadband([record["sweeps"]["deadband_floor"],
                    record["sweeps"]["deadband_0.05"]], tmp_path)


def test_lever_sweep_matches_jax(record, tmp_path, monkeypatch):
    port_small(monkeypatch, tmp_path)
    check_levers([record["sweeps"]["levers_production"],
                  record["sweeps"]["levers_overrides"]], tmp_path)


def test_anchor_polish_matches_jax(record, tmp_path, monkeypatch):
    port_small(monkeypatch, tmp_path)
    check_anchor(record["anchor"])


def test_forced_default_writes_nothing(tmp_path, monkeypatch):
    """``out_csv=None`` (the port's default) writes no file; the JAX
    default path would be under docs/artifacts."""
    port_small(monkeypatch, tmp_path)
    monkeypatch.chdir(tmp_path)
    before = set(os.listdir(tmp_path))
    tst.run_physics_lever_sweep(
        n_frames=ref.SMALL_FRAMES, max_trials=ref.SMALL_TRIALS,
        dtype=torch.float64,
        device="cpu", verbose=False,
        variants={"short": {"_stages": ((1.0, 1),)}})
    assert set(os.listdir(tmp_path)) == before


@pytest.mark.slow
def test_responses_match_live_jax(tmp_path, monkeypatch):
    """The fixture's JAX runs made live (the JAX package compiles every
    solver of the three studies; minutes on the CPU) and the port held to
    them as the tier-1 tests hold it to the record."""
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.parallel import batch as jbatch
    from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
    from cheetah_pose_estimation_tpu.pipeline import estimator as jest
    from cheetah_pose_estimation_tpu.pipeline import studies as jst
    from cheetah_pose_estimation_tpu.solver import kinematic as jkin
    from cheetah_pose_estimation_tpu.solver import kinetic as jkn

    dset = port_small(monkeypatch, tmp_path)
    ref.small_schedules(monkeypatch.setattr, jkin.KinematicFTE,
                        jkn.KineticFTE, jbatch, jda, jkn)
    monkeypatch.setattr(jest, "DATA_DRIVEN_DATASET", dset)
    loads, paths = jbl.load_reference_trajectories, jbl.reference_trial_paths
    monkeypatch.setattr(jbl, "load_reference_trajectories",
                        lambda m=None, **k: loads(ref.SMALL_TRIALS, **k))
    monkeypatch.setattr(jbl, "reference_trial_paths",
                        lambda m=None: paths(ref.SMALL_TRIALS))
    monkeypatch.setattr(jst, "round", lambda v, nd=None: v, raising=False)
    monkeypatch.setattr(jnp, "float32", jnp.float64)
    work = str(tmp_path / "jax")
    jfvg = ref.fvg(True, os.path.join(work, "fvg.csv"),
                   n_frames=ref.SMALL_FRAMES)
    rows = {r: ref.sweep_row(work, r, ref.SMALL_DEADBAND, ref.SMALL_LEVERS)
            for r in ref.SWEEP_ROWS}
    janchor = ref.small_anchor(loads)
    monkeypatch.undo()
    port_small(monkeypatch, tmp_path)
    check_fvg(jfvg, tmp_path)
    check_deadband([rows["deadband_floor"], rows["deadband_0.05"]],
                   tmp_path)
    check_levers([rows["levers_production"], rows["levers_overrides"]],
                 tmp_path)
    check_anchor(janchor)


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fvg_rows(values):
    """Made-up forced-vs-gated rows: every score column of trial i is
    ``values[i]``."""
    return [dict({k: float(v) for k in FVG_SCORES}, trial=f"t{i}")
            for i, v in enumerate(values)]


@pytest.mark.parametrize("case", ["equal", "unstable", "no_f64",
                                  "objective"])
def test_fvg_agree_rule(case):
    """chip_smoke's forced-vs-gated rule on made-up rows: the means within
    their bars as they are, or once a trial is witnessed: JAX float32
    missing its own float64 there, or the port's value lower with a lower
    prior-free cost of the free solve."""
    cs = _smoke()
    jax = [100.0, 100.0, 100.0, 100.0]
    port = {"equal": jax, "unstable": [150.0, 100.0, 100.0, 100.0],
            "no_f64": [150.0, 100.0, 100.0, 100.0],
            "objective": [50.0, 100.0, 100.0, 100.0]}[case]
    ref = {"f32": {"rows": _fvg_rows(jax), "c_free": [10.0] * 4},
           "f64": {"rows": _fvg_rows([130.0, 100.0, 100.0, 100.0])}}
    if case == "no_f64":
        ref["f64"] = {}
    c_free = [9.0, 10.0, 10.0, 10.0] if case == "objective" else [10.0] * 4
    gates, bad = cs.fvg_agree(_fvg_rows(port), {"c_free": c_free}, ref)
    assert len(gates) == len(FVG_SCORES)
    assert (len(bad) == len(gates)) == (case == "no_f64")
    if case in ("unstable", "objective"):
        assert all(g["witnessed"] == 1 and g["rel_unexplained"] == 0.0
                   for g in gates)


def test_sweep_rows_agree_rule():
    """A row both JAX runs recorded passes inside its bars; outside them it
    fails unless JAX float32 misses its own float64 by more on any of the
    row's columns (then the row is printed); a row either run did not
    record is printed, not gated."""
    cs = _smoke()
    keys = (("comvel_rmse", 0.05), ("mpe_mm", 0.02))
    j64 = [{"variant": v, "comvel_rmse": 1.0, "mpe_mm": 100.0}
           for v in ("a", "b", "c", "e")]
    j32 = [dict(j64[0]), dict(j64[1], mpe_mm=110.0), dict(j64[2])]
    rows = [{"variant": "a", "comvel_rmse": 1.04, "mpe_mm": 101.0},
            {"variant": "b", "comvel_rmse": 1.0, "mpe_mm": 108.0},
            {"variant": "c", "comvel_rmse": 1.0, "mpe_mm": 90.0},
            {"variant": "d", "comvel_rmse": 9.0, "mpe_mm": 9.0},
            {"variant": "e", "comvel_rmse": 9.0, "mpe_mm": 9.0}]
    bad = []
    gates = cs.sweep_rows_agree("levers", rows, {"f64": {"rows": j64},
                                                 "f32": {"rows": j32}},
                                "variant", keys, bad)
    assert [(g["row"], g["column"]) for g in gates] == [
        (v, k) for v in ("a", "b", "c") for k, _ in keys]
    assert [(g["row"], g["column"]) for g in bad] == [("c", "mpe_mm")]
    # row b: JAX float32 misses its float64 on mpe_mm, so the whole row
    # (its comvel_rmse too) is printed, not gated
    assert [g["set_aside"] for g in gates] == [False, False, True, True,
                                               False, False]
