"""The agreement rule chip_smoke's dataset-CLI phase holds the port's
per-mode means to against the JAX CLI run (``chip_smoke.cli_gap``), the
force-plate phase's rule against the JAX float64 run
(``chip_smoke.kinetic_gate``), the studies phase's rule for the
degradation sweep (``chip_smoke.sweep_gate``), and the artifact layout it
compares (``chip_smoke.artifacts``), on made-up values.
"""
import importlib.util
import json
import os
import pickle

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _smoke()
JAX = [100.0, 50.0, 40.0, 30.0]
OBJ = [10.0, 10.0, 10.0, 10.0]


@pytest.mark.parametrize("case", ["equal", "inside", "outside_both_ways"])
def test_gap_without_witness(case):
    """No trial is witnessed (the port's objectives are not lower): the
    gap is the plain relative gap of the means, either way."""
    port = {"equal": JAX, "inside": [101.0, 50.0, 40.0, 30.0],
            "outside_both_ways": [110.0, 50.0, 40.0, 30.0]}[case]
    g = cs.cli_gap(port, JAX, OBJ, OBJ, [True] * 4)
    rel = (np.mean(port) - np.mean(JAX)) / np.mean(JAX)
    assert g["witnessed"] == 0
    assert g["rel"] == pytest.approx(rel, abs=1e-15)
    assert g["rel_unexplained"] == pytest.approx(rel, abs=1e-15)
    g = cs.cli_gap(-np.asarray(port) + 2 * np.asarray(JAX), JAX, OBJ, OBJ,
                   [True] * 4)
    assert g["rel"] == pytest.approx(-rel, abs=1e-15)


def test_witnessed_trial_is_set_aside():
    """A trial where the port is lower and its objective lower by more
    than TOL_OBJ is set aside; one lower by less, one of a different
    problem and one where the port is higher are not."""
    port = [80.0, 45.0, 36.0, 33.0]
    pobj = [9.0, 10.0 * (1 - cs.TOL_OBJ / 2), 9.0, 9.0]
    comparable = [True, True, False, True]
    g = cs.cli_gap(port, JAX, pobj, OBJ, comparable)
    assert g["witnessed"] == 1
    kept = np.array([100.0, 45.0, 36.0, 33.0])
    assert g["rel_unexplained"] == pytest.approx(
        (kept.mean() - np.mean(JAX)) / np.mean(JAX), abs=1e-15)


def test_artifacts_layout(tmp_path):
    """``artifacts`` records a pickle's keys and shapes, a reprojection
    CSV's header, row count and frame range, a contact file's keys, a force
    table's header and the results table's header and index, by path."""
    d = tmp_path / "2019_03_09" / "jules" / "flick1" / "fte_kinematic"
    d.mkdir(parents=True)
    with open(d / "fte.pickle", "wb") as f:
        pickle.dump({"q": np.zeros((5, 54)), "obj_cost": 1.5,
                     "extra": {"a": None}}, f)
    (d / "cam1_fte.csv").write_text("bodyparts,nose,nose\ncoords,x,y\n"
                                    "0,1.0,2.0\n4,1.0,2.0\n")
    g = tmp_path / "2019_03_09" / "jules" / "flick1" / "grf"
    g.mkdir()
    (g / "autogen-contact.json").write_text(json.dumps({"b": 1, "a": 2}))
    (g / "data_synth.csv").write_text("force_plate,frame,Fx,Fy,Fz\n"
                                      "0,0,0.5,0.0,1.5\n")
    (tmp_path / "dataset_results.csv").write_text("t,x\nm,y\nmpe,1\n")
    a = cs.artifacts(str(tmp_path))
    p = os.path.join("2019_03_09", "jules", "flick1")
    assert a[os.path.join(p, "fte_kinematic", "fte.pickle")] == {
        "extra": {"a": "None"}, "obj_cost": "float", "q": [5, 54]}
    assert a[os.path.join(p, "fte_kinematic", "cam1_fte.csv")] == {
        "header": [["bodyparts", "nose", "nose"], ["coords", "x", "y"]],
        "rows": 2, "frames": ["0", "4"]}
    assert a[os.path.join(p, "grf", "autogen-contact.json")] == ["a", "b"]
    assert a[os.path.join(p, "grf", "data_synth.csv")] == {
        "header": ["force_plate", "frame", "Fx", "Fy", "Fz"]}
    assert a["dataset_results.csv"] == {"header": [["t", "x"], ["m", "y"]],
                                        "index": ["mpe"]}


def test_unstable_reference_trial_is_set_aside():
    """A trial where the reference does not reproduce itself is set aside
    whatever the objectives say; the count of each kind of witness is
    reported."""
    port = [60.0, 45.0, 40.0, 30.0]
    g = cs.cli_gap(port, JAX, OBJ, OBJ, [True] * 4,
                   unstable=[True, False, False, False])
    assert (g["witnessed"], g["witnessed_objective"],
            g["witnessed_unstable"]) == (1, 0, 1)
    kept = np.array([100.0, 45.0, 40.0, 30.0])
    assert g["rel_unexplained"] == pytest.approx(
        (kept.mean() - np.mean(JAX)) / np.mean(JAX), abs=1e-15)
    assert g["rel"] == pytest.approx(
        (np.mean(port) - np.mean(JAX)) / np.mean(JAX), abs=1e-15)


@pytest.mark.parametrize("port,f32,ok", [
    (19.5, 19.4, True),      # within 2 % of float64
    (19.0, 19.4, True),      # within 2 % the other way
    (20.0, 19.4, False),     # outside, and JAX float32 is inside
    (24.0, 25.0, False),     # JAX float32 misses by 30 %: no wider bar
    (19.68, 25.0, True),     # within 2 %, JAX float32 far off
    (18.9, 25.0, False),     # just outside below, JAX float32 far off
    (14.0, 25.0, False),     # far below float64
])
def test_kinetic_gate(port, f32, ok):
    """The port's mean against JAX float64 (here 19.3) within 2 % either
    way; the JAX float32 mean is reported and never widens the bar."""
    g = cs.kinetic_gate(port, 19.3, f32, 0.02)
    assert g["ok"] is ok
    assert g["rel_f64"] == pytest.approx((port - 19.3) / 19.3, abs=1e-15)
    assert g["rel_f32"] == pytest.approx((port - f32) / f32, abs=1e-15)
    assert g["jax_f32_vs_f64"] == pytest.approx((f32 - 19.3) / 19.3,
                                                abs=1e-15)


@pytest.mark.parametrize("port, f32, ok, aside", [
    (40.0, 40.1, True, False),       # equal to JAX float64
    (40.79, 40.1, True, False),      # +1.98 %, inside
    (39.21, 40.1, True, False),      # -1.98 %, inside
    (40.9, 40.1, False, False),      # +2.25 %, outside
    (39.1, 40.1, False, False),      # -2.25 %, outside the other way
    (44.0, 41.0, True, True),        # JAX float32 +2.5 % off its float64:
    (36.0, 38.9, True, True),        # set aside, either way
    (40.9, 40.79, False, False)])    # JAX float32 +1.98 %: still gated
def test_sweep_gate(port, f32, ok, aside):
    """A degradation-sweep mean against JAX float64 (here 40.0) within 2 %
    either way, unless JAX float32 itself misses its float64 by more than
    2 % at that rate: then it is printed, not gated."""
    g = cs.sweep_gate(port, 40.0, f32)
    assert g["ok"] is ok and g["set_aside"] is aside
    assert g["tol"] == 0.02
    assert g["rel_f64"] == pytest.approx((port - 40.0) / 40.0, abs=1e-15)
    assert g["jax_f32_vs_f64"] == pytest.approx((f32 - 40.0) / 40.0,
                                                abs=1e-15)


def test_sweep_agree_gates_recorded_rates_only():
    """``sweep_agree`` gates each column at the rates both JAX runs
    recorded, and prints the others ungated."""
    rep = {"rows": [dict(rate=r, default_mpjpe=40.0 + r, dd_mpjpe=30.0,
                         physics_mpjpe=31.0) for r in (0.0, 8.0)],
           "prior_ok": [[True], [True]], "per_trial": [{}, {}]}
    f64 = [dict(rate=0.0, default_mpjpe=40.0, dd_mpjpe=30.3,
                physics_mpjpe=35.0)]
    f32 = [dict(rate=0.0, default_mpjpe=40.1, dd_mpjpe=30.0,
                physics_mpjpe=31.0), dict(rate=8.0, default_mpjpe=1.0,
                                          dd_mpjpe=1.0, physics_mpjpe=1.0)]
    gates = cs.sweep_agree(rep, {"f64": {"rows": f64}, "f32": {"rows": f32}})
    assert [(g["rate"], g["column"]) for g in gates] == [
        (0.0, "default_mpjpe"), (0.0, "dd_mpjpe"), (0.0, "physics_mpjpe")]
    assert [g["ok"] for g in gates] == [True, True, True]
    assert [g["set_aside"] for g in gates] == [False, False, True]
