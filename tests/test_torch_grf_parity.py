"""``pipeline/grf_parity`` and the reference-tree ground truths of the port
against the JAX package, float64, on the CPU, on a 2-trial 16-frame tree in
the layout of the reference's shipped solutions
(``chip_smoke.write_reference_tree``).

The JAX rows are computed live with JAX's force solve jitted: run eagerly,
as ``grf_parity`` runs it, JAX compiles each of its thousands of operations
at first use (~30 s here); the jitted solve is the same computation
(XLA's fusions move the torques by ~1e-8). The port's rows are held to
those and to the eager rows that ``tests/data/jax_h5_f64.json`` recorded
(``tests/data/jax_h5_reference.py``), within 1e-6 relative (1e-9 body
weights absolute). Without the tree the loaders return what they returned
before the tree was read: the procedural gallops.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl  # noqa: E402,E501
from cheetah_pose_estimation_tpu.pipeline import grf_parity as jgp  # noqa: E402,E501
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd  # noqa: E402,E501
from cheetah_pose_estimation_tpu.solver import kinetic as jkn  # noqa: E402
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib as tbl  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.pipeline import grf_parity as tgp  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd  # noqa: E402,E501

torch.set_num_threads(1)
with open(os.path.join(REPO, "tests", "data", "jax_h5_f64.json"),
          encoding="utf-8") as _f:
    RECORD = json.load(_f)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("reference"))
    return root, chip_smoke.write_reference_tree(root)


@pytest.fixture(scope="module")
def jax_rows(tree):
    orig = jkn.KineticFTE.forces
    jitted = {}

    def forces(self, q, kd):
        fn = jitted.setdefault(id(self), jax.jit(
            lambda q_, kd_: orig(self, q_, kd_)))
        return fn(q, kd)

    mp = pytest.MonkeyPatch()
    mp.setattr(jkn.KineticFTE, "forces", forces)
    try:
        with jax.enable_x64(True):
            df = jgp.grf_parity(out_csv=None, root=os.path.join(
                tree[0], "kinetic_dataset"), verbose=False)
    finally:
        mp.undo()
    return df


def _as_record(df):
    return [{k: (v if isinstance(v, str) else None if np.isnan(v)
                 else float(v) if isinstance(v, float) else int(v))
             for k, v in r.items()} for r in df.to_dict("records")]


def test_grf_parity_rows_match_jax(tree, jax_rows, tmp_path):
    rows = tgp.grf_parity(root=os.path.join(tree[0], "kinetic_dataset"),
                          verbose=False, device="cpu")
    assert list(jax_rows.columns) == list(tgp.COLUMNS)
    assert [list(r) for r in rows] == [list(tgp.COLUMNS)] * 2
    assert not chip_smoke.grf_rows_agree(rows, _as_record(jax_rows))
    assert not chip_smoke.grf_rows_agree(rows, RECORD["grf_parity"]["rows"])
    # flight and stance frames both present, every column finite
    assert all(np.isfinite(r[k]) for r in rows for k in tgp.COLUMNS[1:])
    # written as pandas writes the rows
    import pandas as pd

    out = tmp_path / "gp.csv"
    tgp.grf_parity(out_csv=str(out), root=os.path.join(
        tree[0], "kinetic_dataset"), verbose=False, device="cpu")
    assert out.read_text() == pd.DataFrame(rows).to_csv(index=False)


def test_reference_kinetic_solution_matches_jax(tree):
    d = os.path.join(tree[0], "kinetic_dataset")
    assert [os.path.relpath(p, d) for p in tgp.kinetic_trial_dirs(d)] == \
        [os.path.relpath(p, d) for p in jgp.kinetic_trial_dirs(d)] == \
        ["2009_09_07/arabia/trial06", "2009_09_07/shiraz/trial04"]
    for p in tgp.kinetic_trial_dirs(d):
        a, b = tgp.load_reference_kinetic_solution(p), \
            jgp.load_reference_kinetic_solution(p)
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("call", ["trajectories", "trajectories_kinetic",
                                  "trajectories_multiview", "trial_paths",
                                  "gt"])
def test_reference_loaders_match_jax(tree, monkeypatch, call):
    root, qs = tree
    for mod in (jbl, jrd, tbl, trd):
        monkeypatch.setattr(mod, "REF_TEST_SET", root)
    if call == "trajectories_multiview":
        monkeypatch.setenv("CHEETAH_GT_KINEMATIC", "1")
    if call.startswith("trajectories"):
        kw = dict(include_kinetic=call == "trajectories_kinetic")
        a, b = tbl.load_reference_trajectories(**kw), \
            jbl.load_reference_trajectories(**kw)
        assert len(a) == len(b) == (4 if kw["include_kinetic"] else 2)
        for (qa, sa, fa), (qb, sb, fb) in zip(a, b):
            assert np.array_equal(qa, qb) and (sa, fa) == (sb, fb)
        if call == "trajectories":
            names = tbl.reference_trial_paths()
            assert all(np.array_equal(q, qs[n]) for (q, _, _), n
                       in zip(a, names))
            assert [[s, f, chip_smoke.array_digest(q)] for q, s, f in a] \
                == RECORD["ref_tree"]["trajectories"]
        assert tbl.load_reference_trajectories(1, **kw)[0][0] is not None
    elif call == "trial_paths":
        assert tbl.reference_trial_paths() == jbl.reference_trial_paths() \
            == RECORD["ref_tree"]["trial_paths"]
        assert tbl.reference_trial_paths(1) == jbl.reference_trial_paths(1)
    else:
        got = {}
        for i, (c, d, t) in enumerate(trd.TEST_SET[:3]):
            a = trd._reference_gt_trajectory(d, c, t, 40 + 2 * i, i)
            assert np.array_equal(a, jrd._reference_gt_trajectory(
                d, c, t, 40 + 2 * i, i))
            got["/".join((d, c, t))] = chip_smoke.array_digest(a)
        for i, (c, d, t) in enumerate(trd.KINETIC_SET[:3]):
            kd = os.path.join("kinetic_dataset", d)
            a = trd._reference_gt_trajectory(kd, c, f"trial{t}", 50,
                                             100 + i, 200.0)
            assert np.array_equal(a, jrd._reference_gt_trajectory(
                kd, c, f"trial{t}", 50, 100 + i, 200.0))
            got["/".join((kd, c, f"trial{t}"))] = chip_smoke.array_digest(a)
        assert got == RECORD["ref_tree"]["gt"]


def test_without_the_tree(tmp_path, monkeypatch):
    """No tree: the procedural gallops as before, the same as JAX's; no
    force-plate trials, no rows."""
    missing = str(tmp_path / "absent")
    for mod in (jbl, jrd, tbl, trd):
        monkeypatch.setattr(mod, "REF_TEST_SET", missing)
    a, b = tbl.load_reference_trajectories(), jbl.load_reference_trajectories()
    assert len(a) == 10
    for i, ((qa, sa, fa), (qb, sb, fb)) in enumerate(zip(a, b)):
        assert np.array_equal(qa, tsyn.gallop_trajectory(40 + 2 * i, seed=i))
        assert np.array_equal(qa, qb) and (sa, fa) == (sb, fb) == (
            "acinoset", 120.0)
    assert tbl.reference_trial_paths(3) == jbl.reference_trial_paths(3) == [
        f"synthetic_gallop_{i}" for i in range(3)]
    c, d, t = trd.KINETIC_SET[0]
    assert np.array_equal(
        trd._reference_gt_trajectory(os.path.join("kinetic_dataset", d), c,
                                     f"trial{t}", 50, 100,
                                     fallback_fps=200.0),
        tsyn.gallop_trajectory(50, fps=200.0, seed=100))
    assert tgp.kinetic_trial_dirs(missing) == []
    assert tgp.grf_parity(root=missing, verbose=False, device="cpu") == []
