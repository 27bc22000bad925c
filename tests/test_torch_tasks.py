"""Port parity of the trajectory-generation tasks against the JAX package,
float64 on the CPU, at a small size (``SMALL`` of
``tests/data/jax_dynamics_reference.py``: a 16-frame stop at 8 m/s and a
12-frame gallop at 9 m/s): the tasks' q0, TaskSpec arrays and
configuration equal; the cost at q0; and, at q0 moved 1e-6 off its lateral
symmetry (``perturbed``), the cost, gradient and normal blocks and the
state after 12 and 10 LM steps (``gn.lm_solve``), against the JAX run
recorded in ``tests/data/jax_dynamics_f64.json`` (no JAX task solver is
compiled here).

Why perturbed: at the tasks' q0 every settled frame is laterally
symmetric, so the stance feet's sideways polygon forces are zero up to
round-off (~1e-11 body weights) and their sign decides which of them the
per-frame elimination treats as free; JAX's and the port's rounding pick
differently, and the gradient and curvature with them. A 1e-6 move makes
the choice well posed.

Tolerances: cost, gradient and normal blocks are the same float64
expressions (<= 1e-9 relative); after the LM steps q within 1e-6 with the
same step and acceptance counts.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.dynamics import tasks as jt
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu_torch.dynamics import tasks as tt
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.ops import banded
from cheetah_pose_estimation_tpu_torch.solver import gn

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "jax_dynamics_reference", os.path.join(HERE, "data",
                                           "jax_dynamics_reference.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)
SUBJECT = jparams.get_subject("acinoset")
TSUBJECT = tparams.get_subject("acinoset")
BUILD = {"stop": (jt.high_speed_stop, tt.high_speed_stop),
         "gallop": (jt.periodic_gallop, tt.periodic_gallop)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def record():
    import json

    with open(os.path.join(HERE, "data", "jax_dynamics_f64.json"),
              encoding="utf-8") as f:
        rec = json.load(f)
    assert rec["small_scale"] == ref.SMALL_SCALE
    assert rec["small_seed"] == ref.SMALL_SEED
    return rec


def _port_task(name):
    """The port's TrajectoryTask and q0 for ``SMALL[name]``, float64 on the
    CPU."""
    got = {}
    solve = tt.TrajectoryTask.solve

    def grab(self, q0, max_iters=None, ftol=1e-10):
        got.update(task=self, q0=np.asarray(q0))
        raise StopIteration

    tt.TrajectoryTask.solve = grab
    try:
        BUILD[name][1](TSUBJECT, device="cpu", dtype=torch.float64,
                       **ref.SMALL[name][0])
    except StopIteration:
        pass
    finally:
        tt.TrajectoryTask.solve = solve
    return got["task"], got["q0"]


@pytest.mark.parametrize("name", ["stop", "gallop"])
def test_task_setup_matches_jax(name):
    jtask, jq0 = ref.capture_task(BUILD[name][0], SUBJECT,
                                  **ref.SMALL[name][0])
    ttask, tq0 = _port_task(name)
    assert np.array_equal(tq0, jq0)
    for f in jt.TaskSpec._fields:
        assert np.array_equal(getattr(ttask.spec, f).numpy(),
                              np.asarray(getattr(jtask.spec, f))), f
    assert ttask.config == tt.TaskConfig(**vars(jtask.config))
    assert ttask.fte.config.foot_height_bound \
        == jtask.fte.config.foot_height_bound
    d = ttask.data
    assert d.stance.shape == (1,) + jtask.data.stance.shape
    assert torch.equal(d.stance[0], torch.as_tensor(
        np.array(jtask.data.stance)))
    assert float(d.base.h[0]) == float(jtask.data.base.h)


def test_task_helpers_equal_jax():
    assert tt.GALLOP_FOOT_ORDER == jt.GALLOP_FOOT_ORDER
    for f in ("_LEG_LINKS", "_BODY_SEGMENTS", "_ALL_LINKS", "_CROUCH_FRONT",
              "_CROUCH_BACK"):
        assert getattr(tt, f) == getattr(jt, f)
    assert np.array_equal(tt._crouch_pose(0.6), jt._crouch_pose(0.6))
    assert np.array_equal(tt._neutral_pose(), jt._neutral_pose())
    assert np.array_equal(tt.sin_around_touchdown(7, 20, 30.0),
                          jt.sin_around_touchdown(7, 20, 30.0))
    assert [tt._ang_index(l, c) for l in tt._ALL_LINKS
            for c in ("phi", "theta", "psi")] == [
        jt._ang_index(l, c) for l in jt._ALL_LINKS
        for c in ("phi", "theta", "psi")]
    rows_t, rows_j = [], []
    mask = np.arange(6) > 2
    tt._box_rows(rows_t, "neck", "psi", -0.1, 0.2, mask, center=np.pi)
    jt._box_rows(rows_j, "neck", "psi", -0.1, 0.2, mask, center=np.pi)
    for a, b in zip(tt._pack_boxes(rows_t, 6), jt._pack_boxes(rows_j, 6)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", ["stop", "gallop"])
def test_cost_gradient_and_normal_match_jax(record, name):
    r = record["small"][name]
    task, q0 = _port_task(name)
    t = lambda x: torch.as_tensor(np.asarray(x))[None]
    assert _rel(task._cost(t(q0)).item(), r["cost_q0"]) <= 1e-9
    qp = t(ref.perturbed(q0))
    assert _rel(task._cost(qp).item(), r["cost"]) <= 1e-9
    g, H = task._normal(qp)
    assert g.shape == (1,) + q0.shape
    assert H.diag.shape == (1,) + q0.shape + (54,)
    assert H.lower.shape == (1, 3) + q0.shape + (54,)
    assert _rel(g[0].numpy(), r["g"]) <= 1e-9
    assert _rel(torch.diagonal(H.diag[0], dim1=1, dim2=2).numpy(),
                r["H_diag_diag"]) <= 1e-9
    vs = np.random.default_rng(ref.SMALL_SEED + 1).normal(
        size=(2,) + q0.shape)
    for v, hv in zip(vs, r["Hv"]):
        assert _rel(banded.matvec(H, t(v))[0].numpy(), hv) <= 1e-9
    # the curvature is symmetric PSD with the 1e-2 ridge: every block
    # system solves
    assert torch.isfinite(banded.solve(H, g)).all()


@pytest.mark.parametrize("name", ["stop", "gallop"])
def test_lm_steps_match_jax(record, name):
    r = record["small"][name]
    task, q0 = _port_task(name)
    qp = torch.as_tensor(ref.perturbed(q0))[None]
    st = gn.lm_solve(task._cost, task._normal, qp,
                     gn.LMConfig(max_iters=r["steps"], ftol=1e-10, lam0=1.0))
    assert (int(st.it[0]), int(st.n_accepted[0])) == (r["iterations"],
                                                      r["accepted"])
    assert r["accepted"] > 0
    assert np.abs(st.q[0].numpy() - np.asarray(r["q"])).max() <= 1e-6
    assert _rel(st.cost.item(), r["lm_cost"]) <= 1e-9


def test_solve_returns_the_jax_keys():
    """``solve`` through ``high_speed_stop``: the JAX result's keys and
    shapes (two LM steps)."""
    out = tt.high_speed_stop(TSUBJECT, n_frames=8, settle_frames=3,
                             max_iters=2, device="cpu", dtype=torch.float64)
    assert sorted(out) == sorted([
        "q", "dq", "tau", "grf_z", "grf_xy", "cost", "iterations",
        "accepted", "eom_cost", "torque_cost", "eom_rms_bw", "final_speed",
        "stop_distance"])
    assert out["q"].shape == out["dq"].shape == (8, 54)
    assert out["tau"].shape == (8, 22) and out["grf_xy"].shape == (8, 4, 4)
    assert out["iterations"] == 2 and np.isfinite(out["cost"])
