"""Port parity of the forward simulator against the JAX package, float64
on the CPU: the contact forces and the accelerations at seeded random
states (some feet below the ground), a 50-step RK4 rollout with a pose
hold and passive elements, the drop pose; and the physical properties of
the JAX package's own tests (``tests/test_simulate.py``,
``tests/test_passive.py``) on the port at a small size.

Tolerances: one derivative is the same float64 expression with the feet
differentiated in closed form where JAX uses autodiff (<= 1e-10
relative); 50 RK4 steps of it, each through a 54x54 Cholesky (<= 1e-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.dynamics import eom as jeom
from cheetah_pose_estimation_tpu.dynamics import passive as jpas
from cheetah_pose_estimation_tpu.dynamics import simulate as jsim
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu_torch.dynamics import eom as teom
from cheetah_pose_estimation_tpu_torch.dynamics import passive as tpas
from cheetah_pose_estimation_tpu_torch.dynamics import simulate as tsim
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.models import skeleton as tsk

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")
TSUBJECT = tparams.get_subject("acinoset")
CP = jsim.ContactParams()
TCP = tsim.ContactParams()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _state(seed):
    """A crouched drop pose lowered so some feet are below the ground,
    moving, with a random torque."""
    rng = np.random.default_rng(seed)
    q = jsim.drop_pose(SUBJECT, height=0.55) + rng.normal(scale=0.1,
                                                          size=54)
    h = np.asarray(jeom.foot_points(jnp.asarray(q), SUBJECT))[:, 2]
    q[2] -= h.mean()
    return q, rng.normal(size=54), rng.normal(size=22)


def test_contact_params_and_drop_pose_equal_jax():
    assert tuple(TCP) == tuple(CP)
    for z_rot, height in ((0.0, 1.0), (0.3, 0.8)):
        assert np.array_equal(tsim.drop_pose(TSUBJECT, z_rot, height),
                              jsim.drop_pose(SUBJECT, z_rot, height))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contact_forces_and_accel_match_jax(seed):
    q, dq, tau = _state(seed)
    F_ref = np.asarray(jsim.contact_forces(jnp.asarray(q), jnp.asarray(dq),
                                           SUBJECT, CP))
    F = tsim.contact_forces(_t(q), _t(dq), TSUBJECT, TCP).numpy()
    assert (F_ref[:, 2] > 0).any() and (F_ref[:, 2] == 0).any()
    assert _rel(F, F_ref) <= 1e-10
    js = jpas.make_torque_spring([("base", "tail0", "y")], stiffness=50.0)
    jd = jpas.make_torque_damper([("base", "tail0", "y")], damping=5.0)
    ts = tpas.make_torque_spring([("base", "tail0", "y")], stiffness=50.0,
                                 device="cpu")
    td = tpas.make_torque_damper([("base", "tail0", "y")], damping=5.0,
                                 device="cpu")
    c = jpas.cylinder_drag_coefficients(SUBJECT)
    for jext, text in ((None, None),
                       (jpas.make_ext_q_fn(SUBJECT, c, js, jd),
                        tpas.make_ext_q_fn(TSUBJECT, c, ts, td))):
        ref = jsim._accel(jnp.asarray(q), jnp.asarray(dq), jnp.asarray(tau),
                          SUBJECT, CP, ext_q_fn=jext)
        got = tsim._accel(_t(q), _t(dq), _t(tau), TSUBJECT, TCP,
                          ext_q_fn=text)
        assert _rel(got.numpy(), ref) <= 1e-10


def test_simulate_50_steps_matches_jax():
    """50 RK4 steps of 2e-4 s (recorded every 10) from a state in contact,
    with a PD pose hold (the drop test's) and drag, spring and damper."""
    q0, dq0, _ = _state(3)
    B = np.asarray(jeom.TORQUE_MAP.B)
    jB, tB = jnp.asarray(B), _t(B)
    jq0, tq0 = jnp.asarray(q0), _t(q0)
    c = jpas.cylinder_drag_coefficients(SUBJECT)
    joints = [("base", "tail0", "y"), ("UBL", "LBL", "y")]
    jext = jpas.make_ext_q_fn(SUBJECT, c,
                              jpas.make_torque_spring(joints, 40.0, 0.2),
                              jpas.make_torque_damper(joints, 3.0))
    text = tpas.make_ext_q_fn(
        TSUBJECT, c, tpas.make_torque_spring(joints, 40.0, 0.2, "cpu"),
        tpas.make_torque_damper(joints, 3.0, "cpu"))
    kw = dict(duration=50 * 2e-4, dt=2e-4, record_every=10)
    qj, dqj = jsim.simulate(
        SUBJECT, q0, dq0, ext_q_fn=jext,
        tau_fn=lambda t, s: 300.0 * (jB.T @ (jq0 - s.q))
        - 5.0 * (jB.T @ s.dq), **kw)
    qt, dqt = tsim.simulate(
        TSUBJECT, q0, dq0, ext_q_fn=text,
        tau_fn=lambda t, s: 300.0 * ((tq0 - s.q) @ tB) - 5.0 * (s.dq @ tB),
        device="cpu", **kw)
    assert qt.shape == (6, 54) == np.asarray(qj).shape
    assert _rel(qt, qj) <= 1e-8 and _rel(dqt, dqj) <= 1e-8
    assert np.abs(np.asarray(qj) - q0).max() > 1e-4    # it moved


# -- the physical properties of the JAX tests, on the port -----------------

def test_ballistic_com_follows_gravity():
    """Above the ground the centre of mass free-falls (the JAX test's
    throw, 0.05 s instead of 0.2)."""
    q0 = tsim.drop_pose(TSUBJECT, height=3.0)
    dq0 = np.zeros(54)
    dq0[0] = 4.0
    q, _ = tsim.simulate(TSUBJECT, q0, dq0, 0.05, dt=5e-4, record_every=20,
                         device="cpu")
    com0 = tsk.com_position(_t(q[0]), TSUBJECT).numpy()
    com1 = tsk.com_position(_t(q[-1]), TSUBJECT).numpy()
    t = (q.shape[0] - 1) * 20 * 5e-4
    expect = com0 + np.array([4.0 * t, 0.0, -0.5 * teom.GRAVITY * t ** 2])
    np.testing.assert_allclose(com1, expect, atol=2e-3)


def test_tail_spring_pulls_toward_rest():
    """A damped tail spring pulls a kinked tail toward its rest angle
    during a short passive drop (the JAX test's setting)."""
    q0 = tsim.drop_pose(TSUBJECT, height=0.9)
    g = tpas.joint_coefficient_row("base", "tail0", "y")
    i, j = np.nonzero(g)[0]
    q0[j] = q0[i] + 0.8
    ext = tpas.make_ext_q_fn(
        TSUBJECT,
        spring=tpas.make_torque_spring([("base", "tail0", "y")], 200.0,
                                       device="cpu"),
        damper=tpas.make_torque_damper([("base", "tail0", "y")], 20.0,
                                       device="cpu"))
    qs, _ = tsim.simulate(TSUBJECT, q0, np.zeros(54), duration=0.12,
                          dt=2e-4, ext_q_fn=ext, record_every=100,
                          device="cpu")
    rel = qs @ g
    assert np.all(np.isfinite(qs))
    assert abs(rel[-1]) < abs(rel[0]) * 0.8


def test_drop_test_short_is_finite_and_falls():
    out = tsim.drop_test(TSUBJECT, initial_height=0.8, duration=0.02,
                         device="cpu")
    assert out["q"].shape == (6, 54) and np.isfinite(out["q"]).all()
    assert out["final_base_height"] < 0.8 and out["upright"]
    assert out["final_foot_heights"].shape == (4,)
