"""Port parity of the passive force elements and the torque map's
generalized forces against the JAX package, float64 on the CPU, and the
physical properties of the JAX package's own tests (``tests/test_passive.py``)
on the port.

Tolerances: the forces are the same float64 expressions, the drag's
Jacobian in closed form where JAX differentiates the link centres
(<= 1e-10 relative, the bar set for this slice; observed ~1e-15).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.dynamics import eom as jeom
from cheetah_pose_estimation_tpu.dynamics import passive as jpas
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu_torch.dynamics import eom as teom
from cheetah_pose_estimation_tpu_torch.dynamics import passive as tpas
from cheetah_pose_estimation_tpu_torch.models import params as tparams

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")
TSUBJECT = tparams.get_subject("acinoset")
SPRING_JOINTS = [("base", "tail0", "y"), ("tail0", "tail1", "z"),
                 ("bodyF", "neck", "x")]
DAMPER_JOINTS = [("base", "bodyF", "y"), ("UFL", "LFL", "y")]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _state(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=54) * 0.3
    q[2] += 0.6
    return q, rng.normal(size=54)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def test_tables_equal_jax():
    assert np.array_equal(tpas.cylinder_drag_coefficients(TSUBJECT),
                          jpas.cylinder_drag_coefficients(SUBJECT))
    for j in SPRING_JOINTS + DAMPER_JOINTS:
        assert np.array_equal(tpas.joint_coefficient_row(*j),
                              jpas.joint_coefficient_row(*j))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drag_matches_jax(seed):
    q, dq = _state(seed)
    c = jpas.cylinder_drag_coefficients(SUBJECT)
    ref = np.asarray(jpas.drag_generalized_forces(jnp.asarray(q),
                                                  jnp.asarray(dq), SUBJECT,
                                                  c))
    got = tpas.drag_generalized_forces(_t(q), _t(dq), TSUBJECT, c).numpy()
    assert _rel(got, ref) <= 1e-10
    # a batch of states at once, as the port's functions broadcast
    q2, dq2 = _state(seed + 10)
    got2 = tpas.drag_generalized_forces(_t([q, q2]), _t([dq, dq2]),
                                        TSUBJECT, c).numpy()
    assert _rel(got2[0], ref) <= 1e-10


@pytest.mark.parametrize("seed", [3, 4])
def test_springs_and_dampers_match_jax(seed):
    q, dq = _state(seed)
    js = jpas.make_torque_spring(SPRING_JOINTS, stiffness=[3.0, 5.0, 7.0],
                                 rest=0.1)
    ts = tpas.make_torque_spring(SPRING_JOINTS, stiffness=[3.0, 5.0, 7.0],
                                 rest=0.1, device="cpu")
    jd = jpas.make_torque_damper(DAMPER_JOINTS, damping=0.5)
    td = tpas.make_torque_damper(DAMPER_JOINTS, damping=0.5, device="cpu")
    for a, b in ((js, ts), (jd, td)):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), y.numpy())
    assert _rel(tpas.spring_potential(_t(q), ts).item(),
                float(jpas.spring_potential(jnp.asarray(q), js))) <= 1e-10
    assert _rel(tpas.spring_generalized_forces(_t(q), ts).numpy(),
                jpas.spring_generalized_forces(jnp.asarray(q), js)) <= 1e-10
    assert _rel(tpas.damper_generalized_forces(_t(dq), td).numpy(),
                jpas.damper_generalized_forces(jnp.asarray(dq), jd)) <= 1e-10
    c = jpas.cylinder_drag_coefficients(SUBJECT)
    ref = jpas.make_ext_q_fn(SUBJECT, drag_coeff=c, spring=js, damper=jd)(
        jnp.asarray(q), jnp.asarray(dq))
    got = tpas.make_ext_q_fn(TSUBJECT, drag_coeff=c, spring=ts, damper=td)(
        _t(q), _t(dq))
    assert _rel(got.numpy(), ref) <= 1e-10


@pytest.mark.parametrize("seed", [5, 6])
def test_torque_generalized_forces_match_jax(seed):
    tau = np.random.default_rng(seed).normal(size=22)
    fs = SUBJECT.total_mass * jeom.GRAVITY
    ref = jeom.torque_generalized_forces(jnp.asarray(tau), fs)
    got = teom.torque_generalized_forces(_t(tau), fs)
    assert got.shape == (54,) and _rel(got.numpy(), ref) <= 1e-10
    both = teom.torque_generalized_forces(_t([tau, 2 * tau]), fs)
    assert _rel(both[1].numpy(), 2 * np.asarray(ref)) <= 1e-10


# -- the physical properties of tests/test_passive.py, on the port ---------

def test_drag_dissipates_and_is_quadratic():
    q, dq = (_t(x) for x in _state(1))
    c = tpas.cylinder_drag_coefficients(TSUBJECT)
    assert c.shape == (17,) and (c > 0).all()
    Q = tpas.drag_generalized_forces(q, dq, TSUBJECT, c)
    assert float(Q @ dq) < 0.0
    Q2 = tpas.drag_generalized_forces(q, 2.0 * dq, TSUBJECT, c)
    np.testing.assert_allclose(float(Q2 @ (2 * dq)), 8.0 * float(Q @ dq),
                               rtol=1e-6)


def test_spring_is_conservative_and_silent_at_rest():
    q = _t(_state(2)[0])
    spring = tpas.make_torque_spring(
        [("base", "tail0", "y"), ("tail0", "tail1", "y")], stiffness=3.0,
        rest=0.1, device="cpu")
    qg = q.clone().requires_grad_(True)
    Q_ad = -torch.autograd.grad(tpas.spring_potential(qg, spring), qg)[0]
    np.testing.assert_allclose(tpas.spring_generalized_forces(q, spring),
                               Q_ad, atol=1e-12)
    q_rest = q.numpy().copy()
    for a, b in (("base", "tail0"), ("tail0", "tail1")):
        i, j = np.nonzero(tpas.joint_coefficient_row(a, b, "y"))[0]
        q_rest[j] = q_rest[i] + 0.1
    np.testing.assert_allclose(
        tpas.spring_generalized_forces(_t(q_rest), spring), 0.0, atol=1e-12)


def test_damper_dissipates():
    dq = _t(_state(3)[1])
    damper = tpas.make_torque_damper(
        [("base", "bodyF", "y"), ("bodyF", "neck", "y")], damping=0.5,
        device="cpu")
    assert float(tpas.damper_generalized_forces(dq, damper) @ dq) <= 0.0
    np.testing.assert_allclose(
        tpas.damper_generalized_forces(torch.zeros(54, dtype=torch.float64),
                                       damper), 0.0, atol=1e-12)
