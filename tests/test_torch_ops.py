"""Port parity, ops and skeleton: the PyTorch functions against their JAX
counterparts in float64 on inputs made with numpy from a seed, and every
closed-form Jacobian against ``torch.autograd.functional.jacobian``.

Tolerances: float64 closed forms against autodiff of the same expressions
agree to rounding, so 1e-10 (relative to the largest entry) leaves five
orders of headroom over the ~1e-15 observed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.ops import camera as jcam
from cheetah_pose_estimation_tpu.ops import losses as jloss
from cheetah_pose_estimation_tpu.ops import rotations as jrot
from cheetah_pose_estimation_tpu_torch.models import skeleton as tsk
from cheetah_pose_estimation_tpu_torch.ops import camera as tcam
from cheetah_pose_estimation_tpu_torch.ops import losses as tloss
from cheetah_pose_estimation_tpu_torch.ops import rotations as trot

torch.set_num_threads(1)
TOL = 1e-10
SUBJECT = jparams.get_subject("acinoset")


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.mark.parametrize("seed", [0, 1])
def test_rotation_and_derivative(seed):
    ang = np.random.default_rng(seed).uniform(-3, 3, size=(6, 3))
    R, dR = trot.euler_zyx_and_derivative(_t(ang))
    assert _rel(jrot.euler_zyx(jnp.asarray(ang)), R) < TOL
    dR_jax = jax.vmap(jax.jacfwd(jrot.euler_zyx))(jnp.asarray(ang))
    assert _rel(dR_jax, dR) < TOL
    auto = torch.autograd.functional.jacobian(trot.euler_zyx, _t(ang[0]))
    assert _rel(auto, dR[0]) < TOL


def test_marker_coefficients():
    assert _rel(jsk.marker_coefficients(SUBJECT),
                tsk.marker_coefficients(SUBJECT)) < TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_fk_and_jacobian(seed):
    q = np.random.default_rng(seed).normal(size=(4, 54))
    ref = np.asarray(jsk.fk_markers(q, SUBJECT))
    assert _rel(ref, tsk.fk_markers(_t(q), SUBJECT)) < TOL
    assert _rel(ref, tsk.fk_markers_linear(_t(q), SUBJECT)) < TOL
    pts, J = tsk.fk_markers_and_jacobian(_t(q), SUBJECT)
    pj, Jj = jax.vmap(lambda x: jsk.fk_markers_and_jacobian(x, SUBJECT))(
        jnp.asarray(q))
    assert _rel(pj, pts) < TOL and _rel(Jj, J) < TOL
    auto = torch.autograd.functional.jacobian(
        lambda x: tsk.fk_markers_linear(x, SUBJECT), _t(q[0]))
    assert _rel(auto, J[0]) < TOL
    assert _rel(jsk.com_position(q, SUBJECT),
                tsk.com_position(_t(q), SUBJECT)) < TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_joint_residuals_and_jacobian(seed):
    q = np.random.default_rng(seed).normal(size=(3, 54))
    r, J = tsk.joint_residuals_and_jacobian(_t(q))
    assert _rel(jax.vmap(jsk.joint_residuals)(jnp.asarray(q)), r) < TOL
    assert _rel(jax.vmap(jax.jacfwd(jsk.joint_residuals))(jnp.asarray(q)),
                J) < TOL
    auto = torch.autograd.functional.jacobian(tsk.joint_residuals, _t(q[1]))
    assert _rel(auto, J[1]) < TOL


def _scene_points(seed):
    rng = np.random.default_rng(seed)
    sc = jsyn.ring_cameras(np.array([1.0, 0.0, 0.5]), n_cams=3, seed=seed)
    X = rng.normal(size=(9, 3)) * 0.5 + np.array([1.0, 0.0, 0.5])
    return sc, X


@pytest.mark.parametrize("model", ["fisheye", "pinhole"])
@pytest.mark.parametrize("seed", [0, 3])
def test_projection_and_jacobian(model, seed):
    sc, X = _scene_points(seed)
    jproj = getattr(jcam, f"project_{model}")
    tproj = getattr(tcam, f"project_{model}_and_jacobian")
    for c in range(3):
        cam = (sc.K[c], sc.D[c], sc.R[c], sc.t[c])
        uv, J = tproj(_t(X), *map(_t, cam))
        assert _rel(jproj(X, *cam), uv) < TOL
        Jj = jax.vmap(jax.jacfwd(lambda p: jproj(p, *cam)))(jnp.asarray(X))
        assert _rel(Jj, J) < TOL
        auto = torch.autograd.functional.jacobian(
            lambda p: tproj(p, *map(_t, cam))[0], _t(X[0]))
        assert _rel(auto, J[0]) < TOL


@pytest.mark.parametrize("model", ["fisheye", "pinhole"])
def test_undistort_and_backproject(model):
    sc, X = _scene_points(1)
    cam = (sc.K[0], sc.D[0])
    uv = np.asarray(jcam.project_fisheye(X, *cam, sc.R[0], sc.t[0]))
    assert _rel(getattr(jcam, f"undistort_{model}")(uv, *cam),
                getattr(tcam, f"undistort_{model}")(_t(uv), *map(_t, cam))
                ) < TOL
    ab = np.random.default_rng(2).normal(size=(5, 2)) * 0.1
    ref = np.stack([np.asarray(jcam.backproject_to_distance(
        a, 3.3, sc.R[0], sc.t[0])) for a in ab])
    assert _rel(ref, tcam.backproject_to_distance(
        _t(ab), 3.3, _t(sc.R[0]), _t(sc.t[0]))) < TOL


@pytest.mark.parametrize("scale", [10.0, 3.0, 1.0])
def test_gauss_newton_weights(scale):
    rng = np.random.default_rng(int(scale))
    r = np.concatenate([rng.normal(size=300) * 30 * scale, [0.0, -2.0]])
    w = rng.uniform(0.0, 1.0, size=r.shape)
    w[:5] = 0.0
    p = (3 * scale, 10 * scale, 20 * scale)
    g, h = jloss.gauss_newton_weights(jnp.asarray(r), jnp.asarray(w),
                                      jloss.redescending, 1e-3,
                                      loss_params=tuple(map(jnp.asarray, p)))
    g2, h2 = tloss.gauss_newton_weights(_t(r), _t(w), 1e-3,
                                        loss_params=tuple(map(_t, p)))
    assert _rel(g, g2) < TOL and _rel(h, h2) < TOL
    assert _rel(jloss.redescending(jnp.asarray(w * r), *p),
                tloss.redescending(_t(w * r), *p)) < TOL
    e = _t(r[:20])
    auto = torch.autograd.functional.jacobian(
        lambda x: tloss.redescending(x, *p).sum(), e)
    assert _rel(auto, tloss.redescending_psi(e, *p)) < TOL


def test_gauss_newton_weights_float32_overflow_matches_jax():
    """At s = 10 a float32 psi overflows (exp(200)) to NaN in the JAX
    package's autodiff; the port reproduces that bit for bit."""
    r = np.array([0.0, 1.0, -5.0, 150.0, 250.0], np.float32)
    w = np.ones_like(r)
    p = (30.0, 100.0, 200.0)
    g, _ = jloss.gauss_newton_weights(
        jnp.asarray(r), jnp.asarray(w), jloss.redescending, 1e-3,
        loss_params=tuple(jnp.asarray(v, jnp.float32) for v in p))
    g2, _ = tloss.gauss_newton_weights(
        torch.as_tensor(r), torch.as_tensor(w), 1e-3,
        loss_params=tuple(torch.tensor(v) for v in p))
    np.testing.assert_array_equal(np.isnan(np.asarray(g)),
                                  torch.isnan(g2).numpy())
    assert np.isnan(np.asarray(g)[:3]).all()
