"""Port parity of the multi-view reconstruction against the JAX package, in
float64: two-view DLT triangulation, the multi-view spine and the multi-view
initial trajectory, and the 6-camera kinematic cost, gradient and normal
equations (the ground-truth mode's system).

Tolerances: the triangulation goes through two SVD implementations
(<= 1e-10 relative; observed ~1e-14), the initialisation through them and a
spline fit (<= 1e-10); cost terms, gradient and normal blocks are the same
float64 expressions (<= 1e-12 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.ops import camera as jcam
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.pipeline import initialization as jinit
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.ops import camera as tcam
from cheetah_pose_estimation_tpu_torch.pipeline import initialization as tinit
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def test_triangulate_dlt():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 3)) + np.array([0.0, 0.0, 9.0])
    Rs, ts, abs_ = [], [], []
    for k in range(2):
        a = rng.normal(scale=0.3, size=3)
        R = np.asarray(jnp.asarray(_rot(a)))
        t = rng.normal(scale=0.5, size=3)
        Xc = X @ R.T + t
        abs_.append(Xc[:, :2] / Xc[:, 2:3])
        Rs.append(R)
        ts.append(t)
    j = np.asarray(jcam.triangulate_dlt(jnp.asarray(abs_[0]),
                                        jnp.asarray(abs_[1]), Rs[0], ts[0],
                                        Rs[1], ts[1]))
    t = tcam.triangulate_dlt(_T(abs_[0]), _T(abs_[1]), _T(Rs[0]),
                             _T(ts[0]), _T(Rs[1]), _T(ts[1])).numpy()
    assert _rel(j, t) <= 1e-10
    assert np.abs(t - X).max() <= 1e-8          # exact data: the points


def _rot(a):
    """Rotation matrix of the rotation vector a (Rodrigues)."""
    th = np.linalg.norm(a)
    k = a / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


@pytest.fixture(scope="module")
def multiview():
    """A 6-camera problem of the procedural gallop (JAX-built), with
    detections gated out on some frames."""
    q_gt, _, fps = jbl.load_reference_trajectories(max_trials=2)[1]
    data, q0, tr = jbl.build_monocular_problem(q_gt[:24], "acinoset", fps,
                                               seed=1, cam_idx=None)
    return data, q0, tr


def test_multiview_initialisation(multiview):
    data, q0, tr = multiview
    meas, w = np.asarray(tr.meas), np.asarray(data.weight)
    sc = tr.scene
    t_col = sc.t.reshape(-1, 3, 1)          # as the scene file stores t
    js = jinit.triangulate_spine_multiview(meas, w, sc.K, sc.D, sc.R, t_col)
    ts = tinit.triangulate_spine_multiview(meas, w, sc.K, sc.D, sc.R, t_col)
    assert np.array_equal(np.isnan(js), np.isnan(ts))
    assert _rel(np.nan_to_num(js), np.nan_to_num(ts)) <= 1e-10
    jq = jinit.initialize_trajectory(meas, w, sc.K, sc.D, sc.R, t_col,
                                     SUBJECT, cam_idx=None)
    tq = tinit.initialize_trajectory(meas, w, sc.K, sc.D, sc.R, t_col,
                                     SUBJECT, cam_idx=None)
    assert _rel(jq, tq) <= 1e-10
    assert _rel(jq, q0) <= 1e-10                # bench_lib's own q0
    # pairs with a gated-out spine drop out of the mean
    w2 = w.copy()
    w2[:5, 0] = 0.0
    w2[3, :] = 0.0
    js2 = jinit.triangulate_spine_multiview(meas, w2, sc.K, sc.D, sc.R, t_col)
    ts2 = tinit.triangulate_spine_multiview(meas, w2, sc.K, sc.D, sc.R,
                                            t_col)
    assert np.isnan(ts2[3]).all() and np.array_equal(np.isnan(js2),
                                                     np.isnan(ts2))
    assert _rel(np.nan_to_num(js2), np.nan_to_num(ts2)) <= 1e-10


@pytest.mark.parametrize("scale", [10.0, 1.0])
def test_six_camera_cost_and_normal(multiview, scale):
    data, q0, _ = multiview
    assert np.asarray(data.meas).shape[1] == 6
    rng = np.random.default_rng(2)
    q = np.asarray(q0) + rng.normal(scale=0.05, size=np.shape(q0))
    tdata, tq = convert.kinematic_problem(data, q, device="cpu")
    jf = jkin.KinematicFTE(jkin.KinematicConfig(), SUBJECT)
    tf = tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT)
    terms = jf.cost_terms(jnp.asarray(q), data, scale)
    tterms = tf.cost_terms(tq, tdata, scale)
    total = abs(float(jf._cost_impl(jnp.asarray(q), data, scale)))
    for k in terms:
        assert abs(float(terms[k]) - float(tterms[k][0])) <= 1e-12 * max(
            total, 1.0), k
    g, H = jf._normal(jnp.asarray(q), data, scale)
    tg, tH = tf._normal(tq, tdata, scale)
    assert _rel(g, tg[0]) <= 1e-12
    assert _rel(H.diag, tH.diag[0]) <= 1e-12
    for k in range(3):
        assert _rel(H.lower[k], tH.lower[0, k]) <= 1e-12
