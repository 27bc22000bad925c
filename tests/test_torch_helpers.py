"""Port parity of the public helpers that no pipeline path calls, against
the JAX package in float64: the distortion models, the rotation helpers,
the banded damping and log-determinant, the losses ``quadratic`` and
``redescending_smooth``, the joint-manifold projection, the body-scale
sign vote, ``CheetahEstimator.get_objective_cost``, the windowed
supervised table, the dill helpers and ``armodel.unique_id``.

Tolerances: the port against JAX within 1e-12 (relative to the values'
scale) everywhere: the same float64 formulas. Where the JAX package has a
test of the helper, the port also meets that test's own check at its
tolerance (the fisheye round trip 1e-8 px, the Euler-rate maps 1e-12, the
log-determinant 1e-10 relative, the damping 1e-12, the sign vote exactly).
"""
import os

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.ops import banded as jbanded
from cheetah_pose_estimation_tpu.ops import camera as jcam
from cheetah_pose_estimation_tpu.ops import losses as jlosses
from cheetah_pose_estimation_tpu.ops import rotations as jrot
from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.priors import armodel as jar
from cheetah_pose_estimation_tpu.utils import data_ops as jdo
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.models import skeleton as tsk
from cheetah_pose_estimation_tpu_torch.ops import banded as tbanded
from cheetah_pose_estimation_tpu_torch.ops import camera as tcam
from cheetah_pose_estimation_tpu_torch.ops import losses as tlosses
from cheetah_pose_estimation_tpu_torch.ops import rotations as trot
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.priors import armodel as tar
from cheetah_pose_estimation_tpu_torch.utils import data_ops as tdo

torch.set_num_threads(1)
TOL = 1e-12
T = lambda a: torch.as_tensor(np.array(a, np.float64))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(1.0, np.abs(b).max())


def test_distortion_models():
    rng = np.random.default_rng(0)
    ab = rng.uniform(-1.2, 1.2, size=(7, 24, 2))
    for D in (rng.normal(scale=0.05, size=4), rng.normal(size=(4, 1)) * 0.1):
        _close(tcam.distort_fisheye(T(ab), T(D)), jcam.distort_fisheye(ab, D))
        _close(tcam.distort_pinhole(T(ab), T(D)), jcam.distort_pinhole(ab, D))
    # the JAX test's round trip: undistort, distort, to pixels (1e-8 px)
    K = np.array([[800.0, 0, 640], [0, 810.0, 500], [0, 0, 1]])
    D = np.array([-0.02, 0.01, -0.003, 0.0005])
    uv = rng.uniform(100, 1100, size=(50, 2))
    ab_u = tcam.undistort_fisheye(T(uv), T(K), T(D))
    uv2 = tcam._apply_K(tcam.distort_fisheye(ab_u, T(D)), T(K))
    assert (uv2.numpy() - uv).__abs__().max() <= 1e-8


def test_rotation_helpers():
    rng = np.random.default_rng(1)
    ang = rng.uniform(-1.2, 1.2, size=(9, 3))
    _close(trot.rot_y(T(ang[:, 1])), jrot.rot_y(ang[:, 1]))
    _close(trot.rot_z(T(ang[:, 2])), jrot.rot_z(ang[:, 2]))
    R = jrot.euler_zyx(ang)
    _close(trot.euler_zyx_inverse(T(R)), jrot.euler_zyx_inverse(R))
    _close(trot.euler_zyx_inverse(trot.euler_zyx(T(ang))), ang)
    _close(trot.euler_rate_to_world_omega(T(ang)),
           jrot.euler_rate_to_world_omega(ang))
    # the JAX test's consistency of the two maps (1e-12)
    for a, da in zip(ang, rng.normal(size=(9, 3))):
        w = trot.euler_rate_to_world_omega(T(a)).numpy() @ da
        b = trot.euler_rate_to_body_omega(T(a)).numpy() @ da
        assert np.abs(w - trot.euler_zyx(T(a)).numpy() @ b).max() <= 1e-12


def _spd_banded(rng, N, d, K):
    A = rng.normal(size=(N * d, N * d)) * 0.3
    H = A @ A.T
    mask = np.kron(np.abs(np.subtract.outer(np.arange(N), np.arange(N)))
                   <= K, np.ones((d, d)))
    Hd = H * mask + np.eye(N * d) * N * d
    diag = np.stack([Hd[t * d:(t + 1) * d, t * d:(t + 1) * d]
                     for t in range(N)])
    lower = np.zeros((K, N, d, d))
    for k in range(1, K + 1):
        for t in range(N - k):
            lower[k - 1, t] = Hd[(t + k) * d:(t + k + 1) * d,
                                 t * d:(t + 1) * d]
    return diag, lower, Hd


def test_banded_damping_and_logdet():
    rng = np.random.default_rng(2)
    diag, lower, Hd = _spd_banded(rng, 6, 4, 2)
    Hj = jbanded.BlockBanded(diag, lower)
    Ht = tbanded.BlockBanded(T(diag)[None], T(lower)[None])
    scale = rng.uniform(1, 2, size=(6, 4))
    for sc in (None, scale):
        dj = jbanded.to_dense(jbanded.add_diag_damping(Hj, 0.7, sc))
        dt = tbanded.to_dense(tbanded.add_diag_damping(
            Ht, 0.7, None if sc is None else T(sc)))[0]
        _close(dt, dj)
        ref = Hd + 0.7 * (np.eye(24) if sc is None else np.diag(sc.ravel()))
        assert np.abs(dt.numpy() - ref).max() <= 1e-12
    # per-lane damping on a batch of two copies
    H2 = tbanded.BlockBanded(Ht.diag.repeat(2, 1, 1, 1),
                             Ht.lower.repeat(2, 1, 1, 1, 1))
    d2 = tbanded.to_dense(tbanded.add_diag_damping(H2, T([0.5, 2.0])))
    for i, lam in enumerate((0.5, 2.0)):
        assert np.abs(d2[i].numpy() - Hd - lam * np.eye(24)).max() <= 1e-12
    ld_t = tbanded.logdet_from_factor(tbanded.cholesky(Ht))
    ld_j = float(jbanded.logdet_from_factor(jbanded.cholesky(Hj)))
    assert ld_t.shape == (1,)
    _close(ld_t.numpy()[0], ld_j)
    sign, ref = np.linalg.slogdet(Hd)
    assert sign > 0 and abs(float(ld_t[0]) - ref) <= 1e-10 * abs(ref)


def test_losses():
    r = np.random.default_rng(3).normal(scale=30.0, size=200)
    for c in (1.0, 3.0, 20.0):
        _close(tlosses.redescending_smooth(T(r), c),
               jlosses.redescending_smooth(r, c))
    _close(tlosses.quadratic(T(r)), jlosses.quadratic(r))


def test_project_joint_manifold():
    rng = np.random.default_rng(4)
    q = tsyn.gallop_trajectory(12, seed=0)
    q[:, 3:] += rng.normal(scale=0.2, size=q[:, 3:].shape)
    q[3, 10] += 2 * np.pi                       # a coordinate on another branch
    qt = tsk.project_joint_manifold(T(q))
    _close(qt, jsk.project_joint_manifold(q))
    assert np.array_equal(qt[:, :3].numpy(), q[:, :3])
    assert tsk.joint_residuals(qt).abs().max() <= 1e-10
    assert np.abs(qt.numpy() - q).max() < np.pi
    # a point on the manifold stays where it is
    _close(tsk.project_joint_manifold(qt), qt.numpy(), 1e-10)


@pytest.mark.parametrize("true_shift", [-0.3, 0.25])
def test_scale_shift_sign(true_shift):
    """The JAX test's problem (a trajectory pushed along the ray, the
    measurements at the true pose): the same vote as JAX, the right
    direction, and 0 inside the dead zone."""
    subj = tparams.get_subject("acinoset")
    q = tsyn.gallop_trajectory(40, seed=0)[:32]
    center = tsyn.fk_markers_np(q, subj).mean(axis=(0, 1))
    scene = tsyn.ring_cameras(center, n_cams=3, seed=4, fps=120.0)
    trial = tsyn.synthesize(q, subj, scene, noise_px=1.0, outlier_frac=0.0,
                            seed=4, subject_name="acinoset")
    w = tsyn.gated_weights(trial)
    ray = tda.camera_ray(q, scene.R[0], scene.t[0])
    q_bad = q.copy()
    q_bad[:, :3] += true_shift * ray
    args = (trial.meas[:, 0], w[:, 0], scene.K[0], scene.D[0], scene.R[0],
            scene.t[0])
    for fisheye in (True, False):
        s_t = tda.scale_shift_sign(q_bad, subj, *args, fisheye=fisheye)
        s_j = jda.scale_shift_sign(q_bad, jparams.get_subject("acinoset"),
                                   *args, fisheye=fisheye)
        assert s_t == s_j
        med = tda.scale_median(q_bad, subj, *args, fisheye=fisheye)
        _close(med, jda.scale_median(q_bad, jparams.get_subject("acinoset"),
                                     *args, fisheye=fisheye), 1e-10)
        assert tda.scale_shift_sign(q_bad, subj, *args, fisheye=fisheye,
                                    dead_zone_m=abs(med) + 1e-9) == 0.0
    assert tda.scale_shift_sign(q_bad, subj, *args) == -np.sign(true_shift)


def test_get_objective_cost(tmp_path):
    q = jsyn.gallop_trajectory(16, seed=1)
    subj = jparams.get_subject("jules")
    scene = jsyn.ring_cameras(np.asarray(jsk.fk_markers(q, subj)).mean(
        axis=(0, 1)), n_cams=2, fps=90.0, seed=1)
    tr = jsyn.synthesize(q, subj, scene, seed=1, subject_name="jules")
    path = os.path.join("2017_12_09", "jules", "run")
    jsyn.write_trial_dir(tr, str(tmp_path), path)
    ej = jest.init_trajectory(str(tmp_path), path, "jules")
    et = test_.init_trajectory(str(tmp_path), path, "jules")
    assert np.isnan(et.get_objective_cost()) and np.isnan(
        ej.get_objective_cost())
    for v in (3.25, np.float32(1.5), 0.0):
        ej.obj_cost = et.obj_cost = v
        assert et.get_objective_cost() == ej.get_objective_cost() == float(v)
        assert type(et.get_objective_cost()) is float


@pytest.mark.parametrize("n_in,n_step", [(1, 1), (3, 1), (3, 2), (2, 4)])
def test_series_to_supervised(n_in, n_step):
    X = np.random.default_rng(5).normal(size=(17, 3))
    for data in (X, X[:, 0]):
        t = tdo.series_to_supervised(data, n_in, n_step)
        j = jdo.series_to_supervised(data, n_in, n_step)
        assert np.array_equal(t.values, j.to_numpy())
        assert t.columns == list(j.columns)
        assert np.array_equal(t.index, j.index.to_numpy())


def test_dill_helpers(tmp_path):
    pytest.importorskip("dill")
    obj = {"f": lambda x: 2 * x, "a": np.arange(3)}
    tdo.save_dill(str(tmp_path / "t.dill"), obj)
    jdo.save_dill(str(tmp_path / "j.dill"), obj)
    for load in (tdo.load_dill, jdo.load_dill):
        for name in ("t.dill", "j.dill"):
            back = load(str(tmp_path / name))
            assert back["f"](4) == 8 and np.array_equal(back["a"], obj["a"])


def test_unique_id():
    for vals in ((), (4, True, 0.01, "x"), ([1, 2], None, np.float64(0.5))):
        assert tar.unique_id(vals) == jar.unique_id(vals)
