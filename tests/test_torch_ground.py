"""Port parity of the default mode's ground-plane depth correction against
the JAX package, in float64: the ground, penetration and no-slip terms of
the kinematic solver (cost, gradient, normal: diagonal blocks and the
no-slip cross blocks in ``lower[0]``), the stance detection, touchdown
samples, shift fit and ray correction, and ``_anchor_polish`` (ray shift,
anchored polish, 5 % objective gate).

Tolerances: cost terms, gradient and normal blocks are the same float64
expressions (<= 1e-12 relative); the stance matrices are identical; the
touchdown samples, shifts and corrected trajectories are float64 numpy on
float64 forward kinematics (<= 1e-10). The polish accepts the same trials
and its trajectories agree within 1e-8 (a few LM steps through two
factorizations whose float64 rounding differs), except on a trial where the
ray shift leaves the lowest stance foot within an ulp of the plane and the
two packages' forward kinematics put it on opposite sides: there the
penetration hinge's curvature differs in the first step, and the bound is
1e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import batched as jpb
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.models import skeleton as tsk
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")
FPS = 120.0


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def problem():
    """2 monocular trials of 24 frames (windows of the procedural gallops
    that hold hind-foot stances), padded to 32; their true trajectories with
    1 mm of noise moved 0.6 m toward the camera along the per-frame rays
    (so stance feet hover above the plane), the planes' elevations, and
    both packages' batches."""
    datas, q0s, qs, gz = [], [], [], []
    rng = np.random.default_rng(4)
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(2)):
        q = q[(16, 18)[i]:][:24]
        n = 24
        d, q0, _ = jbl.build_monocular_problem(q, "acinoset", fps, seed=i)
        qn = q + rng.normal(scale=0.001, size=(n, 54))
        ray = jda.camera_ray(qn, np.asarray(d.cam.R)[0],
                             np.asarray(d.cam.t)[0])
        qn[:, :3] -= 0.6 * ray
        datas.append(d)
        q0s.append(q0)
        qs.append(qn)
        gz.append(jcon.estimate_ground_height(q, SUBJECT))
    bj, _ = jbatch.pad_and_stack(datas, q0s, n_frames=32, dtype=jnp.float64)
    _, qb = jbatch.pad_and_stack(datas, qs, n_frames=32, dtype=jnp.float64)
    bt, _ = convert.kinematic_problem(bj, qb, batched=True, device="cpu")
    return datas, qs, np.asarray(qb), np.asarray(gz), bj, bt


@pytest.mark.parametrize("scale", [3.0, 1.0])
def test_ground_terms_match_jax(problem, scale):
    _, _, qb, gz, bj, bt = problem
    rng = np.random.default_rng(1)
    sw = rng.uniform(0.0, 1.0, size=(2, 32, 4)) \
        * (rng.uniform(size=(2, 32, 4)) < 0.6)
    # planes through the feet: about half the feet are below them (1 mm off
    # the median, which is a paw height itself: a foot exactly on the plane
    # would switch the hinge on one rounding)
    paws = np.stack([jda.paw_heights(q, SUBJECT) for q in qb])
    gzm = np.median(paws, axis=(1, 2)) + 1e-3
    assert ((paws < gzm[:, None, None]).mean() > 0.3)
    bj2 = bj._replace(ground_z=jnp.asarray(gzm), stance_w=jnp.asarray(sw))
    bt2 = bt._replace(ground_z=torch.as_tensor(gzm),
                      stance_w=torch.as_tensor(sw))
    cfg = dict(ground_weight=2e3, penetration_weight=1e4, noslip_weight=3e3)
    jf = jkin.KinematicFTE(jkin.KinematicConfig(**cfg), SUBJECT)
    tf = tkin.KinematicFTE(tkin.KinematicConfig(**cfg), SUBJECT)
    q = jnp.asarray(qb)
    qt = torch.as_tensor(qb)
    terms = jax.vmap(lambda qq, d: jf.cost_terms(qq, d, scale))(q, bj2)
    tterms = tf.cost_terms(qt, bt2, scale)
    for k in terms:
        assert _rel(terms[k], tterms[k]) <= 1e-12, k
    g, H = jax.vmap(lambda qq, d: jf._normal(qq, d, scale))(q, bj2)
    tg, tH = tf._normal(qt, bt2, scale)
    assert _rel(g, tg) <= 1e-12
    assert _rel(H.diag, tH.diag) <= 1e-12
    for k in range(3):
        assert _rel(H.lower[:, k], tH.lower[:, k]) <= 1e-12
    # the no-slip cross blocks are there: lower[0] differs from the
    # constant-acceleration band alone
    plain = tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT)._normal(
        qt, bt2, scale)[1]
    assert _rel(tH.lower[:, 0], plain.lower[:, 0]) > 1e-6


def test_ground_gradient_is_the_cost_derivative(problem):
    """The port's ground-term gradient against autograd of its own cost."""
    _, _, qb, _, _, bt = problem
    paws = np.stack([tda.paw_heights(q, SUBJECT) for q in qb])
    gzm = np.median(paws, axis=(1, 2))
    sw = np.random.default_rng(2).uniform(size=(2, 32, 4))
    bt2 = bt._replace(ground_z=torch.as_tensor(gzm),
                      stance_w=torch.as_tensor(sw))
    cfg = tkin.KinematicConfig(ground_weight=2e3, penetration_weight=1e4,
                               noslip_weight=3e3, weld_weight=0.0)
    tf = tkin.KinematicFTE(cfg, SUBJECT)
    qt = torch.as_tensor(qb).requires_grad_(True)
    tf._cost_impl(qt, bt2, 1.0).sum().backward()
    g, _ = tf._normal(torch.as_tensor(qb), bt2, 1.0)
    assert _rel(qt.grad, g) <= 1e-6


def test_stance_shift_and_ray_correction(problem):
    datas, qs, _, gz, _, _ = problem
    for d, q, g in zip(datas, qs, gz):
        sj = jda.detect_stance(q, SUBJECT, FPS, g)
        st = tda.detect_stance(q, SUBJECT, FPS, g)
        assert np.array_equal(sj, st) and st.sum() > 0
        a = jda.touchdown_samples(q, SUBJECT, st, g)
        b = tda.touchdown_samples(q, SUBJECT, st, g)
        for x, y in zip(a, b):
            assert x.shape == y.shape and np.abs(x - y).max() <= 1e-10
        R, t = np.asarray(d.cam.R)[0], np.asarray(d.cam.t)[0]
        qj, sj2, shj = jda.ray_depth_correction(q, SUBJECT, FPS, g, R, t)
        qt, st2, sht = tda.ray_depth_correction(q, SUBJECT, FPS, g, R, t)
        assert np.array_equal(sj2, st2)
        assert np.abs(shj - sht).max() <= 1e-10 and sht[0] > 0.35
        assert np.abs(qj - qt).max() <= 1e-10


@pytest.mark.parametrize("gaps", [
    [0.08, 0.05, 0.2, 0.06],            # hovering: the lowest sample
    [0.01, 0.9, 0.95],                  # a lowest outlier: the second
    [-0.08, -0.1, -0.06],               # all deep: toward the camera
    [-0.01, 0.02, -0.03],               # mixed shallow
    [-0.01, -0.02],                     # all shallow negative: none
    [0.3],                              # one sample: none
    [0.01, 0.02],                       # below the noise floor: none
])
def test_fit_shift_branches(gaps):
    N = 30
    rng = np.random.default_rng(len(gaps))
    ts = rng.integers(0, N, size=len(gaps)).astype(float)
    ws = rng.uniform(1, 8, size=len(gaps))
    ray_z = -rng.uniform(0.05, 0.2, size=N)
    ray_z[3] = -0.01                    # a ray too vertical: no lever
    g = np.asarray(gaps, float)
    a = jda.fit_shift(ts, g, ws, ray_z)
    b = tda.fit_shift(ts, g, ws, ray_z)
    assert np.abs(a - b).max() <= 1e-10


def test_anchor_polish_matches_jax(problem):
    datas, _, qb, gz, bj, bt = problem

    def ests(make_data):
        out = []
        for i, d in enumerate(datas):
            n = np.asarray(d.meas).shape[0]
            out.append(types.SimpleNamespace(
                data=make_data(d, n),
                scene=types.SimpleNamespace(
                    cam_idx=0, fps=FPS, r_arr=np.asarray(d.cam.R),
                    t_arr=np.asarray(d.cam.t)),
                params=types.SimpleNamespace(ground_plane_height=gz[i])))
        return out

    stages = ((1.0, 6),)
    cfg_j = jkin.KinematicConfig(fisheye=True, robust=True)
    cfg_t = tkin.KinematicConfig(fisheye=True, robust=True)
    qj, live_j = jpb._anchor_polish(qb, ests(lambda d, n: d), bj, SUBJECT,
                                    cfg_j, jnp.float64, stages=stages)
    rep = {}
    qt, live_t = tpb._anchor_polish(qb, ests(lambda d, n: d), bt, SUBJECT,
                                    cfg_t, stages=stages, report=rep)
    changed_j = [bool(np.any(qj[i] != qb[i])) for i in range(2)]
    assert live_j == live_t and changed_j == rep["polish_changed"]
    assert any(changed_j)
    # the ray shift puts the lowest stance foot on the plane to within an
    # ulp, where the penetration hinge switches; the lanes whose hinge
    # pattern at the polish's start is the same in both packages agree to
    # 1e-8, a lane where one foot's hinge flipped to 1e-5 (observed 1.9e-6
    # after one step: one GN curvature term of the first step differs)
    for i in range(2):
        n = np.asarray(datas[i].meas).shape[0]
        R, t = np.asarray(datas[i].cam.R)[0], np.asarray(datas[i].cam.t)[0]
        qc = jda.ray_depth_correction(qb[i, :n], SUBJECT, FPS, gz[i], R,
                                      t)[0]
        # the paw heights the normal equations see
        paw = [jsk.MARKERS.index(m) for m in ("l_front_paw", "r_front_paw",
                                             "l_back_paw", "r_back_paw")]
        pj = np.asarray(jax.vmap(lambda x: jsk.fk_markers_and_jacobian(
            x, SUBJECT)[0])(jnp.asarray(qc)))[:, paw, 2] < gz[i]
        pt = tsk.fk_markers_and_jacobian(torch.as_tensor(qc), SUBJECT)[
            0].numpy()[:, paw, 2] < gz[i]
        flips = int((pj != pt).sum())
        assert flips <= 1
        tol = 1e-8 if flips == 0 else 1e-5
        assert np.abs(qj[i] - qt[i]).max() <= tol, (i, flips)

