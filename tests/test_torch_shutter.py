"""Port parity of the solver options: the bordered LM (``gn._bordered_solve``,
``lm_solve_bordered``), the live shutter coupling and its border terms, the
joint shutter-delay solve, and the fixed-length annealed driver
(``lm_solve_annealed_scan``, ``make_solver(driver="scan")``), on a
3-camera, 18-frame multi-view problem built by the JAX package (camera 2
late by 0.4 frame periods) and carried across with ``convert.py``, in
float64.

Tolerances: one bordered solve and the cost, gradient and border blocks are
the same float64 expressions (bounds 1e-10 and 1e-8); solves differ by the
order of float64 sums through many factorizations (bound 1e-6), with equal
step counts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import noise as jnoise
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.ops import banded as jbanded
from cheetah_pose_estimation_tpu.solver import gn as jgn
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.ops import banded as tbanded
from cheetah_pose_estimation_tpu_torch.solver import gn as tgn
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("phantom")
N_FRAMES, N_CAMS, TAU_H = 18, 3, 0.4
SHORT = ((3.0, 8), (1.0, 20))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def delayed_problem(n_frames=N_FRAMES, n_cams=N_CAMS, seed=3):
    """A multi-view JAX problem whose camera 2 sees the scene TAU_H frame
    periods late (detections moved along their image velocity, as the JAX
    package's shutter test does), the initial q (truth + noise) and h."""
    q_gt = jsyn.gallop_trajectory(n_frames=n_frames, seed=seed)
    center = np.asarray(jsk.fk_markers(q_gt, SUBJECT)).mean(axis=(0, 1))
    scene = jsyn.ring_cameras(center, n_cams=n_cams, seed=seed)
    trial = jsyn.synthesize(q_gt, SUBJECT, scene, noise_px=1.0,
                            outlier_frac=0.0, drop_frac=0.0, seed=seed)
    h = 1.0 / scene.fps
    meas = np.array(trial.meas)
    vel = np.zeros_like(meas[..., 0])
    vel[1:] = (meas[1:, ..., 0] - meas[:-1, ..., 0]) / h
    meas[:, 2, :, :, 0] += TAU_H * h * vel[:, 2]
    N = n_frames
    data = jkin.KinematicData(
        meas=jnp.asarray(meas), weight=jnp.asarray(jsyn.gated_weights(trial)),
        cam=jkin.CameraSet(*[jnp.asarray(x) for x in (
            scene.K, scene.D, scene.R, scene.t)]),
        h=jnp.asarray(h),
        acc_weight=jnp.asarray(jnoise.acc_model_weights()),
        frame_valid=jnp.ones(N),
        gmm=jkin.GMMPrior(jnp.zeros((1, 22)), jnp.eye(22)[None],
                          jnp.zeros((1,))),
        ar=jkin.ARAnchor(jnp.zeros((N, 28)), jnp.zeros(28), jnp.zeros(N)),
        sd_tau=jnp.zeros(n_cams))
    q0 = q_gt + np.random.default_rng(seed).normal(scale=0.03,
                                                   size=q_gt.shape)
    return data, q0, h


@pytest.fixture(scope="module")
def problem():
    data, q0, h = delayed_problem()
    tdata, tq0 = convert.kinematic_problem(data, q0, device="cpu")
    return data, jnp.asarray(q0), tdata, tq0, h


@pytest.fixture(scope="module")
def shutter_ftes():
    cfg = dict(live_shutter=True)
    return (jkin.KinematicFTE(jkin.KinematicConfig(**cfg), SUBJECT),
            tkin.KinematicFTE(tkin.KinematicConfig(**cfg), SUBJECT))


def random_bordered(B, N, d, C, seed):
    """B random bordered SPD systems (numpy): a diagonally dominant banded
    block, border columns and their diagonal."""
    rng = np.random.default_rng(seed)
    lower = 0.05 * rng.normal(size=(B, 3, N, d, d))
    for k in range(1, 4):
        lower[:, k - 1, max(N - k, 0):] = 0.0
    sym = rng.normal(size=(B, N, d, d))
    diag = 0.2 * (sym + np.swapaxes(sym, -1, -2)) + 30.0 * np.eye(d)
    diag = diag * rng.uniform(0.5, 50.0, size=(B, N, d, 1))
    diag = 0.5 * (diag + np.swapaxes(diag, -1, -2))
    Bmat = rng.normal(size=(B, N, d, C))
    Htt = np.sum(Bmat ** 2, axis=(1, 2)) * 0.1 + rng.uniform(
        50.0, 100.0, size=(B, C))
    Htt[:, 0] += 1e12
    return (diag, lower, rng.normal(size=(B, N, d)), rng.normal(size=(B, C)),
            Bmat, Htt, rng.uniform(1e-6, 1e-1, size=B))


def test_bordered_solve_matches_jax():
    diag, lower, gq, gtau, Bmat, Htt, lam = random_bordered(2, 7, 54, 4, 0)
    T = lambda a: torch.as_tensor(a)
    dq, dtau = tgn._bordered_solve(
        T(gq), tbanded.BlockBanded(T(diag), T(lower)), T(gtau), T(Bmat),
        T(Htt), T(lam), 1e-8)
    for b in range(2):
        jdq, jdtau = jgn._bordered_solve(
            jnp.asarray(gq[b]), jbanded.BlockBanded(jnp.asarray(diag[b]),
                                                    jnp.asarray(lower[b])),
            jnp.asarray(gtau[b]), jnp.asarray(Bmat[b]), jnp.asarray(Htt[b]),
            jnp.asarray(lam[b]), 1e-8)
        assert _rel(jdq, dq[b].numpy()) <= 1e-10
        assert _rel(jdtau, dtau[b].numpy()) <= 1e-10


def test_bordered_solve_is_the_dense_solution():
    """The Schur step solves the whole bordered system (float64, dense)."""
    diag, lower, gq, gtau, Bmat, Htt, lam = random_bordered(1, 5, 54, 3, 1)
    T = lambda a: torch.as_tensor(a)
    H = tbanded.BlockBanded(T(diag), T(lower))
    dq, dtau = tgn._bordered_solve(T(gq), H, T(gtau), T(Bmat), T(Htt),
                                   T(lam), 1e-8)
    # the damped system: H + lam diag(H) on the q block, Htt (1 + lam)
    Hd = tbanded.to_dense(H)[0].numpy()
    Hd = Hd + lam[0] * np.diag(np.diag(Hd))
    Bd = Bmat[0].reshape(-1, 3)
    K = np.block([[Hd, Bd], [Bd.T, np.diag(Htt[0] * (1.0 + lam[0]))]])
    x = np.linalg.solve(K, -np.concatenate([gq[0].ravel(), gtau[0]]))
    assert _rel(x[:-3], dq[0].numpy().ravel()) <= 1e-10
    assert _rel(x[-3:][1:], dtau[0].numpy()[1:]) <= 1e-10


def test_live_shutter_cost_and_gradient(problem, shutter_ftes):
    """With the live coupling the measurement term depends on q[t-2..t]
    through the shift: the chain-rule gradient equals autograd of the cost
    and JAX's gradient; the cost and curvature equal JAX's."""
    data, q0, tdata, tq0, h = problem
    jf, tf = shutter_ftes
    tau = np.array([0.0, 0.4 * h, -0.7 * h])
    jd = data._replace(sd_tau=jnp.asarray(tau))
    td = tdata._replace(sd_tau=torch.as_tensor(tau)[None])
    q = tq0.clone().requires_grad_(True)
    cost = tf._cost_impl(q, td)
    g_auto, = torch.autograd.grad(cost.sum(), q)
    g, H = tf._normal(tq0, td)
    assert _rel(g_auto.numpy(), g.numpy()) <= 1e-8
    jg, jH = jf.normal(q0, jd)
    assert _rel(jf.cost(q0, jd), cost.detach().numpy()[0]) <= 1e-10
    assert _rel(jg, g[0].numpy()) <= 1e-8
    assert _rel(jH.diag, H.diag[0].numpy()) <= 1e-10
    assert _rel(jH.lower, H.lower[0].numpy()) <= 1e-10


def test_border_terms_match_jax(problem, shutter_ftes):
    data, q0, tdata, tq0, h = problem
    jf, tf = shutter_ftes
    tau = np.array([0.0, 0.2 * h, 0.5 * h])
    gtau, Bmat, Htt = tf._border_terms(tq0, torch.as_tensor(tau)[None],
                                       tdata)
    jgtau, jB, jHtt = jf._border_terms(q0, jnp.asarray(tau), data)
    assert _rel(jgtau, gtau[0].numpy()) <= 1e-8
    assert _rel(jB, Bmat[0].numpy()) <= 1e-8
    assert _rel(jHtt, Htt[0].numpy()) <= 1e-8


def test_joint_shutter_solver_matches_jax(problem, shutter_ftes):
    """The bordered LM from the live-shutter solve, 12 steps: q and tau
    against JAX's, the same step count, and the relative delay of camera 2
    moves toward the injected one."""
    data, q0, tdata, tq0, h = problem
    jf, tf = shutter_ftes
    jst = jf.make_solver(stages=SHORT)(q0, data)
    st = tf.make_solver(stages=SHORT)(tq0, tdata)
    assert _rel(jst.q, st.q[0].numpy()) <= 1e-6
    jb = jf.make_joint_shutter_solver(max_iters=12)(
        jst.q, jnp.zeros(N_CAMS), data)
    tb = tf.make_joint_shutter_solver(max_iters=12)(
        st.q, torch.zeros(1, N_CAMS, dtype=torch.float64), tdata)
    assert _rel(jb.q, tb.q[0].numpy()) <= 1e-6
    assert np.abs(np.asarray(jb.tau) - tb.tau[0].numpy()).max() \
        <= 1e-6 * h
    assert int(jb.it) == int(tb.it[0])
    assert int(jb.n_accepted) == int(tb.n_accepted[0])
    tau = tb.tau[0].numpy()
    assert abs(tau[2] - tau[1] - TAU_H * h) < abs(TAU_H * h)


def test_scan_driver_matches_jax_and_while(problem):
    """``driver="scan"`` with ftol = 0 (every lane uses its whole budget):
    JAX's scan result, 28 steps, and the port's while driver's result."""
    data, q0, tdata, tq0, _ = problem
    jf = jkin.KinematicFTE(jkin.KinematicConfig(), SUBJECT)
    tf = tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT)
    jst = jf.make_solver(stages=SHORT, ftol=0.0, driver="scan")(q0, data)
    st = tf.make_solver(stages=SHORT, ftol=0.0, driver="scan")(tq0, tdata)
    sw = tf.make_solver(stages=SHORT, ftol=0.0)(tq0, tdata)
    assert _rel(jst.q, st.q[0].numpy()) <= 1e-6
    assert int(jst.it) == int(st.it[0]) == int(sw.it[0]) == 28
    assert int(jst.n_accepted) == int(st.n_accepted[0])
    assert _rel(sw.q.numpy(), st.q.numpy()) <= 1e-8


def test_scan_driver_one_stage_is_lm_solve_scan(problem):
    """One stage: the scan driver is ``gn.lm_solve_scan`` (JAX "fixed"),
    whose result JAX's one-stage annealed scan equals."""
    data, q0, tdata, tq0, _ = problem
    jf = jkin.KinematicFTE(jkin.KinematicConfig(), SUBJECT)
    tf = tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT)
    stage = ((10.0, 6),)
    jst = jf.make_solver(stages=stage, driver="scan")(q0, data)
    st = tf.make_solver(stages=stage, driver="scan")(tq0, tdata)
    assert _rel(jst.q, st.q[0].numpy()) <= 1e-8
    assert int(jst.it) == int(st.it[0]) == 6


def test_annealed_scan_runs_lanes_in_lockstep(problem):
    """Two lanes, one of which converges early: every lane takes every
    step, and each lane's result is its single-lane result."""
    data, q0, tdata, tq0, _ = problem
    tf = tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT)
    two = tkin.map_data(lambda x: torch.cat([x, x]), tdata)
    q2 = torch.cat([tq0, tdata.meas.new_zeros(1, 1, 1) + tq0 + 0.01])
    run = tf.make_solver(stages=((3.0, 4), (1.0, 6)), driver="scan")
    st = run(q2, two)
    assert st.it.tolist() == [10, 10]
    for i in range(2):
        one = run(q2[i:i + 1], tdata)
        assert _rel(one.q.numpy(), st.q[i:i + 1].numpy()) <= 1e-10


def test_unknown_driver_raises():
    fte = tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT)
    with pytest.raises(ValueError):
        fte.make_solver(driver="fixed")
