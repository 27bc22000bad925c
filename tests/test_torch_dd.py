"""Port parity of the data-driven stage against the JAX package, float64:
the pose-prior, AR-anchor and base-anchor terms of the kinematic solver, the
prior gate, the depth helpers and line-scan, and ``run_data_driven`` end to
end against bench.py's composition (``jax_data_driven`` in
``tests/data/jax_stage15_reference.py``).

Tolerances: cost terms, gradient and normal blocks are the same float64
expressions (<= 1e-12 relative); the gradient against autograd of the
port's own cost <= 1e-6 relative (the JAX package's own bound). The gate is
exact. Rays and scale medians <= 1e-9. The line-scan gives the same shifts
and q within 1e-9; the whole stage the same gate decisions and shifts, q
within 1e-6 relative: several short LM solves in a row, each step through
a factorization whose float64 rounding differs (observed ~1e-12).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.priors import armodel as jar
from cheetah_pose_estimation_tpu.priors import gmm as jgmm
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")
DD_CFG = dict(use_gmm=True, use_ar=True, **jest.DD_BASE_ANCHOR)
SHORT = ((10.0, 3), (3.0, 3), (1.0, 8))
SCAN_SHORT = ((1.0, 6),)

_spec = importlib.util.spec_from_file_location(
    "jax_stage15_reference", os.path.join(os.path.dirname(__file__), "data",
                                          "jax_stage15_reference.py"))
ref15 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref15)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _jax_batch(n_trials, frames, n_frames):
    """JAX batch of the first procedural trials cut to ``frames``, its q0,
    and the true trajectories plus 1 cm of noise, padded like q0."""
    datas, q0s, qs = [], [], []
    rng = np.random.default_rng(5)
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(
            n_trials)):
        d, q0, _ = jbl.build_monocular_problem(q[:frames[i]], "acinoset",
                                               fps, seed=i)
        datas.append(d)
        q0s.append(q0)
        qs.append(q[:frames[i]] + rng.normal(scale=0.01,
                                             size=(frames[i], 54)))
    bj, qj = jbatch.pad_and_stack(datas, q0s, n_frames=n_frames,
                                  dtype=jnp.float64)
    _, q_true = jbatch.pad_and_stack(datas, qs, n_frames=n_frames,
                                     dtype=jnp.float64)
    return bj, qj, np.asarray(q_true, np.float64)


def _push_back(bj, q, i, metres):
    """q with trial i moved ``metres`` away from its camera along the
    per-frame rays."""
    q = q.copy()
    q[i, :, :3] += metres * jda.camera_ray(q[i], np.asarray(bj.cam.R)[i, 0],
                                           np.asarray(bj.cam.t)[i, 0])
    return q


@pytest.fixture(scope="module")
def prior_problem():
    """2 trials x 16 frames with a random GMM (means near the trials' own
    relative angles) and AR anchor as in tests/test_kinematic_solver.py,
    gmm_scale (1, 0) and a perturbed base reference; JAX and port forms."""
    bj, qj, _ = _jax_batch(2, (16, 16), 16)
    rng = np.random.default_rng(0)
    B, N, K = 2, 16, 3
    x22 = np.asarray(qj) @ jsk.A_REL[6:].T
    means = x22.mean(1)[:, None] + rng.normal(scale=0.3, size=(B, K, 22))
    A = rng.normal(size=(B, K, 22, 22)) * 0.1
    prec = np.einsum("bkij,bklj->bkil", A, A) + 2.0 * np.eye(22)
    bj = bj._replace(
        gmm=jkin.GMMPrior(jnp.asarray(means), jnp.asarray(prec),
                          jnp.asarray(rng.normal(size=(B, K)))),
        ar=jkin.ARAnchor(
            jnp.asarray(np.asarray(qj) @ jsk.A_REL.T
                        + rng.normal(scale=0.2, size=(B, N, 28))),
            jnp.asarray(rng.uniform(0.5, 2.0, size=(B, 28))),
            jnp.asarray(np.tile((np.arange(N) >= 4).astype(float),
                                (B, 1)))),
        gmm_scale=jnp.asarray([1.0, 0.0]),
        base_ref=qj[:, :, :6] + rng.normal(scale=0.05, size=(B, N, 6)))
    q = qj + rng.normal(scale=0.05, size=qj.shape)
    bt, qt = convert.kinematic_problem(bj, q, batched=True, device="cpu")
    return bj, jnp.asarray(q), bt, qt


@pytest.mark.parametrize("scale", [10.0, 1.0])
def test_prior_terms_match_jax(prior_problem, scale):
    bj, q, bt, qt = prior_problem
    jf = jkin.KinematicFTE(jkin.KinematicConfig(**DD_CFG), SUBJECT)
    tf = tkin.KinematicFTE(tkin.KinematicConfig(**DD_CFG), SUBJECT)
    terms = jax.vmap(lambda qq, d: jf.cost_terms(qq, d, scale))(q, bj)
    tterms = tf.cost_terms(qt, bt, scale)
    for k in ("measurement", "model", "pose", "motion", "limit"):
        assert _rel(terms[k], tterms[k].numpy()) <= 1e-12, k
    assert float(np.abs(terms["pose"][0])) > 0.0 and \
        float(terms["pose"][1]) == 0.0          # gmm_scale (1, 0)
    assert float(np.min(terms["motion"])) > 0.0
    g, H = jax.vmap(lambda qq, d: jf._normal(qq, d, scale))(q, bj)
    tg, tH = tf._normal(qt, bt, scale)
    assert _rel(g, tg.numpy()) <= 1e-12
    assert _rel(H.diag, tH.diag.numpy()) <= 1e-12
    assert _rel(H.lower, tH.lower.numpy()) <= 1e-12
    assert _rel(jax.vmap(jf.objective)(q, bj), tf.objective(qt, bt)) <= 1e-12


def test_prior_gradient_matches_autograd(prior_problem):
    _, _, bt, qt = prior_problem
    tf = tkin.KinematicFTE(tkin.KinematicConfig(**DD_CFG), SUBJECT)
    qv = qt.clone().requires_grad_(True)
    (ga,) = torch.autograd.grad(tf._cost(qv, bt).sum(), qv)
    g, _ = tf._normal(qt, bt)
    assert _rel(ga.numpy(), g.numpy()) <= 1e-6


def test_unported_terms_still_raise():
    """Only a loss the JAX package lacks raises; the live shutter coupling
    (tests/test_torch_shutter.py) and the ground terms
    (tests/test_torch_ground.py) are ported."""
    with pytest.raises(NotImplementedError):
        tkin.KinematicFTE(tkin.KinematicConfig(loss="cauchy"), SUBJECT)
    tkin.KinematicFTE(tkin.KinematicConfig(live_shutter=True), SUBJECT)
    tkin.KinematicFTE(tkin.KinematicConfig(ground_weight=1.0), SUBJECT)


def test_prior_gate_is_exact():
    c_free = np.array([10.0, -5.0, -0.2, 0.3, 100.0, -100.0, np.nan])
    c_chain = np.array([12.9, -4.0, 0.05, 0.61, 131.0, -69.0, 1.0])
    np.testing.assert_array_equal(test_.prior_gate_accept(c_chain, c_free),
                                  jest.prior_gate_accept(c_chain, c_free))
    assert test_.DD_BASE_ANCHOR == jest.DD_BASE_ANCHOR
    assert test_.PRIOR_GUARD_RATIO == jest.PRIOR_GUARD_RATIO


def test_ray_and_scale_median_match_jax():
    q_gt, _, fps = jbl.load_reference_trajectories(1)[0]
    d, _, _ = jbl.build_monocular_problem(q_gt, "acinoset", fps, seed=0)
    cam = jax.tree.map(np.asarray, d.cam)
    rng = np.random.default_rng(3)
    q = q_gt + rng.normal(scale=0.02, size=q_gt.shape)
    q[:, :3] *= 1.05                    # a depth error for the channel
    assert _rel(jda.camera_ray(q, cam.R[0], cam.t[0]),
                tda.camera_ray(q, cam.R[0], cam.t[0])) <= 1e-9
    args = (np.asarray(d.meas)[:, 0], np.asarray(d.weight)[:, 0], cam.K[0],
            cam.D[0], cam.R[0], cam.t[0])
    mj = jda.scale_median(q, SUBJECT, *args)
    mt = tda.scale_median(q, SUBJECT, *args)
    assert mj != 0.0 and abs(mj - mt) <= 1e-9
    assert abs(jda.scale_depth_shift(q, SUBJECT, *args)
               - tda.scale_depth_shift(q, SUBJECT, *args)) <= 1e-9


def test_depth_linescan_matches_jax():
    """Three trials near their true trajectories, one pushed 0.3 m back
    along its rays; short re-solves, with and without the body-scale
    constraint."""
    bj, _, q = _jax_batch(3, (24, 24, 24), 24)
    q = _push_back(bj, q, 1, 0.3)
    rays = np.stack([jda.camera_ray(q[i], np.asarray(bj.cam.R)[i, 0],
                                    np.asarray(bj.cam.t)[i, 0])
                     for i in range(3)])
    jscan = jda.make_depth_linescan(SUBJECT, jnp.float64, stages=SCAN_SHORT)
    tscan = tda.make_depth_linescan(SUBJECT, stages=SCAN_SHORT)
    bt, qt = convert.kinematic_problem(bj, q, batched=True, device="cpu")
    for med in (None, np.array([0.0, -0.25, 0.2])):
        qo_j, sh_j = jscan(jnp.asarray(q), bj, rays, med)
        qo_t, sh_t = tscan(qt, bt, rays, med)
        np.testing.assert_array_equal(sh_j, sh_t)
        assert np.abs(np.asarray(qo_j) - qo_t.numpy()).max() <= 1e-9
        assert sh_t[1] < 0.0 and sh_t[0] == 0.0


@pytest.fixture(scope="module")
def jax_priors(tmp_path_factory):
    """JAX priors trained (float64) on a short procedural pose table."""
    tmp = tmp_path_factory.mktemp("dd_priors")
    paths = {}
    for name, seeds in (("train", range(100, 110)), ("val", range(200,
                                                                   203))):
        paths[name] = str(tmp / f"{name}.csv")
        ref15.pose_table_frame(seeds).to_csv(paths[name])
    X = ref15.pose_table_frame(range(100, 110)).iloc[:, 6:28].to_numpy()
    params = jgmm.fit(X, n_components=5, seed=42, max_iter=30)
    mm = jar.train_motion_model(paths["train"], window_size=4, lasso=True,
                                validation_fname=paths["val"])
    return jgmm.to_solver_prior(params), mm


def test_run_data_driven_matches_jax(jax_priors):
    """3 trials of 20/22/24 frames padded to 24, float64, short schedules,
    from the true trajectories plus noise as the prior-free solutions, with
    trial 1 0.3 m too deep."""
    gp, mm = jax_priors
    bj, _, q_free = _jax_batch(3, (20, 22, 24), 24)
    q_free = _push_back(bj, q_free, 1, 0.3)
    qd_j, ok_j, sh_j = ref15.jax_data_driven(
        jnp.asarray(q_free), bj, gp, mm, SUBJECT, jnp.float64, stages=SHORT,
        scan_stages=SCAN_SHORT)
    bt, qt = convert.kinematic_problem(bj, q_free, batched=True,
                                      device="cpu")
    qd_t, ok_t, sh_t = tpb.run_data_driven(
        qt, bt, convert.gmm_prior(gp, 3, device="cpu", dtype=torch.float64),
        convert.motion_model(mm), SUBJECT, stages=SHORT,
        scan_stages=SCAN_SHORT)
    np.testing.assert_array_equal(ok_j, ok_t)
    np.testing.assert_array_equal(sh_j, sh_t)
    assert _rel(qd_j, qd_t.numpy()) <= 1e-6
    assert np.isfinite(qd_t.numpy()).all()
