"""Port parity of the physics-based solver against the JAX package, float64,
at B = 2 trials and N = 12 frames (one trial padded by a frame), with a
prescribed stance schedule, a 3-component GMM pose prior and a ground plane
per trial, all from numpy seeds.

Tolerances (relative: max |a - b| / max |a|):

* Huber cost and Gauss-Newton weights: the same expressions, <= 1e-14; the
  kinematic cost and normal with ``loss="huber"``: <= 1e-12.
* ``_frame_solve``: EOM slack and vertical forces <= 1e-10; torques and
  polygon forces <= 1e-9. The eliminated system is ill-conditioned by
  design (the polygon block spans a 2-D plane with four directions and is
  held only by a 1e-3 ridge at ~1e-8 of the diagonal), so rounding of the
  inputs is amplified: perturbing q by one ulp moves the JAX package's own
  torques by 1.1e-10 and polygon forces by 2.8e-10 (observed port
  differences 1.4e-10 and 4.3e-10).
* ``_cost`` terms that do not pass through the elimination (measurement
  and prior, constant-acceleration, smoothing, stance, weld) <= 1e-12; the
  EOM and torque terms and the total <= 1e-10 (the elimination above).
* ``_normal`` gradient against ``jax.grad`` of the JAX cost: <= 1e-9; the
  frozen EOM blocks and all normal blocks against the JAX ``_normal``:
  <= 1e-9 (observed ~1e-14 for the blocks, ~1e-10 for the gradient).
* The LM step's acceptance guard: the same states as the JAX ``_lm_step``
  on a problem where the guard rejects a step that lowers the cost.

The short annealed solve is held in ``tests/test_torch_kinetic_solve.py``
(its JAX compile is a file's worth of time on its own).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.ops import banded as jbanded
from cheetah_pose_estimation_tpu.ops import losses as jlosses
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.solver import gn as jgn
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.ops import banded as tbanded
from cheetah_pose_estimation_tpu_torch.ops import losses as tlosses
from cheetah_pose_estimation_tpu_torch.solver import gn as tgn
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")
B, N = 2, 12
SCALES = (3.0, 1.0)
CFG = dict(use_gmm=True)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _axes(tree):
    """vmap in_axes of a batched JAX pytree: 0 for leaves with the trial
    axis, None for shared ones."""
    return jax.tree.map(lambda x: 0 if np.ndim(x) and np.shape(x)[0] == B
                        else None, tree)


def kinetic_problem():
    """JAX KineticData for two procedural trials (12 and 11 frames) with
    prescribed stances, warm starts 1 cm off the truth, and its port twin."""
    rng = np.random.default_rng(1)
    kds, qws = [], []
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(B)):
        n = N - i
        d, _, _ = jbl.build_monocular_problem(q[:n], "acinoset", fps, seed=i)
        gp = jkin.GMMPrior(rng.normal(scale=0.1, size=(3, 22)),
                           np.tile(4.0 * np.eye(22), (3, 1, 1)),
                           np.log(np.full(3, 1.0 / 3.0)))
        st = np.zeros((n, 4))
        st[2:7, 0] = st[4:9, 2] = st[1:5, 3] = 1.0
        qw = q[:n] + rng.normal(scale=0.01, size=(n, 54))
        kds.append(jkn.KineticData(
            base=d._replace(gmm=gp), stance=jnp.asarray(st),
            grf_fixed=jnp.zeros((n, 4)), grf_xy_fixed=jnp.zeros((n, 4, 4)),
            use_fixed_grf=jnp.asarray(0.0), q_warm=jnp.asarray(qw),
            ground_z=jnp.asarray(-0.02 * i)))
        qws.append(qw)
    jb, jq = jbatch.pad_and_stack_kinetic(kds, qws, n_frames=N,
                                          dtype=jnp.float64)
    tb, tq = convert.kinetic_problem(jb, jq, device="cpu", batched=True)
    return jb, jq, tb, tq


@pytest.fixture(scope="module")
def problem():
    return kinetic_problem()


@pytest.fixture(scope="module")
def ftes():
    return (jkn.KineticFTE(jkn.KineticConfig(**CFG), SUBJECT),
            tkn.KineticFTE(tkn.KineticConfig(**CFG), SUBJECT))


@pytest.fixture(scope="module")
def jax_terms(problem, ftes):
    """Every JAX quantity the tests compare, from one jitted, vmapped
    function (one compile)."""
    jb, jq, _, _ = problem
    jf = ftes[0]

    def terms(q, data, s):
        q3 = jf._q3_stack(q)
        anchor = jnp.broadcast_to(data.tau_anchor, (q.shape[0], 22))
        fs = jax.vmap(lambda q3t, st, gf, gxf, an: jf._frame_solve(
            q3t, data, st, gf, gxf, an)[:4])(
            q3, data.stance, data.grf_fixed, data.grf_xy_fixed, anchor)
        eom, torque, _ = jf._physics_costs(q, data, s)
        blocks = jf.eom_curvature_blocks(q, data)
        g, H = jf._normal(q, data, s, eom_blocks=blocks)
        return dict(
            frame=fs, base=jf._kin._cost(q, data.base, s),
            acc=jkin.acc_cost(q, data.base.h, data.base.acc_weight,
                              data.base.frame_valid),
            eom=eom, torque=torque, smooth=jf._smooth_cost(q, data),
            stance=jf._stance_penalties(q, data),
            weld=jf._weld_cost(q, data, s), total=jf._cost(q, data, s),
            limit=jf._kin._limit_cost(q, data.base.frame_valid),
            grad=jax.grad(lambda qq: jf._cost(qq, data, s))(q),
            blocks=blocks, g=g, Hd=H.diag, Hl=H.lower)

    fn = jax.jit(jax.vmap(terms, in_axes=(0, _axes(jb), 0)))
    out = fn(jq, jb, jnp.asarray(SCALES))
    return jax.tree.map(np.asarray, out)


def test_huber_matches_jax():
    rng = np.random.default_rng(2)
    r = rng.normal(scale=8.0, size=(2, 500))
    r[0, :5] = [0.0, 3.0, -3.0, 1e-12, -9.0]
    w = rng.uniform(0.0, 2.0, size=(2, 500))
    delta = np.array([[3.0], [9.0]])
    for i in range(2):
        want = jlosses.huber(jnp.asarray(r[i]), delta[i, 0])
        assert _rel(want, tlosses.huber(torch.as_tensor(r[i]),
                                        delta[i, 0])) <= 1e-14
        gj, hj = jlosses.gauss_newton_weights(
            jnp.asarray(r[i]), jnp.asarray(w[i]), jlosses.huber, 1e-3,
            loss_params=(delta[i, 0],))
        gt, ht = tlosses.gauss_newton_weights(
            torch.as_tensor(r[i]), torch.as_tensor(w[i]), 1e-3,
            loss_params=(torch.as_tensor(delta[i]),), loss="huber")
        assert _rel(gj, gt) <= 1e-14 and _rel(hj, ht) <= 1e-14


def test_kinematic_huber_cost_and_normal_match_jax(problem):
    jb, jq, tb, tq = problem
    jf = jkin.KinematicFTE(jkin.KinematicConfig(loss="huber"), SUBJECT)
    tf = tkin.KinematicFTE(tkin.KinematicConfig(loss="huber"), SUBJECT)
    s = jnp.asarray(SCALES)
    fn = jax.jit(jax.vmap(lambda q, d, sc: (jf._cost(q, d, sc),
                                            jf._normal(q, d, sc)),
                          in_axes=(0, _axes(jb.base), 0)))
    cj, (gj, Hj) = fn(jq, jb.base, s)
    st = torch.as_tensor(SCALES, dtype=torch.float64)
    ct = tf._cost(tq, tb.base, st)
    gt, Ht = tf._normal(tq, tb.base, st)
    assert _rel(cj, ct) <= 1e-12
    assert _rel(gj, gt) <= 1e-12
    assert _rel(Hj.diag, Ht.diag) <= 1e-12
    assert _rel(Hj.lower, Ht.lower) <= 1e-12


def test_frame_solve_matches_jax(problem, ftes, jax_terms):
    _, _, tb, tq = problem
    tf = ftes[1]
    slack, tau, gz, gxy, _ = tf._frame_solve(tf._q3_stack(tq), tb,
                                             tf._anchor(tq, tb))
    js, jt, jz, jxy = jax_terms["frame"]
    assert _rel(js, slack) <= 1e-10
    assert _rel(jz, gz) <= 1e-10
    assert _rel(jt, tau) <= 1e-9
    assert _rel(jxy, gxy) <= 1e-9
    assert tb.stance.sum() > 0 and float(gz.abs().max()) > 0.0


def test_cost_terms_match_jax(problem, ftes, jax_terms):
    _, _, tb, tq = problem
    tf = ftes[1]
    s = torch.as_tensor(SCALES, dtype=torch.float64)
    eom, torque, _ = tf._physics_costs(tq, tb, s)
    got = dict(
        base=tf._kin._cost(tq, tb.base, s),
        acc=tkin.acc_cost(tq, tb.base.h, tb.base.acc_weight,
                          tb.base.frame_valid),
        smooth=tf._smooth_cost(tq, tb), stance=tf._stance_penalties(tq, tb),
        weld=tf._weld_cost(tq, tb, s), eom=eom, torque=torque,
        total=tf._cost(tq, tb, s))
    for name in ("base", "acc", "smooth", "stance", "weld"):
        assert _rel(jax_terms[name], got[name]) <= 1e-12, name
        assert float(got[name].abs().max()) > 0.0, name
    for name in ("eom", "torque", "total"):
        assert _rel(jax_terms[name], got[name]) <= 1e-10, name
    forces = tf.forces(tq, tb)
    assert _rel(jax_terms["frame"][1], forces[0]) <= 1e-9
    # the reference-scaled objective, lane 1 (scale 1): the JAX package's
    # ``objective`` expression on its own terms
    j = jax_terms
    want = 1e-3 * (j["total"][1] - j["limit"][1] - j["stance"][1]
                   - j["weld"][1])
    assert abs(float(tf.objective(tq, tb)[1]) - want) <= 1e-10 * abs(want)


def test_normal_gradient_matches_jax_grad(problem, ftes, jax_terms):
    _, _, tb, tq = problem
    g, _ = ftes[1]._normal(tq, tb, torch.as_tensor(SCALES,
                                                    dtype=torch.float64))
    assert _rel(jax_terms["grad"], g) <= 1e-9


def test_normal_blocks_match_jax(problem, ftes, jax_terms):
    _, _, tb, tq = problem
    tf = ftes[1]
    blocks = tf.eom_curvature_blocks(tq, tb)
    for k in range(3):
        assert _rel(jax_terms["blocks"][k], blocks[k]) <= 1e-9, k
    g, H = tf._normal(tq, tb, torch.as_tensor(SCALES, dtype=torch.float64),
                      eom_blocks=blocks)
    assert _rel(jax_terms["g"], g) <= 1e-9
    assert _rel(jax_terms["Hd"], H.diag) <= 1e-9
    assert _rel(jax_terms["Hl"], H.lower) <= 1e-9


def test_guard_rejection_matches_jax_lm_step():
    """Two lanes of a quadratic problem, the guard capping lane 1 below its
    trial point: that lane rejects a step that lowers the cost, lane 0
    accepts; both agree with the JAX ``_lm_step`` field by field."""
    rng = np.random.default_rng(4)
    target = rng.normal(size=(2, 4, 3))
    q0 = np.zeros((2, 4, 3))
    caps = np.array([100.0, 1e-3])

    def jcost(q, a):
        return jnp.sum((q - a) ** 2)

    def jnormal(q, a):
        eye = jnp.broadcast_to(2.0 * jnp.eye(3), (4, 3, 3))
        return 2.0 * (q - a), jbanded.BlockBanded(
            eye, jnp.zeros((3, 4, 3, 3)))

    cfg_j = jgn.LMConfig(lam0=1e-3, linear_solver="scan")

    def jstep(q, a, cap):
        s0 = jgn._init_state(lambda x: jcost(x, a), q, cfg_j)
        return jgn._lm_step(s0, lambda x: jcost(x, a),
                            lambda x: jnormal(x, a), cfg_j,
                            guard_fn=lambda x: jnp.sum(x * x),
                            guard_cap=cap)

    sj = jax.vmap(jstep)(jnp.asarray(q0), jnp.asarray(target),
                         jnp.asarray(caps))
    t = torch.as_tensor(target)

    def tnormal(q):
        eye = (2.0 * torch.eye(3, dtype=q.dtype)).expand(2, 4, 3, 3)
        return 2.0 * (q - t), tbanded.BlockBanded(
            eye, torch.zeros((2, 3, 4, 3, 3), dtype=q.dtype))

    tcost = lambda q: ((q - t) ** 2).sum((1, 2))
    cfg_t = tgn.LMConfig(lam0=1e-3, linear_solver="scan")
    s0 = tgn._init_state(tcost, torch.as_tensor(q0), cfg_t)
    st = tgn._lm_step(s0, tcost, tnormal, cfg_t,
                      guard_fn=lambda x: (x * x).sum((1, 2)),
                      guard_cap=torch.as_tensor(caps))
    assert st.n_accepted.tolist() == [1, 0] == np.asarray(
        sj.n_accepted).tolist()
    for f in ("q", "cost", "lam", "nu"):
        assert _rel(getattr(sj, f), getattr(st, f)) <= 1e-12, f
    assert st.done.tolist() == np.asarray(sj.done).tolist()
