"""Port parity of the physics-based solver's options against the JAX
package, float64, on the problem of ``tests/test_torch_kinetic.py`` (B = 2
trials, N = 12 frames, prescribed stances, so feet are loaded): the
complementarity penalty (``enable_lcp``), the 3D tracking mode
(``use_2d_reprojections=False``, measurement weights zeroed as the
estimator does) and the fixed-length driver (``driver="scan"``), and
``results.check_lcp``.

Tolerances: cost, gradient and normal blocks are the same float64
expressions through the ill-conditioned per-frame elimination (bound 1e-8;
see ``tests/test_torch_kinetic.py``); the solves differ by the order of
float64 sums through their factorizations (bound 1e-6), with equal step
and accepted-step counts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import results as jres
from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch.pipeline import results as tres
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn
from test_torch_kinetic import CFG, SUBJECT, _axes, _rel, kinetic_problem

torch.set_num_threads(1)
# both options in one configuration: one JAX compile covers the LCP
# penalty, the tracking term and the missing smoothing energy
BOTH = dict(CFG, enable_lcp=True, use_2d_reprojections=False)
STAGES = ((3.0, 3), (1.0, 5))


def tracking_problem():
    """The kinetic problem with the measurement weights zeroed (the
    estimator's tracking mode) and the ground plane 10 cm lower, so the
    loaded feet are off the ground (the complementarity penalty is live),
    both packages'."""
    jb, jq, tb, tq = kinetic_problem()
    jb = jb._replace(base=jb.base._replace(
        weight=jnp.zeros_like(jb.base.weight)), ground_z=jb.ground_z - 0.1)
    tb = tb._replace(base=tb.base._replace(
        weight=torch.zeros_like(tb.base.weight)), ground_z=tb.ground_z - 0.1)
    return jb, jq, tb, tq


@pytest.fixture(scope="module")
def problem():
    return tracking_problem()


def test_option_terms_match_jax(problem):
    """Cost, gradient and normal blocks with both options on, at
    annealing scales 3 and 1; the gradient is also autograd's of the
    port's cost."""
    jb, jq, tb, tq = problem
    jf = jkn.KineticFTE(jkn.KineticConfig(**BOTH), SUBJECT)
    tf = tkn.KineticFTE(tkn.KineticConfig(**BOTH), SUBJECT)

    def terms(q, data, s):
        g, H = jf._normal(q, data, s)
        return dict(cost=jf._cost(q, data, s),
                    lcp=jf._physics_costs(q, data, s)[1],
                    track=jf._track_cost(q, data),
                    g=g, Hd=H.diag, Hl=H.lower)

    scales = (3.0, 1.0)
    out = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        terms, in_axes=(0, _axes(jb), 0)))(jq, jb, jnp.asarray(scales)))
    s = torch.tensor(scales, dtype=torch.float64)
    assert _rel(out["cost"], tf._cost(tq, tb, s)) <= 1e-8
    assert _rel(out["lcp"], tf._physics_costs(tq, tb, s)[1]) <= 1e-8
    assert _rel(out["track"], tf._track_cost(tq, tb)) <= 1e-12
    g, H = tf._normal(tq, tb, s)
    qg = tq.clone().requires_grad_(True)
    g_auto, = torch.autograd.grad(tf._cost(qg, tb, s).sum(), qg)
    assert _rel(g_auto, g) <= 1e-8
    assert _rel(out["g"], g) <= 1e-8
    assert _rel(out["Hd"], H.diag) <= 1e-8
    assert _rel(out["Hl"], H.lower) <= 1e-8
    # the penalty is live: loaded feet above the plane
    lcp0 = tkn.KineticFTE(tkn.KineticConfig(**dict(BOTH, enable_lcp=False)),
                          SUBJECT)._physics_costs(tq, tb, s)[1]
    assert (tf._physics_costs(tq, tb, s)[1] > lcp0).all()


@pytest.mark.slow
def test_option_solve_scan_driver_matches_jax(problem):
    """The annealed solve with both options and the fixed-length driver,
    the JAX solver vmapped over the trials with the scan linear solver;
    then ``check_lcp`` on the solved forces against JAX's. Slow (~160 s,
    most of it the JAX compile of the vmapped solver); its tier-1 twin is
    :func:`test_option_solve_drivers_agree`."""
    jb, jq, tb, tq = problem
    jf = jkn.KineticFTE(jkn.KineticConfig(**BOTH), SUBJECT)
    tf = tkn.KineticFTE(tkn.KineticConfig(**BOTH), SUBJECT)
    run = jax.jit(jax.vmap(jf.make_solver(stages=STAGES,
                                          linear_solver="scan",
                                          driver="scan"),
                           in_axes=(0, _axes(jb))))
    sj = run(jq, jb)
    st = tf.make_solver(stages=STAGES, driver="scan")(tq, tb)
    assert st.it.tolist() == np.asarray(sj.it).tolist() == [8, 8]
    assert st.n_accepted.tolist() == np.asarray(sj.n_accepted).tolist()
    assert min(st.n_accepted.tolist()) > 0
    assert _rel(sj.q, st.q) <= 1e-6
    assert _rel(sj.cost, st.cost) <= 1e-6
    _, gz, _ = tf.forces(st.q, tb)
    jgz = jax.vmap(lambda q, d: jf.forces(q, d)[1],
                   in_axes=(0, _axes(jb)))(sj.q, jb)
    assert _rel(np.asarray(jgz), gz) <= 1e-6
    heights = np.random.default_rng(0).uniform(-0.05, 0.05, gz.shape)
    _same_check_lcp(gz.numpy(), np.asarray(jgz), heights)


def _same_check_lcp(gz, jgz, heights):
    """``check_lcp`` of both packages on the same heights: equal verdicts
    at a bar below and above the violation, values within 1e-6."""
    for tol in (1e-2, 10.0):
        a = tres.check_lcp(gz, heights, tol)
        b = jres.check_lcp(jgz, heights, tol)
        assert a["ok"] == b["ok"]
        for k in ("max_violation", "mean_violation"):
            assert abs(a[k] - b[k]) <= 1e-6 * abs(b[k])


def test_option_solve_drivers_agree(problem):
    """Tier-1 twin of the slow JAX solve: the port's solve with both
    options and ftol = 0 takes the same 8 steps with either driver and
    ends at the same q; ``check_lcp`` of the warm start's forces equals
    JAX's."""
    jb, jq, tb, tq = problem
    tf = tkn.KineticFTE(tkn.KineticConfig(**BOTH), SUBJECT)
    st = tf.make_solver(stages=STAGES, ftol=0.0, driver="scan")(tq, tb)
    sw = tf.make_solver(stages=STAGES, ftol=0.0)(tq, tb)
    assert st.it.tolist() == sw.it.tolist() == [8, 8]
    assert min(st.n_accepted.tolist()) > 0
    assert _rel(sw.q, st.q) <= 1e-10
    jf = jkn.KineticFTE(jkn.KineticConfig(**BOTH), SUBJECT)
    data0 = jax.tree.map(lambda x: x[0] if np.ndim(x) and np.shape(x)[0] == 2
                         else x, jb)
    jgz = np.asarray(jax.jit(lambda q, d: jf.forces(q, d)[1])(jq[0], data0))
    gz = tf.forces(tq[:1], tkin.map_data(lambda x: x[:1], tb))[1][0].numpy()
    assert _rel(jgz, gz) <= 1e-8
    heights = np.random.default_rng(0).uniform(-0.05, 0.05, gz.shape)
    _same_check_lcp(gz, jgz, heights)

