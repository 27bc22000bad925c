"""Port parity, the slice as a whole: cost and normal equations, one LM step
(the form of ``__graft_entry__.entry``) and a short heading multistart, on
monocular problems built by the JAX package and carried across with
``convert.py``, in float64.

Tolerances: cost, gradient and curvature blocks are the same float64
expressions (observed ~1e-16 relative; bound 1e-10). After one LM step and
after the short multistart the trajectories differ only by the order of
float64 sums through a few factorizations (observed ~1e-13; bound 1e-8).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.solver import gn as jgn
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.ops import banded as tbanded
from cheetah_pose_estimation_tpu_torch.parallel import batch as tbatch
from cheetah_pose_estimation_tpu_torch.solver import gn as tgn
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def problem16():
    """The 16-frame monocular problem of ``__graft_entry__.entry``."""
    q_gt, _, fps = jbl.load_reference_trajectories(max_trials=1)[0]
    data, q0, _ = jbl.build_monocular_problem(q_gt[:16], "acinoset", fps,
                                              seed=0, n_cams=2, cam_idx=1)
    tdata, tq0 = convert.kinematic_problem(data, q0, device="cpu")
    return data, q0, tdata, tq0


@pytest.fixture(scope="module")
def ftes():
    return (jkin.KinematicFTE(jkin.KinematicConfig(), SUBJECT),
            tkin.KinematicFTE(tkin.KinematicConfig(), SUBJECT))


@pytest.mark.parametrize("scale", [10.0, 3.0, 1.0])
def test_cost_and_normal_match_jax(problem16, ftes, scale):
    data, q0, tdata, tq0 = problem16
    jf, tf = ftes
    q = jnp.asarray(q0)
    terms = jf.cost_terms(q, data, scale)
    tterms = tf.cost_terms(tq0, tdata, scale)
    total = abs(float(jf._cost_impl(q, data, scale)))
    for k in ("measurement", "model", "limit"):
        assert abs(float(terms[k]) - float(tterms[k][0])) <= 1e-10 * total, k
    assert _rel(jf._cost_impl(q, data, scale),
                tf._cost_impl(tq0, tdata, scale)) < 1e-10
    g, H = jf._normal(q, data, scale)
    tg, tH = tf._normal(tq0, tdata, scale)
    assert _rel(g, tg[0]) < 1e-10
    assert _rel(H.diag, tH.diag[0]) < 1e-10
    assert _rel(H.lower, tH.lower[0]) < 1e-10


@pytest.mark.parametrize("linear_solver", ["scan", "cr", "cuda"])
def test_one_lm_step_matches_entry(problem16, ftes, linear_solver):
    """``__graft_entry__.entry``'s forward step: init + one LM step."""
    data, q0, tdata, tq0 = problem16
    jf, tf = ftes
    cost_fn = lambda q: jf._cost(q, data, 1.0)
    normal_fn = lambda q: jf._normal(q, data, 1.0)
    st = jgn._lm_step(jgn._init_state(cost_fn, jnp.asarray(q0),
                                      jgn.LMConfig()),
                      cost_fn, normal_fn, jgn.LMConfig())
    cfg = tgn.LMConfig(linear_solver=linear_solver)
    tc = lambda q: tf._cost_impl(q, tdata, 1.0)
    tn = lambda q: tf._normal(q, tdata, 1.0)
    tst = tgn._lm_step(tgn._init_state(tc, tq0, cfg), tc, tn, cfg)
    assert np.abs(np.asarray(st.q) - tst.q[0].numpy()).max() < 1e-8
    assert _rel(st.cost, tst.cost[0]) < 1e-10
    assert float(st.lam) == pytest.approx(float(tst.lam[0]), rel=1e-12)
    assert bool(st.done) == bool(tst.done[0])


def test_default_linear_solver_follows_device(problem16, ftes, monkeypatch):
    """A config that leaves ``linear_solver`` unset gets the default for the
    tensors' device: the kernel for CUDA tensors, the scan for CPU ones."""
    _, _, tdata, tq0 = problem16
    _, tf = ftes
    assert tgn.LMConfig().linear_solver is None
    assert tgn.default_linear_solver(tq0) == "scan"

    class _OnCard:
        device = torch.device("cuda")
    assert tgn.default_linear_solver(_OnCard()) == "cuda"

    tc = lambda q: tf._cost_impl(q, tdata, 1.0)
    tn = lambda q: tf._normal(q, tdata, 1.0)

    def step(cfg):
        return tgn._lm_step(tgn._init_state(tc, tq0, cfg), tc, tn, cfg)

    unset = step(tgn.LMConfig())
    torch.testing.assert_close(unset.q, step(tgn.LMConfig(
        linear_solver="scan")).q, rtol=0, atol=0)
    seen = []
    monkeypatch.setattr(tgn, "default_linear_solver",
                        lambda x: seen.append(x.device.type) or "cr")
    torch.testing.assert_close(step(tgn.LMConfig()).q, step(tgn.LMConfig(
        linear_solver="cr")).q, rtol=0, atol=0)
    assert seen == ["cpu"]


def test_short_multistart_matches_jax(ftes):
    """2 trials x 16 frames: probe ((10, 3),) on 3 heading restarts, finish
    ((3, 2), (1, 4)); JAX as in production (scan probe, CR finish), the port
    with its CPU default (scan)."""
    jf, tf = ftes
    datas, q0s = [], []
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(2)):
        d, q0, _ = jbl.build_monocular_problem(q[:16], "acinoset", fps,
                                               seed=i)
        datas.append(d)
        q0s.append(q0)
    bj, qj = jbatch.pad_and_stack(datas, q0s, n_frames=16,
                                  dtype=jnp.float64)
    run = jbatch.make_multistart_probe(
        jf.make_solver(stages=((10.0, 3),), driver="fixed",
                       linear_solver="scan"),
        jf.make_solver(stages=((3.0, 2), (1.0, 4)), linear_solver="cr"))
    st = run(qj, bj)
    bt, qt = convert.kinematic_problem(bj, qj, batched=True,
                                      device="cpu")
    trun = tbatch.make_multistart_probe(
        tf.make_solver(stages=((10.0, 3),), driver="scan"),
        tf.make_solver(stages=((3.0, 2), (1.0, 4))))
    tst = trun(qt, bt)
    assert np.abs(np.asarray(st.q) - tst.q.numpy()).max() < 1e-8
    assert _rel(st.cost, tst.cost) < 1e-10
    np.testing.assert_array_equal(np.asarray(st.it), tst.it.numpy())
    np.testing.assert_array_equal(np.asarray(st.n_accepted),
                                  tst.n_accepted.numpy())


def test_annealed_lanes_run_independently(ftes):
    """A lane whose loop condition is false keeps its state exactly while
    other lanes run on: solving two trials together gives each trial's
    single-trial result."""
    _, tf = ftes
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    b, q0, _, _ = bench_lib.build_batch(max_trials=2, n_frames=44,
                                        dtype=torch.float64, device="cpu")
    run = tf.make_solver(stages=((3.0, 3), (1.0, 5)))
    both = run(q0, b)
    for i in range(2):
        one = run(q0[i:i + 1], tkin.map_data(lambda x: x[i:i + 1], b))
        torch.testing.assert_close(one.q[0], both.q[i], rtol=0, atol=1e-12)
        assert int(one.it[0]) == int(both.it[i])


def test_pick_restart_demotes_non_finite():
    st = tgn.LMState(q=torch.arange(6.0)[:, None, None],
                     cost=torch.tensor([float("nan"), 5.0, 5.0,
                                        4.97, 4.99, 4.96]),
                     lam=torch.zeros(6), nu=torch.zeros(6),
                     it=torch.zeros(6, dtype=torch.long),
                     done=torch.zeros(6, dtype=torch.bool),
                     n_accepted=torch.zeros(6, dtype=torch.long))
    sel = tbatch._pick_restart(st, tbatch.MULTISTART_MARGIN, 3)
    # lanes are restart-major (R=3, B=2). Trial 0: the NaN unperturbed lane
    # loses to the best finite alternative (lane 4) even inside the margin;
    # trial 1: 4.96 vs 5.0 is inside the 1 % margin, so restart 0 stays
    assert sel.q[:, 0, 0].tolist() == [4.0, 1.0]
    jst = jax.tree.map(lambda x: jnp.asarray(x.numpy()).reshape(
        (3, 2) + x.shape[1:]), st)
    jsel = jbatch._pick_restart(jst, jbatch.MULTISTART_MARGIN)
    np.testing.assert_array_equal(np.asarray(jsel.q), sel.q.numpy())


def test_padded_batch_normal_matches_jax(ftes):
    """Trials of 40 and 42 frames padded to 44: padded frames carry
    frame_valid = 0 and the identity diagonal block in both packages."""
    jf, tf = ftes
    bj, qj, _, _ = jbl.build_batch(max_trials=2, n_frames=44,
                                   dtype=jnp.float64)
    bt, qt = convert.kinematic_problem(bj, qj, batched=True,
                                      device="cpu")
    g, H = jax.jit(jax.vmap(lambda q, d: jf._normal(q, d, 1.0)))(qj, bj)
    tg, tH = tf._normal(qt, bt, 1.0)
    assert _rel(g, tg) < 1e-10
    assert _rel(H.diag, tH.diag) < 1e-10
    assert _rel(H.lower, tH.lower) < 1e-10
    eye = np.eye(54) * (1.0 + tkin.KinematicConfig().tikhonov)
    np.testing.assert_allclose(tH.diag[0, 40:].numpy(),
                               np.broadcast_to(eye, (4, 54, 54)), atol=1e-12)
    assert _rel(jax.jit(jax.vmap(lambda q, d: jf._cost_impl(q, d, 1.0)))(
                qj, bj),
                tf._cost_impl(qt, bt, 1.0)) < 1e-10


def test_acc_gradient_is_the_banded_product_without_its_cancellation():
    """``acc_gradient`` (D^T W (D q) by nested differences) is the gradient
    of ``acc_cost`` and, in float64, the product ``matvec(acc_banded, q)``
    the JAX package forms. In float32, on a 200 fps trajectory of a few
    metres, the product cancels terms of ~1e8 and misses the gradient at
    that float32 point by > 1e-3 of its largest entry; the differences
    stay within 1e-4. ``KinematicFTE.acc_gradient`` takes the differences
    in the force-plate configuration only."""
    rng = np.random.default_rng(0)
    N, h = 50, 0.005
    t = np.arange(N) * h
    q = np.empty((2, N, 54))
    q[:, :, 0] = 1.0 + 9.0 * t
    q[:, :, 1:3] = 0.5 + 0.05 * np.sin(6 * np.pi * t)[:, None]
    q[:, :, 3:] = 0.3 * np.sin(6 * np.pi * t[:, None]
                               + rng.uniform(0, 6, 51))
    q = q.astype(np.float32).astype(np.float64)
    w = rng.uniform(0.5, 2.0, (2, 54))
    fv = np.ones((2, N))
    fv[1, 44:] = 0.0
    args = lambda d: [torch.as_tensor(a, dtype=d)
                      for a in (q, np.full(2, h), w, fv)]
    q64, h64, w64, fv64 = args(torch.float64)
    g = tkin.acc_gradient(q64, h64, w64, fv64)
    qg = q64.clone().requires_grad_(True)
    auto = torch.autograd.grad(tkin.acc_cost(qg, h64, w64, fv64).sum(),
                               qg)[0]
    prod = tbanded.matvec(tkin.acc_banded(h64, w64, fv64), q64)
    assert _rel(g, auto) < 1e-12 and _rel(g, prod) < 1e-9
    q32, h32, w32, fv32 = args(torch.float32)
    g32 = tkin.acc_gradient(q32, h32, w32, fv32).double()
    p32 = tbanded.matvec(tkin.acc_banded(h32, w32, fv32), q32).double()
    scale = float(g.abs().max())
    assert float((g32 - g).abs().max()) < 1e-4 * scale
    assert float((p32 - g).abs().max()) > 1e-3 * scale
    data = types.SimpleNamespace(h=h32, acc_weight=w32, frame_valid=fv32)
    H32 = tkin.acc_banded(h32, w32, fv32)
    for kinetic_dataset, want in (
            (True, tkin.acc_gradient(q32, h32, w32, fv32)),
            (False, tbanded.matvec(H32, q32))):
        fte = tkin.KinematicFTE(tkin.KinematicConfig(
            kinetic_dataset=kinetic_dataset), SUBJECT)
        assert torch.equal(fte.acc_gradient(q32, data, H32), want)
