"""Port parity of the physics-based solver's annealed LM solve against the
JAX package, float64, on the problem of ``tests/test_torch_kinetic.py``
(B = 2 trials, N = 12 frames): stages ((3.0, 3), (1.0, 5)) from warm starts
1 cm off the truth, the JAX solver vmapped over the trials with the scan
linear solver, the port's with its CPU default (the scan). Bound: the same
iterations and accepted steps per lane, q and the final costs within 1e-6
relative (observed ~4e-10: eight steps, each through float64
factorizations whose rounding differs). Every option builds; an unknown
driver raises ``ValueError``.
"""
import jax
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn
from test_torch_kinetic import CFG, SUBJECT, _axes, _rel, kinetic_problem

torch.set_num_threads(1)


def test_annealed_solve_matches_jax():
    jb, jq, tb, tq = kinetic_problem()
    jf = jkn.KineticFTE(jkn.KineticConfig(**CFG), SUBJECT)
    tf = tkn.KineticFTE(tkn.KineticConfig(**CFG), SUBJECT)
    stages = ((3.0, 3), (1.0, 5))
    run = jax.jit(jax.vmap(jf.make_solver(stages=stages,
                                          linear_solver="scan"),
                           in_axes=(0, _axes(jb))))
    sj = run(jq, jb)
    st = tf.make_solver(stages=stages)(tq, tb)
    assert st.n_accepted.tolist() == np.asarray(sj.n_accepted).tolist()
    assert min(st.n_accepted.tolist()) > 0
    assert st.it.tolist() == np.asarray(sj.it).tolist()
    assert _rel(sj.q, st.q) <= 1e-6
    assert _rel(sj.cost, st.cost) <= 1e-6


def test_unported_kinetic_options_raise():
    """Every option of the JAX solver is ported (their parity:
    ``tests/test_torch_kinetic_options.py``): each builds a solver with
    either driver; only a driver the JAX package lacks raises."""
    for kw in (dict(enable_lcp=True), dict(use_2d_reprojections=False)):
        fte = tkn.KineticFTE(tkn.KineticConfig(**kw), SUBJECT)
        for driver in ("while", "scan"):
            assert callable(fte.make_solver(driver=driver))
    with pytest.raises(ValueError):
        tkn.KineticFTE(tkn.KineticConfig(), SUBJECT).make_solver(
            driver="fixed")
