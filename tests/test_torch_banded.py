"""Port parity, banded solves: the port's scan, cyclic-reduction and kernel
twins (``cuda_banded.solve_reference``, and ``solve_reference_blocked``,
which follows the kernel's order of operations: blocked Cholesky, explicit
inverses of the diagonal factors, products) against the JAX package's
``banded.solve``, ``banded.cr_solve`` and the Pallas kernel in interpret
mode, in float64 on the SPD systems of ``tests/test_pallas_banded.py``.

Tolerance 1e-10 relative: all are exact factorizations in float64 (observed
~1e-15). The CUDA kernel itself runs only on a card: its test is
``tests/test_torch_cuda_kernel.py`` (``gpu`` marker, no JAX import, so it
also runs on a machine without JAX).

Float32 conditioning of the kernel's arithmetic (the blocked twin in
float32) on the solver's own Jacobi-scaled normal systems, against float64
``solve_reference`` of the same float32 inputs: relative error <= 7e-4 at
lam = 1e-2; at every lam the normwise backward error <= 1e-5 (float32 eps
is 1.2e-7; observed ~1e-7, like the substitution of ``solve_reference`` in
float32). At lam = 1e-6 and 1e-12 no float32 solve reaches 7e-4 in the
forward error: the systems' condition reaches 1e6 to 1e9 and at 1e-12 the
float32-rounded systems are indefinite, so a NaN lane is a right answer
there, and the forward error is not held to a bar; the blocked twin may
fail no more lanes than the substitution on the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.ops import banded as jb
from cheetah_pose_estimation_tpu.ops import pallas_banded as pb
from cheetah_pose_estimation_tpu_torch.ops import banded as tb
from cheetah_pose_estimation_tpu_torch.ops import cuda_banded as cb
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.parallel import batch as tbatch
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib as tbl
from cheetah_pose_estimation_tpu_torch.solver import gn as tgn
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin
from test_pallas_banded import _spd_banded

torch.set_num_threads(1)
TOL = 1e-10
TOL_REL_F32 = 7e-4       # the kernel's bar (the JAX Pallas kernel's)
TOL_BACKWARD_F32 = 1e-5


def _systems(seed, B, N, d):
    rng = np.random.default_rng(seed)
    Hs = [_spd_banded(rng, N, d, 3)[0] for _ in range(B)]
    diag = np.stack([np.asarray(h.diag, np.float64) for h in Hs])
    lower = np.stack([np.asarray(h.lower, np.float64) for h in Hs])
    return diag, lower, rng.normal(size=(B, N, d))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(a).max()


def _jax_each(fn, diag, lower, b):
    return np.stack([np.asarray(fn(jb.BlockBanded(jnp.asarray(diag[i]),
                                                  jnp.asarray(lower[i])),
                                   jnp.asarray(b[i])))
                     for i in range(len(b))])


@pytest.mark.parametrize("N,d", [(8, 54), (16, 30), (5, 6), (1, 4)])
def test_scan_and_cr_match_jax(N, d):
    diag, lower, b = _systems(N + d, 2, N, d)
    H = tb.BlockBanded(torch.as_tensor(diag), torch.as_tensor(lower))
    bt = torch.as_tensor(b)
    assert _rel(_jax_each(jb.solve, diag, lower, b), tb.solve(H, bt)) < TOL
    assert _rel(_jax_each(jb.cr_solve, diag, lower, b),
                tb.cr_solve(H, bt)) < TOL
    assert _rel(_jax_each(jb.matvec, diag, lower, b),
                tb.matvec(H, bt)) < TOL
    dense = np.asarray(jb.to_dense(jb.BlockBanded(jnp.asarray(diag[1]),
                                                  jnp.asarray(lower[1]))))
    np.testing.assert_array_equal(dense, tb.to_dense(H)[1].numpy())


@pytest.mark.parametrize("N", [1, 3, 9, 12])
def test_kernel_twin_matches_pallas_interpret(N):
    diag, lower, b = _systems(N, 3, N, 54)
    ref = np.asarray(pb.pallas_banded_solve_batched(
        jnp.asarray(diag), jnp.asarray(lower), jnp.asarray(b),
        interpret=True))
    x = cb.solve(torch.as_tensor(diag), torch.as_tensor(lower),
                 torch.as_tensor(b))
    assert _rel(ref, x) < TOL
    assert _rel(ref, cb.solve_reference(torch.as_tensor(diag),
                                        torch.as_tensor(lower),
                                        torch.as_tensor(b))) < TOL


@pytest.mark.parametrize("N", [1, 3, 9, 12])
def test_blocked_twin_matches_pallas_interpret(N):
    diag, lower, b = _systems(N + 100, 3, N, 54)
    ref = np.asarray(pb.pallas_banded_solve_batched(
        jnp.asarray(diag), jnp.asarray(lower), jnp.asarray(b),
        interpret=True))
    x = cb.solve_reference_blocked(torch.as_tensor(diag),
                                   torch.as_tensor(lower), torch.as_tensor(b))
    assert _rel(ref, x) < TOL


@pytest.fixture(scope="module")
def normal_problem():
    """A 2-trial, 16-frame monocular problem in float64 on the CPU, its q0,
    and q after 8 float64 LM steps at annealing scale 1."""
    datas, q0s = [], []
    for i in range(2):
        d, q0, _ = tbl.build_monocular_problem(
            tsyn.gallop_trajectory(16, seed=i), "acinoset", 120.0, seed=i)
        datas.append(d)
        q0s.append(q0)
    batched, q0b = tbatch.pad_and_stack(datas, q0s, dtype=torch.float64,
                                        device="cpu")
    fte = tkin.KinematicFTE(tkin.KinematicConfig(),
                            tparams.get_subject("acinoset"))
    q8 = fte.make_solver(stages=((1.0, 8),))(q0b, batched).q
    return fte, batched, q0b, q8


@pytest.mark.parametrize("lam", [1e-2, 1e-6, 1e-12])
def test_blocked_twin_float32_conditioning(normal_problem, lam):
    fte, batched, q0b, q8 = normal_problem
    q = q0b if lam == 1e-2 else q8
    g, H = fte._normal(q, batched, 1.0)
    Hs, rhs, _ = tgn.scaled_system(g, H, torch.full((2,), lam,
                                                    dtype=torch.float64),
                                   1e-8)
    f32 = [a.float().contiguous() for a in (Hs.diag, Hs.lower, rhs)]
    nan_lanes = {}
    for fn in (cb.solve_reference_blocked, cb.solve_reference):
        x = fn(*f32)
        qual = cb.solve_quality(*f32, x)
        fin = qual["finite"]
        assert (qual["backward"][fin] <= TOL_BACKWARD_F32).all(), qual
        assert fin[qual["spd_margin"]].all(), qual
        assert torch.isnan(x[~fin]).all()
        nan_lanes[fn] = int((~fin).sum())
        if lam == 1e-2:
            assert qual["spd_margin"].all()
            assert (qual["forward"] <= TOL_REL_F32).all(), qual
    # the kernel's arithmetic fails no more lanes than the substitution
    assert (nan_lanes[cb.solve_reference_blocked]
            <= nan_lanes[cb.solve_reference]), nan_lanes


@pytest.mark.parametrize("solver", ["scan", "cr", "twin", "blocked"])
def test_indefinite_lane_is_nan_others_untouched(solver):
    diag, lower, b = _systems(5, 3, 6, 54)
    fn = {"scan": lambda d, l, r: tb.solve(tb.BlockBanded(d, l), r),
          "cr": lambda d, l, r: tb.cr_solve(tb.BlockBanded(d, l), r),
          "twin": cb.solve_reference,
          "blocked": cb.solve_reference_blocked}[solver]
    args = [torch.as_tensor(a) for a in (diag, lower, b)]
    x_ok = fn(*args)
    args[0][1, 2] = -torch.eye(54, dtype=torch.float64)
    x = fn(*args)
    assert torch.isnan(x[1]).all()
    assert torch.isfinite(x[[0, 2]]).all()
    torch.testing.assert_close(x[[0, 2]], x_ok[[0, 2]], rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    diag, lower, b = (torch.zeros(1, 4, 54, 54), torch.zeros(1, 3, 4, 54, 54),
                      torch.zeros(1, 4, 54))
    with pytest.raises(cb.KernelInputError):
        cb.solve(diag.to("meta"), lower.to("meta"), b.to("meta"))
    with pytest.raises(TypeError):
        cb._check(diag.double(), lower, b)
    with pytest.raises(cb.KernelInputError):
        cb._check(diag[:, :, :30, :30], lower, b)
    with pytest.raises(cb.KernelInputError):
        cb._check(diag.mT, lower, b)
    # not a ValueError: the physics fallback never takes it for a failed
    # solve
    assert not issubclass(cb.KernelInputError, ValueError)
    shifted = torch.zeros(diag.numel() + 1)[1:].view(diag.shape)
    with pytest.raises(cb.KernelInputError, match="aligned"):
        cb._check(shifted, lower, b)
