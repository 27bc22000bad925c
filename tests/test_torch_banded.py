"""Port parity, banded solves: the port's scan, cyclic-reduction and kernel
twin (``cuda_banded.solve_reference``) against the JAX package's
``banded.solve``, ``banded.cr_solve`` and the Pallas kernel in interpret
mode, in float64 on the SPD systems of ``tests/test_pallas_banded.py``.

Tolerance 1e-10 relative: all are exact factorizations in float64 (observed
~1e-15). The CUDA kernel itself runs only on a card: its test is
``tests/test_torch_cuda_kernel.py`` (``gpu`` marker, no JAX import, so it
also runs on a machine without JAX).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.ops import banded as jb
from cheetah_pose_estimation_tpu.ops import pallas_banded as pb
from cheetah_pose_estimation_tpu_torch.ops import banded as tb
from cheetah_pose_estimation_tpu_torch.ops import cuda_banded as cb
from test_pallas_banded import _spd_banded

torch.set_num_threads(1)
TOL = 1e-10


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


@pytest.mark.parametrize("solver", ["scan", "cr", "twin"])
def test_indefinite_lane_is_nan_others_untouched(solver):
    diag, lower, b = _systems(5, 3, 6, 54)
    fn = {"scan": lambda d, l, r: tb.solve(tb.BlockBanded(d, l), r),
          "cr": lambda d, l, r: tb.cr_solve(tb.BlockBanded(d, l), r),
          "twin": cb.solve_reference}[solver]
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
    with pytest.raises(ValueError):
        cb.solve(diag.to("meta"), lower.to("meta"), b.to("meta"))
    with pytest.raises(TypeError):
        cb._check(diag.double(), lower, b)
    with pytest.raises(ValueError):
        cb._check(diag[:, :, :30, :30], lower, b)
    with pytest.raises(ValueError):
        cb._check(diag.mT, lower, b)
