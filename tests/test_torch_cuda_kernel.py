"""The hand-written CUDA banded-solve kernel against its plain PyTorch
version, on the card. Imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernel.py

Skips (and counts no pass) where ``torch.cuda.is_available()`` is False.
Tolerance: float32 kernel vs the float64 plain version, relative to the
largest entry, <= 7e-4 (the JAX Pallas kernel's bar against its scan). On
the solver's normal systems at lam = 1e-12 (float32-rounded, they are
indefinite) a lane is either NaN or has a normwise backward error <= 1e-5,
every lane that is positive definite by a float32 margin is finite
(``cuda_banded.solve_quality``), and the kernel has no more NaN lanes than
the plain float32 substitution (``solve_reference``) on the same inputs.
"""
import pytest
import torch

from cheetah_pose_estimation_tpu_torch.ops import cuda_banded as cb


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(10, 64), (30, 64), (70, 64), (1, 256),
                                 (3, 5), (2, 1), (4, 7)])
def test_kernel_matches_plain(B, N):
    dev = _cuda()
    diag, lower, rhs = cb.random_systems(B, N, B * 1000 + N, dev)
    before = cb.launches
    before_shape = cb.launches_by_shape.get((B, N), 0)
    x = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    assert cb.launches == before + 1
    assert cb.launches_by_shape[B, N] == before_shape + 1
    ref = cb.solve_reference(diag.double(), lower.double(), rhs.double())
    assert float((x.double() - ref).abs().max() / ref.abs().max()) < 7e-4


@pytest.mark.gpu
def test_kernel_nan_lane_and_rejects():
    dev = _cuda()
    diag, lower, rhs = cb.random_systems(4, 8, 0, dev)
    ok = cb.solve(diag, lower, rhs)
    diag[2, 3] = -torch.eye(54, device=dev)
    x = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    assert torch.isnan(x[2]).all()
    assert torch.equal(x[[0, 1, 3]], ok[[0, 1, 3]])
    with pytest.raises(TypeError):
        cb.solve(diag.double(), lower.double(), rhs.double())
    with pytest.raises(cb.KernelInputError):
        cb.solve(diag[..., :50, :50].contiguous(), lower, rhs)


@pytest.mark.gpu
def test_kernel_on_normal_systems_lam_1e12():
    dev = _cuda()
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin
    batched, q0, _, subject = bench_lib.build_batch(
        max_trials=10, n_frames=64, dtype=torch.float64, device=dev)
    g, H = kin.KinematicFTE(kin.KinematicConfig(), subject)._normal(
        q0, batched, 1.0)
    Hs, rhs, _ = gn.scaled_system(g, H, torch.full((10,), 1e-12,
                                                    device=dev,
                                                    dtype=torch.float64),
                                  1e-8)
    f32 = [a.float().contiguous() for a in (Hs.diag, Hs.lower, rhs)]
    x = cb.solve(*f32)
    torch.cuda.synchronize()
    qual = cb.solve_quality(*f32, x)
    fin = qual["finite"]
    assert (qual["backward"][fin] <= 1e-5).all(), qual
    assert fin[qual["spd_margin"]].all(), qual
    assert torch.isnan(x[~fin]).all()
    plain_nan = ~torch.isfinite(cb.solve_reference(*f32)).all(2).all(1)
    assert int((~fin).sum()) <= int(plain_nan.sum())
