"""The hand-written CUDA banded-solve kernel against its plain PyTorch
version, on the card. Imports no JAX, so it runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cuda_kernel.py

Skips (and counts no pass) where ``torch.cuda.is_available()`` is False.
Tolerance: float32 kernel vs the float64 plain version, relative to the
largest entry, <= 7e-4 (the JAX Pallas kernel's bar against its scan).
"""
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu_torch.ops import cuda_banded as cb


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _systems(B, N, seed, dev):
    """Block-diagonally dominant SPD systems in the kernel's layout."""
    rng = np.random.default_rng(seed)
    lower = 0.02 * rng.normal(size=(B, 3, N, 54, 54))
    for k in range(1, 4):
        lower[:, k - 1, max(N - k, 0):] = 0.0
    sym = rng.normal(size=(B, N, 54, 54))
    diag = 0.1 * (sym + np.swapaxes(sym, -1, -2)) + 20.0 * np.eye(54)
    rhs = rng.normal(size=(B, N, 54))
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (diag, lower, rhs)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(10, 64), (30, 64), (1, 256), (3, 5),
                                 (2, 1)])
def test_kernel_matches_plain(B, N):
    dev = _cuda()
    diag, lower, rhs = _systems(B, N, B * 1000 + N, dev)
    before = cb.launches
    x = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    assert cb.launches == before + 1
    ref = cb.solve_reference(diag.double(), lower.double(), rhs.double())
    assert float((x.double() - ref).abs().max() / ref.abs().max()) < 7e-4


@pytest.mark.gpu
def test_kernel_nan_lane_and_rejects():
    dev = _cuda()
    diag, lower, rhs = _systems(4, 8, 0, dev)
    ok = cb.solve(diag, lower, rhs)
    diag[2, 3] = -torch.eye(54, device=dev)
    x = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    assert torch.isnan(x[2]).all()
    assert torch.equal(x[[0, 1, 3]], ok[[0, 1, 3]])
    with pytest.raises(TypeError):
        cb.solve(diag.double(), lower.double(), rhs.double())
    with pytest.raises(ValueError):
        cb.solve(diag[..., :50, :50].contiguous(), lower, rhs)
