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
The force-plate pipeline's shape, 1x50, is held on a random system and on
a torque-anchored kinetic normal system (the GRF re-estimation's, damped at
lam = 1e-2 and scaled as ``gn.scaled_system`` does). The every-camera
sweep's line-scan shape, 252x64, runs in two waves of CTAs: a NaN lane of
the second wave stays in its lane.
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
                                 (1, 50), (3, 5), (2, 1), (4, 7)])
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
def test_kernel_two_waves_252x64_nan_lane_in_second_wave():
    """252 systems, more than the card's 132 SMs (one system per SM at a
    time, so two waves): every lane against the plain version, and a lane
    of the second wave poisoned with NaN comes back NaN alone, the other
    lanes bit-identical."""
    dev = _cuda()
    B, N, lane = 252, 64, 200
    diag, lower, rhs = cb.random_systems(B, N, B * 1000 + N, dev)
    ok = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    ref = cb.solve_reference(diag.double(), lower.double(), rhs.double())
    assert float((ok.double() - ref).abs().max() / ref.abs().max()) < 7e-4
    diag[lane].fill_(float("nan"))
    x = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    others = [i for i in range(B) if i != lane]
    assert torch.isnan(x[lane]).all()
    assert torch.equal(x[others], ok[others])


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


def anchored_kinetic_system(dev, dtype=torch.float32):
    """The damped (lam = 1e-2), Jacobi-scaled normal system of a 1x50
    torque-anchored kinetic problem at its warm start: a procedural 200 fps
    gallop seen by 4 cameras, two stance windows, a random torque anchor
    of weight 1e4, the 0.03 m foot-height box."""
    import numpy as np

    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin
    from cheetah_pose_estimation_tpu_torch.solver import kinetic as kn

    N = 50
    q_gt = syn.gallop_trajectory(N, fps=200.0, seed=3)
    data, _, _ = bench_lib.build_monocular_problem(
        q_gt, "shiraz", 200.0, cam_idx=None, seed=3, n_cams=4)
    stance = np.zeros((N, 4))
    stance[5:20, 2] = stance[25:40, 3] = 1.0
    kd = kn.KineticData(
        base=data, stance=stance, grf_fixed=np.zeros((N, 4)),
        grf_xy_fixed=np.zeros((N, 4, 4)), use_fixed_grf=np.asarray(0.0),
        q_warm=q_gt, tau_anchor=np.random.default_rng(0).normal(
            scale=0.05, size=(N, 22)), tau_anchor_weight=np.asarray(1e4),
        ground_z=np.asarray(0.0))
    kbat, qw = pbatch.pad_and_stack_kinetic([kd], [q_gt], dtype=dtype,
                                            device=dev)
    fte = kn.KineticFTE(kn.KineticConfig(foot_height_bound=0.03),
                        params.get_subject("shiraz"))
    g, H = fte._normal(qw, kbat, 1.0,
                       eom_blocks=fte.eom_curvature_blocks(qw, kbat))
    b = kbat.base
    floor = torch.clamp(torch.diagonal(kin.acc_banded(
        b.h, b.acc_weight, b.frame_valid).diag, dim1=-2, dim2=-1), min=1e-8)
    Hs, rhs, _ = gn.scaled_system(g, H, torch.full((1,), 1e-2, dtype=dtype,
                                                   device=dev), floor)
    return [a.contiguous() for a in (Hs.diag, Hs.lower, rhs)]


@pytest.mark.gpu
def test_kernel_on_torque_anchored_kinetic_system_1x50():
    dev = _cuda()
    diag, lower, rhs = anchored_kinetic_system(dev)
    assert diag.shape == (1, 50, 54, 54)
    x = cb.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    ref = cb.solve_reference(diag.double(), lower.double(), rhs.double())
    assert torch.isfinite(x).all() and torch.isfinite(ref).all()
    assert float((x.double() - ref).abs().max() / ref.abs().max()) < 7e-4
