"""Port parity, problem building: the port's host problem builder gives the
JAX package's measurements, weights, cameras and q0 for the same seed
(procedural gallops, numpy random draws in the same order).

Tolerances: meas and q0 pass through float64 FK, projection and
undistortion in both packages (observed <= 3e-13 px / 3e-14 in q); bounds
1e-9. Weights, cameras and tables are copied or drawn identically: exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib as tbl

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_gallop_and_cameras(seed):
    np.testing.assert_array_equal(jsyn.gallop_trajectory(20, seed=seed),
                                  tsyn.gallop_trajectory(20, seed=seed))
    c = np.array([1.0, 2.0, 0.5])
    for a, b in zip(jsyn.ring_cameras(c, seed=seed),
                    tsyn.ring_cameras(c, seed=seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,cam_idx", [(0, 2), (4, 1), (9, 2)])
def test_build_monocular_problem_matches_jax(seed, cam_idx):
    q_gt = jsyn.gallop_trajectory(24, seed=seed)
    dj, q0j, trj = jbl.build_monocular_problem(q_gt, "acinoset", 120.0,
                                               seed=seed, cam_idx=cam_idx)
    dt, q0t, trt = tbl.build_monocular_problem(q_gt, "acinoset", 120.0,
                                               seed=seed, cam_idx=cam_idx)
    np.testing.assert_allclose(np.asarray(dt.meas), np.asarray(dj.meas),
                               rtol=0, atol=1e-9)
    np.testing.assert_array_equal(np.asarray(dt.weight),
                                  np.asarray(dj.weight))
    for a, b in zip(dt.cam, dj.cam):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for f in ("h", "acc_weight", "frame_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(dt, f)),
                                      np.asarray(getattr(dj, f)))
    np.testing.assert_allclose(q0t, q0j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(trt.markers_gt, trj.markers_gt, rtol=0,
                               atol=1e-12)


def test_build_batch_matches_jax_pad_and_stack():
    """Two trials of unequal length padded to 48 frames, float64."""
    bt, qt, trials, _ = tbl.build_batch(max_trials=2, n_frames=48,
                                        dtype=torch.float64)
    datas, q0s = [], []
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(2)):
        d, q0, _ = jbl.build_monocular_problem(q, "acinoset", fps, seed=i)
        datas.append(d)
        q0s.append(q0)
    bj, qj = jbatch.pad_and_stack(datas, q0s, n_frames=48,
                                  dtype=jnp.float64)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=0,
                               atol=1e-9)
    for name in ("meas", "weight", "frame_valid", "acc_weight", "h"):
        np.testing.assert_allclose(getattr(bt, name).numpy(),
                                   np.asarray(getattr(bj, name)), rtol=0,
                                   atol=1e-9, err_msg=name)
    assert [t.q_gt.shape[0] for t in trials] == [40, 42]
    assert bt.frame_valid[0, 40:].sum() == 0 and bt.frame_valid[1, :42].all()
