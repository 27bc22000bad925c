"""Trajectory initialisation from 2D detections.

Port of ``cheetah_pose_estimation_tpu/pipeline/initialization.py`` (numpy
and scipy on the host; the camera model runs in float64 torch on the CPU):
place the spine marker (multi-view: the mean of pairwise two-view DLT
triangulations; monocular: back-projected along its camera ray at a depth
estimated from the apparent body size), smooth with cubic splines, take the
heading from the planar velocity, and set every link's yaw to it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.interpolate import UnivariateSpline

from ..models.params import SubjectParams
from ..models.skeleton import LINK_NAMES, MARKERS
from ..ops import camera as cam_ops

SPINE = MARKERS.index("spine")
NECK_BASE = MARKERS.index("neck_base")
TAIL_BASE = MARKERS.index("tail_base")


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _undistort(uv, K, D, fisheye: bool) -> np.ndarray:
    fn = cam_ops.undistort_fisheye if fisheye else cam_ops.undistort_pinhole
    return fn(_t(uv), _t(K), _t(D)).numpy()


def triangulate_spine_multiview(meas: np.ndarray, weight: np.ndarray,
                                K, D, R, t, fisheye: bool = True
                                ) -> np.ndarray:
    """Mean of the two-view triangulations of the spine marker over the
    camera pairs (i, i+1 mod C) that both see it.

    ``meas`` (N, C, L, 2[, W]) pixel detections (the first of W is used),
    ``weight`` (N, C, L[, W]), 0 for gated-out detections. Returns (N, 3)
    spine positions, NaN where no pair sees it."""
    if meas.ndim == 5:
        meas = meas[..., 0]
        weight = weight[..., 0]
    N, C = meas.shape[:2]
    ab = np.stack([_undistort(meas[:, c, SPINE], K[c], D[c], fisheye)
                   for c in range(C)], axis=1)           # (N, C, 2)
    ok = weight[:, :, SPINE] > 0                          # (N, C)
    acc = np.zeros((N, 3))
    cnt = np.zeros(N)
    for i in range(C):
        j = (i + 1) % C
        pair_ok = ok[:, i] & ok[:, j]
        if not pair_ok.any():
            continue
        acc[pair_ok] += cam_ops.triangulate_dlt(
            _t(ab[pair_ok, i]), _t(ab[pair_ok, j]), _t(R[i]), _t(t[i]),
            _t(R[j]), _t(t[j])).numpy()
        cnt[pair_ok] += 1
    out = np.full((N, 3), np.nan)
    nz = cnt > 0
    out[nz] = acc[nz] / cnt[nz, None]
    return out


def estimate_monocular_depth(meas: np.ndarray, weight: np.ndarray,
                             cam_idx: int, K, D, fisheye: bool,
                             body_axis_m: float) -> np.ndarray:
    """Per-frame camera depth from the apparent neck-to-tail separation
    (a low percentile over the trial; 3 m when nothing is detected)."""
    ab = _undistort(meas[:, cam_idx, [NECK_BASE, TAIL_BASE]], K[cam_idx],
                    D[cam_idx], fisheye)                  # (N, 2, 2)
    sep = np.linalg.norm(ab[:, 0] - ab[:, 1], axis=1)
    ok = (weight[:, cam_idx, NECK_BASE] > 0) & \
        (weight[:, cam_idx, TAIL_BASE] > 0) & (sep > 1e-6)
    depth = np.full(meas.shape[0], np.nan)
    depth[ok] = body_axis_m / sep[ok]
    if np.isfinite(depth).any():
        depth[:] = np.nanpercentile(depth, 20.0)
    else:
        depth[:] = 3.0
    return depth


def spine_from_single_view(meas: np.ndarray, weight: np.ndarray,
                           cam_idx: int, K, D, R, t, fisheye: bool = True,
                           dist_to_plane: Optional[float] = None,
                           body_axis_m: float = 0.75) -> np.ndarray:
    """Monocular: back-project the spine pixel along its camera ray."""
    if meas.ndim == 5:
        meas = meas[..., 0]
        weight = weight[..., 0]
    ab = _undistort(meas[:, cam_idx, SPINE], K[cam_idx], D[cam_idx], fisheye)
    if dist_to_plane is not None:
        depth = np.full(meas.shape[0], float(dist_to_plane))
    else:
        depth = estimate_monocular_depth(meas, weight, cam_idx, K, D,
                                         fisheye, body_axis_m)
    X = cam_ops.backproject_to_distance(_t(ab), _t(depth), _t(R[cam_idx]),
                                        _t(t[cam_idx]).reshape(3)).numpy()
    X[~(weight[:, cam_idx, SPINE] > 0)] = np.nan
    return X


def smooth_and_head(spine: np.ndarray, linear: bool = False):
    """Spline-smooth the (NaN-holed) spine track; yaw = pi + atan2 of the
    planar velocity, unwrapped and re-centred on the principal branch."""
    N = spine.shape[0]
    fr = np.arange(N, dtype=float)
    ok = np.isfinite(spine).all(axis=1)
    k = 1 if linear else 3
    if ok.sum() <= k:
        sm = np.repeat(np.nanmean(spine, axis=0, keepdims=True), N, axis=0)
        sm = np.nan_to_num(sm)
    else:
        sm = np.stack([UnivariateSpline(fr[ok], spine[ok, i], k=k)(fr)
                       for i in range(3)], axis=1)
    d = np.gradient(sm[:, :2], axis=0)
    psi = np.unwrap(np.pi + np.arctan2(d[:, 1], d[:, 0]))
    psi -= 2.0 * np.pi * np.round(np.median(psi) / (2.0 * np.pi))
    return sm, psi


def initial_q(spine_smooth: np.ndarray, psi: np.ndarray,
              subject: SubjectParams) -> np.ndarray:
    """q0: base centre half a body length behind the spine marker in x,
    every link's yaw at the heading, everything else zero."""
    N = spine_smooth.shape[0]
    q0 = np.zeros((N, 54))
    q0[:, :3] = spine_smooth
    q0[:, 0] += subject.length[0] / 2.0
    for i in range(len(LINK_NAMES)):
        q0[:, 5 if i == 0 else 3 * i + 5] = psi
    return q0


def initialize_trajectory(meas: np.ndarray, weight: np.ndarray, K, D, R, t,
                          subject: SubjectParams, fisheye: bool = True,
                          cam_idx: Optional[int] = None,
                          kinetic_dataset: bool = False) -> np.ndarray:
    """Full init path (multi-view with ``cam_idx=None``, else monocular
    from that camera): returns q0 (N, 54)."""
    if cam_idx is None:
        spine = triangulate_spine_multiview(meas, weight, K, D, R, t,
                                            fisheye)
    else:
        body_axis = float(subject.length[0] + subject.length[1])
        spine = spine_from_single_view(meas, weight, cam_idx, K, D, R, t,
                                       fisheye, body_axis_m=body_axis)
    sm, psi = smooth_and_head(spine, linear=kinetic_dataset)
    return initial_q(sm, psi, subject)
