"""Trajectory error metrics.

Port of ``rmse``, ``traj_smoothness`` and ``traj_error`` of
``cheetah_pose_estimation_tpu/pipeline/metrics.py``, in numpy: the per-joint
table that the JAX function returns as a pandas DataFrame is a (24,) array
here, with the same numbers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def rmse(predictions: np.ndarray, targets: np.ndarray) -> float:
    d = np.asarray(predictions) - np.asarray(targets)
    return float(np.sqrt(np.nanmean((d**2).ravel())))


def traj_smoothness(X: np.ndarray, Y: np.ndarray) -> float:
    """Mean |difference of the frame-to-frame marker displacements| of two
    marker trajectories (N, L, 3)."""
    X, Y = np.asarray(X), np.asarray(Y)
    dx = np.linalg.norm(np.diff(X, axis=0), axis=2)
    dy = np.linalg.norm(np.diff(Y, axis=0), axis=2)
    return float(np.mean(np.abs(dx - dy)))


def traj_error(X: np.ndarray, Y: np.ndarray, centered: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Per-joint mean error (L,) in mm, per-frame mean error (N,) in mm and
    the smoothness error in mm of marker trajectories X, Y (N, L, 3).
    ``centered`` subtracts each frame's marker centroid first (MPJPE; else
    MPE)."""
    smoothness_error_mm = traj_smoothness(X, Y) * 1000.0
    X = np.array(X, dtype=float)
    Y = np.array(Y, dtype=float)
    if centered:
        X -= X.mean(axis=1, keepdims=True)
        Y -= Y.mean(axis=1, keepdims=True)
    distances = np.sqrt(np.sum((X - Y)**2, axis=2))
    return (distances.mean(axis=0) * 1000.0, distances.mean(axis=1) * 1000.0,
            smoothness_error_mm)
