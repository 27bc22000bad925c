"""Trajectory error metrics.

Port of ``cheetah_pose_estimation_tpu/pipeline/metrics.py``, in numpy: the
per-joint table that the JAX package returns as a pandas DataFrame is a
(24,) array here, with the same numbers, and ``compare_traj_error``'s
per-joint bar chart is drawn by matplotlib without pandas.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ..data import io as dio
from ..models.skeleton import MARKERS


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


def compare_traj_error(data_dir: str, cam_idx: int,
                       include_kinetic: bool = False,
                       kinetic_out_fname: str = "fte",
                       save_plots: bool = True) -> Dict[str, Dict]:
    """The monocular solutions of one trial scored against its multi-view
    solve (JAX ``metrics.py:55-119``): for the default
    (``fte_kinematic_orig_<cam>``), data-driven (``fte_kinematic_<cam>``)
    and, with ``include_kinetic``, physics-based (``fte_kinetic_<cam>``,
    ``<kinetic_out_fname>.pickle``) solutions that exist under
    ``data_dir``, over their common frames: {mode: {"mpe_mm", "mpjpe_mm",
    "smoothness_mm", "per_joint" (24,) mm}}. With ``save_plots``, the
    per-frame error curves ``traj_error<suffix>.pdf`` and the per-joint
    bars ``mpjpe_dist<suffix>.pdf`` go to the last mode's directory where
    it exists (a line names them when matplotlib is not installed)."""
    from . import results

    gt = dio.load_fte_pickle(os.path.join(data_dir, "fte_kinematic",
                                          "fte.pickle"))["positions"]
    modes = [("single view", f"fte_kinematic_orig_{cam_idx}", "fte"),
             ("data-driven", f"fte_kinematic_{cam_idx}", "fte")]
    if include_kinetic:
        modes.append(("physics-based", f"fte_kinetic_{cam_idx}",
                      kinetic_out_fname))
    out: Dict[str, Dict] = {}
    per_frame = {}
    for name, sub, fname in modes:
        path = os.path.join(data_dir, sub, f"{fname}.pickle")
        if not os.path.exists(path):
            continue
        pos = dio.load_fte_pickle(path)["positions"]
        n = min(len(pos), len(gt))
        per_joint, frame_err, smooth = traj_error(gt[:n], pos[:n])
        per_joint_c, _, _ = traj_error(gt[:n], pos[:n], centered=True)
        for kind, tbl in (("mpe", per_joint), ("mpjpe", per_joint_c)):
            print(f"{name} {kind} [mm]: {float(tbl.mean()):.1f}")
            print(f"{name} smoothness error [mm]: {smooth:.1f}")
        dist = np.sqrt(np.sum((gt[:n] - pos[:n])**2, axis=2))
        distc = np.sqrt(np.sum(
            ((gt[:n] - gt[:n].mean(1, keepdims=True))
             - (pos[:n] - pos[:n].mean(1, keepdims=True)))**2, axis=2))
        out[name] = {"mpe_mm": float(dist.mean() * 1000),
                     "mpjpe_mm": float(distc.mean() * 1000),
                     "smoothness_mm": smooth, "per_joint": per_joint}
        per_frame[name] = frame_err
    tgt = os.path.join(data_dir, modes[-1][1])
    if not (save_plots and per_frame and os.path.isdir(tgt)):
        return out
    suffix = "" if kinetic_out_fname == "fte" else kinetic_out_fname[-1]
    names = [os.path.join(tgt, f"{n}{suffix}.pdf")
             for n in ("traj_error", "mpjpe_dist")]
    plt = results._pyplot()
    if plt is None:
        results._skipped(names)
        return out
    fig = plt.figure(figsize=(16, 12), dpi=60)
    for name, err in per_frame.items():
        plt.plot(err, label=name)
    plt.xlabel("Finite Element")
    plt.ylabel("Error (mm)")
    plt.legend()
    fig.savefig(names[0])
    plt.close(fig)
    fig = plt.figure(figsize=(16, 12))
    h = 0.8 / len(out)
    y = np.arange(len(MARKERS))
    for k, (name, v) in enumerate(out.items()):
        plt.barh(y + (k - (len(out) - 1) / 2) * h, v["per_joint"], h,
                 label=name)
    plt.yticks(y, MARKERS)
    plt.xlabel("Error (mm)")
    plt.ylabel("Joint")
    plt.legend()
    fig.savefig(names[1])
    plt.close(fig)
    return out
