"""Synthetic trial generation (procedural gallops, camera rings, DLC-like
detections).

Port of the parts of ``cheetah_pose_estimation_tpu/data/synthetic.py`` that
bench problems need, as numpy on top of the port's forward kinematics and
camera model (float64 on the CPU). The random draws follow the JAX
package's exactly, so the same seed gives the same problem.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from cheetah_pose_estimation_tpu.models import noise as noise_tables
from cheetah_pose_estimation_tpu.models.params import SubjectParams

from ..models import skeleton as sk
from ..ops import camera as cam_ops


class SyntheticScene(NamedTuple):
    K: np.ndarray        # (C, 3, 3)
    D: np.ndarray        # (C, 4)
    R: np.ndarray        # (C, 3, 3)
    t: np.ndarray        # (C, 3)
    cam_res: Tuple[int, int]
    fps: float
    fisheye: bool


class SyntheticTrial(NamedTuple):
    q_gt: np.ndarray         # (N, 54)
    markers_gt: np.ndarray   # (N, 24, 3)
    meas: np.ndarray         # (N, C, 24, 2, 1) pixel detections
    likelihood: np.ndarray   # (N, C, 24, 1)
    scene: SyntheticScene
    subject_name: str


def _look_at(pos: np.ndarray, target: np.ndarray):
    f = target - pos
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.array([0.0, 0.0, 1.0]))
    r = r / np.linalg.norm(r)
    d = np.cross(f, r)
    R = np.stack([r, d, f])
    return R, -R @ pos


def ring_cameras(center: np.ndarray, n_cams: int = 6, distance: float = 9.0,
                 height: float = 1.2, fps: float = 120.0,
                 fisheye: bool = True, arc: float = 2.4,
                 seed: int = 0) -> SyntheticScene:
    """Cameras on an arc around ``center``, all looking at it."""
    rng = np.random.default_rng(seed)
    Ks, Ds, Rs, ts = [], [], [], []
    for a in np.linspace(-arc / 2, arc / 2, n_cams):
        pos = center + np.array([distance * np.sin(a),
                                 -distance * np.cos(a), height])
        pos = pos + rng.normal(scale=0.2, size=3)
        R, t = _look_at(pos, center)
        K = np.array([[1400.0 + rng.normal(scale=20), 0.0, 1352.0],
                      [0.0, 1400.0 + rng.normal(scale=20), 760.0],
                      [0.0, 0.0, 1.0]])
        D = (np.array([-0.03, 0.01, -0.002, 0.0005])
             + rng.normal(scale=1e-3, size=4)) if fisheye else \
            np.array([-0.15, 0.03, 0.001, 0.0])
        Ks.append(K)
        Ds.append(D)
        Rs.append(R)
        ts.append(t)
    return SyntheticScene(np.stack(Ks), np.stack(Ds), np.stack(Rs),
                          np.stack(ts), (2704, 1520), fps, fisheye)


def gallop_trajectory(n_frames: int = 60, fps: float = 120.0,
                      speed: float = 12.0, seed: int = 0) -> np.ndarray:
    """Procedural galloping q trajectory: straight run in +x with periodic
    limb/spine motion."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_frames) / fps
    ph = 2 * np.pi * 3.2 * t
    q = np.zeros((n_frames, 54))
    q[:, 0] = speed * t
    q[:, 1] = 0.02 * np.sin(0.5 * ph)
    q[:, 2] = 0.55 + 0.06 * np.sin(ph)
    q[:, 4] = 0.15 * np.sin(ph)           # base pitch
    q[:, 5] = np.pi                        # yaw: body -x axis faces +x
    names = sk.LINK_NAMES

    def set_theta(link, val):
        q[:, 3 * names.index(link) + 4] = val

    for ln in names[1:]:
        q[:, 3 * names.index(ln) + 5] = np.pi
    set_theta("bodyF", -0.2 * np.sin(ph))
    set_theta("neck", -0.3 + 0.1 * np.sin(ph))
    set_theta("tail0", 0.3 * np.sin(ph + 1.0))
    set_theta("tail1", 0.4 * np.sin(ph + 1.5))
    legs = {"UFL": 0.0, "UFR": 0.4, "UBL": np.pi, "UBR": np.pi + 0.4}
    for leg, phase in legs.items():
        back = leg[1] == "B"
        swing = 0.6 * np.sin(ph + phase)
        set_theta(leg, swing)
        knee = (0.45 + 0.35 * np.sin(ph + phase + 0.8))
        set_theta("L" + leg[1:], swing + (knee if back else -knee))
        ank = (0.3 + 0.3 * np.sin(ph + phase + 1.2))
        set_theta("H" + leg[1:], swing + (knee if back else -knee)
                  + (-ank if back else ank))
    q += rng.normal(scale=0.005, size=q.shape)
    return q


def fk_markers_np(q: np.ndarray, subject: SubjectParams) -> np.ndarray:
    """Host FK in float64: q (..., 54) -> markers (..., 24, 3)."""
    return sk.fk_markers(torch.as_tensor(q, dtype=torch.float64),
                         subject).numpy()


def synthesize(q_gt: np.ndarray, subject: SubjectParams,
               scene: Optional[SyntheticScene] = None,
               noise_px: float = 1.5, outlier_frac: float = 0.02,
               outlier_px: float = 60.0, drop_frac: float = 0.05,
               dlc_thresh: float = 0.5, seed: int = 0,
               subject_name: str = "acinoset") -> SyntheticTrial:
    """Render noisy DLC-like detections of a q trajectory (no correlated
    failure model: occlusion/confusion bursts are not ported)."""
    rng = np.random.default_rng(seed)
    markers = fk_markers_np(q_gt, subject)
    N = q_gt.shape[0]
    if scene is None:
        scene = ring_cameras(markers.mean(axis=(0, 1)))
    proj = (cam_ops.project_fisheye if scene.fisheye
            else cam_ops.project_pinhole)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    meas = np.empty((N, scene.K.shape[0], sk.N_MARKERS, 2))
    for c in range(scene.K.shape[0]):
        meas[:, c] = proj(T(markers), T(scene.K[c]), T(scene.D[c]),
                          T(scene.R[c]), T(scene.t[c])).numpy()
    meas = meas + rng.normal(scale=noise_px, size=meas.shape)
    out_mask = rng.uniform(size=meas.shape[:3]) < outlier_frac
    meas[out_mask] += rng.normal(scale=outlier_px, size=(out_mask.sum(), 2))
    likelihood = np.clip(rng.uniform(0.6, 1.0, size=meas.shape[:3]),
                         0.0, 1.0)
    drop = rng.uniform(size=likelihood.shape) < drop_frac
    likelihood[drop] = rng.uniform(0.0, dlc_thresh, size=drop.sum())
    return SyntheticTrial(q_gt=q_gt, markers_gt=markers,
                          meas=meas[..., None],
                          likelihood=likelihood[..., None],
                          scene=scene, subject_name=subject_name)


def gated_weights(trial: SyntheticTrial, dlc_thresh: float = 0.5,
                  kinetic_dataset: bool = False) -> np.ndarray:
    """(N, C, 24, W) measurement weights: 1/R gated by likelihood."""
    w_rows = noise_tables.measurement_weights(
        trial.meas.shape[-1], kinetic_dataset)          # (W, 24)
    return np.einsum("wl,nclw->nclw", w_rows,
                     (trial.likelihood > dlc_thresh).astype(float))
