"""Synthetic trial generation (procedural gallops, camera rings, DLC-like
detections with correlated failures, AcinoSet-style trial directories).

Port of ``cheetah_pose_estimation_tpu/data/synthetic.py``, as numpy on top
of the port's forward kinematics and camera model (float64 on the CPU).
The random draws follow the JAX package's exactly, in order and count, so
the same seed gives the same trial.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import noise as noise_tables
from ..models import skeleton as sk
from ..models.params import SubjectParams
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


# marker groups that occlude together (a whole limb, the head, the tail), as
# indices into skeleton.MARKERS
_OCCLUSION_GROUPS = [[0, 1, 2], [3, 4, 5], [6, 7],
                     [8, 9, 10, 11], [12, 13, 14, 15],
                     [16, 17, 18, 19], [20, 21, 22, 23]]
# the two front / two back limb chains, for whole-limb confusion bursts
_LIMB_SWAPS = [(np.array([8, 9, 10, 11]), np.array([12, 13, 14, 15])),
               (np.array([16, 17, 18, 19]), np.array([20, 21, 22, 23]))]


def corrupt_dlc(meas: np.ndarray, likelihood: np.ndarray,
                rng: np.random.Generator,
                occlusion_rate: float = 0.0, occlusion_len: float = 8.0,
                confusion_rate: float = 0.0, confusion_len: float = 6.0,
                freeze_prob: float = 0.35, dlc_thresh: float = 0.5,
                lik_noise_px: float = 12.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """DLC-style correlated failure modes, on copies of ``meas``
    (N, C, L, 2) and ``likelihood`` (N, C, L); rates are events per camera
    per 100 frames:

    * occlusion bursts: a marker group disappears (likelihood below the
      threshold) for a window in one camera, or with probability
      ``freeze_prob`` stays at its entry position with confident
      likelihood;
    * limb left/right confusion: a front or back limb pair swaps detections
      for a window, at full confidence;
    * likelihood-correlated noise: below-threshold detections get extra
      noise of ``lik_noise_px * (thresh - lik)``.

    Every decision comes from ``rng`` and the likelihoods, never from pixel
    values, so renderings that differ by rounding take the same decisions."""
    meas = meas.copy()
    likelihood = likelihood.copy()
    N, C, L = likelihood.shape

    def windows(rate, mean_len):
        n_ev = rng.poisson(rate * N / 100.0)
        out = []
        for _ in range(n_ev):
            s = int(rng.integers(0, max(N - 2, 1)))
            ln = max(2, int(rng.exponential(mean_len)))
            out.append((s, min(s + ln, N)))
        return out

    for c in range(C):
        for (s, e) in windows(occlusion_rate, occlusion_len):
            grp = _OCCLUSION_GROUPS[int(rng.integers(len(_OCCLUSION_GROUPS)))]
            if rng.uniform() < freeze_prob:
                meas[s:e, c, grp] = meas[s, c, grp][None]
                likelihood[s:e, c, grp] = rng.uniform(
                    0.85, 1.0, size=(e - s, len(grp)))
            else:
                likelihood[s:e, c, grp] = rng.uniform(
                    0.0, dlc_thresh, size=(e - s, len(grp)))
        for (s, e) in windows(confusion_rate, confusion_len):
            a, b = _LIMB_SWAPS[int(rng.integers(len(_LIMB_SWAPS)))]
            tmp = meas[s:e, c, a].copy()
            meas[s:e, c, a] = meas[s:e, c, b]
            meas[s:e, c, b] = tmp
            likelihood[s:e, c, a] = rng.uniform(0.8, 1.0,
                                                size=(e - s, len(a)))
            likelihood[s:e, c, b] = rng.uniform(0.8, 1.0,
                                                size=(e - s, len(b)))

    low = likelihood < dlc_thresh
    extra = lik_noise_px * (dlc_thresh - likelihood[low])
    meas[low] += rng.normal(size=(low.sum(), 2)) * extra[:, None]
    return meas, likelihood


def synthesize(q_gt: np.ndarray, subject: SubjectParams,
               scene: Optional[SyntheticScene] = None,
               noise_px: float = 1.5, outlier_frac: float = 0.02,
               outlier_px: float = 60.0, drop_frac: float = 0.05,
               dlc_thresh: float = 0.5, seed: int = 0,
               subject_name: str = "acinoset",
               occlusion_rate: float = 0.0, confusion_rate: float = 0.0
               ) -> SyntheticTrial:
    """Render noisy DLC-like detections of a q trajectory; with
    ``occlusion_rate`` or ``confusion_rate`` > 0 also the correlated failure
    model (:func:`corrupt_dlc`)."""
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
    if occlusion_rate > 0 or confusion_rate > 0:
        meas, likelihood = corrupt_dlc(
            meas, likelihood, rng, occlusion_rate=occlusion_rate,
            confusion_rate=confusion_rate, dlc_thresh=dlc_thresh)
    return SyntheticTrial(q_gt=q_gt, markers_gt=markers,
                          meas=meas[..., None],
                          likelihood=likelihood[..., None],
                          scene=scene, subject_name=subject_name)


def write_trial_dir(trial: SyntheticTrial, root_dir: str, data_path: str,
                    monocular_cam: int = 0, write_ppm: bool = False,
                    ground_plane_height: float = 0.0) -> str:
    """Materialize a synthetic trial as an AcinoSet-style directory tree:
    dlc/cam*.csv, extrinsic_calib/N_cam_scene_sba.json, metadata.json, and
    with ``write_ppm`` the pairwise pseudo-measurements of each camera
    (``ppm.synthesize_ppm`` with the camera's index as seed) as
    dlc_pw/cam*.pickle."""
    from . import io as dio

    data_dir = os.path.join(root_dir, data_path)
    os.makedirs(data_dir, exist_ok=True)
    N, C = trial.meas.shape[:2]
    for c in range(C):
        dio.save_dlc_table(
            os.path.join(data_dir, "dlc", f"cam{c + 1}.csv"),
            trial.meas[:, c, :, :, 0], trial.likelihood[:, c, :, 0])
    if write_ppm:
        from . import ppm as ppm_mod
        for c in range(C):
            pose, lik, pws = ppm_mod.synthesize_ppm(
                trial.meas[:, c, :, :, 0], trial.likelihood[:, c, :, 0],
                seed=c)
            ppm_mod.save_ppm_pickle(
                os.path.join(data_dir, "dlc_pw", f"cam{c + 1}.pickle"),
                pose, lik, pws)
    dio.save_scene(
        os.path.join(data_dir, "extrinsic_calib",
                     f"{C}_cam_scene_sba.json"),
        trial.scene.K, trial.scene.D, trial.scene.R, trial.scene.t,
        trial.scene.cam_res)
    dio.save_metadata(data_dir, start_frame=0, end_frame=N,
                      monocular_cam=monocular_cam,
                      ground_plane_height=ground_plane_height)
    return data_dir


def gated_weights(trial: SyntheticTrial, dlc_thresh: float = 0.5,
                  kinetic_dataset: bool = False) -> np.ndarray:
    """(N, C, 24, W) measurement weights: 1/R gated by likelihood."""
    w_rows = noise_tables.measurement_weights(
        trial.meas.shape[-1], kinetic_dataset)          # (W, 24)
    return np.einsum("wl,nclw->nclw", w_rows,
                     (trial.likelihood > dlc_thresh).astype(float))
