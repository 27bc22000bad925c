"""Bench problem building and scoring.

Port of the stage-1 parts of
``cheetah_pose_estimation_tpu/pipeline/bench_lib.py``: batched monocular
default-mode problems over procedural gallops (the fallback of
``load_reference_trajectories`` when the reference test set is absent),
and the per-trial quality metrics. Problem building is host work in
numpy/float64; ``build_batch`` puts the stacked batch on ``device``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from cheetah_pose_estimation_tpu.models import noise as noise_tables
from cheetah_pose_estimation_tpu.models import params as P

from ..data import synthetic as syn
from ..models import skeleton as sk
from ..parallel import batch as pbatch
from ..solver import kinematic as kin
from ..utils.device import DeviceLike
from . import initialization as init


def load_reference_trajectories(max_trials: Optional[int] = None):
    """(q, subject_name, fps) tuples of the procedural gallops (the JAX
    package's fallback when the reference test set is absent)."""
    out = [(syn.gallop_trajectory(40 + 2 * i, seed=i), "acinoset", 120.0)
           for i in range(10)]
    return out[:max_trials] if max_trials else out


def empty_priors(N: int):
    gmmp = kin.GMMPrior(np.zeros((1, 22)), np.eye(22)[None], np.zeros((1,)))
    ar = kin.ARAnchor(np.zeros((N, 28)), np.zeros(28), np.zeros(N))
    return gmmp, ar


def build_monocular_problem(q_gt: np.ndarray, subject_name: str, fps: float,
                            cam_idx: Optional[int] = 2, seed: int = 0,
                            n_cams: int = 6, noise_px: float = 1.5
                            ) -> Tuple[kin.KinematicData, np.ndarray,
                                       syn.SyntheticTrial]:
    """One trial's monocular problem (numpy leaves), its q0 and the
    synthetic trial it was rendered from."""
    subject = P.get_subject(subject_name)
    markers = syn.fk_markers_np(q_gt, subject)
    scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=n_cams,
                             fps=fps, seed=seed)
    trial = syn.synthesize(q_gt, subject, scene, noise_px=noise_px,
                           outlier_frac=0.02, seed=seed,
                           subject_name=subject_name)
    w = syn.gated_weights(trial)
    q0 = init.initialize_trajectory(trial.meas, w, scene.K, scene.D,
                                    scene.R, scene.t, subject,
                                    fisheye=True, cam_idx=cam_idx)
    N = q_gt.shape[0]
    gmmp, ar = empty_priors(N)
    sl = slice(None) if cam_idx is None else slice(cam_idx, cam_idx + 1)
    data = kin.KinematicData(
        meas=trial.meas[:, sl], weight=w[:, sl],
        cam=kin.CameraSet(scene.K[sl], scene.D[sl], scene.R[sl],
                          scene.t[sl]),
        h=np.asarray(1.0 / fps),
        acc_weight=noise_tables.acc_model_weights(),
        frame_valid=np.ones(N), gmm=gmmp, ar=ar)
    return data, q0, trial


def build_batch(max_trials: Optional[int] = None,
                n_frames: Optional[int] = None,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None):
    """Batched monocular default problem over the test trials.

    Returns (batched_data, q0_batch, trials, subject) with the batch's
    tensors on ``device``."""
    subject = P.get_subject("acinoset")
    datas, q0s, trials = [], [], []
    for i, (q_gt, _, fps) in enumerate(load_reference_trajectories(
            max_trials)):
        d, q0, tr = build_monocular_problem(q_gt, "acinoset", fps, seed=i)
        datas.append(d)
        q0s.append(q0)
        trials.append(tr)
    batched, q0b = pbatch.pad_and_stack(datas, q0s, n_frames=n_frames,
                                        dtype=dtype, device=device)
    return batched, q0b, trials, subject


def score_per_trial(qs_batch: np.ndarray, trials, fpss, subject):
    """Per-trial (MPE mm, MPJPE mm, CoM-vel RMSE m/s) vs the synthetic
    ground truth; qs_batch is (B, Npad, 54)."""
    rows = []
    for i, tr in enumerate(trials):
        n = tr.q_gt.shape[0]
        q = torch.as_tensor(np.asarray(qs_batch[i, :n], np.float64))
        rec = sk.fk_markers(q, subject).numpy()
        err = rec - tr.markers_gt
        mpe = float(np.mean(np.linalg.norm(err, axis=2)) * 1e3)
        errr = (rec - rec.mean(axis=1, keepdims=True)) \
            - (tr.markers_gt - tr.markers_gt.mean(axis=1, keepdims=True))
        mpjpe = float(np.mean(np.linalg.norm(errr, axis=2)) * 1e3)
        cv_r = np.diff(sk.com_position(q, subject).numpy(), axis=0) * fpss[i]
        cv_g = np.diff(sk.com_position(torch.as_tensor(tr.q_gt), subject)
                       .numpy(), axis=0) * fpss[i]
        cvr = float(np.sqrt(np.mean(np.sum((cv_r - cv_g) ** 2, axis=1))))
        rows.append((mpe, mpjpe, cvr))
    return rows
