"""Bench problem building and scoring.

Port of ``cheetah_pose_estimation_tpu/pipeline/bench_lib.py``: batched
monocular default-mode problems over procedural gallops (the fallback of
``load_reference_trajectories`` when the reference test set is absent),
the physics stage's problems (``build_physics_batch``), the per-trial
quality metrics, the trials' names (``reference_trial_paths``) and the
bench's ground-plane depth anchor (``make_anchor_polish``). Problem
building is host work in numpy/float64; ``build_batch`` and
``build_physics_batch`` put the stacked batch on ``device``.

The data-driven stage's priors are trained on the AcinoSet pose dataset in
production; while it is absent from the repository they are trained on a
procedural pose table (:func:`procedural_pose_table`) from the bench's
gallop generator, on seeds disjoint from the bench trials'. Numbers from
priors trained on it say nothing about AcinoSet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import synthetic as syn
from ..models import noise as noise_tables
from ..models import params as P
from ..models import skeleton as sk
from ..parallel import batch as pbatch
from ..priors import armodel, gmm
from ..priors.dataset import PoseTable
from ..solver import kinematic as kin
from ..utils.device import DeviceLike
from . import initialization as init

# seeds of the procedural prior-training and validation tables (the bench
# trials use seeds 0-9)
TRAIN_SEEDS = tuple(range(100, 140))
VAL_SEEDS = tuple(range(200, 210))


def load_reference_trajectories(max_trials: Optional[int] = None):
    """(q, subject_name, fps) tuples of the procedural gallops (the JAX
    package's fallback when the reference test set is absent)."""
    out = [(syn.gallop_trajectory(40 + 2 * i, seed=i), "acinoset", 120.0)
           for i in range(10)]
    return out[:max_trials] if max_trials else out


def reference_trial_paths(max_trials: Optional[int] = None):
    """Trial names in the order of :func:`load_reference_trajectories`
    (JAX ``bench_lib.py:76-93``): without the reference test set, which
    the port does not read, ``synthetic_gallop_{i}``."""
    out = [f"synthetic_gallop_{i}" for i in range(10)]
    return out[:max_trials] if max_trials else out


def make_anchor_polish(subject, dtype: torch.dtype = torch.float32,
                       device: DeviceLike = None):
    """The monocular ground-plane depth anchor on bench problems (JAX
    ``bench_lib.py:122-165``): per trial the analytic ray shift from its
    camera (no shift: no polish), one batched anchored polish under
    ``depth_anchor.POLISH_CFG`` and ``POLISH_STAGES`` from the shifted
    trajectories, and per trial the polish kept where its prior-free
    objective is finite and at most 5 % above the input's
    (``batched._ray_polish``, shared with the dataset CLI's polish).

    Returns run(qs, batched, trials, fpss, gphs, report=None) -> (B, Npad,
    54) tensor of ``dtype`` on ``device`` (the card by default); with
    ``report``, the per-trial shift and acceptance are recorded in it."""
    from ..utils.device import resolve_device
    from . import batched as batched_mod
    from . import depth_anchor as danchor

    dev = resolve_device(device)
    cfg = kin.KinematicConfig(fisheye=True, robust=True)
    stages = danchor.POLISH_STAGES

    def run(qs_in, batched, trials, fpss, gphs, report=None):
        qs_np = np.asarray(torch.as_tensor(qs_in).detach().cpu(), np.float64)
        cam = batched.cam
        host = lambda x: x.detach().double().cpu().numpy()
        rays = [(tr.q_gt.shape[0], fpss[i], float(gphs[i]),
                 host(cam.R[i, 0]), host(cam.t[i, 0]))
                for i, tr in enumerate(trials)]
        out, shifts, accept = batched_mod._ray_polish(
            qs_np, batched, subject, cfg, rays, stages)
        if report is not None:
            report.update(shifts=shifts.tolist(), accept=accept.tolist())
        return torch.as_tensor(out, dtype=dtype, device=dev)

    return run


def empty_priors(N: int):
    gmmp = kin.GMMPrior(np.zeros((1, 22)), np.eye(22)[None], np.zeros((1,)))
    ar = kin.ARAnchor(np.zeros((N, 28)), np.zeros(28), np.zeros(N))
    return gmmp, ar


def build_monocular_problem(q_gt: np.ndarray, subject_name: str, fps: float,
                            cam_idx: Optional[int] = 2, seed: int = 0,
                            n_cams: int = 6, noise_px: float = 1.5,
                            occlusion_rate: float = 0.0,
                            confusion_rate: float = 0.0
                            ) -> Tuple[kin.KinematicData, np.ndarray,
                                       syn.SyntheticTrial]:
    """One trial's monocular problem (numpy leaves), its q0 and the
    synthetic trial it was rendered from; ``occlusion_rate`` and
    ``confusion_rate`` set the correlated DLC failures
    (``synthetic.corrupt_dlc``)."""
    subject = P.get_subject(subject_name)
    markers = syn.fk_markers_np(q_gt, subject)
    scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=n_cams,
                             fps=fps, seed=seed)
    trial = syn.synthesize(q_gt, subject, scene, noise_px=noise_px,
                           outlier_frac=0.02, seed=seed,
                           subject_name=subject_name,
                           occlusion_rate=occlusion_rate,
                           confusion_rate=confusion_rate)
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


def build_problems(max_trials: Optional[int] = None):
    """The test trials' monocular default problems, one per trial: (datas
    (numpy leaves), q0s, trials, subject). The physics stage's host prep
    takes the datas."""
    subject = P.get_subject("acinoset")
    datas, q0s, trials = [], [], []
    for i, (q_gt, _, fps) in enumerate(load_reference_trajectories(
            max_trials)):
        d, q0, tr = build_monocular_problem(q_gt, "acinoset", fps, seed=i)
        datas.append(d)
        q0s.append(q0)
        trials.append(tr)
    return datas, q0s, trials, subject


def build_batch(max_trials: Optional[int] = None,
                n_frames: Optional[int] = None,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None):
    """Batched monocular default problem over the test trials.

    Returns (batched_data, q0_batch, trials, subject) with the batch's
    tensors on ``device``."""
    datas, q0s, trials, subject = build_problems(max_trials)
    batched, q0b = pbatch.pad_and_stack(datas, q0s, n_frames=n_frames,
                                        dtype=dtype, device=device)
    return batched, q0b, trials, subject


def build_physics_batch(datas: Sequence[kin.KinematicData],
                        qs_default: Sequence[np.ndarray],
                        fpss: Sequence[float], subject,
                        gmm_prior: Optional[kin.GMMPrior] = None,
                        n_frames: Optional[int] = None,
                        dtype: torch.dtype = torch.float32,
                        ground_heights: Optional[Sequence[float]] = None,
                        device: DeviceLike = None,
                        stances: Optional[Sequence[np.ndarray]] = None):
    """Batched physics-based problems warm-started from solved kinematic
    trajectories ``qs_default`` (one (n_i, 54) array per trial): foot
    kinematics and centre of mass of every trial in one padded float64 call
    on the host, contact detection and stance pruning per trial, then one
    stacked ``KineticData`` on ``device`` (torque/GRF estimation mode).

    ``gmm_prior`` (numpy leaves, no trial axis) replaces each problem's pose
    prior; ``ground_heights`` are the per-trial ground plane elevations (0
    by default); ``stances``, per-trial (n_i, 4) stance matrices, replace
    the detection and pruning here. Returns (batched KineticData, q_warm
    (B, N, 54))."""
    from ..solver import kinetic as kn
    from . import contacts as contacts_mod

    B = len(qs_default)
    qs = [np.asarray(q, np.float64) for q in qs_default]
    Nmax = max(q.shape[0] for q in qs)
    qp = np.zeros((B, Nmax, qs[0].shape[1]))
    dqp = np.zeros_like(qp)
    for i, (q, fps) in enumerate(zip(qs, fpss)):
        qp[i, : q.shape[0]] = q
        dqp[i, 1: q.shape[0]] = (q[1:] - q[:-1]) * fps
    h_all, v_all = contacts_mod.foot_kinematics(qp, dqp, subject)
    com_all = sk.com_position(torch.as_tensor(qp), subject).numpy()
    kds = []
    for i, (d, q, fps) in enumerate(zip(datas, qs, fpss)):
        N = q.shape[0]
        h = 1.0 / fps
        gph = 0.0 if ground_heights is None else float(ground_heights[i])
        dq = np.zeros_like(q)
        dq[1:] = (q[1:] - q[:-1]) / h
        com_vel = (com_all[i, 1:N] - com_all[i, :N - 1]) * fps
        speed = float(np.mean(np.linalg.norm(com_vel, axis=1)))
        if stances is not None:
            stance = np.asarray(stances[i], np.float64)
        else:
            contacts, _ = contacts_mod.contact_detection(
                q, dq, subject, 0, speed, fps, ground_plane_height=gph,
                foot_kin=(h_all[i, :N], v_all[i, :N]))
            stance = kn.prune_stance(
                kn.stance_matrix(contacts, 0, N), q, subject, h,
                foot_speed=np.linalg.norm(v_all[i, :N, :, :2], axis=-1))
        kds.append(kn.KineticData(
            base=d if gmm_prior is None else d._replace(gmm=gmm_prior),
            stance=stance, grf_fixed=np.zeros((N, 4)),
            grf_xy_fixed=np.zeros((N, 4, 4)), use_fixed_grf=np.asarray(0.0),
            q_warm=q, tau_anchor=np.zeros((1, kn.dyn.N_TAU)),
            tau_anchor_weight=np.asarray(0.0), ground_z=np.asarray(gph)))
    return pbatch.pad_and_stack_kinetic(kds, qs, n_frames=n_frames,
                                        dtype=dtype, device=device)


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


def procedural_pose_table(seeds: Sequence[int], n_frames: int = 240
                          ) -> PoseTable:
    """Pose table of one segment per seed: the rows of ``relative_pose(q)``
    for q = ``gallop_trajectory(n_frames, seed=s)`` plus a constant offset
    on the angle columns 3:54, drawn as
    ``default_rng(10_000 + s).normal(scale=0.05, size=51)``. Without the
    offset every seed traces one gait curve plus 0.005 rad of noise, and the
    GMM over its relative angles is either inert or extremely stiff."""
    rows = []
    for s in seeds:
        q = syn.gallop_trajectory(n_frames, seed=s)
        q[:, 3:54] += np.random.default_rng(10_000 + s).normal(scale=0.05,
                                                               size=51)
        rows.append(sk.relative_pose(torch.as_tensor(q)).numpy())
    return PoseTable(index=np.tile(np.arange(n_frames), len(seeds)),
                     data=np.concatenate(rows))


class Priors(NamedTuple):
    gmm_params: gmm.GMMParams
    gmm_prior: kin.GMMPrior       # numpy leaves, no trial axis
    motion_model: armodel.MotionModel


def train_priors(train: PoseTable, val: PoseTable,
                 device: DeviceLike = None) -> Priors:
    """The bench's data-driven priors: a 5-component GMM over the 22
    relative joint angles (seed 42, 200 EM steps) and the lasso AR model
    over the 28-dim relative pose with window 4 (alpha 1e-2), trained in
    float64 on ``device``."""
    params = gmm.fit(train.data[:, 6:28], n_components=5, seed=42,
                     device=device)
    mm = armodel.train_motion_model(train, window_size=4, lasso=True,
                                    validation=val, device=device)
    return Priors(params, gmm.to_solver_prior(params), mm)
