"""Monocular depth correction: the ground-plane ray shift, the body-scale
channel and the depth line-scan.

Port of ``cheetah_pose_estimation_tpu/pipeline/depth_anchor.py``. The
reprojection cost is nearly flat along the viewing ray, so a monocular
solve keeps the depth error of its initialisation. Two corrections:

* the default mode's ground-plane correction (:func:`ray_depth_correction`):
  detect stance windows on the solved trajectory, take each window's
  lowest paw height above the calibrated plane, turn those gaps into depth
  shifts along the camera ray (a stance foot hovering ``gap`` above the
  plane betrays ``gap / -ray_z`` metres of depth error) and shift the base
  by their robust minimum; the caller then polishes with the anchored
  kinematic terms ``POLISH_CFG``;
* the data-driven mode's line-scan (:func:`make_depth_linescan`): re-solve
  the trajectory at candidate depth offsets and keep a clear winner,
  constrained by the body-scale channel.

The ray, stance and scale helpers are host numpy in float64; the scan runs
on the device of the tensors it is given.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models import skeleton as sk
from ..models.params import SubjectParams
from ..ops import camera as cam_ops

_PAW_IDX = np.array([sk.MARKERS.index(m) for m in
                     ("l_front_paw", "r_front_paw",
                      "l_back_paw", "r_back_paw")])

# anchored-polish weights (solver.kinematic.KinematicConfig): the stance-z
# pull is softer than the measurement term so a bad stance window cannot
# drag a good reconstruction; the hinge only guards against penetration;
# no-slip pins global translation during stance
POLISH_CFG = dict(ground_weight=2e3, penetration_weight=1e4,
                  noslip_weight=3e3)
POLISH_STAGES = ((1.0, 30),)


def detect_stance(q: np.ndarray, subject: SubjectParams, fps: float,
                  ground_z: float = 0.0) -> np.ndarray:
    """(N, 4) stance indicator from a solved trajectory: contact detection
    gated per foot against its own lowest height (so a global depth error
    does not blind it), then stance pruning; zeros when detection fails."""
    from ..solver import kinetic as kn
    from . import contacts as cmod

    q = np.asarray(q, np.float64)
    N = q.shape[0]
    dq = np.zeros_like(q)
    dq[1:] = (q[1:] - q[:-1]) * fps
    com = sk.com_position(torch.as_tensor(q), subject).numpy()
    com_v = np.diff(com, axis=0) * fps
    speed = (float(np.mean(np.linalg.norm(com_v, axis=1)))
             if N > 1 else 0.0)
    try:
        contacts, _ = cmod.contact_detection(
            q, dq, subject, 0, speed, fps, ground_plane_height=ground_z,
            per_foot_relative=True)
    except (ValueError, IndexError):
        return np.zeros((N, 4))
    stance = kn.stance_matrix(contacts, 0, N)
    return kn.prune_stance(stance, q, subject, 1.0 / fps)


def paw_heights(q: np.ndarray, subject: SubjectParams) -> np.ndarray:
    """(N, 4) paw-marker z along a trajectory (float64)."""
    return sk.fk_markers(torch.as_tensor(np.asarray(q, np.float64)),
                         subject).numpy()[:, _PAW_IDX, 2]


def touchdown_samples(q: np.ndarray, subject: SubjectParams,
                      stance: np.ndarray, ground_z: float
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per stance window of each foot: (frame of its lowest paw height,
    that height above the plane, the window's length as weight). A stance
    foot hovers early and late in its window but at its lowest it is flat
    on the ground, so each window gives one nearly unbiased plane sample."""
    paws = paw_heights(q, subject)
    w = np.asarray(stance, np.float64)
    ts, gaps, ws = [], [], []
    for f in range(4):
        on = w[:, f] > 0
        if not on.any():
            continue
        idx = np.flatnonzero(on)
        splits = np.flatnonzero(np.diff(idx) > 1)
        for run in np.split(idx, splits + 1):
            rel = paws[run, f] - ground_z
            k = int(np.argmin(rel))
            ts.append(float(run[k]))
            gaps.append(float(rel[k]))
            ws.append(float(len(run)))
    return np.asarray(ts), np.asarray(gaps), np.asarray(ws)


def fit_shift(ts: np.ndarray, gaps: np.ndarray, ws: np.ndarray,
              ray_z: np.ndarray, min_ray_z: float = 0.02,
              max_shift_m: float = 1.5,
              deep_pen_m: float = 0.05,
              min_shift_m: float = 0.35) -> np.ndarray:
    """Constant per-trial shift along the ray (metres, + away from the
    camera) implied by the touchdown gaps, s_i = gap_i / (-ray_z_i), as an
    (N,) array.

    Hovering feet bias the positive samples up, so the lowest positive
    sample is taken ("at least one stance foot touches the ground"; a
    lowest sample more than 0.5 m below the second lowest is an artifact
    and the second lowest is used). Negative samples (feet below the plane)
    are pose noise, amplified by the ray lever, and are dropped unless every
    gap is deeper than ``deep_pen_m``; then the most negative sample (with
    the same guard) is taken. Samples whose ray is too vertical
    (``|ray_z| <= min_ray_z``) carry no lever. Zero without two samples, or
    when the shift is below the channel's noise floor ``min_shift_m``;
    clipped to ``max_shift_m``."""
    N = ray_z.shape[0]
    lever = -np.asarray(ray_z, np.float64)
    ti = np.clip(np.asarray(ts, int), 0, N - 1)
    ok = (np.asarray(ws) > 0) & (np.abs(lever[ti]) > min_ray_z)
    if ok.sum() < 2:
        return np.zeros(N)
    g_ok = gaps[ok]
    s_all = g_ok / lever[ti[ok]]
    pos = s_all[s_all >= 0.0]
    neg = s_all[s_all < 0.0]
    if pos.size:
        s = np.sort(pos)
        s_hat = s[1] if (s.size > 1 and s[0] < s[1] - 0.5) else s[0]
    elif neg.size and np.all(g_ok <= -deep_pen_m):
        s = np.sort(neg)
        s_hat = s[1] if (s.size > 1 and s[0] < s[1] - 0.5) else s[0]
    else:
        return np.zeros(N)
    if abs(s_hat) < min_shift_m:
        return np.zeros(N)
    return np.full(N, np.clip(s_hat, -max_shift_m, max_shift_m))


def ray_depth_correction(q: np.ndarray, subject: SubjectParams, fps: float,
                         ground_z: float, R_cam: np.ndarray,
                         t_cam: np.ndarray,
                         stance: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Analytic monocular depth correction of a solved trajectory: returns
    (q corrected, stance (N, 4), shift (N,) metres). ``stance`` reuses an
    existing detection. A zero shift returns q unchanged."""
    q = np.asarray(q, np.float64)
    if stance is None:
        stance = detect_stance(q, subject, fps, ground_z)
    ts, gaps, ws = touchdown_samples(q, subject, stance, ground_z)
    ray = camera_ray(q, R_cam, t_cam)
    shift = fit_shift(ts, gaps, ws, ray[:, 2])
    q_out = q.copy()
    q_out[:, :3] = q[:, :3] + shift[:, None] * ray
    return q_out, stance, shift


def camera_ray(q: np.ndarray, R_cam: np.ndarray,
               t_cam: np.ndarray) -> np.ndarray:
    """(N, 3) unit rays from the camera centre through the per-frame base
    position (x_cam = R x + t, so the centre is c = -R^T t)."""
    t = np.asarray(t_cam, np.float64).reshape(3)
    c = -np.asarray(R_cam, np.float64).T @ t
    d = np.asarray(q, np.float64)[:, :3] - c[None]
    n = np.linalg.norm(d, axis=1, keepdims=True)
    return d / np.maximum(n, 1e-9)


MIN_MARKERS = 8       # detections a frame needs to carry a scale signal
MAX_SHIFT_M = 1.5     # clip of the body-scale shift


def scale_depth_shift(q: np.ndarray, subject: SubjectParams,
                      meas: np.ndarray, weight: np.ndarray,
                      K: np.ndarray, D_dist: np.ndarray,
                      R_cam: np.ndarray, t_cam: np.ndarray,
                      min_frames: int = 16,
                      max_spread_ratio: float = 0.6,
                      fisheye: bool = True) -> float:
    """Per-trial depth shift (metres along the viewing ray of a fisheye
    camera, or a pinhole one with ``fisheye=False``, + away from it)
    implied by apparent body scale: with fixed
    segment lengths the projected marker spread scales as 1/depth, so per
    frame shift = d_rec (size_rec / size_meas - 1), sizes being the weighted
    RMS spreads of the gated detections and of the reprojected markers. The
    frames' shifts are combined by a count-weighted median and clipped to
    +-1.5 m; frames with fewer than 8 detections are dropped, and the
    channel abstains (0.0) with fewer than ``min_frames`` frames or a
    spread (MAD) above ``max_spread_ratio`` x |median|."""
    q = np.asarray(q, np.float64)
    N = q.shape[0]
    pts = sk.fk_markers(torch.as_tensor(q), subject).reshape(-1, 3)
    proj = cam_ops.project_fisheye if fisheye else cam_ops.project_pinhole
    uv_rec = proj(
        pts, *[torch.as_tensor(np.asarray(a, np.float64))
               for a in (K, D_dist, R_cam, t_cam)]).numpy().reshape(N, -1, 2)
    meas = np.asarray(meas, np.float64)       # (N, L, 2, W) or (N, L, 2)
    w = np.asarray(weight, np.float64)        # (N, L, W) or (N, L)
    if meas.ndim == 4:                        # collapse the W axis: best det
        wbest = w.argmax(axis=-1)
        meas = np.take_along_axis(
            meas, wbest[:, :, None, None], axis=-1)[..., 0]
        w = np.max(w, axis=-1)
    t = np.asarray(t_cam, np.float64).reshape(3)
    c = -np.asarray(R_cam, np.float64).T @ t
    d_rec = np.linalg.norm(q[:, :3] - c[None], axis=1)         # (N,)
    shifts, wts = [], []
    for i in range(N):
        m = w[i] > 0
        if m.sum() < MIN_MARKERS:
            continue
        wm = w[i][m]
        mu_m = (wm[:, None] * meas[i][m]).sum(0) / wm.sum()
        mu_r = (wm[:, None] * uv_rec[i][m]).sum(0) / wm.sum()
        s_m = np.sqrt((wm[:, None] * (meas[i][m] - mu_m) ** 2).sum()
                      / wm.sum())
        s_r = np.sqrt((wm[:, None] * (uv_rec[i][m] - mu_r) ** 2).sum()
                      / wm.sum())
        if s_m < 1e-6 or s_r < 1e-6:
            continue
        shifts.append(d_rec[i] * (s_r / s_m - 1.0))
        wts.append(float(m.sum()))
    if len(shifts) < min_frames:
        return 0.0
    shifts = np.asarray(shifts)
    order = np.argsort(shifts)
    cw = np.cumsum(np.asarray(wts)[order])
    med = float(shifts[order[np.searchsorted(cw, 0.5 * cw[-1])]])
    mad = float(np.median(np.abs(shifts - med)))
    if mad > max_spread_ratio * max(abs(med), 1e-9):
        return 0.0
    return float(np.clip(med, -MAX_SHIFT_M, MAX_SHIFT_M))


# candidate depth offsets of the line-scan (metres along the rays), the
# relative cost win a candidate needs over the zero shift, and the
# body-scale median below which the scale constraint is off
SCAN_SHIFTS = (-0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1)
SCAN_MARGIN = 0.01
DEAD_ZONE_M = 0.05


def scale_median(q: np.ndarray, subject: SubjectParams,
                 meas: np.ndarray, weight: np.ndarray,
                 K: np.ndarray, D_dist: np.ndarray,
                 R_cam: np.ndarray, t_cam: np.ndarray,
                 fisheye: bool = True) -> float:
    """Raw signed body-scale median (metres along the ray): no spread gate,
    no noise floor, 8 frames suffice. The line-scan uses its sign (veto) and
    its magnitude (candidate bound)."""
    return scale_depth_shift(q, subject, meas, weight, K, D_dist, R_cam,
                             t_cam, max_spread_ratio=1e9, min_frames=8,
                             fisheye=fisheye)


def scale_shift_sign(q: np.ndarray, subject: SubjectParams,
                     meas: np.ndarray, weight: np.ndarray,
                     K: np.ndarray, D_dist: np.ndarray,
                     R_cam: np.ndarray, t_cam: np.ndarray,
                     fisheye: bool = True,
                     dead_zone_m: float = DEAD_ZONE_M) -> float:
    """The body-scale channel's direction vote (-1, 0 or +1): the sign of
    :func:`scale_median`, 0 inside +-``dead_zone_m``."""
    med = scale_median(q, subject, meas, weight, K, D_dist, R_cam, t_cam,
                       fisheye=fisheye)
    return 0.0 if abs(med) <= dead_zone_m else float(np.sign(med))


def make_depth_linescan(subject: SubjectParams,
                        stages: Tuple = ((1.0, 60),), *,
                        shifts: Tuple[float, ...] = SCAN_SHIFTS,
                        finish_stages: Optional[Tuple] = None,
                        margin: float = SCAN_MARGIN,
                        dtype: Optional[torch.dtype] = None):
    """Monocular depth line-scan: re-solve at candidate depths, keep the
    clear winner (JAX ``depth_anchor.py:333-446``).

    Every trial is shifted by each offset of ``shifts`` (one of them 0)
    along its per-frame camera rays and re-solved with the prior-free
    judge config (a fixed ``stages`` schedule); all len(shifts) x B lanes
    are one batch. Per trial the best candidate is accepted only if its
    cost beats the zero-shift lane's by more than ``margin`` (relative) and
    lies inside the grid (an edge pick is not bracketed); otherwise the
    input trajectory ships unchanged. An optional per-trial ``scale_med``
    (from :func:`scale_median`), where its |median| clears the scan's
    ``dead_zone_m``, restricts candidates to its sign and to 2 |median| +
    0.15 m. With ``finish_stages`` the winners are re-annealed by a second
    solver of that schedule over all B lanes, and only the accepted ones
    take its result. ``dtype``: the scan's (the input's when None).

    Returns ``scan(q_in, batched, rays, scale_med=None,
    dead_zone_m=DEAD_ZONE_M) -> (q_out (B,N,54) tensor, shift (B,)
    numpy)``. The keyword-only options keep ``__defaults__`` to
    ``stages`` alone."""
    from ..solver import kinematic as kin

    fte = kin.KinematicFTE(kin.KinematicConfig(fisheye=True, robust=True),
                           subject)
    # the JAX package's driver "fixed": the fixed-length loop for one
    # stage, the while loop for more
    run = fte.make_solver(stages=stages,
                          driver="scan" if len(stages) == 1 else "while")
    finish = None if finish_stages is None else \
        fte.make_solver(stages=finish_stages)
    offs = tuple(float(s) for s in shifts)
    ZI = offs.index(0.0)
    Kn = len(offs)

    def scan(q_in: torch.Tensor, batched, rays: np.ndarray, scale_med=None,
             dead_zone_m: float = DEAD_ZONE_M):
        if dtype is not None:
            q_in = q_in.to(dtype)
            batched = kin.map_data(
                lambda x: x.to(dtype) if torch.is_tensor(x)
                and x.is_floating_point() else x, batched)
        B = q_in.shape[0]
        raysb = torch.as_tensor(np.asarray(rays), dtype=q_in.dtype,
                                device=q_in.device)
        qks = torch.cat([torch.cat([q_in[..., :3] + s * raysb,
                                    q_in[..., 3:]], -1) for s in offs])
        rep = kin.map_data(lambda x: torch.cat([x] * Kn), batched)
        st = run(qks, rep)
        cost = st.cost.double().cpu().numpy().reshape(Kn, B)
        c = np.where(np.isfinite(cost), cost, np.inf)
        offv = np.asarray(offs)
        if scale_med is not None:
            med = np.asarray(scale_med, np.float64)
            act = np.abs(med) > dead_zone_m
            sign_ok = (offv[:, None] == 0.0) \
                | (np.sign(offv)[:, None] == np.sign(med)[None, :])
            mag_ok = np.abs(offv)[:, None] \
                <= 2.0 * np.abs(med)[None, :] + 0.15
            allowed = ~act[None, :] | (sign_ok & mag_ok)
            c = np.where(allowed, c, np.inf)
        best = np.argmin(c, axis=0)
        thr = c[ZI] - margin * np.abs(c[ZI])
        accept = c[best, np.arange(B)] < thr
        accept &= (best > 0) & (best < Kn - 1)
        shift_out = np.where(accept, offv[best], 0.0)
        if not accept.any():
            return q_in, shift_out
        qsol = st.q.reshape((Kn, B) + tuple(q_in.shape[1:]))
        qf = qsol[torch.as_tensor(best, device=q_in.device),
                  torch.arange(B, device=q_in.device)]
        if finish is not None:
            # every lane is re-annealed; the unaccepted keep their input
            qf = finish(qf, batched).q
        acc = torch.as_tensor(accept, device=q_in.device)[:, None, None]
        return torch.where(acc, qf, q_in), shift_out

    return scan
