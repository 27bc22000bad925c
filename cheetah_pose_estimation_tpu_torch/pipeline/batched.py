"""The batched data-driven and physics-based stages.

Port of the data-driven branch of
``cheetah_pose_estimation_tpu/pipeline/batched.run_monocular_batched``
(``batched.py:210-430``), in the form bench.py composes it as stage 1.5
(``dd_host``, ``dd_depth``, ``dd_pipeline``, ``bench.py:305-397``); the two
agree. :func:`run_data_driven` runs that stage, :func:`run_physics` bench.py's
stage 2 (``bench.py:440-487``), each on the device of the tensors it is
given. The serial estimator, the ground-plane polish, the rolling AR
refinement and the dataset drivers (``run_physics_batched`` reads trial
directories) are not ported yet.
"""
from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import skeleton as sk
from ..models.params import SubjectParams
from ..priors import armodel
from ..solver import kinematic as kin
from ..solver import kinetic as kn
from . import bench_lib
from . import depth_anchor as danchor
from .estimator import DD_BASE_ANCHOR, prior_gate_accept

SOLVE_STAGES: Tuple[Tuple[float, int], ...] = ((10.0, 30), (3.0, 30),
                                               (1.0, 150))
SCAN_STAGES: Tuple[Tuple[float, int], ...] = ((1.0, 60),)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def _anchors(mm: armodel.MotionModel, qs: np.ndarray, fv: np.ndarray):
    """AR anchor predictions (B, N, 28) and valid masks (B, N) from the
    trajectories qs (B, N, 54), with the AR buffer and padded frames off,
    and the relative poses (B, N, 28) they were predicted from."""
    xs = sk.relative_pose(torch.as_tensor(qs)).numpy()
    out = [armodel.anchor_predictions(mm, x) for x in xs]
    return (np.stack([yp for yp, _ in out]),
            np.stack([vl for _, vl in out]) * fv, xs)


class _Phases:
    """Wall seconds per phase into ``out`` (a dict), each phase ending in a
    device sync; a no-op when ``out`` is None."""

    def __init__(self, out: Optional[dict], device: torch.device):
        self.out, self.device = out, device
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now


def run_data_driven(q_free: torch.Tensor, batched: kin.KinematicData,
                    gmm_prior: kin.GMMPrior, motion_model: armodel.MotionModel,
                    subject: SubjectParams,
                    stages: Tuple[Tuple[float, int], ...] = SOLVE_STAGES,
                    scan_stages: Tuple[Tuple[float, int], ...] = SCAN_STAGES,
                    timings: Optional[dict] = None):
    """Data-driven monocular reconstruction of a batch, warm-started from
    the prior-free (stage-1) solutions ``q_free`` (B, N, 54).

    ``batched`` is the stage-1 problem (one fisheye camera per trial, real
    frames marked by ``frame_valid``), ``gmm_prior`` the solver prior with a
    leading trial axis, ``motion_model`` the AR model. The GMM chain, the dd
    solve and the re-polish run ``stages``, the line-scan ``scan_stages``
    (the production schedules by default). In order:

    1. pin the base to the prior-free solve (``base_ref``);
    2. the GMM chain solve (pose prior + base anchor);
    3. the prior-free costs of both; a non-finite chain cost where the free
       one is finite raises (the prior machinery is broken, not the data);
    4. the per-trial prior gate, and the gated bootstrap;
    5. AR anchors from the bootstrap with adaptive weights (non-finite ones
       raise); gate-rejected trials get no AR frames and no pose prior in
       the dd solve;
    6. the dd solve (pose prior + AR anchor + base anchor);
    7. camera rays and body-scale medians, then the depth line-scan;
    8. trials the scan moved are shifted along their rays and re-polished
       by the dd solver, with the base pinned to the shifted base and AR
       anchors recomputed at the new depth (on every frame of those
       trials);
    9. gate-rejected trials the scan left unmoved ship ``q_free``.

    With a ``timings`` dict, the wall seconds of each phase (chain, gate,
    anchors, dd, depth_host, scan, repolish) are added to it, each phase
    ending in a device sync.

    Returns (q (B, N, 54) tensor, prior_ok (B,) bool numpy, shifts (B,)
    numpy metres)."""
    B = q_free.shape[0]
    dev, dtype = q_free.device, q_free.dtype
    phase = _Phases(timings, dev)
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    cfg = dict(fisheye=True, robust=True)
    free = kin.KinematicFTE(kin.KinematicConfig(**cfg), subject)
    chain = kin.KinematicFTE(kin.KinematicConfig(
        use_gmm=True, **cfg, **DD_BASE_ANCHOR), subject).make_solver(
            stages=stages)
    dd = kin.KinematicFTE(kin.KinematicConfig(
        use_gmm=True, use_ar=True, **cfg, **DD_BASE_ANCHOR),
        subject).make_solver(stages=stages)
    scan = danchor.make_depth_linescan(subject, stages=scan_stages)

    # 1-3: base pin, GMM chain, prior-free costs
    bat0 = batched._replace(gmm=gmm_prior, base_ref=q_free[:, :, :6])
    st_chain = chain(q_free, bat0)
    phase("chain")
    c_free = _np(free._cost(q_free, bat0, 1.0))
    c_chain = _np(free._cost(st_chain.q, bat0, 1.0))
    broken = ~np.isfinite(c_chain) & np.isfinite(c_free)
    if broken.any():
        raise RuntimeError("data-driven prior chain produced non-finite "
                           f"costs on trials {np.flatnonzero(broken).tolist()}"
                           " whose prior-free solves are finite")
    # 4: gate and gated bootstrap
    prior_ok = prior_gate_accept(c_chain, c_free)
    ok = torch.as_tensor(prior_ok, device=dev)[:, None, None]
    qb = torch.where(ok, st_chain.q, q_free)
    phase("gate")
    # 5: AR anchors from the bootstrap
    qb_np = _np(qb)
    fv = _np(batched.frame_valid)
    yp, vl, xs = _anchors(motion_model, qb_np, fv)
    ws = np.stack([armodel.adaptive_motion_weights(motion_model, yp[i], xs[i],
                                                   vl[i]) for i in range(B)])
    if not (np.isfinite(yp).all() and np.isfinite(ws).all()):
        raise RuntimeError("AR anchor predictions/weights are non-finite: "
                           "the motion-model inputs are corrupt")
    bat = bat0._replace(
        ar=kin.ARAnchor(tens(yp), tens(ws),
                        tens(vl * prior_ok[:, None].astype(np.float64))),
        gmm_scale=tens(prior_ok.astype(np.float64)))
    phase("anchors")
    # 6: the dd solve
    st_dd = dd(qb, bat)
    phase("dd")
    # 7: rays, body-scale medians, line-scan
    qs_np = _np(st_dd.q)
    n_real = fv.sum(1).astype(int)
    cam = kin.map_data(_np, bat.cam)
    meas, weight = _np(bat.meas), _np(bat.weight)
    rays = np.zeros(qs_np.shape[:2] + (3,))
    veto = np.zeros(B)
    for i in range(B):
        n = n_real[i]
        rays[i] = danchor.camera_ray(qs_np[i], cam.R[i, 0], cam.t[i, 0])
        veto[i] = danchor.scale_median(
            qs_np[i, :n], subject, meas[i, :n, 0], weight[i, :n, 0],
            cam.K[i, 0], cam.D[i, 0], cam.R[i, 0], cam.t[i, 0])
    phase("depth_host")
    _, shifts = scan(st_dd.q, bat, rays, veto)
    phase("scan")
    q_dd = st_dd.q
    moved = shifts != 0.0
    if moved.any():
        # 8: re-polish the moved trials at the shifted depth
        qs_shift = qs_np.copy()
        qs_shift[:, :, :3] += shifts[:, None, None] * rays
        yp2, vl2, _ = _anchors(motion_model, qs_shift, fv)
        bat2 = bat._replace(base_ref=tens(qs_shift[:, :, :6]),
                            ar=bat.ar._replace(y_pred=tens(yp2),
                                               valid=tens(vl2)))
        st2 = dd(tens(qs_shift), bat2)
        q_dd = torch.where(torch.as_tensor(moved, device=dev)[:, None, None],
                           st2.q, q_dd)
        phase("repolish")
    # 9: prior-free trials with no depth evidence ship stage 1's solution
    rej_unmoved = ~prior_ok & ~moved
    if rej_unmoved.any():
        q_dd = torch.where(
            torch.as_tensor(rej_unmoved, device=dev)[:, None, None],
            q_free, q_dd)
    return q_dd, prior_ok, shifts


def run_physics(q_warm: torch.Tensor, datas, fpss, subject: SubjectParams,
                gmm_prior: Optional[kin.GMMPrior],
                ground_heights=None,
                stages: Tuple[Tuple[float, int], ...] = kn.STAGES,
                timings: Optional[dict] = None):
    """Physics-based reconstruction of a batch (bench.py's stage 2),
    warm-started from kinematic solutions ``q_warm`` (B, N, 54), e.g. the
    data-driven stage's.

    ``datas`` are the per-trial monocular problems (numpy leaves, the
    trial's real frames), ``fpss`` their frame rates, ``gmm_prior`` the
    pose prior (numpy leaves, no trial axis) of
    ``KineticConfig(use_gmm=True)``, ``ground_heights`` the per-trial ground
    plane elevations. In order:

    1. host prep (``bench_lib.build_physics_batch``): each trial's warm
       start cut to its real frames, foot kinematics and centre of mass in
       one padded float64 call, contact detection, stance pruning, the
       stacked batch on q_warm's device and dtype;
    2. the frozen EOM curvature blocks at the warm start;
    3. the annealed LM solve of ``KineticFTE.make_solver`` over every lane
       at once (bench.py runs it in waves of 5 lanes; the lanes are
       independent, so one wave gives the same per-lane result).

    With a ``timings`` dict, the wall seconds of the three phases
    (host_prep, curvature, lm) are added to it, each ending in a device
    sync. Returns (LMState, the batched KineticData)."""
    phase = _Phases(timings, q_warm.device)
    qs = [_np(q_warm[i, : np.asarray(d.meas).shape[0]])
          for i, d in enumerate(datas)]
    kbat, qw = bench_lib.build_physics_batch(
        datas, qs, fpss, subject, gmm_prior=gmm_prior,
        n_frames=q_warm.shape[1], dtype=q_warm.dtype,
        ground_heights=ground_heights, device=q_warm.device)
    phase("host_prep")
    fte = kn.KineticFTE(kn.KineticConfig(use_gmm=True), subject)
    blocks = fte.eom_curvature_blocks(qw, kbat)
    phase("curvature")
    st = fte.make_solver(stages=stages)(qw, kbat, eom_blocks=blocks)
    phase("lm")
    return st, kbat
