"""Batched dataset execution: each mode's trials as one batched solve.

Port of ``cheetah_pose_estimation_tpu/pipeline/batched.py``. The dataset
CLI's batched path (:func:`run_monocular_batched`, with
:func:`run_physics_batched` for the physics-based mode) reads every trial
directory, pads and stacks the trials of one subject into one batch, solves
it on the device of the run (the card by default), and writes each trial's
``fte.pickle`` and ``cam<i>_fte.csv``. The modes: the multi-view
ground-truth solve, the monocular default mode with the ground-plane depth
correction and anchored polish (:func:`_anchor_polish`), the data-driven
mode (:func:`run_data_driven`, also bench.py's stage 1.5, ``bench.py:305-397``)
and the physics-based mode (:func:`run_physics`, also bench.py's stage 2,
``bench.py:440-487``). With several devices (``mesh``, JAX ``batched.py:
92-112``) a group is padded by cyclic repetition to a multiple of the mesh
(:func:`_pad_group`) and each of its solves runs over the trial mesh
(``parallel/batch.on_mesh``: contiguous chunks of lanes, one per device,
one host thread each); the host work between the solves sees the whole
group, and only the real trials are written. With one card ``mesh="auto"``
is None (:func:`_resolve_mesh`), and the group is solved as one batch.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import convert
from ..models import noise as noise_tables
from ..models import params as params_mod
from ..models import skeleton as sk
from ..models.params import SubjectParams
from ..ops import cuda_banded
from ..parallel import batch as pbatch
from ..priors import armodel
from ..priors import dataset as prior_ds
from ..priors import gmm as gmm_mod
from ..solver import kinematic as kin
from ..solver import kinetic as kn
from ..utils import data_ops
from ..utils.device import DeviceLike, resolve_device
from . import bench_lib
from . import depth_anchor as danchor
from . import estimator as est_mod
from . import initialization as init_mod
from .estimator import DD_BASE_ANCHOR, _np, prior_gate_accept

SOLVE_STAGES: Tuple[Tuple[float, int], ...] = ((10.0, 30), (3.0, 30),
                                               (1.0, 150))
SCAN_STAGES: Tuple[Tuple[float, int], ...] = ((1.0, 60),)


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
                    timings: Optional[dict] = None, *,
                    motion_prior_rolling: int = 0):
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
    6. the dd solve (pose prior + AR anchor + base anchor), then
       ``motion_prior_rolling`` refinements (JAX ``batched.py:316-331``):
       per lane the AR predictions recomputed from the current solution on
       every real frame (gate-rejected trials too; the weights are kept)
       and the dd solve again from it;
    7. camera rays and body-scale medians, then the depth line-scan;
    8. trials the scan moved are shifted along their rays and re-polished
       by the dd solver, with the base pinned to the shifted base and AR
       anchors recomputed at the new depth (on every frame of those
       trials);
    9. gate-rejected trials the scan left unmoved ship ``q_free``.

    With a ``timings`` dict, the wall seconds of each phase (chain, gate,
    anchors, dd, rolling, depth_host, scan, repolish) are added to it, each
    phase ending in a device sync.

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
    # 6: the dd solve, and the rolling AR refinements
    st_dd = dd(qb, bat)
    phase("dd")
    for _ in range(motion_prior_rolling):
        yp_r, vl_r, _ = _anchors(motion_model, _np(st_dd.q), fv)
        bat = bat._replace(ar=bat.ar._replace(y_pred=tens(yp_r),
                                              valid=tens(vl_r)))
        st_dd = dd(st_dd.q, bat)
        phase("rolling")
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
                timings: Optional[dict] = None, stances=None):
    """Physics-based reconstruction of a batch (bench.py's stage 2),
    warm-started from kinematic solutions ``q_warm`` (B, N, 54), e.g. the
    data-driven stage's.

    ``datas`` are the per-trial monocular problems (numpy leaves, the
    trial's real frames), ``fpss`` their frame rates, ``gmm_prior`` the
    pose prior (numpy leaves, no trial axis) of
    ``KineticConfig(use_gmm=True)``, ``ground_heights`` the per-trial ground
    plane elevations, ``stances`` the per-trial (n_i, 4) stance matrices
    when the caller detected them (else they are detected here). In order:

    1. host prep (``bench_lib.build_physics_batch``): each trial's warm
       start cut to its real frames, foot kinematics and centre of mass in
       one padded float64 call, contact detection and stance pruning
       (unless ``stances`` are given), the stacked batch on q_warm's device
       and dtype;
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
        ground_heights=ground_heights, device=q_warm.device,
        stances=stances)
    phase("host_prep")
    fte = kn.KineticFTE(kn.KineticConfig(use_gmm=True), subject)
    blocks = fte.eom_curvature_blocks(qw, kbat)
    phase("curvature")
    st = fte.make_solver(stages=stages)(qw, kbat, eom_blocks=blocks)
    phase("lm")
    return st, kbat


# ---------------------------------------------------------------------------
# the dataset CLI's batched path
# ---------------------------------------------------------------------------

def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _prepare(root_dir: str, data_path: str, cheetah: str,
             cam_override: Optional[int], monocular: bool):
    """A trial's estimator with its problem (``est.data``, numpy leaves)
    and its initial trajectory ``est.q0`` (multi-view, or from the
    monocular camera), made on the host in float64."""
    est = est_mod.init_trajectory(
        root_dir, data_path, cheetah, kinematic_model=True,
        monocular_enable=monocular, override_monocular_cam=cam_override)
    full_weight = np.einsum(
        "wl,ncl->nclw",
        noise_tables.measurement_weights(1, est.params.kinetic_dataset),
        (est.likelihood > est.params.dlc_thresh).astype(float))
    est.q0 = init_mod.initialize_trajectory(
        est.xy[..., None], full_weight, est.scene.k_arr, est.scene.d_arr,
        est.scene.r_arr, est.scene.t_arr, est.subject,
        fisheye=not est.params.kinetic_dataset, cam_idx=est.scene.cam_idx)
    return est


def _groups(root_dir: str, test_set, cam_overrides, monocular: bool
            ) -> Dict[str, List]:
    """The prepared trials of ``test_set`` that exist under ``root_dir``,
    grouped by subject."""
    groups: Dict[str, List] = defaultdict(list)
    for idx, (cheetah, date, trial_name) in enumerate(test_set):
        data_path = os.path.join(date, cheetah, trial_name)
        if not os.path.isdir(os.path.join(root_dir, data_path)):
            continue
        cam = cam_overrides[idx] if cam_overrides is not None else None
        est = _prepare(root_dir, data_path, cheetah, cam, monocular)
        groups[params_mod.get_subject(cheetah).name].append(est)
    return groups


def _n_frames(datas) -> int:
    """The group's padded length: the longest trial rounded up to 16."""
    return int(np.ceil(max(np.shape(d.meas)[0] for d in datas) / 16) * 16)


def _train_gmm(dataset: str, device: torch.device) -> kin.GMMPrior:
    """The data-driven pose prior from the training table at ``dataset``:
    the 5-component GMM over the 22 relative joint angles (seed 42), as a
    solver prior (numpy leaves, no trial axis), cached beside the table."""
    tab = prior_ds.load_pose_dataset(dataset)
    return gmm_mod.to_solver_prior(gmm_mod.fit(
        tab.data[:, 6:28], n_components=5, seed=42, device=device,
        cache_dir=data_ops.prior_cache_dir(dataset)))


def _trial_objective(fte: kin.KinematicFTE, est, dtype, dev) -> float:
    """The objective of one trial as a batch of one (its own frames, no
    padding)."""
    d1, q1 = pbatch.pad_and_stack([est.data], [est.q], dtype=dtype,
                                  device=dev)
    return float(fte.objective(q1, d1)[0])


def _ray_polish(qs: np.ndarray, batched: kin.KinematicData,
                subject: SubjectParams, cfg_free: kin.KinematicConfig,
                rays: Sequence[Tuple[int, float, float, np.ndarray,
                                     np.ndarray]], stages, mesh=None):
    """The depth correction and anchored polish shared by
    :func:`_anchor_polish` and ``bench_lib.make_anchor_polish``: per trial
    (``rays``: its frame count, fps, ground height and its camera's R and
    t) the ray shift of ``depth_anchor.ray_depth_correction``; a trial with
    no shift is left alone. Then one warm-started LM run over the batch
    under ``cfg_free`` with ``POLISH_CFG``'s ground terms on, and per trial
    the polish kept only where its ``cfg_free`` objective is finite and no
    more than 5 % above the input's; with a ``mesh`` the polish solve runs
    over it. Returns (qs polished (numpy), the per-trial first shift
    component, the per-trial acceptance)."""
    B, Npad = qs.shape[0], qs.shape[1]
    dev, dtype = batched.meas.device, batched.meas.dtype
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    stance_b = np.zeros((B, Npad, 4))
    gz = np.array([r[2] for r in rays], np.float64)
    shifts = np.zeros(B)
    qs_corr = qs.copy()
    for i, (n, fps, g, R, t) in enumerate(rays):
        qc, stw, shift = danchor.ray_depth_correction(qs[i, :n], subject,
                                                      fps, g, R, t)
        shifts[i] = float(shift[0])
        if float(np.max(np.abs(shift))) == 0.0:
            continue
        qs_corr[i, :n] = qc
        stance_b[i, :n] = stw
    if stance_b.sum() == 0.0:
        return qs, shifts, np.zeros(B, bool)
    pol = kin.KinematicFTE(dataclasses.replace(cfg_free, **danchor.POLISH_CFG),
                           subject)
    st = _on(mesh, pol.make_solver(stages=stages), dev)(
        tens(qs_corr), batched._replace(ground_z=tens(gz),
                                        stance_w=tens(stance_b)))
    gate = kin.KinematicFTE(cfg_free, subject)
    c0 = _np(gate.objective(tens(qs), batched))
    c1 = _np(gate.objective(st.q, batched))
    accept = np.isfinite(c1) & (c1 <= 1.05 * c0)
    return np.where(accept[:, None, None], _np(st.q), qs), shifts, accept


def _anchor_polish(qs: np.ndarray, ests: List, batched: kin.KinematicData,
                   subject: SubjectParams, cfg_base: kin.KinematicConfig,
                   stages=danchor.POLISH_STAGES,
                   report: Optional[dict] = None, mesh=None,
                   n_real: Optional[int] = None):
    """Monocular ground-plane depth correction and a short anchored polish.

    ``qs`` (B, Npad, 54) are the solved trajectories. Per trial on the
    host: the ray shift of ``depth_anchor.ray_depth_correction``; a trial
    with no shift is left alone (its stance pull would act on hovering
    stance frames too and over-correct the depth by the hover bias). Then
    one warm-started LM run over the batch with the ground, penetration
    and no-slip terms on (``POLISH_CFG``) and the learned priors and base
    anchor off. A trial keeps its polish only when its plain kinematic
    objective (no priors, no anchors) got no more than 5 % worse: the shift
    is reprojection-neutral, so a material increase means the polish
    diverged against bad stance evidence (:func:`_ray_polish`; over the
    ``mesh`` when one is given). With ``report``, the ray shift and
    whether the trial changed are recorded in it for the first ``n_real``
    trials (default: all). Returns (qs polished, whether any trial
    changed)."""
    rays = [(est.data.meas.shape[0], est.scene.fps,
             float(est.params.ground_plane_height),
             est.scene.r_arr[est.scene.cam_idx],
             est.scene.t_arr[est.scene.cam_idx]) for est in ests]
    free = dict(use_gmm=False, use_ar=False, base_anchor_trans=0.0,
                base_anchor_rot=0.0)
    out, shifts, accept = _ray_polish(
        qs, batched, subject, dataclasses.replace(cfg_base, **free), rays,
        stages, mesh)
    n = len(ests) if n_real is None else n_real
    if report is not None:
        report.setdefault("polish_ray_shift", []).extend(
            shifts[:n].tolist())
        report.setdefault("polish_changed", []).extend(
            bool(np.any(out[i] != qs[i])) for i in range(n))
    return out, bool(accept.any())


def _resolve_mesh(mesh, n_trials: int, device: torch.device):
    """The trial mesh of a group of ``n_trials`` solved on ``device``:
    ``"auto"`` gives a mesh over min(CUDA devices, n_trials) cards when the
    run is on the card and more than one card is visible, else None (the
    group as one batch on ``device``); devices (a sequence) give their
    mesh (``parallel/batch.trial_mesh``); None gives None."""
    if isinstance(mesh, str) and mesh == "auto":
        if device.type != "cuda":
            return None
        n = min(torch.cuda.device_count(), max(n_trials, 1))
        return pbatch.trial_mesh(n) if n > 1 else None
    return None if mesh is None else pbatch.trial_mesh(devices=mesh)


def _pad_group(ests: List, mesh) -> Tuple[List, int]:
    """Pad a trial group by cyclic repetition so that its batch divides the
    mesh; returns (padded ests, n_real). The padded lanes are copies of
    real trials, so every per-lane step stays shape-consistent; only
    ``ests[:n_real]`` are written."""
    n_real = len(ests)
    if mesh is None:
        return ests, n_real
    pad = (-n_real) % len(mesh)
    return ests + [ests[i % n_real] for i in range(pad)], n_real


def _on(mesh, fn, device: torch.device):
    """``fn`` (a batched function of trial-axis arguments) as it is without
    a mesh, else over the mesh with its outputs gathered on ``device``."""
    return fn if mesh is None else pbatch.on_mesh(fn, mesh, device)


def _launches() -> dict:
    """The banded-solve kernel's launch counts per (B, N) so far."""
    return dict(cuda_banded.launches_by_shape)


def run_monocular_batched(root_dir: str, dir_prefix: str,
                          test_set: Sequence[Tuple[str, str, str]],
                          cam_overrides: Optional[List[int]] = None,
                          modes: Sequence[str] = ("ground-truth", "default",
                                                  "data-driven"),
                          data_driven_dataset: Optional[str] = None,
                          dtype: torch.dtype = torch.float32,
                          motion_prior_rolling: int = 0,
                          ground_anchor: bool = True,
                          verbose: bool = True,
                          device: DeviceLike = None,
                          report: Optional[dict] = None,
                          mesh: Optional[object] = "auto"
                          ) -> Dict[str, float]:
    """Solve every (mode, trial) of ``test_set`` under ``root_dir`` with
    one batched run per (mode, subject) group on ``device`` (the card by
    default) and write the artifacts under ``dir_prefix``.

    * ground-truth: the multi-view solve from the multi-view
      initialisation (``fte_kinematic``);
    * default: monocular, the heading multistart, then (with
      ``ground_anchor``) the ground-plane correction and anchored polish
      (``fte_kinematic_orig_<cam>``);
    * data-driven: the heading multistart without priors, then
      :func:`run_data_driven` with the priors trained from
      ``data_driven_dataset`` and ``motion_prior_rolling`` AR refinements
      (``fte_kinematic_<cam>``);
    * physics-based: :func:`run_physics_batched` (``fte_kinetic_<cam>``).

    ``mesh``: ``"auto"`` (several cards: each group over
    min(cards, trials) of them; one card or the CPU: none), None, or the
    mesh's devices (:func:`_resolve_mesh`); a group on a mesh is padded
    by :func:`_pad_group` and its solves run over the mesh.

    ``opt_time_s`` of a trial is its group's solve wall (the chain, scan
    and polish included, host prep and artifact IO not) over the trial
    count. With a ``report`` dict, each mode's decisions (prior gate, scan
    shifts, polish shifts and changes, stance), solve and mode walls and
    the kernel's cumulative launches per shape at the mode's end are
    recorded under the mode's name; the per-trial lists follow the order of
    ``trials`` there (the subject groups' order). Returns the wall seconds
    per mode."""
    dev = resolve_device(device)
    timings: Dict[str, float] = {}
    for mode in modes:
        t0 = time.time()
        rep: dict = {} if report is None else report.setdefault(mode, {})
        if mode == "physics-based":
            timings[mode] = run_physics_batched(
                root_dir, dir_prefix, test_set, cam_overrides=cam_overrides,
                data_driven_dataset=data_driven_dataset, dtype=dtype,
                verbose=verbose, device=dev, report=rep, mesh=mesh)
            continue
        monocular = mode != "ground-truth"
        use_priors = mode == "data-driven"
        groups = _groups(root_dir, test_set, cam_overrides, monocular)
        if use_priors:
            dset = data_driven_dataset \
                or est_mod._default_data_driven_dataset()
            gp = _train_gmm(dset, dev)
            # the lasso AR model, window 4, validated on the
            # validation_dataset.csv beside the training table
            mm = armodel.train_motion_model(
                dset, window_size=4, lasso=True, device=dev,
                cache_dir=data_ops.prior_cache_dir(dset))
        for subject_name, ests in groups.items():
            subject = params_mod.get_subject(subject_name)
            m = _resolve_mesh(mesh, len(ests), dev)
            ests, n_real = _pad_group(ests, m)
            datas = [e.data for e in ests]
            batched, q0b = pbatch.pad_and_stack(
                datas, [e.q0 for e in ests], n_frames=_n_frames(datas),
                dtype=dtype, device=dev)
            cfg = kin.KinematicConfig(
                fisheye=True, robust=True, use_gmm=use_priors,
                use_ar=use_priors, **(DD_BASE_ANCHOR if use_priors else {}))
            fte = kin.KinematicFTE(cfg, subject)
            _sync(dev)
            t_s = time.time()
            if use_priors:
                free = kin.KinematicFTE(
                    kin.KinematicConfig(fisheye=True, robust=True), subject)
                q_free = _on(m, pbatch.make_kinematic_multistart(free),
                             dev)(q0b, batched).q
                q, prior_ok, shifts = _on(m, lambda qf, b, g: run_data_driven(
                    qf, b, g, mm, subject,
                    motion_prior_rolling=motion_prior_rolling), dev)(
                        q_free, batched, convert.gmm_prior(
                            gp, len(ests), device=dev, dtype=dtype))
                prior_ok, shifts = prior_ok[:n_real], shifts[:n_real]
                rep.setdefault("prior_ok", []).extend(prior_ok.tolist())
                rep.setdefault("scan_shifts", []).extend(
                    np.asarray(shifts, float).tolist())
                if verbose and not prior_ok.all():
                    print(f"[batched] prior gate: {int(prior_ok.sum())}/"
                          f"{n_real} trials accept the pose prior")
                if verbose and np.any(shifts != 0.0):
                    print("[batched] depth line-scan shifts: "
                          f"{np.round(shifts, 2).tolist()}")
            elif monocular:
                # the default mode solves cold from the init, escaping bad
                # heading basins by the multistart
                q = _on(m, pbatch.make_kinematic_multistart(fte), dev)(
                    q0b, batched).q
            else:
                q = _on(m, fte.make_solver(), dev)(q0b, batched).q
            _sync(dev)
            solve_s = time.time() - t_s
            qs = _np(q)
            if monocular and ground_anchor and not use_priors:
                t_a = time.time()
                qs, live = _anchor_polish(qs, ests, batched, subject, cfg,
                                          report=rep, mesh=m, n_real=n_real)
                _sync(dev)
                solve_s += time.time() - t_a
                if verbose and live:
                    print("[batched] ground-plane depth anchor applied")
            ests = ests[:n_real]
            for i, est in enumerate(ests):
                est.q = qs[i, :est.data.meas.shape[0]]
                est.obj_cost = _trial_objective(fte, est, dtype, dev)
                est.opt_time_s = solve_s / max(n_real, 1)
                cam = est.scene.cam_idx
                fname = ("fte_kinematic" if not monocular else
                         f"fte_kinematic_{cam}" if use_priors else
                         f"fte_kinematic_orig_{cam}")
                est.save(fname, out_dir_prefix=dir_prefix)
            rep.setdefault("trials", []).extend(e.data_path for e in ests)
            rep["solve_s"] = rep.get("solve_s", 0.0) + solve_s
        timings[mode] = time.time() - t0
        rep["wall_s"] = timings[mode]
        rep["launches"] = _launches()
        if verbose:
            print(f"[batched] mode={mode}: {timings[mode]:.1f}s for "
                  f"{sum(len(v) for v in groups.values())} trials")
    return timings


def run_physics_batched(root_dir: str, dir_prefix: str,
                        test_set: Sequence[Tuple[str, str, str]],
                        cam_overrides: Optional[List[int]] = None,
                        data_driven_dataset: Optional[str] = None,
                        dtype: torch.dtype = torch.float32,
                        verbose: bool = True,
                        device: DeviceLike = None,
                        report: Optional[dict] = None,
                        mesh: Optional[object] = "auto") -> float:
    """The physics-based mode over the test set: per trial, the warm start
    read back from the saved data-driven solution, contact detection on it
    written to ``grf/autogen-contact.json`` and read back as the stance
    matrix (pruned on the warm start); then :func:`run_physics` per subject
    group with the GMM pose prior trained from ``data_driven_dataset``, and
    the solved forces (``KineticFTE.forces``) into each trial's ``tau``,
    ``grf_z`` and ``grf_xy``. Needs the data-driven mode's artifacts. A
    group on a ``mesh`` (as in :func:`run_monocular_batched`) is padded
    and its physics solve runs over the mesh. With a ``report`` dict the
    stance matrices, solve wall and kernel launches go into it. Returns the
    wall seconds."""
    dev = resolve_device(device)
    t0 = time.time()
    rep: dict = {} if report is None else report
    groups = _groups(root_dir, test_set, cam_overrides, monocular=True)
    gp = _train_gmm(data_driven_dataset
                    or est_mod._default_data_driven_dataset(), dev)
    n_total = 0
    for subject_name, ests in groups.items():
        subject = params_mod.get_subject(subject_name)
        m = _resolve_mesh(mesh, len(ests), dev)
        ests, n_real = _pad_group(ests, m)
        q_warms, stances = [], []
        for est in ests:
            d = est_mod._load_warm_start(est, True, dir_prefix)
            est.com_vel, est.com_pos = d["com_vel"], d["com_pos"]
            est_mod.determine_contacts(est, monocular=True,
                                       out_dir_prefix=dir_prefix)
            with open(os.path.join(dir_prefix, est.data_path, "grf",
                                   "autogen-contact.json"),
                      encoding="utf-8") as f:
                cj = json.load(f)
            N = est.params.end_frame - est.params.start_frame
            stance = kn.stance_matrix(cj["contacts"], cj["start_frame"], N)
            stances.append(kn.prune_stance(stance, np.asarray(d["q"]),
                                           subject, 1.0 / est.scene.fps))
            q_warms.append(np.asarray(d["q"], np.float64))
        datas = [e.data for e in ests]
        Npad = _n_frames(datas)
        # run_physics reads each trial's real frames only
        q_warm_b = torch.as_tensor(np.stack([np.pad(
            q, ((0, Npad - len(q)), (0, 0)), mode="edge") for q in q_warms]),
            dtype=dtype, device=dev)
        _sync(dev)
        t_s = time.time()
        st, kbat = _on(m, lambda qw, lanes: run_physics(
            qw, [datas[i] for i in lanes], [ests[i].scene.fps for i in lanes],
            subject, gp, ground_heights=[
                ests[i].params.ground_plane_height for i in lanes],
            stances=[stances[i] for i in lanes]), dev)(
                q_warm_b, np.arange(len(ests)))
        _sync(dev)
        solve_s = time.time() - t_s
        fte = kn.KineticFTE(kn.KineticConfig(use_gmm=True), subject)
        tau_b, gz_b, gxy_b = [_np(x) for x in fte.forces(st.q, kbat)]
        obj = _np(fte.objective(st.q, kbat))
        qs = _np(st.q)
        ests, stances = ests[:n_real], stances[:n_real]
        for i, est in enumerate(ests):
            n = est.data.meas.shape[0]
            est.q = qs[i, :n]
            est.tau, est.grf_z, est.grf_xy = tau_b[i, :n], gz_b[i, :n], \
                gxy_b[i, :n]
            est.obj_cost = float(obj[i])
            est.opt_time_s = solve_s / max(n_real, 1)
            est.save(f"fte_kinetic_{est.scene.cam_idx}",
                     out_dir_prefix=dir_prefix)
        rep.setdefault("trials", []).extend(e.data_path for e in ests)
        rep.setdefault("stance", []).extend(
            s.astype(int).tolist() for s in stances)
        rep["solve_s"] = rep.get("solve_s", 0.0) + solve_s
        n_total += len(ests)
    wall = time.time() - t0
    rep["wall_s"] = wall
    rep["launches"] = _launches()
    if verbose:
        print(f"[batched] mode=physics-based: {wall:.1f}s for "
              f"{n_total} trials")
    return wall
