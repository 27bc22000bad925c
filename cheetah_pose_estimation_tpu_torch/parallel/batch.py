"""Batching ragged trials and the monocular heading multistart.

Port of ``cheetah_pose_estimation_tpu/parallel/batch.py``: trials are padded
to a common frame and camera count and stacked into one ``KinematicData``
(or, with the physics arrays, ``KineticData``) of tensors with a leading
trial axis. The monocular heading multistart solves every trial from three
heading offsets: in full (``make_multistart``, ``multistart_single`` for the
serial path's one trial), or as a short probe of every offset that
finishes only the winner (``make_kinematic_multistart``, the batched
production solver). The TPU backend crossover (``backend_for``,
``CR_MAX_BATCH``) is not ported: the linear solver follows the tensors'
device.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..solver.kinematic import (ARAnchor, CameraSet, KinematicData,
                                map_data)
from ..utils.device import DeviceLike, resolve_device

HEADING_RESTARTS: Tuple[float, ...] = (0.0, 0.3, -0.3)
MULTISTART_MARGIN = 0.01
PROBE_STAGES: Tuple[Tuple[float, int], ...] = ((10.0, 30),)
FULL_STAGES: Tuple[Tuple[float, int], ...] = ((3.0, 30), (1.0, 150))


def _pad_to(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad < 0:
        raise ValueError(
            f"trial dimension {x.shape[axis]} exceeds the requested padded "
            f"size {n} (axis {axis}); pass n_frames/n_cams >= the longest "
            "trial (padding never truncates)")
    if pad == 0:
        return x
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width)


def pad_and_stack(datas: Sequence[KinematicData],
                  q0s: Sequence[np.ndarray],
                  n_frames: Optional[int] = None,
                  n_cams: Optional[int] = None,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None
                  ) -> Tuple[KinematicData, torch.Tensor]:
    """Stack per-trial problems (numpy leaves) into one batch of tensors.

    Padded frames get ``frame_valid = 0`` (weights zeroed, stencil residuals
    masked, identity diagonal anchor in the normal matrix); padded cameras
    get zero weights and a harmless identity pose. q0 padding repeats the
    last valid frame."""
    dev = resolve_device(device)
    N = n_frames or max(d.meas.shape[0] for d in datas)
    C = n_cams or max(d.meas.shape[1] for d in datas)

    def prep(d: KinematicData, q0: np.ndarray):
        n, c = d.meas.shape[0], d.meas.shape[1]
        eye_pad = lambda k: np.concatenate(
            [np.zeros((c, k, k)), np.broadcast_to(np.eye(k), (C - c, k, k))])
        cam = CameraSet(
            _pad_to(np.asarray(d.cam.K), C, 0) + (eye_pad(3) if c < C
                                                  else 0.0),
            _pad_to(np.asarray(d.cam.D), C, 0),
            _pad_to(np.asarray(d.cam.R), C, 0) + (eye_pad(3) if c < C
                                                  else 0.0),
            _pad_to(np.asarray(d.cam.t), C, 0) + (np.concatenate(
                [np.zeros((c, 3)),
                 np.tile(np.array([0.0, 0.0, 10.0]), (C - c, 1))]) if c < C
                else 0.0))
        ar = ARAnchor(_pad_to(np.asarray(d.ar.y_pred), N, 0),
                      np.asarray(d.ar.weight),
                      _pad_to(np.asarray(d.ar.valid), N, 0))
        sw = _pad_to(np.broadcast_to(np.asarray(d.stance_w), (n, 4)), N, 0)
        q0p = np.asarray(q0)
        if q0p.shape[0] > N:
            raise ValueError(
                f"q0 length {q0p.shape[0]} exceeds the requested padded "
                f"size {N}; pass n_frames >= the longest trial")
        if q0p.shape[0] < N:
            q0p = np.concatenate(
                [q0p, np.tile(q0p[-1:], (N - q0p.shape[0], 1))])
        return KinematicData(
            meas=_pad_to(_pad_to(np.asarray(d.meas), N, 0), C, 1),
            weight=_pad_to(_pad_to(np.asarray(d.weight), N, 0), C, 1),
            cam=cam, h=np.asarray(d.h),
            acc_weight=np.asarray(d.acc_weight),
            frame_valid=_pad_to(np.asarray(d.frame_valid), N, 0),
            gmm=d.gmm, ar=ar, ground_z=np.asarray(d.ground_z, float),
            stance_w=sw), q0p

    prepped = [prep(d, q) for d, q in zip(datas, q0s)]

    def stack(*xs):
        return torch.as_tensor(np.stack([np.asarray(x) for x in xs]),
                               dtype=dtype, device=dev)

    leaves = [list(_leaves(p[0])) for p in prepped]
    stacked = [stack(*col) for col in zip(*leaves)]
    batched = _unflatten(prepped[0][0], iter(stacked))
    q0b = torch.as_tensor(np.stack([p[1] for p in prepped]), dtype=dtype,
                          device=dev)
    return batched, q0b


def _leaves(data):
    if isinstance(data, tuple) and hasattr(data, "_fields"):
        for x in data:
            yield from _leaves(x)
    else:
        yield data


def _unflatten(like, it):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(x, it) for x in like])
    return next(it)


def _pick_restart(st, margin: float, R: int):
    """Per-trial restart selection from a state batched (R*B, ...) in
    restart-major order: restart 0 (unperturbed) unless an alternative beats
    it by more than ``margin``. Non-finite costs are demoted to +inf first,
    so a NaN unperturbed lane cannot win every comparison."""
    cost = st.cost.reshape(R, -1)
    cost = torch.where(torch.isfinite(cost), cost,
                       torch.full_like(cost, float("inf")))
    c0 = cost[0]
    alt = torch.argmin(cost[1:], dim=0) + 1
    c_alt = torch.gather(cost, 0, alt[None])[0]
    best = torch.where(c_alt < (1.0 - margin) * c0, alt, torch.zeros_like(alt))
    best = torch.where(torch.isinf(c0) & torch.isfinite(c_alt), alt, best)
    B = best.shape[0]
    lane = best * B + torch.arange(B, device=best.device)
    return type(st)(*[x[lane] for x in st])


def _perturbed(q0b: torch.Tensor, offs: Tuple[float, ...]) -> torch.Tensor:
    """The R heading-perturbed copies of q0b (B, N, 54), restart-major."""
    q0r = []
    for o in offs:
        q = q0b.clone()
        q[:, :, 5] += o
        q0r.append(q)
    return torch.cat(q0r)


def _repeat(batched: KinematicData, R: int) -> KinematicData:
    return map_data(lambda x: x.repeat((R,) + (1,) * (x.ndim - 1)), batched)


def make_multistart(run, offsets: Tuple[float, ...] = HEADING_RESTARTS,
                    margin: float = MULTISTART_MARGIN):
    """A multistart solver ``ms(q0b, batched)``: every trial of the batch
    solved in full by ``run`` (a batched solver, as returned by
    ``KinematicFTE.make_solver``) from each of the ``offsets`` heading
    perturbations, all R x B lanes as one batch, and the best restart kept
    per trial by the margin rule. ``offsets[0]`` must be the unperturbed
    0. Monocular problems only: multi-view solves are single-start."""
    offs = tuple(float(o) for o in offsets)
    R = len(offs)

    def solve_all(q0b: torch.Tensor, batched: KinematicData):
        return _pick_restart(run(_perturbed(q0b, offs), _repeat(batched, R)),
                             margin, R)

    return solve_all


def multistart(run, q0b: torch.Tensor, batched: KinematicData,
               offsets: Tuple[float, ...] = HEADING_RESTARTS,
               margin: float = MULTISTART_MARGIN):
    """One-shot :func:`make_multistart`."""
    return make_multistart(run, offsets, margin)(q0b, batched)


def multistart_single(run, q0: torch.Tensor, data: KinematicData,
                      offsets: Tuple[float, ...] = HEADING_RESTARTS,
                      margin: float = MULTISTART_MARGIN):
    """Single-trial multistart (the serial path): ``q0`` (N, 54) and
    ``data``, the trial's problem as a batch of one; the R restarts are one
    R-lane batch of the trial's own length. Returns the picked restart's
    state, with its batch axis of one."""
    return multistart(run, q0[None], data, offsets, margin)


def make_multistart_probe(probe_run, full_run,
                          offsets: Tuple[float, ...] = HEADING_RESTARTS,
                          margin: float = MULTISTART_MARGIN):
    """Demand-driven multistart: ``probe_run`` (a short fixed-length solve)
    runs every trial from every heading offset as one batch of R*B lanes,
    the winning restart per trial is picked by the margin rule, and
    ``full_run`` continues only the B winners from their probe states."""
    offs = tuple(float(o) for o in offsets)
    R = len(offs)

    def solve_all(q0b: torch.Tensor, batched: KinematicData):
        sel = _pick_restart(probe_run(_perturbed(q0b, offs),
                                      _repeat(batched, R)), margin, R)
        return full_run(sel.q, batched)

    return solve_all


def make_kinematic_multistart(fte, margin: float = MULTISTART_MARGIN,
                              linear_solver: Optional[str] = None):
    """The production monocular solver: probe-multistart over the default
    annealing schedule of ``KinematicFTE.make_solver`` (probe = its first
    stage as a fixed-length solve, full = the remaining stages)."""
    probe = fte.make_solver(stages=PROBE_STAGES, driver="fixed",
                            linear_solver=linear_solver)
    full = fte.make_solver(stages=FULL_STAGES, linear_solver=linear_solver)
    return make_multistart_probe(probe, full, margin=margin)


def pad_and_stack_kinetic(kds, q_warms: Sequence[np.ndarray],
                          n_frames: Optional[int] = None,
                          n_cams: Optional[int] = None,
                          dtype: torch.dtype = torch.float32,
                          device: DeviceLike = None):
    """Stack per-trial physics problems (``solver.kinetic.KineticData``
    with numpy leaves) into one batch of tensors: the kinematic bases go
    through :func:`pad_and_stack`, the physics arrays are zero-padded on the
    frame axis (padded frames are masked by ``frame_valid`` in every
    kinetic term). Returns (batched KineticData, q_warm (B, N, 54))."""
    from ..dynamics.eom import N_TAU
    from ..solver.kinetic import KineticData

    dev = resolve_device(device)
    N = n_frames or max(kd.base.meas.shape[0] for kd in kds)
    base, q_warm = pad_and_stack([kd.base for kd in kds], q_warms,
                                 n_frames=N, n_cams=n_cams, dtype=dtype,
                                 device=dev)

    def stack(field, pad_frames=True):
        xs = [np.asarray(getattr(kd, field), float) for kd in kds]
        xs = [_pad_to(x, N, 0) if pad_frames else x.reshape(())
              for x in xs]
        return torch.as_tensor(np.stack(xs), dtype=dtype, device=dev)

    anchors = [_pad_to(np.broadcast_to(
        np.asarray(kd.tau_anchor, float).reshape(-1, N_TAU),
        (kd.base.meas.shape[0], N_TAU)), N, 0) for kd in kds]
    return KineticData(
        base=base, stance=stack("stance"), grf_fixed=stack("grf_fixed"),
        grf_xy_fixed=stack("grf_xy_fixed"),
        use_fixed_grf=stack("use_fixed_grf", False), q_warm=q_warm,
        tau_anchor=torch.as_tensor(np.stack(anchors), dtype=dtype,
                                   device=dev),
        tau_anchor_weight=stack("tau_anchor_weight", False),
        ground_z=stack("ground_z", False)), q_warm
