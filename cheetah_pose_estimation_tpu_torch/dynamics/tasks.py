"""Trajectory-generation (optimal control) tasks.

Port of ``cheetah_pose_estimation_tpu/dynamics/tasks.py`` (the whole file):
the reference's legacy task family (``cheetah.py:360-704``) as
measurement-free trajectory optimisation over the 17-link dynamics of the
physics-based FTE,

* :func:`high_speed_stop` (``cheetah.py:360-486``): start at speed, end at
  rest, feet on the ground after a settling window, minimal joint torque
  (optionally a short stop);
* :func:`periodic_gallop` (``cheetah.py:489-650``): a periodic stride at a
  prescribed average speed and foot-contact order.

The trajectory q (N, 54) is the unknown; the joint torques and stance GRFs
are eliminated per frame in closed form by the port's ``KineticFTE``, and
the EOM enters as a weighted slack whose exact Gauss-Newton curvature,
recomputed at the live q on every step, keeps the normal system
block-banded in time. Task conditions are quadratic anchors and hinge
penalties: exact anchor and velocity blocks, active-set box and
joint-limit blocks, and the periodicity blocks on the diagonal only (their
cross block lies outside the band; the gradient is exact).

The port's ``KineticFTE`` is batched, so a task is one lane (B = 1), and
every LM step solves through ``gn._scaled_solve``: on the card the
hand-written kernel (``ops/cuda_banded.solve``, float32), on the CPU the
plain banded Cholesky. The tasks' default dtype is float32, the kernel's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import params as params_mod
from ..models.params import SubjectParams
from ..ops import banded
from ..solver import gn as gn_mod
from ..solver import kinematic as kin
from ..solver import kinetic as kn
from ..utils.device import DeviceLike, resolve_device
from . import eom as dyn

NQ = kn.NQ


class TaskSpec(NamedTuple):
    """Task-specific quadratic/hinge terms on top of the kinetic physics
    (JAX ``tasks.py:51-65``); arrays of one dtype on one device."""
    stance: torch.Tensor          # (N, 4) prescribed contact schedule
    anchor_w: torch.Tensor        # (N, NQ) per-element state anchor weights
    anchor_v: torch.Tensor        # (N, NQ) state anchor targets
    vel_w: torch.Tensor           # (N, NQ) weights on (q[t]-q[t-1])/h, t>=1
    vel_v: torch.Tensor           # (N, NQ) velocity targets
    box_G: torch.Tensor           # (R, NQ) bound rows: lo <= G q <= hi
    box_lo: torch.Tensor          # (R,)
    box_hi: torch.Tensor          # (R,)
    box_mask: torch.Tensor        # (R, N) 1.0 where the row applies
    periodic_w: torch.Tensor      # scalar weight
    periodic_mask: torch.Tensor   # (NQ,) dims with q[0] == q[N-1]
    periodic_vmask: torch.Tensor  # (NQ,) dims with dq[0] == dq[N-1]
    lin: torch.Tensor             # (N, NQ) linear cost coefficients
    h: torch.Tensor               # scalar timestep


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    eom_weight: float = 1e4
    torque_weight: float = 1.0
    no_slip_penalty: float = 1e3
    foot_height_penalty: float = 1e4
    foot_height_bound: float = 0.01   # stance feet within 1 cm of ground
    clearance_penalty: float = 1e6    # feet never below the ground
    box_penalty: float = 1e4
    max_iters: int = 200


def _spec(dtype: torch.dtype, device: torch.device, **arrays
              ) -> TaskSpec:
    """A :class:`TaskSpec` of ``dtype`` on ``device`` from host arrays."""
    return TaskSpec(**{k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                          device=device)
                       for k, v in arrays.items()})


def _dummy_kinetic_data(N: int, h: float, stance, dtype: torch.dtype,
                        device) -> kn.KineticData:
    """Measurement-free one-lane KineticData: one zero-weight camera, no
    priors (JAX ``tasks.py:78-105``)."""
    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    eye = lambda n: torch.eye(n, dtype=dtype, device=device)
    cam = kin.CameraSet(K=eye(3)[None, None], D=z(1, 1, 4),
                        R=eye(3)[None, None],
                        t=torch.tensor([[[0.0, 0.0, 10.0]]], dtype=dtype,
                                       device=device))
    base = kin.KinematicData(
        meas=z(1, N, 1, 24, 2, 1), weight=z(1, N, 1, 24, 1), cam=cam,
        h=torch.full((1,), float(h), dtype=dtype, device=device),
        acc_weight=z(1, NQ),
        frame_valid=torch.ones((1, N), dtype=dtype, device=device),
        gmm=kin.GMMPrior(means=z(1, 1, 22), prec=eye(22)[None, None],
                         log_norm=z(1, 1)),
        ar=kin.ARAnchor(y_pred=z(1, N, 28), weight=z(1, 28),
                        valid=z(1, N)),
        ground_z=z(1))
    return kn.KineticData(
        base=base,
        stance=torch.as_tensor(stance, dtype=dtype, device=device)[None],
        grf_fixed=z(1, N, 4), grf_xy_fixed=z(1, N, 4, 4),
        use_fixed_grf=z(1), q_warm=z(1, N, NQ),
        tau_anchor=z(1, 1, dyn.N_TAU), tau_anchor_weight=z(1),
        ground_z=z(1))


class TrajectoryTask:
    """LM trajectory optimizer: kinetic physics + TaskSpec terms (JAX
    ``tasks.py:108-255``), one lane: q is (1, N, 54)."""

    def __init__(self, subject: SubjectParams, spec: TaskSpec,
                 config: TaskConfig = TaskConfig()):
        self.subject = subject
        self.spec = spec
        self.config = config
        N = spec.stance.shape[0]
        kcfg = kn.KineticConfig(
            robust=False, use_gmm=False,
            torque_weight=config.torque_weight,
            eom_weight=config.eom_weight,
            no_slip_penalty=config.no_slip_penalty,
            foot_height_penalty=config.foot_height_penalty,
            foot_height_bound=config.foot_height_bound)
        self.fte = kn.KineticFTE(kcfg, subject)
        self.data = _dummy_kinetic_data(N, float(spec.h), spec.stance,
                                        spec.anchor_w.dtype,
                                        spec.anchor_w.device)

    # -- task cost terms -----------------------------------------------------
    def _extras_cost(self, q: torch.Tensor) -> torch.Tensor:
        """Anchors, velocity anchors, box hinges, periodicity, ground
        clearance and the linear terms, (1,) (JAX ``tasks.py:129-154``)."""
        sp, cfg, h = self.spec, self.config, self.spec.h
        c = (sp.anchor_w * (q - sp.anchor_v) ** 2).sum((1, 2))
        dq = (q[:, 1:] - q[:, :-1]) / h
        c = c + (sp.vel_w[1:] * (dq - sp.vel_v[1:]) ** 2).sum((1, 2))
        v = torch.einsum("rj,btj->brt", sp.box_G, q)
        viol = torch.clamp(v - sp.box_hi[:, None], min=0.0) \
            + torch.clamp(sp.box_lo[:, None] - v, min=0.0)
        c = c + cfg.box_penalty * (sp.box_mask * viol * viol).sum((1, 2))
        rp = sp.periodic_mask * (q[:, -1] - q[:, 0])
        c = c + sp.periodic_w * (rp * rp).sum(-1)
        rv = sp.periodic_vmask * ((q[:, -1] - q[:, -2])
                                  - (q[:, 1] - q[:, 0])) / h
        c = c + sp.periodic_w * (rv * rv).sum(-1)
        pts = dyn.foot_points(q, self.subject)
        below = torch.clamp(-pts[..., 2], min=0.0)
        c = c + cfg.clearance_penalty * (below * below).sum((1, 2))
        return c + (sp.lin * q).sum((1, 2))

    def _cost(self, q: torch.Tensor) -> torch.Tensor:
        """(1,) total cost (JAX ``tasks.py:156-160``)."""
        eom_c, tau_c, _ = self.fte._physics_costs(q, self.data)
        pen = self.fte._stance_penalties(q, self.data)
        lim = self.fte._kin._limit_cost(q, self.data.base.frame_valid)
        return eom_c + tau_c + pen + lim + self._extras_cost(q)

    # -- normal equations ------------------------------------------------
    def _normal(self, q: torch.Tensor):
        """Gradient (1, N, 54) by autograd of :meth:`_cost` and the
        block-banded curvature (JAX ``tasks.py:162-229``)."""
        sp, cfg = self.spec, self.config
        dtype = q.dtype
        N = q.shape[1]
        h = sp.h
        q = q.detach()
        with torch.enable_grad():
            qg = q.clone().requires_grad_(True)
            g = torch.autograd.grad(self._cost(qg).sum(), qg)[0]

        # EOM exact-GN curvature, recomputed at the live q
        Hdiag, el1, el2 = self.fte.eom_curvature_blocks(q, self.data)
        l1 = el1.clone()
        # state anchors; velocity anchors couple q[t] and q[t-1]
        Hdiag = Hdiag + 2.0 * torch.diag_embed(sp.anchor_w)[None]
        wv = torch.diag_embed(sp.vel_w[1:] / (h * h))         # (N-1, d, d)
        Hdiag[:, 1:] += 2.0 * wv
        Hdiag[:, :-1] += 2.0 * wv
        l1[:, :-1] -= 2.0 * wv
        # box hinge active-set curvature
        v = torch.einsum("rj,btj->brt", sp.box_G, q)
        active = sp.box_mask * ((v > sp.box_hi[:, None])
                                | (v < sp.box_lo[:, None])).to(dtype)
        Hdiag = Hdiag + 2.0 * cfg.box_penalty * torch.einsum(
            "ra,xrt,rc->xtac", sp.box_G, active, sp.box_G)
        # periodicity: the diagonal blocks only
        wp = 2.0 * sp.periodic_w
        Pd = torch.diag_embed(sp.periodic_mask)
        Pv = torch.diag_embed(sp.periodic_vmask) / (h * h)
        Hdiag[:, 0] += wp * (Pd + Pv)
        Hdiag[:, -1] += wp * (Pd + Pv)
        Hdiag[:, 1] += wp * Pv
        Hdiag[:, -2] += wp * Pv
        # clearance and stance foot height: active-set GN curvature with
        # the feet's closed-form z Jacobian
        pts_f, Jf = dyn.feet_and_jacobian(q, self.subject)
        Jz = Jf[..., 2, :]                                   # (1, N, 4, d)
        z_f = pts_f[..., 2]
        act_clear = (z_f < 0.0).to(dtype)
        act_height = self.data.stance * (
            z_f.abs() > cfg.foot_height_bound).to(dtype)
        w_feet = 2.0 * (cfg.clearance_penalty * act_clear
                        + cfg.foot_height_penalty * act_height)
        Hdiag = Hdiag + torch.einsum("xtf,xtfa,xtfc->xtac", w_feet, Jz, Jz)
        Hdiag = Hdiag + 1e-2 * torch.eye(NQ, dtype=dtype, device=q.device)
        # joint limits
        kin_fte = self.fte._kin
        G = kin_fte._table("_G", q)
        vlim = torch.einsum("cj,btj->btc", G, q)
        act = ((vlim > kin_fte._table("_hi", q))
               | (vlim < kin_fte._table("_lo", q))).to(dtype)
        Hdiag = Hdiag + 2.0 * kin_fte.config.limit_penalty * torch.einsum(
            "ca,xtc,ce->xtae", G, act, G)
        lower = torch.stack([l1, el2, torch.zeros_like(l1)], 1)
        return g, banded.BlockBanded(diag=Hdiag, lower=lower)

    # -- solve -------------------------------------------------------------
    def solve(self, q0, max_iters: Optional[int] = None,
              ftol: float = 1e-10) -> Dict:
        """LM from q0 (N, 54) through ``gn.lm_solve`` with lam0 = 1 (JAX
        ``tasks.py:232-255``); the result's arrays are float64 numpy."""
        cfg = gn_mod.LMConfig(max_iters=max_iters or self.config.max_iters,
                              ftol=ftol, lam0=1e0)
        q0 = torch.as_tensor(q0, dtype=self.spec.h.dtype,
                             device=self.spec.h.device)
        state = gn_mod.lm_solve(self._cost, self._normal, q0[None], cfg)
        q = state.q
        with torch.no_grad():
            eom_c, tau_c, (slack, tau, gz, gxy) = self.fte._physics_costs(
                q, self.data)
        dq = torch.zeros_like(q)
        dq[:, 1:] = (q[:, 1:] - q[:, :-1]) / self.spec.h
        np64 = lambda x: x[0].detach().double().cpu().numpy()
        return {
            "q": np64(q), "dq": np64(dq), "tau": np64(tau),
            "grf_z": np64(gz), "grf_xy": np64(gxy),
            "cost": float(state.cost[0]), "iterations": int(state.it[0]),
            "accepted": int(state.n_accepted[0]),
            "eom_cost": float(eom_c[0]), "torque_cost": float(tau_c[0]),
            "eom_rms_bw": float(torch.sqrt((slack[0, 2:] ** 2).mean())),
        }


# ---------------------------------------------------------------------------
# The tasks
# ---------------------------------------------------------------------------

def _ang_index(link: str, comp: str) -> int:
    return kin._ang(link, comp)


_LEG_LINKS = ("UFL", "LFL", "HFL", "UFR", "LFR", "HFR",
              "UBL", "LBL", "HBL", "UBR", "LBR", "HBR")
_BODY_SEGMENTS = ("bodyF", "neck")
_ALL_LINKS = ("base", "bodyF", "neck", "tail0", "tail1") + _LEG_LINKS


def _neutral_pose(height: float = 0.55) -> np.ndarray:
    """Standing pose: every link yaw at pi (the skeleton's forward-facing
    convention, ``simulate.drop_pose``), base at ``height``."""
    q = np.zeros(NQ)
    q[2] = height
    q[5] = np.pi
    for i in range(1, 17):
        q[3 * i + 5] = np.pi
    return q


# leg thetas putting all four feet on the ground at base height 0.55 with
# zero joint-limit violation
_CROUCH_FRONT = (0.5, 0.5, 0.75)
_CROUCH_BACK = (0.75, 0.75, 1.0)


def _crouch_pose(height: float = 0.55) -> np.ndarray:
    """Standing pose with bent legs so the feet rest on the ground."""
    q = _neutral_pose(height)
    for legs, (a, b, c) in ((("UFL", "LFL", "HFL"), _CROUCH_FRONT),
                            (("UFR", "LFR", "HFR"), _CROUCH_FRONT),
                            (("UBL", "LBL", "HBL"), _CROUCH_BACK),
                            (("UBR", "LBR", "HBR"), _CROUCH_BACK)):
        th, ca, ho = legs
        q[_ang_index(th, "theta")] = a
        q[_ang_index(ca, "theta")] = b
        q[_ang_index(ho, "theta")] = c
    return q


def _box_rows(rows: list, link: str, comp: str, lo: float, hi: float,
              mask: np.ndarray, center: float = 0.0):
    g = np.zeros(NQ)
    g[_ang_index(link, comp)] = 1.0
    rows.append((g, center + lo, center + hi, mask))


def _pack_boxes(rows: list, N: int):
    G = np.stack([r[0] for r in rows])
    lo = np.array([r[1] for r in rows])
    hi = np.array([r[2] for r in rows])
    mask = np.stack([np.broadcast_to(r[3], (N,)) for r in rows]).astype(float)
    return G, lo, hi, mask


def high_speed_stop(subject: Optional[SubjectParams] = None,
                    initial_vel: float = 10.0, n_frames: int = 40,
                    h: float = 0.02, minimize_distance: bool = False,
                    settle_frames: int = 10,
                    config: TaskConfig = TaskConfig(foot_height_bound=0.03),
                    max_iters: Optional[int] = None, seed: int = 0,
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """Plan a stop from ``initial_vel`` m/s (JAX ``tasks.py:315-420``,
    reference cheetah.py:360-486): start at the origin at speed, end at
    rest in a standard posture, feet driven to the ground after
    ``settle_frames``, body height capped at 0.6 m; with
    ``minimize_distance`` the final x enters the objective (weight 1e-4).
    Runs on ``device`` (None: the card) in ``dtype``."""
    dev = resolve_device(device)
    subject = subject or params_mod.get_subject("acinoset")
    N = n_frames
    rng = np.random.default_rng(seed)
    after = np.arange(N) >= settle_frames
    always = np.ones(N, bool)
    last = np.arange(N) == N - 1

    stance = np.zeros((N, 4))
    stance[settle_frames:, :] = 1.0

    anchor_w = np.zeros((N, NQ))
    anchor_v = np.zeros((N, NQ))
    anchor_w[0, 0:2] = 1e6                 # start at the origin
    anchor_w[0, 2] = 1e4                   # z anchored softly to leg height
    anchor_v[0, 2] = 0.55

    vel_w = np.zeros((N, NQ))
    vel_v = np.zeros((N, NQ))
    vel_w[1, 0] = 1e6                      # start at speed, toward -x
    vel_v[1, 0] = -initial_vel
    vel_w[-1, :] = 1e6                     # end at rest

    rows: list = []
    gy = np.zeros(NQ)
    gy[1] = 1.0
    rows.append((gy, -0.2, 0.2, always))
    gz = np.zeros(NQ)
    gz[2] = 1.0
    rows.append((gz, 0.25, 0.6, after))
    for link in _ALL_LINKS:
        _box_rows(rows, link, "phi", -np.pi / 4, np.pi / 4, always)
        _box_rows(rows, link, "psi", -np.pi / 4, np.pi / 4, always,
                  center=np.pi)
    crouch = _crouch_pose()
    for link in _LEG_LINKS:
        c0 = crouch[_ang_index(link, "theta")]
        _box_rows(rows, link, "theta", -np.radians(60), np.radians(60),
                  always, center=c0)
        _box_rows(rows, link, "theta", -np.radians(20), np.radians(20), last,
                  center=c0)
    for link in _BODY_SEGMENTS:
        _box_rows(rows, link, "theta", -np.radians(45), np.radians(45),
                  always)
        _box_rows(rows, link, "theta", -np.radians(10), np.radians(10), last)
    for link in _ALL_LINKS:
        _box_rows(rows, link, "phi", -np.radians(5), np.radians(5), last)
        _box_rows(rows, link, "psi", -np.radians(5), np.radians(5), last,
                  center=np.pi)
    G, lo_v, hi_v, mask = _pack_boxes(rows, N)

    lin = np.zeros((N, NQ))
    if minimize_distance:
        lin[-1, 0] = 1e-4 * subject.total_mass * dyn.GRAVITY

    spec = _spec(dtype, dev, stance=stance, anchor_w=anchor_w,
                     anchor_v=anchor_v, vel_w=vel_w, vel_v=vel_v, box_G=G,
                     box_lo=lo_v, box_hi=hi_v, box_mask=mask,
                     periodic_w=0.0, periodic_mask=np.zeros(NQ),
                     periodic_vmask=np.zeros(NQ), lin=lin, h=h)

    # init: a decelerating ramp toward -x at standing height, the
    # pre-settle frames' pitches jittered to break symmetry
    q0 = np.tile(_crouch_pose(), (N, 1))
    t = np.arange(N) / (N - 1)
    total_time = (N - 1) * h
    q0[:, 0] = -total_time * (initial_vel / 2) * (2 * t - t ** 2)
    for i in range(17):
        q0[:settle_frames, 3 * i + 4] += rng.normal(
            0, np.radians(5), size=settle_frames)

    task = TrajectoryTask(subject, spec, config)
    out = task.solve(q0, max_iters=max_iters)
    out["final_speed"] = float(np.linalg.norm(out["dq"][-1, :3]))
    out["stop_distance"] = float(abs(out["q"][-1, 0] - out["q"][0, 0]))
    return out


def sin_around_touchdown(mid_frame: int, n_frames: int,
                         amplitude_d: float = 25.0) -> np.ndarray:
    """Leg-swing initialisation: one sinusoid period peaking at touchdown
    (JAX ``tasks.py:423-430``)."""
    t = np.arange(n_frames, dtype=float)
    return np.radians(amplitude_d) * np.sin(
        2.0 * np.pi * (t - mid_frame) / n_frames)


# reference default for 14 m/s (cheetah.py docstring at 489-499)
GALLOP_FOOT_ORDER = ((1, 7), (6, 13), (31, 38), (25, 32))


def periodic_gallop(subject: Optional[SubjectParams] = None,
                    avg_vel: float = 14.0,
                    foot_order: Sequence[Tuple[int, int]] = GALLOP_FOOT_ORDER,
                    n_frames: int = 44, h: float = 0.01,
                    config: TaskConfig = TaskConfig(),
                    max_iters: Optional[int] = None, seed: int = 0,
                    device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> Dict:
    """Plan one periodic gallop stride at ``avg_vel`` m/s with the contact
    windows of ``foot_order`` (one-based (touchdown, liftoff) finite
    elements of HFL, HFR, HBL, HBR; JAX ``tasks.py:437-527``, reference
    cheetah.py:489-650): periodic in every state but x, the final x fixed
    to avg_vel * total_time. Runs on ``device`` (None: the card) in
    ``dtype``."""
    dev = resolve_device(device)
    subject = subject or params_mod.get_subject("acinoset")
    N = n_frames
    rng = np.random.default_rng(seed)
    total_time = (N - 1) * h
    always = np.ones(N, bool)

    stance = np.zeros((N, 4))
    for i, (td, lo_fe) in enumerate(foot_order):
        stance[max(td - 1, 0):min(lo_fe, N), i] = 1.0

    anchor_w = np.zeros((N, NQ))
    anchor_v = np.zeros((N, NQ))
    anchor_w[0, 0:2] = 1e6                      # start at the origin
    anchor_w[-1, 0] = 1e6                       # final x displacement fixed
    anchor_v[-1, 0] = -avg_vel * total_time     # run toward -x

    vel_w = np.zeros((N, NQ))
    vel_v = np.zeros((N, NQ))
    vel_w[1:, 0] = 1e0                          # soft forward-speed shaping
    vel_v[1:, 0] = -avg_vel

    rows: list = []
    gy = np.zeros(NQ)
    gy[1] = 1.0
    rows.append((gy, -0.2, 0.2, always))
    gz = np.zeros(NQ)
    gz[2] = 1.0
    rows.append((gz, 0.3, 0.7, always))         # never fallen over
    for link in _ALL_LINKS:
        _box_rows(rows, link, "phi", -np.radians(15), np.radians(15), always)
        _box_rows(rows, link, "psi", -np.radians(10), np.radians(10), always,
                  center=np.pi)
    for link in ("base", "bodyF", "neck"):
        _box_rows(rows, link, "theta", -np.radians(45), np.radians(45),
                  always)
    for link in ("tail0", "tail1") + _LEG_LINKS:
        _box_rows(rows, link, "theta", -np.radians(90), np.radians(90),
                  always)
    G, lo_v, hi_v, mask = _pack_boxes(rows, N)

    periodic_mask = np.ones(NQ)
    periodic_mask[0] = 0.0                      # x advances by one stride
    periodic_vmask = np.ones(NQ)

    spec = _spec(dtype, dev, stance=stance, anchor_w=anchor_w,
                     anchor_v=anchor_v, vel_w=vel_w, vel_v=vel_v, box_G=G,
                     box_lo=lo_v, box_hi=hi_v, box_mask=mask,
                     periodic_w=1e5, periodic_mask=periodic_mask,
                     periodic_vmask=periodic_vmask, lin=np.zeros((N, NQ)),
                     h=h)

    # init: a constant-velocity ramp at standing height, sinusoidal leg
    # swings around each touchdown on the stand
    q0 = np.tile(_crouch_pose(), (N, 1))
    t = np.arange(N) / (N - 1)
    q0[:, 0] = -avg_vel * total_time * t
    q0[:, _ang_index("base", "theta")] += rng.normal(0, np.radians(5),
                                                     size=N)
    for i, ((td, lo_fe), (upper, lower)) in enumerate(zip(
            foot_order, (("UFL", "LFL"), ("UFR", "LFR"),
                         ("UBL", "LBL"), ("UBR", "LBR")))):
        swing = sin_around_touchdown(int((td + lo_fe) / 2), N)
        off = np.radians(-15 if upper[1] == "F" else 15)
        q0[:, _ang_index(upper, "theta")] += swing
        q0[:, _ang_index(lower, "theta")] += swing + off

    task = TrajectoryTask(subject, spec, config)
    out = task.solve(q0, max_iters=max_iters)
    out["stride_length"] = float(abs(out["q"][-1, 0] - out["q"][0, 0]))
    out["avg_speed"] = out["stride_length"] / total_time
    per = np.abs(periodic_mask * (out["q"][-1] - out["q"][0]))
    out["periodicity_error"] = float(per.max())
    return out
