"""Physics-based FTE: trajectory estimation under full rigid-body dynamics.

Port of ``cheetah_pose_estimation_tpu/solver/kinetic.py``. The objective is

  cost = measurement (Huber) + [GMM pose prior] + joint limits
         + EOM slack (epsilon-insensitive, weight 1e4 ramped by the annealing
           scale) + torque^2 + marker-acceleration smoothing
         + stance no-slip and foot-height hinges + joint-manifold weld

with the joint torques and ground reaction forces eliminated frame by frame
in closed form (a Jacobi-equilibrated 42x42 Cholesky solve, then a second
solve on the active set left after projecting the forces onto their box and
friction polyhedron). The implicit-Euler derivatives of q make the EOM
residual of frame t depend on q[t-2..t], so the Gauss-Newton curvature stays
inside the bandwidth-3 block-banded structure that every LM step hands to
the banded solve.

Every function takes a batch of trials: q (B, N, 54), ``KineticData``
leaves with a leading trial axis, and a per-trial annealing scale (B,),
where the JAX package vmaps one trial. Derivatives:

* the physics gradient (EOM, torque, smoothing and stance terms) is one
  reverse pass of autograd over the closed-form dynamics
  (``dynamics/eom.py``), through both per-frame factorizations, where the
  JAX package takes ``jax.grad``;
* the frozen EOM curvature blocks are computed once per solve with
  ``torch.func.jacfwd`` of the closed-form dynamics, vmapped over all B*N
  frames at once. The JAX package chunks that assembly by 8 frames
  (``curv_chunk``) to fit 16 GB of device memory; unchunked it peaks at
  7.3 GiB at 10 trials x 64 frames on an 80 GB card (PERF.md), so the
  port has no chunking and no ``curv_chunk`` field.

Options: the epsilon-relaxed complementarity penalty (``enable_lcp``,
its gradient through the eliminated GRFz and the foot heights by autograd,
no curvature term, as in JAX), the 3D tracking mode
(``use_2d_reprojections=False``: the caller zeroes the measurement
weights; a weighted quadratic pull of the relative angles to the
kinematic warm start replaces the marker-smoothing energy) and the
fixed-length driver (``make_solver(driver="scan")``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..dynamics import eom as dyn
from ..models import noise as noise_tables
from ..models import skeleton as sk
from ..models.params import SubjectParams
from ..ops import banded
from ..ops.banded import chol_nan
from ..utils.device import FORWARD_AD, Tables
from . import gn
from . import kinematic as kin

NQ = 54
STAGES: Tuple[Tuple[float, int], ...] = ((3.0, 40), (1.7, 40), (1.0, 100))


class KineticData(NamedTuple):
    """Per-trial physics arrays with a leading trial axis."""
    base: kin.KinematicData
    stance: torch.Tensor        # (B, N, 4) 1.0 while a foot is in stance
    grf_fixed: torch.Tensor     # (B, N, 4) fixed GRFz profile (body weights)
    grf_xy_fixed: torch.Tensor  # (B, N, 4, 4) fixed polygon components
    use_fixed_grf: torch.Tensor  # (B,) 1.0 -> use the fixed profiles
    q_warm: torch.Tensor        # (B, N, 54) kinematic warm start
    # quadratic torque anchor (GRF re-estimation mode)
    tau_anchor: torch.Tensor = np.zeros((1, 1, dyn.N_TAU))  # (B, N, 22)
    tau_anchor_weight: torch.Tensor = np.zeros(1)           # (B,)
    ground_z: torch.Tensor = np.zeros(1)                    # (B,) metres


@dataclasses.dataclass(frozen=True)
class KineticConfig:
    """The JAX package's ``KineticConfig`` (same fields and defaults; the
    reasons for each value are documented there), without ``curv_chunk``
    (see the module docstring)."""
    fisheye: bool = True
    robust: bool = True
    meas_loss: str = "huber"
    meas_guard: float = 2.0
    use_gmm: bool = False
    kinetic_dataset: bool = False
    limit_penalty: float = 1e5
    tikhonov: float = 1e-2
    curvature_floor: float = 1e-3
    eom_weight: float = 1e4
    eom_deadband: float = 2.0
    eom_floor_relative: bool = True
    base_deadband: Optional[float] = 0.0
    keep_acc_model: bool = False
    torque_weight: float = 1.0
    smooth_weight_scale: float = 0.1
    no_slip_penalty: float = 1e3
    foot_height_penalty: float = 1e4
    foot_height_bound: float = 0.1
    friction_coeff: float = 0.8
    weld_weight: float = 1e6
    grf_max: float = 5.0
    min_grf_z: float = 0.01
    enable_lcp: bool = False
    lcp_eps: float = 1e-3
    lcp_penalty: float = 1e5
    cam_multipliers: Tuple[float, ...] = ()
    use_2d_reprojections: bool = True


def _t(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 b for b (..., n)."""
    return torch.cholesky_solve(b[..., None], L)[..., 0]


def _equilibrated_factor(AtA: torch.Tensor):
    """Jacobi scale sc = diag(AtA)^-1/2 and the Cholesky factor of
    sc AtA sc + 128 eps I (NaN where it fails)."""
    sc = torch.rsqrt(torch.diagonal(AtA, dim1=-2, dim2=-1))
    eye = torch.eye(AtA.shape[-1], dtype=AtA.dtype, device=AtA.device)
    bump = 128.0 * torch.finfo(AtA.dtype).eps
    return sc, chol_nan(AtA * sc[..., :, None] * sc[..., None, :]
                        + bump * eye)


class KineticFTE:
    """Cost and normal-equation functions of the physics-based FTE for one
    (config, subject) pair, batched over trials."""

    def __init__(self, config: KineticConfig, subject: SubjectParams):
        self.config = config
        self.subject = subject
        self._kin = kin.KinematicFTE(kin.KinematicConfig(
            fisheye=config.fisheye, robust=config.robust,
            loss=config.meas_loss, use_gmm=config.use_gmm,
            kinetic_dataset=config.kinetic_dataset,
            limit_penalty=config.limit_penalty, tikhonov=config.tikhonov,
            curvature_floor=config.curvature_floor,
            cam_multipliers=config.cam_multipliers,
            # the kinetic stage carries its own weld term (_weld_cost)
            weld_weight=0.0), subject)
        self.force_scale = subject.total_mass * dyn.GRAVITY
        self.tables = Tables()

    def _deadband(self, like: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-coordinate (54,) or scalar epsilon-insensitive slack band,
        None when disabled; built once per dtype and device."""
        cfg = self.config
        if cfg.eom_deadband <= 0.0:
            return None

        def make():
            if not cfg.eom_floor_relative:
                return np.asarray(cfg.eom_deadband)
            db = cfg.eom_deadband * noise_tables.EOM_SLACK_FLOOR
            if cfg.base_deadband is not None:
                db = np.concatenate([np.full(3, cfg.base_deadband), db[3:]])
            return db

        return self.tables.get("eom_deadband", like, make)

    # ------------------------------------------------------------------
    # per-frame torque/GRF elimination
    # ------------------------------------------------------------------
    def _force_columns(self, q_t: torch.Tensor) -> torch.Tensor:
        """(..., 54, 20) generalized-force columns of [GRFz (4); GRFxy
        (16, foot-major)] in body-weight units: J_foot^T e_z and
        J_foot^T D_i with the closed-form foot Jacobians."""
        _, Jf = dyn.feet_and_jacobian(q_t, self.subject)    # (..., 4, 3, 54)
        D = dyn.tables(self.subject, q_t).polygon
        cols_xy = torch.einsum("...fik,di->...kfd", Jf, D)
        return torch.cat([Jf[..., 2, :].mT,
                          cols_xy.reshape(cols_xy.shape[:-2] + (16,))], -1)

    @staticmethod
    def _kinematics(q3: torch.Tensor, h: torch.Tensor):
        """q_t, dq_t, ddq_t (B, N, 54) from the stacked frames (t-2, t-1,
        t) with the implicit-Euler stencils; h (B,)."""
        h = h.view(-1, 1, 1)
        dq = (q3[..., 2, :] - q3[..., 1, :]) / h
        ddq = (q3[..., 2, :] - 2 * q3[..., 1, :] + q3[..., 0, :]) / (h * h)
        return q3[..., 2, :], dq, ddq

    def _wreg(self, data: KineticData, like: torch.Tensor) -> torch.Tensor:
        """(B, 1, 42) ridge of the reduced normal matrix: torque weight
        (+ anchor weight) on the torques, 1e-3 on the free forces."""
        wa = _t(data.tau_anchor_weight, like).reshape(-1, 1)
        B = like.shape[0]
        return torch.cat([
            torch.full((B, dyn.N_TAU), self.config.torque_weight,
                       dtype=like.dtype, device=like.device) + wa,
            torch.full((B, 20), 1e-3, dtype=like.dtype,
                       device=like.device)], -1)[:, None, :]

    def _frame_system(self, q3: torch.Tensor, data: KineticData):
        """The shared per-frame elimination system for q3 (B, N, 3, 54).

        Returns (M, lhs_eff, A, Cg, gmask, sc, L, wreg) with L the Cholesky
        factor of the Jacobi-equilibrated reduced normal matrix
        ``we A^T A + diag(wreg)``."""
        cfg = self.config
        q_t, dq_t, ddq_t = self._kinematics(q3, data.base.h)
        M, cg = dyn.mass_and_bias(q_t, dq_t, self.subject)
        lhs = (_mv(M, ddq_t) + cg) / self.force_scale
        B, N = q3.shape[0], q3.shape[1]
        Btau = dyn.tables(self.subject, q3).torque_map
        Cg = self._force_columns(q_t)                           # (B,N,54,20)
        stance = data.stance
        gmask = torch.cat([stance, stance.repeat_interleave(4, -1)], -1)
        fixed = _t(data.use_fixed_grf, q3).view(-1, 1, 1)
        Cg_act = Cg * (gmask * (1.0 - fixed))[..., None, :]
        A = torch.cat([Btau.expand(B, N, NQ, dyn.N_TAU), Cg_act], -1)
        zfix = torch.cat([data.grf_fixed, data.grf_xy_fixed.reshape(
            B, N, 16)], -1)
        lhs_eff = lhs - fixed * _mv(Cg, zfix * gmask)
        wreg = self._wreg(data, q3)
        AtA = cfg.eom_weight * (A.mT @ A) + torch.diag_embed(wreg)
        sc, L = _equilibrated_factor(AtA)
        return M, lhs_eff, A, Cg, gmask, sc, L, wreg

    def _frame_solve(self, q3: torch.Tensor, data: KineticData,
                     anchor: Optional[torch.Tensor] = None):
        """Per-frame elimination with a one-step active-set refinement
        (q3 (B, N, 3, 54)).

        Pass 1 solves the unconstrained reduced system and projects the GRF
        onto its box and friction polyhedron; pass 2 fixes the projected
        components at their bounds and re-solves the remaining free (tau,
        grf) subsystem, which restores first-order optimality of the
        eliminated variables (the envelope theorem the outer gradient relies
        on). The free-set masks carry no gradient.

        Returns (slack (B,N,54), tau (B,N,22), gz_out (B,N,4), gxy_out
        (B,N,4,4), aux = (A_act, sc2, L2, g_all)) with the pass-2 masked
        factorization and g_all the total applied force components."""
        cfg = self.config
        dtype = q3.dtype
        B, N = q3.shape[0], q3.shape[1]
        M, lhs_eff, A, Cg, gmask, sc, L, wreg = self._frame_system(q3, data)
        stance = data.stance
        free_grf = 1.0 - _t(data.use_fixed_grf, q3).view(-1, 1, 1)
        we = cfg.eom_weight
        wa = _t(data.tau_anchor_weight, q3).view(-1, 1, 1)

        def anchored(rhs):
            if anchor is None:
                return rhs
            return torch.cat([rhs[..., :dyn.N_TAU] + wa * anchor,
                              rhs[..., dyn.N_TAU:]], -1)

        rhs = anchored(we * _mv(A.mT, lhs_eff))
        z0 = sc * _cho_solve(L, sc * rhs)
        g0z = z0[..., dyn.N_TAU:dyn.N_TAU + 4]
        g0xy = z0[..., dyn.N_TAU + 4:].reshape(B, N, 4, 4)
        # pass-1 projection: box + friction polyhedron
        gz_c = torch.clamp(g0z, cfg.min_grf_z, cfg.grf_max) * stance \
            * free_grf
        gxy_c = torch.clamp(g0xy, 0.0, cfg.grf_max) * stance[..., None] \
            * free_grf[..., None]
        cone = cfg.friction_coeff * gz_c / torch.clamp(gxy_c.sum(-1),
                                                       min=1e-9)
        cs = torch.clamp(cone, max=1.0)
        gxy_c = gxy_c * cs[..., None]
        # free set: strictly-inside components of cone-feasible feet
        with torch.no_grad():
            cone_free = cs >= 1.0 - 1e-6
            free_z = ((g0z > cfg.min_grf_z) & (g0z < cfg.grf_max)
                      & cone_free).to(dtype) * stance * free_grf
            free_xy = ((g0xy > 0.0) & (g0xy < cfg.grf_max)
                       & cone_free[..., None]).to(dtype) \
                * stance[..., None] * free_grf[..., None]
            free = torch.cat([free_z, free_xy.reshape(B, N, 16)], -1)
            col_act = torch.cat([torch.ones_like(free[..., :1]).expand(
                B, N, dyn.N_TAU), free], -1)
        g_fix = (1.0 - free) * torch.cat([gz_c, gxy_c.reshape(B, N, 16)],
                                         -1)
        A_act = A * col_act[..., None, :]
        lhs2 = lhs_eff - _mv(Cg, g_fix)
        AtA2 = we * (A_act.mT @ A_act) + torch.diag_embed(wreg)
        sc2, L2 = _equilibrated_factor(AtA2)
        rhs2 = anchored(we * _mv(A_act.mT, lhs2))
        z2 = sc2 * _cho_solve(L2, sc2 * rhs2)
        tau = z2[..., :dyn.N_TAU]
        # safety clip (a re-solved free component can exit its box)
        g2 = torch.clamp(z2[..., dyn.N_TAU:] * free, 0.0, cfg.grf_max) * free
        g_tot = g2 + g_fix
        slack = lhs_eff - _mv(A, torch.cat([tau, g_tot], -1))
        fixed = 1.0 - free_grf
        gz_out = fixed * data.grf_fixed * stance + g_tot[..., :4]
        gxy_out = fixed[..., None] * data.grf_xy_fixed * stance[..., None] \
            + g_tot[..., 4:].reshape(B, N, 4, 4)
        zfix = torch.cat([data.grf_fixed, data.grf_xy_fixed.reshape(
            B, N, 16)], -1)
        g_all = g_tot + fixed * zfix * gmask
        return slack, tau, gz_out, gxy_out, (A_act, sc2, L2, g_all)

    def _projector(self, A_act, sc2, L2) -> torch.Tensor:
        """Symmetric PSD residual projector P = I - we A K A^T of the
        pass-2 elimination (K the inverse reduced normal matrix), (B, N,
        54, 54): the left factor of every EOM curvature kernel."""
        Asc = A_act * sc2[..., None, :]
        X = torch.cholesky_solve(Asc.mT, L2)                  # (B, N, 42, 54)
        eye = torch.eye(NQ, dtype=Asc.dtype, device=Asc.device)
        return eye - self.config.eom_weight * (Asc @ X)

    def _frame_curv_channels(self, q3: torch.Tensor, data: KineticData
                             ) -> torch.Tensor:
        """(B, N, 3, 54, 54) projected EOM residual Jacobians
        P @ dF/dq_{t-a} of F(q3) = (M(q_t) ddq + bias(q_t, dq_t)) / fs:
        the 1/h^2 mass channel, the 1/h velocity channel dbias/ddq and the
        direct channel d(M ddq + bias)/dq_t, minus the force-column channel
        d(Cg(q) g_all)/dq_t with the eliminated forces frozen."""
        B, N = q3.shape[0], q3.shape[1]
        h = data.base.h.view(-1, 1, 1, 1)
        q_t, dq_t, ddq_t = self._kinematics(q3, data.base.h)
        subject = self.subject

        def F(qq, dd, ddq):
            M, cg = dyn.mass_and_bias(qq, dd, subject)
            return _mv(M, ddq) + cg

        flat = lambda x: x.reshape((B * N,) + x.shape[2:])
        with FORWARD_AD:
            D1, Cd = torch.func.vmap(torch.func.jacfwd(F, argnums=(0, 1)))(
                flat(q_t), flat(dq_t), flat(ddq_t))
        D1, Cd = (x.reshape(B, N, NQ, NQ) for x in (D1, Cd))
        M = dyn.mass_matrix(q_t, subject)
        _, _, _, _, (A_act, sc2, L2, g_all) = self._frame_solve(q3, data)
        with FORWARD_AD:
            D2 = torch.func.vmap(torch.func.jacfwd(
                lambda qq, g: _mv(self._force_columns(qq), g)))(
                    flat(q_t), flat(g_all)).reshape(B, N, NQ, NQ)
        fs = self.force_scale
        h2 = h * h
        J0 = (M / h2 + Cd / h + D1) / fs - D2
        J1 = (-2.0 * M / h2 - Cd / h) / fs
        J2 = (M / h2) / fs
        P = self._projector(A_act, sc2, L2)
        return torch.stack([P @ J0, P @ J1, P @ J2], 2)

    @staticmethod
    def _q3_stack(q: torch.Tensor) -> torch.Tensor:
        """(B, N, 3, 54): frames (t-2, t-1, t) with edge replication."""
        qm1 = torch.cat([q[:, :1], q[:, :-1]], 1)
        qm2 = torch.cat([q[:, :1], q[:, :1], q[:, :-2]], 1)
        return torch.stack([qm2, qm1, q], 2)

    @staticmethod
    def _eom_valid(data: KineticData) -> torch.Tensor:
        """(B, N): the EOM residual of frame t is active when frames
        t-2..t are real."""
        fv = data.base.frame_valid
        v = torch.zeros_like(fv)
        if fv.shape[1] > 2:
            v[:, 2:] = fv[:, 2:] * fv[:, 1:-1] * fv[:, :-2]
        return v

    def _anchor(self, q: torch.Tensor, data: KineticData) -> torch.Tensor:
        return _t(data.tau_anchor, q).expand(q.shape[0], q.shape[1],
                                             dyn.N_TAU)

    # ------------------------------------------------------------------
    # cost terms
    # ------------------------------------------------------------------
    @staticmethod
    def _eom_ramp(s: torch.Tensor) -> torch.Tensor:
        """(1/s)^4 per lane: the penalty-continuation ramp of the EOM slack
        and weld weights, tied to the robust loss's annealing scale."""
        return kin._inv_pow4(s)

    def _physics_costs(self, q: torch.Tensor, data: KineticData,
                       loss_scale=1.0):
        """(eom_cost (B,), torque_cost (B,), (slack, tau, gz, gxy))."""
        cfg = self.config
        s = kin._per_lane(loss_scale, q)
        valid = self._eom_valid(data)[..., None]
        anchor = self._anchor(q, data)
        slack, tau, gz, gxy, _ = self._frame_solve(self._q3_stack(q), data,
                                                   anchor)
        db = self._deadband(q)
        sl = slack if db is None else torch.clamp(slack.abs() - db, min=0.0)
        eom_cost = self._eom_ramp(s) * cfg.eom_weight * (
            valid * sl * sl).sum((1, 2))
        torque_cost = cfg.torque_weight * (valid * tau * tau).sum((1, 2))
        d = tau - anchor
        anchor_cost = _t(data.tau_anchor_weight, q).view(-1) * (
            valid * d * d).sum((1, 2))
        if cfg.enable_lcp:
            torque_cost = torque_cost + self._lcp_cost(q, gz, data)
        return eom_cost, torque_cost + anchor_cost, (slack, tau, gz, gxy)

    def _lcp_cost(self, q: torch.Tensor, gz: torch.Tensor,
                  data: KineticData) -> torch.Tensor:
        """Epsilon-relaxed complementarity (JAX ``kinetic.py:526-536``): a
        loaded foot must touch the ground, GRFz * max(height, 0) <= eps,
        as a quadratic penalty on real frames, (B,). ``gz`` (B, N, 4) is
        the eliminated GRFz, so the gradient flows through the force and
        through the foot kinematics."""
        cfg = self.config
        pts = dyn.foot_points(q, self.subject)                  # (B,N,4,3)
        hpos = torch.clamp(pts[..., 2] - _t(data.ground_z, q).view(-1, 1, 1),
                           min=0.0)
        viol = torch.clamp(gz * hpos - cfg.lcp_eps, min=0.0)
        return cfg.lcp_penalty * (data.base.frame_valid[..., None]
                                  * viol * viol).sum((1, 2))

    def _smooth_cost(self, q: torch.Tensor, data: KineticData
                     ) -> torch.Tensor:
        """Marker-position second-difference energy, weighted
        0.1 fps^-2, (B,)."""
        if q.shape[1] < 3:
            return q.new_zeros(q.shape[0])
        h = data.base.h
        fps = 1.0 / h
        pts = sk.fk_markers(q, self.subject)                 # (B, N, 24, 3)
        acc = (fps * fps).view(-1, 1, 1, 1) \
            * (pts[:, 2:] - 2 * pts[:, 1:-1] + pts[:, :-2])
        fv = data.base.frame_valid
        v = (fv[:, 2:] * fv[:, 1:-1] * fv[:, :-2])[..., None, None]
        energy = (v * acc * acc).sum((1, 2, 3))
        return self.config.smooth_weight_scale * (h * h) * energy

    def _stance_penalties(self, q: torch.Tensor, data: KineticData
                          ) -> torch.Tensor:
        """No-slip (foot xy speed <= 1 m/s) and stance foot-height box
        penalties, (B,)."""
        cfg = self.config
        h = data.base.h.view(-1, 1, 1)
        pts = dyn.foot_points(q, self.subject)               # (B, N, 4, 3)
        fv = data.base.frame_valid
        heights = pts[..., 2] - _t(data.ground_z, q).view(-1, 1, 1)
        hviol = torch.clamp(heights.abs() - cfg.foot_height_bound, min=0.0)
        height_pen = cfg.foot_height_penalty * (
            fv[..., None] * data.stance * hviol * hviol).sum((1, 2))
        vel_xy = (pts[:, 1:, :, :2] - pts[:, :-1, :, :2]) / h[..., None]
        speed = torch.sqrt((vel_xy * vel_xy).sum(-1) + 1e-12)
        sviol = torch.clamp(speed - 1.0, min=0.0)
        slip_pen = cfg.no_slip_penalty * (
            fv[:, 1:, None] * data.stance[:, 1:] * sviol * sviol).sum((1, 2))
        return height_pen + slip_pen

    def _penalty_curvature(self, q: torch.Tensor, data: KineticData):
        """GN curvature of the stance penalties with the closed-form foot
        Jacobians: (Hdiag_add (B,N,54,54), Hl1_add (B,N,54,54), the (t,
        t-1) blocks of the slip term stored at column t-1)."""
        cfg = self.config
        dtype = q.dtype
        h = data.base.h.view(-1, 1, 1)
        fv = data.base.frame_valid
        pts, Jf = dyn.feet_and_jacobian(q, self.subject)
        hviol = torch.clamp((pts[..., 2] - _t(data.ground_z, q).view(
            -1, 1, 1)).abs() - cfg.foot_height_bound, min=0.0)
        act_h = (hviol > 0).to(dtype) * data.stance * fv[..., None]
        Jz = Jf[..., 2, :]                                    # (B, N, 4, 54)
        Hd = 2.0 * cfg.foot_height_penalty * torch.einsum(
            "btf,btfk,btfl->btkl", act_h, Jz, Jz)
        vel = (pts[:, 1:, :, :2] - pts[:, :-1, :, :2]) / h[..., None]
        speed = torch.sqrt((vel * vel).sum(-1) + 1e-12)
        sviol = torch.clamp(speed - 1.0, min=0.0)
        act_s = (sviol > 0).to(dtype) * data.stance[:, 1:] * fv[:, 1:, None]
        vhat = vel / speed[..., None]
        u_t = 1.0 / h[..., None] * torch.einsum(
            "btfd,btfdk->btfk", vhat, Jf[:, 1:, :, :2, :])
        u_p = 1.0 / h[..., None] * torch.einsum(
            "btfd,btfdk->btfk", vhat, Jf[:, :-1, :, :2, :])
        ws2 = 2.0 * cfg.no_slip_penalty
        zero = torch.zeros_like(Hd[:, :1])
        Hd = Hd + torch.cat([zero, ws2 * torch.einsum(
            "btf,btfk,btfl->btkl", act_s, u_t, u_t)], 1)
        Hd = Hd + torch.cat([ws2 * torch.einsum(
            "btf,btfk,btfl->btkl", act_s, u_p, u_p), zero], 1)
        Hl1 = torch.cat([-ws2 * torch.einsum("btf,btfk,btfl->btkl", act_s,
                                             u_t, u_p), zero], 1)
        return Hd, Hl1

    def _smooth_curvature(self, q: torch.Tensor, data: KineticData):
        """GN curvature of the smoothing energy: the (1, -2, 1) stencil
        spread of S_t = sum_m Jm^T Jm. Returns (Hd, Hl1, Hl2)."""
        cfg = self.config
        N = q.shape[1]
        h = data.base.h
        _, Jm = sk.fk_markers_and_jacobian(q, self.subject)
        S = torch.einsum("btmik,btmil->btkl", Jm, Jm)
        valid = self._eom_valid(data)
        fps2 = 1.0 / (h * h)
        S = S * (2.0 * cfg.smooth_weight_scale * fps2).view(-1, 1, 1, 1) \
            * valid[..., None, None]
        c = (1.0, -2.0, 1.0)
        Hd = torch.zeros_like(S)
        Hl = [torch.zeros_like(S), torch.zeros_like(S)]
        for a in range(3):
            for b in range(a, 3):
                seg = torch.cat([S[:, b:], torch.zeros_like(S[:, :b])], 1) \
                    if N - b > 0 else torch.zeros_like(S)
                if b == a:
                    Hd = Hd + c[a] * c[b] * seg
                else:
                    Hl[b - a - 1] = Hl[b - a - 1] + c[a] * c[b] * seg
        return Hd, Hl[0], Hl[1]

    def _track_tables(self, like: torch.Tensor):
        """(A (54, 54) relative-angle map, M (54,) tracking weights) of the
        3D tracking term."""
        return (self.tables.get("A_rel_full", like, lambda: sk._A_REL_FULL),
                self.tables.get("kinematic_m", like,
                                lambda: noise_tables.KINEMATIC_M))

    def _track_cost(self, q: torch.Tensor, data: KineticData
                    ) -> torch.Tensor:
        """Weighted 3D tracking of the kinematic warm start over the
        relative angles (JAX ``kinetic.py:657-666``, reference
        ``kinematic_cost``), (B,): the tracking mode's stand-in for the
        reprojections."""
        A, M = self._track_tables(q)
        r = torch.einsum("ij,btj->bti", A, q - data.q_warm)
        return (data.base.frame_valid[..., None] * M * r * r).sum((1, 2))

    def _extra_cost(self, q: torch.Tensor, data: KineticData
                    ) -> torch.Tensor:
        """The marker-smoothing energy with 2D reprojections, the 3D
        tracking term without (JAX ``kinetic.py:691-698``)."""
        if self.config.use_2d_reprojections:
            return self._smooth_cost(q, data)
        return self._track_cost(q, data)

    def _weld_cost(self, q: torch.Tensor, data: KineticData,
                   loss_scale=1.0) -> torch.Tensor:
        """Quadratic pin of the joint manifold (``sk.joint_residuals``),
        continuation-scaled like the EOM, (B,)."""
        s = kin._per_lane(loss_scale, q)
        r = sk.joint_residuals(q)
        return self._eom_ramp(s) * self.config.weld_weight * (
            data.base.frame_valid[..., None] * r * r).sum((1, 2))

    def _cost(self, q: torch.Tensor, data: KineticData,
              loss_scale=1.0) -> torch.Tensor:
        """(B,) total cost, the LM loop's accept/reject arbiter."""
        base_cost = self._kin._cost(q, data.base, loss_scale)
        if self.config.keep_acc_model:
            acc = q.new_zeros(q.shape[0])
        else:
            acc = kin.acc_cost(q, data.base.h, data.base.acc_weight,
                               data.base.frame_valid)
        eom_cost, torque_cost, _ = self._physics_costs(q, data, loss_scale)
        pen = self._stance_penalties(q, data) \
            + self._weld_cost(q, data, loss_scale)
        extra = self._extra_cost(q, data)
        return base_cost - acc + eom_cost + torque_cost + extra + pen

    def objective(self, q: torch.Tensor, data: KineticData) -> torch.Tensor:
        """(B,) reference-scaled objective 1e-3 * (measurement + pose +
        prior + 1e4 slack)."""
        return 1e-3 * (self._cost(q, data)
                       - self._kin._limit_cost(q, data.base.frame_valid)
                       - self._stance_penalties(q, data)
                       - self._weld_cost(q, data))

    def forces(self, q: torch.Tensor, data: KineticData):
        """Solved per-frame (tau (B,N,22), grf_z (B,N,4), grf_xy
        (B,N,4,4)) at q, in body-weight units."""
        _, _, extras = self._physics_costs(q, data)
        return extras[1], extras[2], extras[3]

    # ------------------------------------------------------------------
    # normal equations
    # ------------------------------------------------------------------
    @torch.no_grad()
    def eom_curvature_blocks(self, q: torch.Tensor, data: KineticData):
        """Exact-GN banded blocks of the eliminated-EOM term at q: per
        residual frame r the projected Jacobians PJ[r, a] give block
        (r-a, r-b) the contribution 2 we PJ[r,a]^T PJ[r,b]; rows inside the
        slack deadband are masked out. The solver computes them once at the
        warm start and reuses them every iteration (frozen Gauss-Newton).

        Returns (Hdiag_add (B,N,54,54), Hl1_add, Hl2_add)."""
        cfg = self.config
        B, N = q.shape[0], q.shape[1]
        q3 = self._q3_stack(q)
        PJ = self._frame_curv_channels(q3, data)
        db = self._deadband(q)
        if db is not None:
            slack = self._frame_solve(q3, data, self._anchor(q, data))[0]
            PJ = PJ * (slack.abs() > db).to(q.dtype)[:, :, None, :, None]
        w = 2.0 * cfg.eom_weight * self._eom_valid(data)        # (B, N)
        Hd = q.new_zeros((B, N, NQ, NQ))
        Hl = [q.new_zeros((B, N, NQ, NQ)) for _ in range(2)]
        for a in range(3):
            for b in range(a, 3):
                prod = torch.einsum("br,brik,bril->brkl", w, PJ[:, :, a],
                                    PJ[:, :, b])
                if b == a:
                    Hd[:, :N - a] += prod[:, a:]
                else:
                    # block (r-a, r-b), lower band b-a, column t = r-b
                    Hl[b - a - 1][:, :N - b] += prod[:, b:]
        return Hd, Hl[0], Hl[1]

    def _normal(self, q: torch.Tensor, data: KineticData, loss_scale=1.0,
                eom_blocks=None):
        """Gradient (B, N, 54) and block-banded GN curvature of the cost;
        ``eom_blocks`` are the frozen EOM blocks (computed at q when
        None)."""
        cfg = self.config
        s = kin._per_lane(loss_scale, q)
        q = q.detach()
        base = data.base
        g_base, H_base = self._kin._normal(q, base, s)
        if cfg.keep_acc_model:
            g, Hdiag, Hlower = g_base, H_base.diag, H_base.lower
        else:
            # the kinematic constant-acceleration quadratic is not part of
            # the kinetic objective
            H_acc = kin.acc_banded(base.h, base.acc_weight, base.frame_valid)
            g = g_base - self._kin.acc_gradient(q, base, H_acc)
            Hdiag = H_base.diag - H_acc.diag
            Hlower = H_base.lower - H_acc.lower

        # exact gradient of the physics, smoothing (or tracking) and stance
        # terms: one reverse pass
        with torch.enable_grad():
            qg = q.clone().requires_grad_(True)
            e, t, _ = self._physics_costs(qg, data, s)
            total = (e + t) + self._extra_cost(qg, data) \
                + self._stance_penalties(qg, data)
            g = g + torch.autograd.grad(total.sum(), qg)[0]

        # joint-structure weld: exact gradient + frame-local GN curvature
        fv = base.frame_valid
        rw, Jw = sk.joint_residuals_and_jacobian(q)           # (B,N,74,54)
        ww = (2.0 * cfg.weld_weight * self._eom_ramp(s)).view(-1, 1, 1)
        g = g + ww * fv[..., None] * torch.einsum("btrj,btr->btj", Jw, rw)
        Hdiag_w = ww[..., None] * fv[..., None, None] * (Jw.mT @ Jw)

        if eom_blocks is None:
            eom_blocks = self.eom_curvature_blocks(q, data)
        ed, el1, el2 = eom_blocks
        ramp = self._eom_ramp(s).view(-1, 1, 1, 1)
        Hdiag = Hdiag + ramp * ed + Hdiag_w
        Hp_d, Hp_l1 = self._penalty_curvature(q, data)
        Hdiag = Hdiag + Hp_d
        l1, l2 = Hlower[:, 0] + ramp * el1 + Hp_l1, Hlower[:, 1] + ramp * el2
        if cfg.use_2d_reprojections:
            Hs_d, Hs_l1, Hs_l2 = self._smooth_curvature(q, data)
            Hdiag = Hdiag + Hs_d
            l1, l2 = l1 + Hs_l1, l2 + Hs_l2
        else:
            # tracking: the exact curvature 2 A^T diag(M) A on real frames
            A, M = self._track_tables(q)
            Htrack = 2.0 * torch.einsum("ia,i,ib->ab", A, M, A)
            Hdiag = Hdiag + fv[..., None, None] * Htrack
        Hlower = torch.stack([l1, l2, Hlower[:, 2]], 1)
        return g, banded.BlockBanded(diag=Hdiag, lower=Hlower)

    # ------------------------------------------------------------------
    def make_solver(self, stages: Tuple[Tuple[float, int], ...] = STAGES,
                    ftol: float = 1e-9, lam0: float = 10.0,
                    linear_solver: Optional[str] = None,
                    driver: str = "while"):
        """Annealed LM solve from a kinematic warm start. Returns run(q0,
        data, eom_blocks=None) -> ``gn.LMState``, batched over the leading
        trial axis; the frozen EOM blocks are computed at q0 unless given.
        ``linear_solver`` is passed to ``gn.LMConfig`` (None: the default
        for the tensors' device, the hand-written kernel on the card).
        ``driver`` (JAX ``kinetic.py:883``): "while" (``gn.lm_solve_annealed``)
        or "scan" (``gn.lm_solve_annealed_scan``: every step of the
        schedule, no host-side test per step); any other raises
        ``ValueError``."""
        if driver not in ("while", "scan"):
            raise ValueError(f"driver={driver!r}: one of 'while', 'scan'")
        solver = gn.lm_solve_annealed_scan if driver == "scan" \
            else gn.lm_solve_annealed
        cfg = self.config

        def run(q0: torch.Tensor, data: KineticData, eom_blocks=None
                ) -> gn.LMState:
            blocks = eom_blocks if eom_blocks is not None else \
                self.eom_curvature_blocks(q0, data)
            base = data.base
            # damping floor at the constant-acceleration curvature scale:
            # flat directions (welded-joint coordinates) otherwise take huge
            # trial steps under relative Marquardt damping
            H_acc = kin.acc_banded(base.h, base.acc_weight, base.frame_valid)
            floor = torch.clamp(torch.diagonal(H_acc.diag, dim1=-2,
                                               dim2=-1), min=1e-8)
            guard_fn, guard_cap = None, None
            if cfg.meas_guard > 0.0:
                # measurement + prior cost at scale 1 (the kinematic cost
                # without its constant-acceleration term)
                def guard_fn(qq):
                    return self._kin._cost(qq, base, 1.0) - kin.acc_cost(
                        qq, base.h, base.acc_weight, base.frame_valid)
                # q0.shape[1]: the padded frame count of one trial
                guard_cap = cfg.meas_guard * guard_fn(q0) \
                    + 10.0 * q0.shape[1]
            return solver(
                lambda qq, s: self._cost(qq, data, s),
                lambda qq, s: self._normal(qq, data, s, eom_blocks=blocks),
                q0, stages,
                gn.LMConfig(ftol=ftol, lam0=lam0, diag_floor=floor,
                            step_cap=0.25, linear_solver=linear_solver),
                guard_fn=guard_fn, guard_cap=guard_cap)

        return run


def stance_matrix(contacts: dict, start_frame: int, n_frames: int
                  ) -> np.ndarray:
    """(N, 4) stance indicator from an autogen-contact.json dict."""
    out = np.zeros((n_frames, dyn.N_FEET))
    for i, name in enumerate(dyn.FOOT_NAMES):
        seqs = contacts.get(name)
        if seqs is None:
            continue
        for seq in seqs:
            s = max(seq[0] - start_frame, 0)
            e = min(seq[1] - start_frame + 1, n_frames)
            out[s:e, i] = 1.0
    return out


def prune_stance(stance: np.ndarray, q_warm: np.ndarray,
                 subject: SubjectParams, h: float,
                 max_median_speed: float = 4.0,
                 foot_speed: Optional[np.ndarray] = None,
                 max_edge_speed: float = 2.0) -> np.ndarray:
    """Drop physically impossible stance windows and trim swing-phase edges:
    a window whose median warm-start foot xy-speed exceeds
    ``max_median_speed`` (m/s) is removed, and edge frames faster than
    ``max_edge_speed`` are trimmed off. ``foot_speed`` (N, 4) supplies
    precomputed xy speeds."""
    if foot_speed is not None:
        v = np.asarray(foot_speed)
    else:
        pts = dyn.foot_points(torch.as_tensor(np.asarray(q_warm),
                                              dtype=torch.float64),
                              subject).numpy()
        v = np.zeros(pts.shape[:2])
        v[1:] = np.linalg.norm((pts[1:, :, :2] - pts[:-1, :, :2]) / h,
                               axis=-1)
        v[0] = v[1] if len(v) > 1 else 0.0
    out = stance.copy()
    for f in range(stance.shape[1]):
        on = np.flatnonzero(stance[:, f] > 0)
        if on.size == 0:
            continue
        splits = np.split(on, np.flatnonzero(np.diff(on) > 1) + 1)
        for run in splits:
            if np.median(v[run, f]) > max_median_speed:
                out[run, f] = 0.0
                continue
            s_i, e_i = 0, len(run)
            while s_i < e_i and v[run[s_i], f] > max_edge_speed:
                s_i += 1
            while e_i > s_i and v[run[e_i - 1], f] > max_edge_speed:
                e_i -= 1
            out[run[:s_i], f] = 0.0
            out[run[e_i:], f] = 0.0
    return out
