"""Forward dynamics simulation with penalty ground contact.

Port of ``cheetah_pose_estimation_tpu/dynamics/simulate.py`` (the whole
file): RK4 rollout of the closed-form EOM (``dynamics/eom.py``) with a
smooth spring-damper and regularised-Coulomb contact at the feet, the
counterpart of the reference's drop test (``cheetah.py:653-704``).

Where the JAX package differentiates the feet (``jax.jvp`` for their
velocities, ``jax.grad`` of the contact work for its generalised force,
``simulate.py:36-70``), the port uses the feet's closed-form Jacobian
(``eom.feet_and_jacobian``): velocities J dq, generalised force J^T F. The
54x54 solve of each derivative is a dense Cholesky, as in JAX (no Pallas
kernel there). JAX scans 20 RK4 steps per jitted call; here every step is
eager work on the host's schedule (four derivatives a step), with one copy
to the host per recorded state. The state's dtype is ``dtype`` (float64
by default: the loop is bound by the host, not by the arithmetic).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.params import NQ, SubjectParams
from ..utils.device import DeviceLike, constant, resolve_device
from . import eom as dyn


class ContactParams(NamedTuple):
    stiffness: float = 20000.0    # N/m per foot
    damping: float = 100.0        # N s/m
    friction_mu: float = 0.8
    vel_smooth: float = 0.05      # m/s regularization of Coulomb friction


class SimState(NamedTuple):
    q: torch.Tensor    # (54,)
    dq: torch.Tensor   # (54,)


def _contact(q: torch.Tensor, dq: torch.Tensor, subject: SubjectParams,
             cp: ContactParams):
    """(F (..., 4, 3) world contact forces, the feet's Jacobian (..., 4, 3,
    54))."""
    pts, J = dyn.feet_and_jacobian(q, subject)
    vel = torch.einsum("...fik,...k->...fi", J, dq)
    pen = torch.clamp(-pts[..., 2], min=0.0)                 # penetration
    fz = cp.stiffness * pen - cp.damping * vel[..., 2] * (pen > 0)
    fz = torch.clamp(fz, min=0.0)
    vxy = vel[..., :2]
    speed = torch.sqrt((vxy * vxy).sum(-1) + cp.vel_smooth ** 2)
    fxy = -cp.friction_mu * fz[..., None] * vxy / speed[..., None]
    return torch.cat([fxy, fz[..., None]], -1), J


def contact_forces(q: torch.Tensor, dq: torch.Tensor,
                   subject: SubjectParams, cp: ContactParams) -> torch.Tensor:
    """(..., 4, 3) world contact force on each foot (spring-damper +
    friction; JAX ``simulate.py:36-46``)."""
    return _contact(q, dq, subject, cp)[0]


def _spin_mask(like: torch.Tensor) -> torch.Tensor:
    return constant("spin_mask", like,
                    lambda: np.concatenate([np.zeros(6), np.ones(48)]))


def _accel(q: torch.Tensor, dq: torch.Tensor, tau: torch.Tensor,
           subject: SubjectParams, cp: ContactParams,
           inertia_floor: float = 5e-2, spin_damping: float = 0.05,
           ext_q_fn: Optional[Callable] = None) -> torch.Tensor:
    """ddq (..., 54) (JAX ``simulate.py:49-70``): contact, actuation and
    external generalised forces against the floored mass matrix (thin leg
    segments have ~1e-6 kg m^2 spin inertia about their own axis) and the
    lightly damped spin coordinates."""
    F, J = _contact(q, dq, subject, cp)
    Q = torch.einsum("...fik,...fi->...k", J, F)
    if ext_q_fn is not None:
        Q = Q + ext_q_fn(q, dq)
    Q_tau = tau @ constant("torque_map", q, lambda: dyn.TORQUE_MAP.B).mT
    M, bias = dyn.mass_and_bias(q, dq, subject)
    eye = constant("eye54", q, lambda: np.eye(NQ))
    rhs = Q + Q_tau - bias - spin_damping * dq * _spin_mask(q)
    L = torch.linalg.cholesky(M + inertia_floor * eye)
    return torch.cholesky_solve(rhs[..., None], L)[..., 0]


def simulate(subject: SubjectParams, q0, dq0, duration: float,
             dt: float = 2e-4, tau_fn: Optional[Callable] = None,
             contact: ContactParams = ContactParams(),
             record_every: int = 20, ext_q_fn: Optional[Callable] = None,
             device: DeviceLike = None,
             dtype: torch.dtype = torch.float64
             ) -> Tuple[np.ndarray, np.ndarray]:
    """RK4 rollout (JAX ``simulate.py:73-119``). Returns (q (T, 54), dq (T,
    54)) numpy arrays sampled every ``record_every`` steps, T = 1 + steps
    // record_every. ``tau_fn(t, state) -> (22,)`` optional actuation
    (zero: passive), ``ext_q_fn(q, dq) -> (54,)`` optional extra
    generalised forces (``dynamics.passive``), both on tensors of the
    state's dtype and device (None: the card)."""
    dev = resolve_device(device)
    steps = int(round(duration / dt))
    n_rec = steps // record_every
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    zero_tau = torch.zeros(dyn.N_TAU, dtype=dtype, device=dev)

    def deriv(t: float, s: SimState) -> SimState:
        tau = zero_tau if tau_fn is None else tau_fn(t, s)
        return SimState(s.dq, _accel(s.q, s.dq, tau, subject, contact,
                                     ext_q_fn=ext_q_fn))

    def rk4_step(s: SimState, t: float) -> SimState:
        k1 = deriv(t, s)
        k2 = deriv(t + dt / 2, SimState(s.q + dt / 2 * k1.q,
                                        s.dq + dt / 2 * k1.dq))
        k3 = deriv(t + dt / 2, SimState(s.q + dt / 2 * k2.q,
                                        s.dq + dt / 2 * k2.dq))
        k4 = deriv(t + dt, SimState(s.q + dt * k3.q, s.dq + dt * k3.dq))
        return SimState(s.q + dt / 6 * (k1.q + 2 * k2.q + 2 * k3.q + k4.q),
                        s.dq + dt / 6 * (k1.dq + 2 * k2.dq + 2 * k3.dq
                                         + k4.dq))

    s = SimState(tens(q0), tens(dq0))
    t = 0.0
    qs, dqs = [s.q], [s.dq]
    for _ in range(n_rec):
        for _ in range(record_every):
            s = rk4_step(s, t)
            t += dt
        qs.append(s.q)
        dqs.append(s.dq)
    to_np = lambda xs: torch.stack(xs).cpu().numpy()
    return to_np(qs), to_np(dqs)


def drop_pose(subject: SubjectParams, z_rot: float = 0.0,
              height: float = 1.0) -> np.ndarray:
    """Neutral standing pose at a drop height (JAX ``simulate.py:122-131``;
    reference drop_test initial state, cheetah.py:653-686)."""
    q = np.zeros(NQ)
    q[2] = height
    q[5] = np.pi + z_rot
    for i in range(1, 17):
        q[3 * i + 5] = np.pi + z_rot
    return q


def drop_test(subject: SubjectParams, z_rot: float = 0.0,
              initial_height: float = 1.0, duration: float = 0.8,
              hold_pose_gain: float = 300.0, hold_damping: float = 5.0,
              device: DeviceLike = None,
              dtype: torch.dtype = torch.float64) -> dict:
    """Drop the passive-with-pose-hold cheetah from ``initial_height`` and
    report the landing (JAX ``simulate.py:134-158``: start at rest, fall,
    end not fallen over; ``upright`` is the reference's z >= 0.2). The PD
    pose hold acts in motor space: B^T q is each motor's relative joint
    angle."""
    dev = resolve_device(device)
    q0 = drop_pose(subject, z_rot, initial_height)
    B = torch.as_tensor(dyn.TORQUE_MAP.B, dtype=dtype, device=dev)
    q0_t = torch.as_tensor(q0, dtype=dtype, device=dev)

    def tau_fn(t, s):
        err = (q0_t - s.q) @ B
        return hold_pose_gain * err - hold_damping * (s.dq @ B)

    q, dq = simulate(subject, q0, np.zeros(NQ), duration, tau_fn=tau_fn,
                     device=dev, dtype=dtype)
    final_z = float(q[-1, 2])
    feet = dyn.foot_points(torch.as_tensor(q[-1], dtype=dtype, device=dev),
                           subject)
    return {
        "q": q, "dq": dq, "final_base_height": final_z,
        "upright": final_z > 0.2,
        "final_foot_heights": feet[:, 2].cpu().numpy(),
    }
