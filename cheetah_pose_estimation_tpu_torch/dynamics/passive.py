"""Passive force elements: aerodynamic drag, joint torque springs and
dampers.

Port of ``cheetah_pose_estimation_tpu/dynamics/passive.py`` (the whole
file). Each element is a function of (q, dq) returning a generalized-force
vector (..., 54) that callers add to the applied-force side of the EOM or
hand to :func:`..dynamics.simulate.simulate` through ``ext_q_fn``. Quadratic
drag acts at the link centres; springs and dampers act on relative
Euler-angle coordinates, written as coefficient rows over q (the
conjugacy convention of ``eom.TorqueMap``).

Where the JAX package takes the link-centre velocities and the pullback of
the drag forces with ``jax.jvp`` and ``jax.vjp`` of ``link_frames(q).com``
(``passive.py:46-70``), the port uses the centres' closed-form Jacobian
(``skeleton.com_and_jacobian``: the centres are linear in the rotation
matrices), so v = J dq and Q = J^T F.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..models import skeleton as sk
from ..models.params import NQ, SubjectParams
from ..utils.device import DeviceLike, resolve_device


# ---------------------------------------------------------------------------
# aerodynamic drag
# ---------------------------------------------------------------------------

def cylinder_drag_coefficients(subject: SubjectParams, rho: float = 1.2,
                               cd: float = 0.8) -> np.ndarray:
    """Lumped per-link drag coefficient c = 1/2 rho Cd A with the cylinder
    side area A = length * 2 * radius, (17,) (JAX ``passive.py:37-43``)."""
    lengths = np.asarray(subject.length, float)
    radii = np.asarray(subject.radius, float)
    return 0.5 * rho * cd * lengths * 2.0 * radii


def drag_generalized_forces(q: torch.Tensor, dq: torch.Tensor,
                            subject: SubjectParams, coeff) -> torch.Tensor:
    """Quadratic drag F_l = -c_l |v_l| v_l at each link centre, pulled back
    to generalized forces (..., 54) (JAX ``passive.py:46-70``)."""
    coeff = torch.as_tensor(coeff, dtype=q.dtype, device=q.device)
    _, J = sk.com_and_jacobian(q, subject)                 # (..., 17, 3, 54)
    vel = torch.einsum("...lik,...k->...li", J, dq)
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    F = -coeff[:, None] * speed * vel
    return torch.einsum("...lik,...li->...k", J, F)


# ---------------------------------------------------------------------------
# joint torque springs / dampers
# ---------------------------------------------------------------------------

def joint_coefficient_row(link_a: str, link_b: str, axis: str) -> np.ndarray:
    """Coefficient row g with g.q = relative angle of link_b w.r.t. link_a
    about ``axis`` (JAX ``passive.py:79-89``)."""
    off = {"x": 0, "y": 1, "z": 2}[axis]
    g = np.zeros(NQ)
    for name, sgn in ((link_a, -1.0), (link_b, 1.0)):
        i = sk.LINK_INDEX[name]
        g[(3 if i == 0 else 3 * i + 3) + off] = sgn
    return g


class TorqueSpring(NamedTuple):
    """tau = -k (g.q - rest) on each row of G."""
    G: torch.Tensor          # (R, 54) coordinate rows
    stiffness: torch.Tensor  # (R,)
    rest: torch.Tensor       # (R,) rest angles


class TorqueDamper(NamedTuple):
    """tau = -b (g.dq) on each row of G."""
    G: torch.Tensor          # (R, 54)
    damping: torch.Tensor    # (R,)


def _rows(joints: Sequence[Tuple[str, str, str]], values, dev):
    """The stacked coefficient rows (R, 54) of ``joints`` and each of
    ``values`` broadcast to (R,), float64 tensors on ``dev``."""
    G = np.stack([joint_coefficient_row(*j) for j in joints])
    R = len(joints)
    return [torch.as_tensor(G, dtype=torch.float64, device=dev)] + [
        torch.as_tensor(np.broadcast_to(np.asarray(v, float), (R,)).copy(),
                        device=dev) for v in values]


def make_torque_spring(joints: Sequence[Tuple[str, str, str]],
                       stiffness, rest=0.0,
                       device: DeviceLike = None) -> TorqueSpring:
    """Springs on the relative angles of ``joints`` ((link_a, link_b,
    axis) each), float64 on ``device`` (None: the card; JAX
    ``passive.py:106-114``)."""
    return TorqueSpring(*_rows(joints, (stiffness, rest),
                               resolve_device(device)))


def make_torque_damper(joints: Sequence[Tuple[str, str, str]],
                       damping, device: DeviceLike = None) -> TorqueDamper:
    """Dampers on the relative angle rates of ``joints``, float64 on
    ``device`` (None: the card; JAX ``passive.py:117-123``)."""
    return TorqueDamper(*_rows(joints, (damping,), resolve_device(device)))


def _cast(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(dtype=like.dtype, device=like.device)


def spring_potential(q: torch.Tensor, spring: TorqueSpring) -> torch.Tensor:
    """U = 1/2 sum k (g.q - rest)^2, (...,); the generalized force is
    -dU/dq (JAX ``passive.py:126-129``)."""
    r = q @ _cast(spring.G, q).mT - _cast(spring.rest, q)
    return 0.5 * (_cast(spring.stiffness, q) * r * r).sum(-1)


def spring_generalized_forces(q: torch.Tensor,
                              spring: TorqueSpring) -> torch.Tensor:
    """-G^T (k (G q - rest)), (..., 54) (JAX ``passive.py:132-136``)."""
    G = _cast(spring.G, q)
    r = q @ G.mT - _cast(spring.rest, q)
    return -((_cast(spring.stiffness, q) * r) @ G)


def damper_generalized_forces(dq: torch.Tensor,
                              damper: TorqueDamper) -> torch.Tensor:
    """-G^T (b (G dq)), (..., 54) (JAX ``passive.py:139-143``)."""
    G = _cast(damper.G, dq)
    return -((_cast(damper.damping, dq) * (dq @ G.mT)) @ G)


def make_ext_q_fn(subject: SubjectParams, drag_coeff=None,
                  spring: TorqueSpring | None = None,
                  damper: TorqueDamper | None = None):
    """Bundle elements into an ``ext_q_fn(q, dq) -> (..., 54)`` for
    ``dynamics.simulate.simulate`` (JAX ``passive.py:146-155``). The drag
    coefficients go to the state's device once per dtype."""
    coeffs = {}

    def ext_q(q, dq):
        Q = torch.zeros_like(q)
        if drag_coeff is not None:
            key = (q.dtype, q.device)
            if key not in coeffs:
                coeffs[key] = torch.as_tensor(drag_coeff, dtype=q.dtype,
                                              device=q.device)
            Q = Q + drag_generalized_forces(q, dq, subject, coeffs[key])
        if spring is not None:
            Q = Q + spring_generalized_forces(q, spring)
        if damper is not None:
            Q = Q + damper_generalized_forces(dq, damper)
        return Q

    return ext_q
