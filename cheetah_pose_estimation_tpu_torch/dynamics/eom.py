"""Rigid-body dynamics of the 17-link cheetah in closed form.

Port of ``cheetah_pose_estimation_tpu/dynamics/eom.py``: the manipulator
equation

  EOM(q, dq, ddq) = M(q) ddq + C(q, dq) + G(q) - B(q) grf - B_tau tau

with M = sum_l m_l J_l^T J_l + W_l^T I_l W_l (J_l the Jacobian of link l's
centre, W_l the map from dq to its body-frame angular velocity, I_l its
principal moments as a solid cylinder), C = Mdot dq - 1/2 d(dq^T M dq)/dq
and G = g sum_l m_l J_l[2, :]. The JAX package forms C by nested autodiff
of M (a jvp and a grad, ``eom.py:126-139``). Here it is written out, so that
the solver's gradient is one reverse pass and its Jacobians one forward
pass over plain tensor expressions:

* translation: the centres are linear in the rotation matrices
  (``com_l = q[0:3] + sum_k R_k c[k, l]``), so J_l is exact and
  C_trans = sum_l m_l J_l^T (Jdot_l dq), with Jdot_l dq =
  sum_k (sum_ab d^2R_k/dang_a dang_b dang_a dang_b) c[k, l];
* rotation: omega_l = E(ang_l) dang_l, and C_rot = Edot^T I omega +
  E^T I Edot dang - K^T I omega with Edot = dE/dt and K = d(E dang)/dang.

All functions broadcast over leading batch dimensions. Contact forces use
the friction-polygon parameterisation (``POLYGON_D``) in body-weight units
scaled by the subject's weight.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models import skeleton as sk
from ..models.params import LINK_INDEX, N_LINKS, NQ, SubjectParams
from ..ops.rotations import (euler_rate_to_body_omega,
                             euler_zyx_and_derivative,
                             euler_zyx_second_derivative)
from ..utils.device import FORWARD_AD, constant, tables_of

GRAVITY = 9.81

FEET_LINKS = ("HFL", "HFR", "HBL", "HBR")
FOOT_NAMES = ("HFL_foot", "HFR_foot", "HBL_foot", "HBR_foot")
N_FEET = 4
N_POLYGON = 4
# friction polygon directions (world frame, unit vectors in the xy plane):
# +x, +y, -x, -y
POLYGON_D = np.array([
    [1.0, 0.0, 0.0],
    [0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0],
    [0.0, -1.0, 0.0],
])
FEET_INDEX = np.array([LINK_INDEX[n] for n in FEET_LINKS])


def _inertia_body(subject: SubjectParams) -> np.ndarray:
    """(17, 3) principal moments in each link's body frame: a solid
    cylinder, I_axial = m r^2 / 2 about its alignment axis (x for trunk and
    tail links, z for leg segments), I_perp = m (3 r^2 + l^2) / 12."""
    m, r, l = subject.mass, subject.radius, subject.length
    I_ax = 0.5 * m * r**2
    I_perp = m * (3 * r**2 + l**2) / 12.0
    out = np.zeros((N_LINKS, 3))
    axis = np.abs(sk._AXIS).argmax(axis=1)
    for i in range(N_LINKS):
        out[i] = I_perp[i]
        out[i, axis[i]] = I_ax[i]
    return out


def _selector() -> np.ndarray:
    """(17, 3, 54) S with S[l, j, col_l + j] = 1: link l's angle columns."""
    S = np.zeros((N_LINKS, 3, NQ))
    for l in range(N_LINKS):
        c = 3 if l == 0 else 3 * l + 3
        S[l, :, c:c + 3] = np.eye(3)
    return S


class _Tables(NamedTuple):
    mass: torch.Tensor        # (17,)
    inertia: torch.Tensor     # (17, 3)
    com_coef: torch.Tensor    # (17, 17, 3)
    feet_coef: torch.Tensor   # (17, 4, 3) bottom coefficients of the feet
    selector: torch.Tensor    # (17, 3, 54)
    polygon: torch.Tensor     # (4, 3)
    torque_map: torch.Tensor  # (54, 22)


def tables(subject: SubjectParams, like: torch.Tensor) -> _Tables:
    """The subject's constant tables as tensors of ``like``'s dtype and
    device, made once per (subject, dtype, device)."""
    c = lambda name, make: tables_of(subject).get(name, like, make)
    return _Tables(
        c("mass", lambda: subject.mass),
        c("inertia", lambda: _inertia_body(subject)),
        c("com_coef", lambda: sk.com_coefficients(subject)),
        c("feet_coef",
          lambda: sk.bottom_coefficients(subject)[:, FEET_INDEX, :]),
        constant("omega_selector", like, _selector),
        constant("polygon", like, lambda: POLYGON_D),
        constant("torque_map", like, lambda: TORQUE_MAP.B))


def _angles(q: torch.Tensor) -> torch.Tensor:
    return sk._angles_from_q(q)


def kinetic_energy(q: torch.Tensor, dq: torch.Tensor,
                   subject: SubjectParams) -> torch.Tensor:
    """Total kinetic energy (translational + rotational), by a forward-mode
    derivative of the link centres (the reference cross-check)."""
    with FORWARD_AD:
        _, vcom = torch.func.jvp(
            lambda qq: sk.link_frames(qq, subject).com, (q,), (dq,))
    tb = tables(subject, q)
    ke_t = 0.5 * (tb.mass * (vcom * vcom).sum(-1)).sum(-1)
    E = euler_rate_to_body_omega(_angles(q))
    omega_b = torch.einsum("...lij,...lj->...li", E, _angles(dq))
    return ke_t + 0.5 * (tb.inertia * omega_b * omega_b).sum((-1, -2))


def potential_energy(q: torch.Tensor, subject: SubjectParams
                     ) -> torch.Tensor:
    com = sk.link_frames(q, subject).com
    return GRAVITY * (tables(subject, q).mass * com[..., 2]).sum(-1)


def mass_matrix_ad(q: torch.Tensor, subject: SubjectParams) -> torch.Tensor:
    """M(q) = d^2 KE / ddq^2 by nested autodiff, for one frame q (54,)
    (the reference cross-check of :func:`mass_matrix`)."""
    ke_dq = torch.func.grad(kinetic_energy, argnums=1)
    with FORWARD_AD:
        return torch.func.jacfwd(ke_dq, argnums=1)(q, torch.zeros_like(q),
                                                   subject)


def _omega_selector(q: torch.Tensor) -> torch.Tensor:
    """(..., 17, 3, 54) W with omega_body_l = W_l @ dq."""
    E = euler_rate_to_body_omega(_angles(q))
    return torch.einsum("...lij,ljk->...lik", E,
                        constant("omega_selector", q, _selector))


def _com_jacobian(q: torch.Tensor, dR: torch.Tensor, C: torch.Tensor
                  ) -> torch.Tensor:
    """(..., 17, 3, 54) Jacobian of the link centres from dR (..., 17, 3, 3,
    3) and the centre coefficients C."""
    J_ang = torch.einsum("...kija,klj->...lika", dR, C)
    return sk._scatter_angle_jacobian(J_ang, N_LINKS)


def _mass_from(J, E, tb: _Tables) -> torch.Tensor:
    W = torch.einsum("...lij,ljk->...lik", E, tb.selector)
    return torch.einsum("l,...lik,...lij->...kj", tb.mass, J, J) \
        + torch.einsum("...lik,li,...lij->...kj", W, tb.inertia, W)


def mass_matrix(q: torch.Tensor, subject: SubjectParams) -> torch.Tensor:
    """M(q) (..., 54, 54) in closed form."""
    tb = tables(subject, q)
    ang = _angles(q)
    _, dR = euler_zyx_and_derivative(ang)
    return _mass_from(_com_jacobian(q, dR, tb.com_coef),
                      euler_rate_to_body_omega(ang), tb)


def mass_and_bias(q: torch.Tensor, dq: torch.Tensor, subject: SubjectParams
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M (..., 54, 54), C + G (..., 54)) sharing one rotation stack."""
    tb = tables(subject, q)
    ang, dang = _angles(q), _angles(dq)
    _, dR = euler_zyx_and_derivative(ang)
    ddR = euler_zyx_second_derivative(ang)
    J = _com_jacobian(q, dR, tb.com_coef)                  # (..., 17, 3, 54)
    E, dE = euler_rate_to_body_omega(ang, derivative=True)
    M = _mass_from(J, E, tb)
    # translation: sum_l m_l J_l^T (Jdot_l dq)
    Rdd = torch.einsum("...kijab,...ka,...kb->...kij", ddR, dang, dang)
    acc = torch.einsum("...kij,klj->...li", Rdd, tb.com_coef)
    c_t = torch.einsum("l,...lik,...li->...k", tb.mass, J, acc)
    G = GRAVITY * torch.einsum("l,...lk->...k", tb.mass, J[..., 2, :])
    # rotation: Edot^T I omega + E^T I Edot dang - K^T I omega
    omega = torch.einsum("...lij,...lj->...li", E, dang)
    Edot = dE[..., 0] * dang[..., 0, None, None] \
        + dE[..., 1] * dang[..., 1, None, None]
    Kcols = torch.einsum("...lijc,...lj->...lic", dE, dang)  # (..., 17, 3, 2)
    Iw = tb.inertia * omega
    c_r = torch.einsum("...lji,...lj->...li", Edot, Iw) \
        + torch.einsum("...lji,...lj->...li", E, tb.inertia * torch.einsum(
            "...lij,...lj->...li", Edot, dang))
    c_r = c_r - torch.cat([torch.einsum("...ljc,...lj->...lc", Kcols, Iw),
                           torch.zeros_like(c_r[..., :1])], -1)
    c_r = torch.einsum("...li,lik->...k", c_r, tb.selector)
    return M, c_t + c_r + G


def bias_terms(q: torch.Tensor, dq: torch.Tensor, subject: SubjectParams
               ) -> torch.Tensor:
    """C(q, dq) + G(q): velocity products and gravity, (..., 54)."""
    return mass_and_bias(q, dq, subject)[1]


def foot_points(q: torch.Tensor, subject: SubjectParams) -> torch.Tensor:
    """(..., 4, 3) world positions of the feet (hock bottoms), order
    FEET_LINKS."""
    feet = constant("feet_index", q, lambda: FEET_INDEX, torch.long)
    return sk.link_frames(q, subject).bottom[..., feet, :]


def feet_and_jacobian(q: torch.Tensor, subject: SubjectParams):
    """Feet (..., 4, 3) and their Jacobian (..., 4, 3, 54) in the linear
    form."""
    return sk.points_and_jacobian_from_coeffs(q, tables(subject,
                                                        q).feet_coef)


def grf_generalized_forces(q: torch.Tensor, grf_z: torch.Tensor,
                           grf_xy: torch.Tensor, subject: SubjectParams,
                           force_scale: float) -> torch.Tensor:
    """B(q) grf (..., 54): the feet's Jacobians transposed onto the world
    forces ``force_scale * (grf_z e_z + grf_xy @ POLYGON_D)`` (grf_z
    (..., 4), grf_xy (..., 4, 4) in body-weight units)."""
    tb = tables(subject, q)
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=q.dtype, device=q.device)
    F = (grf_z[..., None] * ez
         + torch.einsum("...fi,ij->...fj", grf_xy, tb.polygon)) * force_scale
    _, Jf = feet_and_jacobian(q, subject)
    return torch.einsum("...fik,...fi->...k", Jf, F)


def eom_residual(q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor,
                 grf_z: torch.Tensor, grf_xy: torch.Tensor,
                 subject: SubjectParams,
                 tau_forces: torch.Tensor | None = None) -> torch.Tensor:
    """M ddq + C + G - B - B_tau, (..., 54); grf in body-weight units."""
    force_scale = subject.total_mass * GRAVITY
    M, cg = mass_and_bias(q, dq, subject)
    B = grf_generalized_forces(q, grf_z, grf_xy, subject, force_scale)
    res = (M @ ddq[..., None])[..., 0] + cg - B
    if tau_forces is not None:
        res = res - tau_forces
    return res


# ---------------------------------------------------------------------------
# joint torque actuation
# ---------------------------------------------------------------------------

class TorqueMap(NamedTuple):
    """Linear map from the 22 motor torque components to generalized
    forces: a torque component about axis a between links (A, B) adds +tau
    to A's angle-a coordinate and -tau to B's."""
    B: np.ndarray      # (54, n_tau)
    names: Tuple[str, ...]


def _axis_offset(axis: str) -> int:
    return {"x": 0, "y": 1, "z": 2}[axis]


def build_torque_map() -> TorqueMap:
    motors = [
        ("neck", "bodyF", "xyz", "neck_bodyF_torque"),
        ("bodyF", "base", "xyz", "bodyF_base_torque"),
        ("base", "tail0", "yz", "base_tail0_torque"),
        ("tail0", "tail1", "yz", "tail0_tail1_torque"),
    ]
    for front, body in (("F", "bodyF"), ("B", "base")):
        for side in ("L", "R"):
            u, l, h = f"U{front}{side}", f"L{front}{side}", f"H{front}{side}"
            fb = "front" if front == "F" else "back"
            rl = "left" if side == "L" else "right"
            motors.append((body, u, "y", f"{fb}-{rl}-hip-pitch"))
            motors.append((u, l, "y", f"{u}_{l}_torque"))
            motors.append((l, h, "y", f"{l}_{h}_torque"))
    cols, names = [], []
    for a, b, axes, base_name in motors:
        for ax in axes:
            col = np.zeros(NQ)
            ia, ib = LINK_INDEX[a], LINK_INDEX[b]
            off = _axis_offset(ax)
            col[(3 if ia == 0 else 3 * ia + 3) + off] += 1.0
            col[(3 if ib == 0 else 3 * ib + 3) + off] -= 1.0
            cols.append(col)
            names.append(f"{base_name}:{ax}")
    return TorqueMap(B=np.stack(cols, axis=1), names=tuple(names))


def tau_as_dict(tau: np.ndarray) -> dict:
    """(N, 22) torque array -> {motor name: (N, n_components)}."""
    tau = np.asarray(tau)
    out = {}
    for col, name in enumerate(TORQUE_MAP.names):
        out.setdefault(name.rsplit(":", 1)[0], []).append(tau[:, col])
    return {k: np.stack(v, axis=1) for k, v in out.items()}


def tau_from_dict(tau: dict, n_frames: int) -> np.ndarray:
    """{motor name: (N, n_components)} -> (n_frames, 22) torque array in
    ``TORQUE_MAP.names`` order, zero for motors the dict lacks (the
    inverse of :func:`tau_as_dict`)."""
    out = np.zeros((n_frames, len(TORQUE_MAP.names)))
    for col, name in enumerate(TORQUE_MAP.names):
        motor = name.rsplit(":", 1)[0]
        if motor in tau:
            idx = [n for n in TORQUE_MAP.names
                   if n.startswith(motor + ":")].index(name)
            out[:, col] = tau[motor][:, idx]
    return out


TORQUE_MAP = build_torque_map()
N_TAU = TORQUE_MAP.B.shape[1]


def torque_generalized_forces(tau: torch.Tensor, force_scale: float
                              ) -> torch.Tensor:
    """tau (..., 22) in body-weight units -> generalized forces (..., 54),
    ``B_tau (tau * force_scale)`` (JAX ``eom.py:266-270``), in tau's dtype
    and on its device."""
    B = constant("torque_map", tau, lambda: TORQUE_MAP.B)
    return (tau * force_scale) @ B.mT
