"""17-link cheetah skeleton: forward kinematics with closed-form Jacobians.

Port of ``cheetah_pose_estimation_tpu/models/skeleton.py`` (geometry and
conventions documented there). Every link's orientation is an absolute
Euler rotation, so marker positions are linear in the per-link rotation
matrices: ``marker_m(q) = q[0:3] + sum_l R_l(q) @ c_{l,m}`` with a constant
coefficient table c (``marker_coefficients``). The JAX package reads c off a
``jax.jacfwd`` of the chain FK; here it is probed in numpy, and the angle
Jacobians use the closed-form dR of ``ops.rotations``.

All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.rotations import euler_zyx, euler_zyx_and_derivative
from ..utils.device import constant, tables_of
from .params import LINK_INDEX, LINK_NAMES, N_LINKS, NQ, SubjectParams

__all__ = ["LINK_NAMES", "MARKERS", "N_MARKERS", "fk_markers",
           "fk_markers_linear", "fk_markers_and_jacobian", "joint_residuals",
           "joint_residuals_and_jacobian", "com_position",
           "marker_coefficients", "com_coefficients", "bottom_coefficients",
           "points_and_jacobian_from_coeffs", "com_and_jacobian", "A_REL",
           "REL_MASK", "NX", "relative_pose"]

MARKERS = (
    "nose", "r_eye", "l_eye", "neck_base", "spine", "tail_base", "tail1",
    "tail2", "r_shoulder", "r_front_knee", "r_front_ankle", "r_front_paw",
    "l_shoulder", "l_front_knee", "l_front_ankle", "l_front_paw", "r_hip",
    "r_back_knee", "r_back_ankle", "r_back_paw", "l_hip", "l_back_knee",
    "l_back_ankle", "l_back_paw",
)
N_MARKERS = len(MARKERS)

# per-link alignment axis in the body frame (unit vector * sign)
_AXIS = np.zeros((N_LINKS, 3))
_AXIS[0:3, 0] = -1.0   # base, bodyF, neck aligned "-x"
_AXIS[3:5, 0] = +1.0   # tail0, tail1 aligned "+x"
_AXIS[5:, 2] = -1.0    # all leg segments aligned "-z"

_L = LINK_INDEX

# (marker) -> (link, end, body-frame offset); end: 0 = top, 1 = bottom
_MARKER_SPEC = {
    "nose": ("neck", 1, (-0.055, 0.0, -0.055)),
    "r_eye": ("neck", 1, (0.0, 0.045, 0.0)),
    "l_eye": ("neck", 1, (0.0, -0.045, 0.0)),
    "neck_base": ("neck", 0, None),
    "spine": ("base", 1, None),
    "tail_base": ("base", 0, None),
    "tail1": ("tail1", 0, None),
    "tail2": ("tail1", 1, None),
    "r_shoulder": ("bodyF", 1, (0.06, 0.075, -0.15)),
    "r_front_knee": ("UFR", 1, None),
    "r_front_ankle": ("HFR", 0, None),
    "r_front_paw": ("HFR", 1, None),
    "l_shoulder": ("bodyF", 1, (0.06, -0.075, -0.15)),
    "l_front_knee": ("UFL", 1, None),
    "l_front_ankle": ("HFL", 0, None),
    "l_front_paw": ("HFL", 1, None),
    "r_hip": ("base", 0, (-0.06, 0.06, -0.1)),
    "r_back_knee": ("UBR", 1, None),
    "r_back_ankle": ("HBR", 0, None),
    "r_back_paw": ("HBR", 1, None),
    "l_hip": ("base", 0, (-0.06, -0.06, -0.1)),
    "l_back_knee": ("UBL", 1, None),
    "l_back_ankle": ("HBL", 0, None),
    "l_back_paw": ("HBL", 1, None),
}
_MARKER_LINK = np.array([_L[_MARKER_SPEC[m][0]] for m in MARKERS])
_MARKER_END = np.array([_MARKER_SPEC[m][1] for m in MARKERS])
_MARKER_OFFSET = np.array(
    [(_MARKER_SPEC[m][2] or (0.0, 0.0, 0.0)) for m in MARKERS])
_LEGS = (("UFL", "LFL", "HFL"), ("UFR", "LFR", "HFR"),
         ("UBL", "LBL", "HBL"), ("UBR", "LBR", "HBR"))


class LinkFrames(NamedTuple):
    """World-frame link data (leading dims broadcast)."""
    R: torch.Tensor       # (..., 17, 3, 3)
    top: torch.Tensor     # (..., 17, 3)
    bottom: torch.Tensor  # (..., 17, 3)
    com: torch.Tensor     # (..., 17, 3)


def _angles_from_q(q: torch.Tensor) -> torch.Tensor:
    """(..., 54) -> (..., 17, 3) per-link (phi, theta, psi)."""
    rest = q[..., 6:].reshape(q.shape[:-1] + (N_LINKS - 1, 3))
    return torch.cat([q[..., None, 3:6], rest], dim=-2)


def _chain(base_com, R, axis_w, params: SubjectParams, xp):
    """Link tops/bottoms/coms from base centre, rotations and world axis
    vectors; ``xp`` is numpy or torch (shared by the tensor FK and the
    numpy coefficient probe)."""
    length, radius = params.length, params.radius
    i_base = _L["base"]
    tops = [None] * N_LINKS
    tops[i_base] = base_com - 0.5 * axis_w[..., i_base, :]
    base_bottom = base_com + 0.5 * axis_w[..., i_base, :]
    base_top = tops[i_base]
    tops[_L["bodyF"]] = base_bottom
    bodyF_com = base_bottom + 0.5 * axis_w[..., _L["bodyF"], :]
    tops[_L["neck"]] = base_bottom + axis_w[..., _L["bodyF"], :]
    tops[_L["tail0"]] = base_top
    tops[_L["tail1"]] = base_top + axis_w[..., _L["tail0"], :]
    lF, rF = length[_L["bodyF"]], radius[_L["bodyF"]]
    lB, rB = length[i_base], radius[i_base]
    for name, sgn in (("UFL", -1.0), ("UFR", 1.0)):
        off = np.array([-lF / 2, sgn * rF, 0.0])
        tops[_L[name]] = bodyF_com + _rotate(R[..., _L["bodyF"], :, :], off,
                                             xp, params, name)
    for name, sgn in (("UBL", -1.0), ("UBR", 1.0)):
        off = np.array([lB / 2, sgn * rB, 0.0])
        tops[_L[name]] = base_com + _rotate(R[..., i_base, :, :], off, xp,
                                            params, name)
    for thigh, calf, hock in _LEGS:
        tops[_L[calf]] = tops[_L[thigh]] + axis_w[..., _L[thigh], :]
        tops[_L[hock]] = tops[_L[calf]] + axis_w[..., _L[calf], :]
    top = xp.stack(tops, -2)
    bottom = top + axis_w
    com = top + 0.5 * axis_w
    return top, bottom, com


def _rotate(R, v: np.ndarray, xp, params: SubjectParams, link: str):
    """R (..., 3, 3) @ the subject's constant offset v (3,) of ``link``."""
    if xp is np:
        return R @ v
    return R @ tables_of(params).get(("leg_offset", link), R, lambda: v)


def link_frames(q: torch.Tensor, params: SubjectParams) -> LinkFrames:
    """Forward kinematics for all 17 links of q (..., 54)."""
    R = euler_zyx(_angles_from_q(q))
    axis_len = tables_of(params).get("axis_len", q,
                                 lambda: _AXIS * params.length[:, None])
    axis_w = (R @ axis_len[..., None])[..., 0]          # (..., 17, 3)
    base_com = q[..., 0:3]
    top, bottom, com = _chain(base_com, R, axis_w, params, torch)
    i_base = _L["base"]
    com = torch.cat([com[..., :i_base, :], base_com[..., None, :],
                     com[..., i_base + 1:, :]], dim=-2)
    return LinkFrames(R=R, top=top, bottom=bottom, com=com)


def marker_positions(frames: LinkFrames) -> torch.Tensor:
    """24 marker world positions (..., 24, 3) from link frames."""
    ends = torch.stack([frames.top, frames.bottom], dim=-3)   # (..., 2, 17, 3)
    end = constant("marker_end", ends, lambda: _MARKER_END, torch.long)
    link = constant("marker_link", ends, lambda: _MARKER_LINK, torch.long)
    anchors = ends[..., end, link, :]
    Rm = frames.R[..., link, :, :]
    off = constant("marker_offset", anchors, lambda: _MARKER_OFFSET)
    return anchors + (Rm @ off[..., None])[..., 0]


def fk_markers(q: torch.Tensor, params: SubjectParams) -> torch.Tensor:
    """q (..., 54) -> marker positions (..., 24, 3) by the link chain."""
    return marker_positions(link_frames(q, params))


def marker_coefficients(params: SubjectParams) -> np.ndarray:
    """(17, 24, 3) constant body-frame coefficient vectors c_{l,m}, made once
    per subject.

    The chain FK with q[0:3] = 0 is linear in the rotations, so setting
    R_l = e_0 e_j^T (all other rotations zero) leaves
    ``marker_m[0] = c_{l,m}[j]``: 51 numpy probes of the chain."""
    return tables_of(params).host("marker_coef",
                              lambda: _probe_marker_coefficients(params))


def _probe_marker_coefficients(params: SubjectParams) -> np.ndarray:
    ends_idx = (_MARKER_END, _MARKER_LINK)
    C = np.zeros((N_LINKS, N_MARKERS, 3))
    for l in range(N_LINKS):
        for j in range(3):
            R = np.zeros((N_LINKS, 3, 3))
            R[l, 0, j] = 1.0
            axis_w = np.einsum("lij,lj->li", R,
                               _AXIS * params.length[:, None])
            top, bottom, _ = _chain(np.zeros(3), R, axis_w, params, np)
            anchors = np.stack([top, bottom])[ends_idx]
            pts = anchors + np.einsum("mij,mj->mi", R[_MARKER_LINK],
                                      _MARKER_OFFSET)
            C[l, :, j] = pts[:, 0]
    return C


def _coef(params: SubjectParams, like: torch.Tensor) -> torch.Tensor:
    return tables_of(params).get("marker_coef", like,
                             lambda: marker_coefficients(params))


def fk_markers_linear(q: torch.Tensor, params: SubjectParams) -> torch.Tensor:
    """Linear-form FK: identical to fk_markers, one rotation stack + einsum."""
    R = euler_zyx(_angles_from_q(q))                        # (..., 17, 3, 3)
    pts = torch.einsum("...lij,lmj->...mi", R, _coef(params, q))
    return pts + q[..., None, 0:3]


def _scatter_angle_jacobian(J_ang: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n, 3, 17, 3) angle Jacobian -> (..., n, 3, 54) q Jacobian with
    the identity on the base translation columns."""
    lead = J_ang.shape[:-4]
    eye = torch.eye(3, dtype=J_ang.dtype, device=J_ang.device)
    trans = eye.expand(lead + (n, 3, 3))
    return torch.cat([trans, J_ang.reshape(lead + (n, 3, NQ - 3))], dim=-1)


def fk_markers_and_jacobian(q: torch.Tensor, params: SubjectParams
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Markers (..., 24, 3) and J (..., 24, 3, 54) in closed form:
    J[..., 0:3] = I, and the columns of link l's angles are
    (dR_l / d angle) @ c_{l,m}."""
    R, dR = euler_zyx_and_derivative(_angles_from_q(q))
    C = _coef(params, q)
    pts = torch.einsum("...lij,lmj->...mi", R, C) + q[..., None, 0:3]
    # J_ang[m, i, l, k] = sum_j dR[l, i, j, k] C[l, m, j]; the q layout
    # (base angles at 3:6, link l>0 at 3l+3) is exactly link-major order
    J_ang = torch.einsum("...lijk,lmj->...milk", dR, C)
    return pts, _scatter_angle_jacobian(J_ang, N_MARKERS)


def _link_point_coefficients(params: SubjectParams, which: str
                             ) -> np.ndarray:
    """(17, 17, 3) c[k, l] with point_l(q) = q[0:3] + sum_k R_k(q) c[k, l]
    for the link centres (``which="com"``) or bottom ends ("bottom"), probed
    like :func:`marker_coefficients`, made once per subject."""
    return tables_of(params).host(("link_coef", which),
                              lambda: _probe_link_points(params, which))


def _probe_link_points(params: SubjectParams, which: str) -> np.ndarray:
    C = np.zeros((N_LINKS, N_LINKS, 3))
    for k in range(N_LINKS):
        for j in range(3):
            R = np.zeros((N_LINKS, 3, 3))
            R[k, 0, j] = 1.0
            axis_w = np.einsum("lij,lj->li", R,
                               _AXIS * params.length[:, None])
            _, bottom, com = _chain(np.zeros(3), R, axis_w, params, np)
            if which == "com":
                com[_L["base"]] = 0.0      # the base centre is q[0:3]
                C[k, :, j] = com[:, 0]
            else:
                C[k, :, j] = bottom[:, 0]
    return C


def com_coefficients(params: SubjectParams) -> np.ndarray:
    """(17, 17, 3) coefficients of the link centres (rows: rotations k)."""
    return _link_point_coefficients(params, "com")


def bottom_coefficients(params: SubjectParams) -> np.ndarray:
    """(17, 17, 3) coefficients of the link bottom ends (the feet are the
    hock bottoms)."""
    return _link_point_coefficients(params, "bottom")


def points_and_jacobian_from_coeffs(q: torch.Tensor, C: torch.Tensor):
    """A point set linear in the rotations: positions (..., L, 3) and the
    closed-form Jacobian (..., L, 3, 54) for coefficients C (17, L, 3)."""
    R, dR = euler_zyx_and_derivative(_angles_from_q(q))
    pts = torch.einsum("...kij,klj->...li", R, C) + q[..., None, 0:3]
    J_ang = torch.einsum("...kija,klj->...lika", dR, C)
    return pts, _scatter_angle_jacobian(J_ang, C.shape[1])


def com_and_jacobian(q: torch.Tensor, params: SubjectParams):
    """Link centres (..., 17, 3) and their Jacobian (..., 17, 3, 54)."""
    C = tables_of(params).get("com_coef", q, lambda: com_coefficients(params))
    return points_and_jacobian_from_coeffs(q, C)


def com_position(q: torch.Tensor, params: SubjectParams) -> torch.Tensor:
    """Mass-weighted whole-body centre of mass (..., 3)."""
    frames = link_frames(q, params)
    m = tables_of(params).get("mass", q, lambda: params.mass)
    return torch.einsum("i,...ij->...j", m, frames.com) / params.total_mass


# ---------------------------------------------------------------------------
# Joint-structure residuals (reference revolute / Hooke joints)
# ---------------------------------------------------------------------------
REVOLUTE_PAIRS = (
    ("bodyF", "UFL"), ("UFL", "LFL"), ("LFL", "HFL"),
    ("bodyF", "UFR"), ("UFR", "LFR"), ("LFR", "HFR"),
    ("base", "UBL"), ("UBL", "LBL"), ("LBL", "HBL"),
    ("base", "UBR"), ("UBR", "LBR"), ("LBR", "HBR"),
)
HOOKE_PAIRS = (("base", "tail0"), ("tail0", "tail1"))
N_JOINT_RES = 6 * len(REVOLUTE_PAIRS) + len(HOOKE_PAIRS)   # 74


def _angle_col(link: int) -> int:
    return 3 if link == 0 else 3 * link + 3


def joint_residuals(q: torch.Tensor) -> torch.Tensor:
    """(..., 54) -> (..., 74) joint-structure residuals (zero on the joint
    manifold): per revolute pair R_rel e_y - e_y and R_rel^T e_y - e_y,
    per Hooke pair R_rel[1, 2], with R_rel = R_a^T R_b."""
    return joint_residuals_and_jacobian(q, jacobian=False)[0]


def joint_residuals_and_jacobian(q: torch.Tensor, jacobian: bool = True):
    """Residuals (..., 74) and, in closed form, d r / d q (..., 74, 54).

    The JAX package takes the Jacobian with ``jax.jacfwd``
    (``solver/kinematic.py:631-633``). With R_rel = R_a^T R_b:
    (R_rel e_y)_i = sum_k R_a[k, i] R_b[k, 1], (R_rel^T e_y)_i =
    sum_k R_b[k, i] R_a[k, 1], R_rel[1, 2] = sum_k R_a[k, 1] R_b[k, 2];
    each is bilinear in (R_a, R_b), so its angle derivatives pair one dR
    with the other link's R."""
    R, dR = euler_zyx_and_derivative(_angles_from_q(q), derivative=jacobian)
    lead = q.shape[:-1]
    res, rows = [], []
    for a, b in REVOLUTE_PAIRS:
        ia, ib = LINK_INDEX[a], LINK_INDEX[b]
        Ra, Rb = R[..., ia, :, :], R[..., ib, :, :]
        res.append(torch.einsum("...ki,...k->...i", Ra, Rb[..., :, 1])
                   - _ey(q))
        res.append(torch.einsum("...ki,...k->...i", Rb, Ra[..., :, 1])
                   - _ey(q))
        if jacobian:
            dRa, dRb = dR[..., ia, :, :, :], dR[..., ib, :, :, :]
            rows.append([(ia, torch.einsum("...kic,...k->...ic", dRa,
                                           Rb[..., :, 1])),
                         (ib, torch.einsum("...ki,...kc->...ic", Ra,
                                           dRb[..., :, 1, :]))])
            rows.append([(ib, torch.einsum("...kic,...k->...ic", dRb,
                                           Ra[..., :, 1])),
                         (ia, torch.einsum("...ki,...kc->...ic", Rb,
                                           dRa[..., :, 1, :]))])
    for a, b in HOOKE_PAIRS:
        ia, ib = LINK_INDEX[a], LINK_INDEX[b]
        Ra, Rb = R[..., ia, :, :], R[..., ib, :, :]
        res.append((Ra[..., :, 1] * Rb[..., :, 2]).sum(-1)[..., None])
        if jacobian:
            dRa, dRb = dR[..., ia, :, :, :], dR[..., ib, :, :, :]
            rows.append([(ia, torch.einsum("...kc,...k->...c",
                                           dRa[..., :, 1, :],
                                           Rb[..., :, 2])[..., None, :]),
                         (ib, torch.einsum("...k,...kc->...c", Ra[..., :, 1],
                                           dRb[..., :, 2, :])[..., None, :])])
    r = torch.cat(res, dim=-1)
    if not jacobian:
        return r, None
    J = q.new_zeros(lead + (N_JOINT_RES, NQ))
    row = 0
    for blocks in rows:
        n = blocks[0][1].shape[-2]
        for link, d in blocks:
            col = _angle_col(link)
            J[..., row:row + n, col:col + 3] += d
        row += n
    return r, J


def _ey(q: torch.Tensor) -> torch.Tensor:
    return constant("ey", q, lambda: np.array([0.0, 1.0, 0.0]))


def project_joint_manifold(q: torch.Tensor) -> torch.Tensor:
    """Chain-wise geometric projection of q (..., 54) onto the joint
    manifold: along each leg chain the child's rotation becomes parent_R
    Ry(theta*), theta* the best-fit pure pitch of the relative rotation
    (max trace alignment); the tail links get the Hooke fit Ry(a) Rz(b).
    The base position and the free links (base, bodyF, neck) pass through.
    Each output coordinate takes the 2 pi branch nearest its input."""
    from ..ops.rotations import euler_zyx_inverse, rot_y, rot_z

    R_raw = euler_zyx(_angles_from_q(q))              # (..., 17, 3, 3)
    R_new = {i: R_raw[..., i, :, :] for i in range(N_LINKS)}
    for a, b in REVOLUTE_PAIRS:
        Rp = R_new[LINK_INDEX[a]]
        Rrel = Rp.mT @ R_raw[..., LINK_INDEX[b], :, :]
        th = torch.atan2(Rrel[..., 0, 2] - Rrel[..., 2, 0],
                         Rrel[..., 0, 0] + Rrel[..., 2, 2])
        R_new[LINK_INDEX[b]] = Rp @ rot_y(th)
    for a, b in HOOKE_PAIRS:
        Rp = R_new[LINK_INDEX[a]]
        Rrel = Rp.mT @ R_raw[..., LINK_INDEX[b], :, :]
        bb = torch.atan2(Rrel[..., 1, 0], Rrel[..., 1, 1])
        aa = torch.atan2(Rrel[..., 0, 2], Rrel[..., 2, 2])
        R_new[LINK_INDEX[b]] = Rp @ rot_y(aa) @ rot_z(bb)
    ang = torch.stack([euler_zyx_inverse(R_new[i]) for i in range(N_LINKS)],
                      dim=-2)
    out = torch.cat([q[..., :3], ang.flatten(-2)], dim=-1)
    two_pi = 2.0 * np.pi
    return out + two_pi * torch.round((q - out) / two_pi)


# ---------------------------------------------------------------------------
# Relative ("pose") coordinates x in R^28
# ---------------------------------------------------------------------------

def _build_relative_maps():
    """Constant linear map q (54) -> stacked relative angles (54), plus the
    28-dim mask of the reduced pose (base 6, bodyF and neck angles, tail
    theta/psi, every leg's theta)."""
    A = np.zeros((54, 54))
    row = 0
    for j in range(6):                     # base: x y z phi theta psi
        A[row, j] = 1.0
        row += 1
    pairs = [  # (plus, minus)
        ("bodyF", "base"), ("neck", "bodyF"), ("base", "tail0"),
        ("tail0", "tail1"),
        ("bodyF", "UFL"), ("UFL", "LFL"), ("LFL", "HFL"),
        ("bodyF", "UFR"), ("UFR", "LFR"), ("LFR", "HFR"),
        ("base", "UBL"), ("UBL", "LBL"),
        ("base", "UBR"), ("UBR", "LBR"),
        ("LBL", "HBL"), ("LBR", "HBR"),
    ]
    for plus, minus in pairs:
        for k in range(3):
            A[row, _angle_col(_L[plus]) + k] += 1.0
            A[row, _angle_col(_L[minus]) + k] -= 1.0
            row += 1
    assert row == 54
    mask = np.zeros(54, dtype=bool)
    mask[0:12] = True                      # base 6 + bodyF 3 + neck 3
    mask[[13, 14, 16, 17]] = True          # tail0/tail1 theta+psi
    for j in range(18, 54, 3):             # all legs: theta only
        mask[j + 1] = True
    assert mask.sum() == 28
    return A, mask


_A_REL_FULL, REL_MASK = _build_relative_maps()
A_REL = _A_REL_FULL[REL_MASK]  # (28, 54)
NX = A_REL.shape[0]


def relative_pose(q: torch.Tensor) -> torch.Tensor:
    """q (..., 54) -> reduced relative pose x (..., 28), x = A_REL q."""
    A = constant("A_REL", q, lambda: A_REL)
    return torch.einsum("ij,...j->...i", A, q)
