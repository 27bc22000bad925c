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

from cheetah_pose_estimation_tpu.models.params import (
    LINK_INDEX, LINK_NAMES, N_LINKS, NQ, SubjectParams)

from ..ops.rotations import euler_zyx, euler_zyx_and_derivative

__all__ = ["LINK_NAMES", "MARKERS", "N_MARKERS", "fk_markers",
           "fk_markers_linear", "fk_markers_and_jacobian", "joint_residuals",
           "joint_residuals_and_jacobian", "com_position",
           "marker_coefficients"]

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
                                             xp)
    for name, sgn in (("UBL", -1.0), ("UBR", 1.0)):
        off = np.array([lB / 2, sgn * rB, 0.0])
        tops[_L[name]] = base_com + _rotate(R[..., i_base, :, :], off, xp)
    for thigh, calf, hock in _LEGS:
        tops[_L[calf]] = tops[_L[thigh]] + axis_w[..., _L[thigh], :]
        tops[_L[hock]] = tops[_L[calf]] + axis_w[..., _L[calf], :]
    top = xp.stack(tops, -2)
    bottom = top + axis_w
    com = top + 0.5 * axis_w
    return top, bottom, com


def _rotate(R, v: np.ndarray, xp):
    """R (..., 3, 3) @ constant v (3,)."""
    if xp is np:
        return R @ v
    return R @ torch.as_tensor(v, dtype=R.dtype, device=R.device)


def link_frames(q: torch.Tensor, params: SubjectParams) -> LinkFrames:
    """Forward kinematics for all 17 links of q (..., 54)."""
    R = euler_zyx(_angles_from_q(q))
    axis_len = torch.as_tensor(_AXIS * params.length[:, None], dtype=q.dtype,
                               device=q.device)
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
    anchors = ends[..., _MARKER_END, _MARKER_LINK, :]
    Rm = frames.R[..., _MARKER_LINK, :, :]
    off = torch.as_tensor(_MARKER_OFFSET, dtype=anchors.dtype,
                          device=anchors.device)
    return anchors + (Rm @ off[..., None])[..., 0]


def fk_markers(q: torch.Tensor, params: SubjectParams) -> torch.Tensor:
    """q (..., 54) -> marker positions (..., 24, 3) by the link chain."""
    return marker_positions(link_frames(q, params))


_COEF_CACHE = {}


def marker_coefficients(params: SubjectParams) -> np.ndarray:
    """(17, 24, 3) constant body-frame coefficient vectors c_{l,m}.

    The chain FK with q[0:3] = 0 is linear in the rotations, so setting
    R_l = e_0 e_j^T (all other rotations zero) leaves
    ``marker_m[0] = c_{l,m}[j]``: 51 numpy probes of the chain."""
    if params.name in _COEF_CACHE:
        return _COEF_CACHE[params.name]
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
    _COEF_CACHE[params.name] = C
    return C


def _coef(params: SubjectParams, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(marker_coefficients(params), dtype=like.dtype,
                           device=like.device)


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


def com_position(q: torch.Tensor, params: SubjectParams) -> torch.Tensor:
    """Mass-weighted whole-body centre of mass (..., 3)."""
    frames = link_frames(q, params)
    m = torch.as_tensor(params.mass, dtype=q.dtype, device=q.device)
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
    return torch.tensor([0.0, 1.0, 0.0], dtype=q.dtype, device=q.device)
