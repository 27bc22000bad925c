"""Euler-angle rotation stacks and their closed-form angle derivatives.

Port of ``cheetah_pose_estimation_tpu/ops/rotations.py``: intrinsic z-y-x
Euler angles (phi roll about x, theta pitch about y, psi yaw about z) with
body-to-inertial rotation ``R = Rz(psi) @ Ry(theta) @ Rx(phi)``. The JAX
package differentiates the rotation stack with ``jax.jacfwd``
(``models/skeleton.py:361``) and the dynamics with nested autodiff; here
dR/dangle, d^2R/dangle^2 and the Euler-rate map's derivatives are written
out.

All functions broadcast over leading batch dimensions.
"""
from __future__ import annotations

from typing import Tuple

import torch


def euler_zyx(angles: torch.Tensor) -> torch.Tensor:
    """(..., 3) (phi, theta, psi) -> (..., 3, 3) ``Rz(psi) Ry(theta) Rx(phi)``."""
    return euler_zyx_and_derivative(angles, derivative=False)[0]


def euler_zyx_and_derivative(angles: torch.Tensor, derivative: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotation (..., 3, 3) and dR (..., 3, 3, 3) with
    ``dR[..., i, j, k] = d R[i, j] / d angle_k`` — the layout of
    ``jax.jacfwd(euler_zyx)``. With ``derivative=False`` dR is None."""
    phi, theta, psi = angles[..., 0], angles[..., 1], angles[..., 2]
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    R = mat([[cp * ct, cp * st * sf - sp * cf, cp * st * cf + sp * sf],
             [sp * ct, sp * st * sf + cp * cf, sp * st * cf - cp * sf],
             [-st, ct * sf, ct * cf]])
    if not derivative:
        return R, None
    z = torch.zeros_like(phi)
    d_phi = mat([[z, cp * st * cf + sp * sf, -cp * st * sf + sp * cf],
                 [z, sp * st * cf - cp * sf, -sp * st * sf - cp * cf],
                 [z, ct * cf, -ct * sf]])
    d_theta = mat([[-cp * st, cp * ct * sf, cp * ct * cf],
                   [-sp * st, sp * ct * sf, sp * ct * cf],
                   [-ct, -st * sf, -st * cf]])
    d_psi = mat([[-sp * ct, -sp * st * sf - cp * cf, -sp * st * cf + cp * sf],
                 [cp * ct, cp * st * sf - sp * cf, cp * st * cf + sp * sf],
                 [z, z, z]])
    return R, torch.stack([d_phi, d_theta, d_psi], dim=-1)


def euler_zyx_inverse(R: torch.Tensor) -> torch.Tensor:
    """(phi, theta, psi) (..., 3) from R = Rz(psi) Ry(theta) Rx(phi)
    (..., 3, 3); valid away from the theta = +-pi/2 gimbal lock."""
    theta = torch.atan2(-R[..., 2, 0],
                        torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2))
    phi = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    psi = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([phi, theta, psi], dim=-1)


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rot_y(theta: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about y."""
    c, s = torch.cos(theta), torch.sin(theta)
    z, one = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[c, z, s], [z, one, z], [-s, z, c]])


def rot_z(psi: torch.Tensor) -> torch.Tensor:
    """(...,) -> (..., 3, 3) rotation about z."""
    c, s = torch.cos(psi), torch.sin(psi)
    z, one = torch.zeros_like(psi), torch.ones_like(psi)
    return _mat([[c, -s, z], [s, c, z], [z, z, one]])


def euler_zyx_second_derivative(angles: torch.Tensor) -> torch.Tensor:
    """ddR (..., 3, 3, 3, 3) with ``ddR[..., i, j, a, b] = d^2 R[i, j] /
    d angle_a d angle_b``: each angle enters through its own factor of
    ``Rz(psi) Ry(theta) Rx(phi)``, so every second derivative is that
    product with the differentiated factors (the dynamics' velocity
    products need it, ``dynamics/eom.bias_terms``)."""
    phi, theta, psi = angles[..., 0], angles[..., 1], angles[..., 2]
    z, one = torch.zeros_like(phi), torch.ones_like(phi)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    def derivs(c, s, axis):
        """(R, R', R'') of the elementary rotation about ``axis``."""
        if axis == 0:
            return (mat([[one, z, z], [z, c, -s], [z, s, c]]),
                    mat([[z, z, z], [z, -s, -c], [z, c, -s]]),
                    mat([[z, z, z], [z, -c, s], [z, -s, -c]]))
        if axis == 1:
            return (mat([[c, z, s], [z, one, z], [-s, z, c]]),
                    mat([[-s, z, c], [z, z, z], [-c, z, -s]]),
                    mat([[-c, z, -s], [z, z, z], [s, z, -c]]))
        return (mat([[c, -s, z], [s, c, z], [z, z, one]]),
                mat([[-s, -c, z], [c, -s, z], [z, z, z]]),
                mat([[-c, s, z], [-s, -c, z], [z, z, z]]))

    X = derivs(torch.cos(phi), torch.sin(phi), 0)
    Y = derivs(torch.cos(theta), torch.sin(theta), 1)
    Zr = derivs(torch.cos(psi), torch.sin(psi), 2)
    rows = []
    for a in range(3):
        cols = []
        for b in range(3):
            n = [0, 0, 0]
            n[a] += 1
            n[b] += 1
            cols.append(Zr[n[2]] @ Y[n[1]] @ X[n[0]])
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def euler_rate_to_body_omega(angles: torch.Tensor, derivative: bool = False):
    """E (..., 3, 3) with ``omega_body = E @ [dphi, dtheta, dpsi]`` for
    R = Rz(psi) Ry(theta) Rx(phi):

      omega_b = [dphi, 0, 0] + Rx(phi)^T [0, dtheta, 0]
                + (Ry(theta) Rx(phi))^T [0, 0, dpsi].

    With ``derivative=True`` returns (E, dE) with dE (..., 3, 3, 2) the
    derivatives by phi and theta (E does not depend on psi)."""
    phi, theta = angles[..., 0], angles[..., 1]
    cf, sf = torch.cos(phi), torch.sin(phi)
    ct, st = torch.cos(theta), torch.sin(theta)
    z, one = torch.zeros_like(phi), torch.ones_like(phi)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    E = mat([[one, z, -st], [z, cf, ct * sf], [z, -sf, ct * cf]])
    if not derivative:
        return E
    dE_phi = mat([[z, z, z], [z, -sf, ct * cf], [z, -cf, -ct * sf]])
    dE_theta = mat([[z, z, -ct], [z, z, -st * sf], [z, z, -st * cf]])
    return E, torch.stack([dE_phi, dE_theta], dim=-1)


def euler_rate_to_world_omega(angles: torch.Tensor) -> torch.Tensor:
    """Ew (..., 3, 3) with ``omega_world = Ew @ [dphi, dtheta, dpsi]``:
    omega_w = dpsi z + dtheta Rz(psi) y + dphi Rz(psi) Ry(theta) x."""
    theta, psi = angles[..., 1], angles[..., 2]
    ct, st = torch.cos(theta), torch.sin(theta)
    cp, sp = torch.cos(psi), torch.sin(psi)
    z, one = torch.zeros_like(theta), torch.ones_like(theta)
    return _mat([[cp * ct, -sp, z], [sp * ct, cp, z], [-st, z, one]])
