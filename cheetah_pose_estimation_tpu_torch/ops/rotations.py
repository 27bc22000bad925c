"""Euler-angle rotation stacks and their closed-form angle derivatives.

Port of ``cheetah_pose_estimation_tpu/ops/rotations.py``: intrinsic z-y-x
Euler angles (phi roll about x, theta pitch about y, psi yaw about z) with
body-to-inertial rotation ``R = Rz(psi) @ Ry(theta) @ Rx(phi)``. The JAX
package differentiates the rotation stack with ``jax.jacfwd``
(``models/skeleton.py:361``); here dR/dangle is written out.

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
