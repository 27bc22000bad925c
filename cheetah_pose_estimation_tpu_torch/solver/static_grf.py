"""Per-frame static GRF estimation.

Port of ``cheetah_pose_estimation_tpu/solver/static_grf.py``: for each frame
of a solved trajectory, with (q, dq, ddq) fixed, the contact forces that
minimise the squared base-DOF equation-of-motion residual subject to the
GRF bounds [0, GMAX] body weights, the friction polyhedron
MU GRFz >= sum GRFxy and the stance (feet outside their stance windows are
held at zero). A projected-gradient quadratic solve, batched over all
frames at once on the device of the inputs.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..dynamics import eom as dyn
from ..models.params import SubjectParams

N_G = dyn.N_FEET + dyn.N_FEET * dyn.N_POLYGON  # 20
MU = 1.3        # friction coefficient
GMAX = 5.0      # largest force component, body weights
ITERS = 150     # projected-gradient steps


def _project_feasible(g: torch.Tensor, stance: torch.Tensor
                      ) -> torch.Tensor:
    """Project g = [GRFz (4); GRFxy (16)] (N, 20) onto {0 <= g <= GMAX,
    friction cone, stance}."""
    gz = g[:, :4].clamp(0.0, GMAX) * stance
    gxy = g[:, 4:].reshape(-1, 4, 4).clamp(0.0, GMAX) * stance[:, :, None]
    scale = MU * gz / gxy.sum(dim=2).clamp_min(1e-12)
    gxy = gxy * scale.clamp_max(1.0)[:, :, None]
    return torch.cat([gz, gxy.reshape(-1, 16)], dim=1)


def estimate_static_grf(q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor,
                        stance: torch.Tensor, subject: SubjectParams
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-frames static GRF solve.

    Args:
      q, dq, ddq: (N, 54) trajectory state.
      stance: (N, 4) stance indicator per foot.
    Returns:
      (grf_z (N, 4), grf_xy (N, 4, 4)) in body-weight units.

    The base-DOF map ``A`` (N, 6, 20) of the forces is linear in them: the
    generalized forces of the 20 unit force components. The step is 1/L
    with L = trace(AᵀA) + 1e-6, iterated ``ITERS`` times from zero."""
    fs = subject.total_mass * dyn.GRAVITY
    M, cg = dyn.mass_and_bias(q, dq, subject)
    lhs6 = ((M @ ddq[..., None])[..., 0] + cg)[:, :6] / fs
    eye = torch.eye(N_G, dtype=q.dtype, device=q.device)
    A = dyn.grf_generalized_forces(
        q[:, None], eye[:, :4], eye[:, 4:].reshape(N_G, 4, 4), subject,
        fs)[..., :6].transpose(1, 2) / fs                    # (N, 6, 20)
    AtA = A.transpose(1, 2) @ A
    Atb = (A.transpose(1, 2) @ lhs6[..., None])[..., 0]
    L = torch.diagonal(AtA, dim1=1, dim2=2).sum(dim=1, keepdim=True) + 1e-6
    stance = stance.to(q.dtype)
    g = torch.zeros(q.shape[0], N_G, dtype=q.dtype, device=q.device)
    for _ in range(ITERS):
        grad = (AtA @ g[..., None])[..., 0] - Atb
        g = _project_feasible(g - grad / L, stance)
    return g[:, :4], g[:, 4:].reshape(-1, 4, 4)
