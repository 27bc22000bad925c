"""Camera models: pinhole + equidistant fisheye, with closed-form Jacobians.

Port of ``cheetah_pose_estimation_tpu/ops/camera.py`` (OpenCV conventions:
x_c = R X + t, a = x/z, b = y/z, K with zero skew). The JAX package takes the
2x3 projection Jacobian with a per-point ``jax.jacfwd``
(``solver/kinematic.py:525-529``); here it is written out by the chain rule

    d uv / d X = diag(fx, fy) @ d(distorted) / d(a, b) @ d(a, b) / d x_c @ R.

Camera parameters broadcast against the points' leading dimensions:
K (..., 3, 3), D (..., 4), R (..., 3, 3), t (..., 3).
"""
from __future__ import annotations

from typing import Tuple

import torch


def world_to_cam(X: torch.Tensor, R: torch.Tensor, t: torch.Tensor
                 ) -> torch.Tensor:
    return (R @ X[..., None])[..., 0] + t


def _powers(x: torch.Tensor):
    """(x^2, x^3, x^4) rounded as XLA's ``integer_pow`` forms them (x*x,
    x*x^2, x^2*x^2): ``torch.pow(x, 4)`` rounds differently, and float32
    parity with the JAX package depends on it."""
    x2 = x * x
    return x2, x * x2, x2 * x2


def _apply_K(xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    u = K[..., 0, 0] * xy[..., 0] + K[..., 0, 2]
    v = K[..., 1, 1] * xy[..., 1] + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def _fisheye(ab: torch.Tensor, D: torch.Tensor, jacobian: bool):
    """Equidistant distortion of (a, b) and its 2x2 Jacobian."""
    a, b = ab[..., 0], ab[..., 1]
    r = torch.sqrt(a * a + b * b)
    th = torch.arctan(r)
    th2 = th * th
    t2, t3, t4 = _powers(th2)
    d0, d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]
    th_d = th * (1 + d0 * th2 + d1 * t2 + d2 * t3 + d3 * t4)
    rr = r + 1e-12
    scale = th_d / rr
    out = ab * scale[..., None]
    if not jacobian:
        return out, None
    dthd_dth = 1 + 3 * d0 * th2 + 5 * d1 * t2 + 7 * d2 * t3 + 9 * d3 * t4
    dthd_dr = dthd_dth / (1 + r * r)
    dscale_dr = (dthd_dr * rr - th_d) / (rr * rr)
    g = dscale_dr / r                  # d scale / d a = g * a (chain via r)
    Jd = torch.stack([torch.stack([scale + a * a * g, a * b * g], -1),
                      torch.stack([a * b * g, scale + b * b * g], -1)], -2)
    return out, Jd


def _pinhole(ab: torch.Tensor, D: torch.Tensor, jacobian: bool):
    """Radial polynomial distortion of (a, b) and its 2x2 Jacobian."""
    a, b = ab[..., 0], ab[..., 1]
    r2 = a * a + b * b
    d0, d1, d2 = D[..., 0], D[..., 1], D[..., 2]
    d = 1 + d0 * r2 + d1 * r2**2 + d2 * r2**3
    out = ab * d[..., None]
    if not jacobian:
        return out, None
    g = 2.0 * (d0 + 2 * d1 * r2 + 3 * d2 * r2**2)
    Jd = torch.stack([torch.stack([d + a * a * g, a * b * g], -1),
                      torch.stack([a * b * g, d + b * b * g], -1)], -2)
    return out, Jd


def _project(X, K, D, R, t, distort, jacobian: bool):
    Xc = world_to_cam(X, R, t)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    ab = Xc[..., :2] / Xc[..., 2:3]
    dist, Jd = distort(ab, D, jacobian)
    uv = _apply_K(dist, K)
    if not jacobian:
        return uv, None
    zero = torch.zeros_like(z)
    inv_z = 1.0 / z
    Jab = torch.stack([torch.stack([inv_z, zero, -x / (z * z)], -1),
                       torch.stack([zero, inv_z, -y / (z * z)], -1)], -2)
    fxy = torch.stack([K[..., 0, 0], K[..., 1, 1]], -1)
    fxy = fxy.expand(Jd.shape[:-2] + (2,))
    return uv, (fxy[..., :, None] * Jd) @ Jab @ R


def project_fisheye(X: torch.Tensor, K, D, R, t) -> torch.Tensor:
    """World points (..., 3) -> pixel coords (..., 2), fisheye model."""
    return _project(X, K, D, R, t, _fisheye, False)[0]


def project_pinhole(X: torch.Tensor, K, D, R, t) -> torch.Tensor:
    """World points (..., 3) -> pixel coords (..., 2), pinhole model."""
    return _project(X, K, D, R, t, _pinhole, False)[0]


def project_fisheye_and_jacobian(X: torch.Tensor, K, D, R, t
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords (..., 2) and d uv / d X (..., 2, 3), fisheye model."""
    return _project(X, K, D, R, t, _fisheye, True)


def project_pinhole_and_jacobian(X: torch.Tensor, K, D, R, t
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel coords (..., 2) and d uv / d X (..., 2, 3), pinhole model."""
    return _project(X, K, D, R, t, _pinhole, True)


def _unapply_K(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    x = (uv[..., 0] - K[..., 0, 2]) / K[..., 0, 0]
    y = (uv[..., 1] - K[..., 1, 2]) / K[..., 1, 1]
    return torch.stack([x, y], dim=-1)


def undistort_fisheye(uv: torch.Tensor, K, D, iters: int = 20
                      ) -> torch.Tensor:
    """Pixel coords -> undistorted normalized coords (Newton on theta)."""
    xy = _unapply_K(uv, K)
    th_d = torch.sqrt((xy * xy).sum(-1))
    d0, d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2], D[..., 3]
    th = th_d
    for _ in range(iters):
        th2 = th * th
        t2, t3, t4 = _powers(th2)
        f = th * (1 + d0 * th2 + d1 * t2 + d2 * t3 + d3 * t4)
        df = 1 + 3 * d0 * th2 + 5 * d1 * t2 + 7 * d2 * t3 + 9 * d3 * t4
        th = th - (f - th_d) / df
    ok = th_d > 1e-12
    scale = torch.tan(th) / torch.where(ok, th_d, torch.ones_like(th_d))
    return xy * torch.where(ok, scale, torch.ones_like(scale))[..., None]


def undistort_pinhole(uv: torch.Tensor, K, D, iters: int = 20
                      ) -> torch.Tensor:
    """Pixel coords -> undistorted normalized coords (radial model)."""
    xy_d = _unapply_K(uv, K)
    xy = xy_d
    for _ in range(iters):
        r2 = (xy * xy).sum(-1)
        d = 1 + D[..., 0] * r2 + D[..., 1] * r2**2 + D[..., 2] * r2**3
        xy = xy_d / d[..., None]
    return xy


def backproject_to_distance(ab: torch.Tensor, dist, R: torch.Tensor,
                            t: torch.Tensor) -> torch.Tensor:
    """Normalized coords (..., 2) at camera-frame depth ``dist`` (scalar or
    (...,)) -> world."""
    dist = torch.as_tensor(dist, dtype=ab.dtype, device=ab.device)
    Xc = dist[..., None] * torch.cat([ab, torch.ones_like(ab[..., :1])], -1)
    Rt = R.transpose(-1, -2)
    return (Rt @ Xc[..., None])[..., 0] - (Rt @ t[..., None])[..., 0]
