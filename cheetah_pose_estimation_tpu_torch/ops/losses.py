"""Robust losses and their generalized-Gauss-Newton weights.

Port of ``cheetah_pose_estimation_tpu/ops/losses.py``: the reference's
smoothed three-part redescending loss, the Huber loss of the physics stage's
measurement term, the Cauchy and Fair losses (``results.plot_cost_functions``
draws them), and per-residual (gradient, curvature) weights for a cost
sum rho(w * r). The JAX package derives psi = rho' with ``jax.grad``
(``ops/losses.py:75-81``); here psi is written out term by term, in the same
arithmetic as that autodiff.

That includes its float32 overflow: the logistic steps are
``1 / (1 + exp(-(x - start)))`` and their derivative, as autodiff forms it,
is ``exp(-z) * (1 + exp(-z))**-2``. At the widest annealing scale
(s = 10, thresholds 30/100/200) a small residual makes exp(200) overflow
float32 to inf, and inf * 0 gives psi = NaN — so in float32 the JAX
package's s = 10 normal systems are NaN and every step of that stage is
rejected. The port keeps that behaviour so that both packages take the
same path on the same problem; float64 does not overflow there.
"""
from __future__ import annotations

import torch


def _step(start, x):
    return 1.0 / (1.0 + torch.exp(-(x - start)))


def _dstep(start, x):
    """d _step / dx exactly as reverse/forward-mode autodiff evaluates it."""
    E = torch.exp(-(x - start))
    return E * (1.0 + E) ** -2


def redescending(e: torch.Tensor, a=3.0, b=10.0, c=20.0) -> torch.Tensor:
    """Smoothed three-part redescending loss of |e| (reference formula)."""
    e = torch.abs(e)
    k1 = a * b - a**2 / 2
    k2 = a * (c - b) / 2
    cost = (1 - _step(a, e)) / 2 * e**2
    cost = cost + (_step(a, e) - _step(b, e)) * (a * e - a**2 / 2)
    cost = cost + (_step(b, e) - _step(c, e)) * (
        k1 + k2 * (1 - ((c - e) / (c - b))**2))
    return cost + _step(c, e) * (k1 + k2)


def redescending_psi(e: torch.Tensor, a=3.0, b=10.0, c=20.0) -> torch.Tensor:
    """psi(e) = d redescending / d e, signed; d|e|/de = +1 at e = 0 like
    JAX's ``abs`` derivative."""
    x = torch.abs(e)
    sa, sb, sc = _step(a, x), _step(b, x), _step(c, x)
    da, db, dc = _dstep(a, x), _dstep(b, x), _dstep(c, x)
    k1 = a * b - a**2 / 2
    k2 = a * (c - b) / 2
    u = (c - x) / (c - b)
    d = -da / 2 * x**2 + (1 - sa) * x
    d = d + (da - db) * (a * x - a**2 / 2) + (sa - sb) * a
    d = d + (db - dc) * (k1 + k2 * (1 - u**2)) \
        + (sb - sc) * k2 * 2 * u / (c - b)
    d = d + dc * (k1 + k2)
    return torch.where(e >= 0, d, -d)


def cauchy(r: torch.Tensor, c) -> torch.Tensor:
    """Cauchy loss c^2 log(1 + (r / c)^2) (JAX ``ops/losses.py:48-49``)."""
    return c**2 * torch.log1p((r / c)**2)


def fair(r: torch.Tensor, c) -> torch.Tensor:
    """Fair loss c^2 (|r| / c - log(1 + |r| / c)) (JAX
    ``ops/losses.py:52-54``)."""
    a = torch.abs(r) / c
    return c**2 * (a - torch.log1p(a))


def huber(r: torch.Tensor, delta) -> torch.Tensor:
    """Quadratic core, linear tail: the influence never vanishes."""
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def huber_psi(e: torch.Tensor, delta) -> torch.Tensor:
    """psi(e) = d huber / d e: e in the core, delta sign(e) in the tail
    (autodiff of ``0.5 * e * e`` gives e exactly)."""
    return torch.where(torch.abs(e) <= delta, e, delta * torch.sign(e))


PSI = {"redescending": redescending_psi, "huber": huber_psi}


def gauss_newton_weights(r: torch.Tensor, w: torch.Tensor,
                         curvature_floor: float = 1e-3, loss_params=(),
                         curvature_cap: float = 1.0,
                         loss: str = "redescending"):
    """Per-residual (gradient, curvature) weights for cost sum rho(w * r),
    rho the named ``loss`` with parameters ``loss_params`` (each
    broadcastable to r: redescending (a, b, c), huber (delta,)), in "irls"
    mode: curvature is the secant psi(e)/e clamped to [floor, cap]. Returns
    (d cost / d r, curvature >= 0)."""
    e = w * r
    psi = PSI[loss](e, *loss_params)
    secant = torch.abs(psi) / torch.clamp(torch.abs(e), min=1e-9)
    hval = torch.clamp(secant, curvature_floor, curvature_cap)
    return w * psi, w * w * hval
