"""Trust-region Levenberg-Marquardt over block-banded normal equations,
batched over trials.

Port of ``cheetah_pose_estimation_tpu/solver/gn.py``. Each lane (trial)
solves ``(H + lam * diag(H)) dq = -g`` and accepts the step iff its cost
decreases. The JAX package vmaps one lane's ``while_loop``/``scan``; here
the lanes are a leading tensor axis and every per-lane decision is a
masked ``torch.where``. Where a faithful-looking port can differ:

* **Independent lanes in the annealed loop.** Under ``vmap`` every lane of
  :func:`lm_solve_annealed` has its own iteration counter, stage index and
  scale, and its own lam/nu reset and fast-forward; so the scale passed to
  the cost and normal functions is a per-lane vector (B,). The loop runs
  while any lane's condition holds, and a lane whose condition is false
  keeps its state exactly (the batched ``while_loop`` computes the body for
  every lane and selects).
* **Acceptance.** ``improved = cn < cost`` rejects NaN trial points (a
  failed factorization gives NaN, and the damping then grows). The ftol
  floor is 8 eps of the dtype, and the relative drop divides by |cost|:
  the smoothed redescending cost can be negative.
* **The linear solver** is chosen from the tensors' device, not from a
  failure: "cuda" (the hand-written kernel, ``ops.cuda_banded``) for CUDA
  tensors and "scan" for CPU tensors, unless ``LMConfig.linear_solver``
  names one. :func:`_scaled_solve` makes that choice, in one place.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops import banded, cuda_banded

LINEAR_SOLVERS = ("scan", "cr", "cuda")


class LMConfig(NamedTuple):
    max_iters: int = 100
    lam0: float = 1e-2
    lam_min: float = 1e-12
    lam_max: float = 1e10
    ftol: float = 1e-8
    xtol: float = 0.0
    diag_floor: object = 1e-8
    step_cap: float = float("inf")
    linear_solver: Optional[str] = None   # None: default_linear_solver(g)


class LMState(NamedTuple):
    q: torch.Tensor           # (B, N, d)
    cost: torch.Tensor        # (B,)
    lam: torch.Tensor         # (B,)
    nu: torch.Tensor          # (B,)
    it: torch.Tensor          # (B,) int64
    done: torch.Tensor        # (B,) bool
    n_accepted: torch.Tensor  # (B,) int64


def default_linear_solver(x: torch.Tensor) -> str:
    return "cuda" if x.device.type == "cuda" else "scan"


def _lanes(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dims."""
    return x.view((-1,) + (1,) * (ndim - 1))


def _scaled_solve(g: torch.Tensor, H: banded.BlockBanded, lam: torch.Tensor,
                  diag_floor, linear_solver: Optional[str] = None
                  ) -> torch.Tensor:
    """Solve (H + lam * diag(H)) dq = -g via symmetric Jacobi scaling
    S = diag(H)^-1/2 (Marquardt damping, and the system's mixed scales
    normalized for the float32 factorization). lam is per lane (B,).
    ``linear_solver=None`` picks the default for g's device."""
    if linear_solver is None:
        linear_solver = default_linear_solver(g)
    if linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"linear_solver={linear_solver!r}; one of "
                         f"{LINEAR_SOLVERS}")
    d = torch.diagonal(H.diag, dim1=-2, dim2=-1)
    d = torch.maximum(d, torch.as_tensor(diag_floor, dtype=d.dtype,
                                         device=d.device))
    s = torch.rsqrt(d)                                       # (B, N, d)
    N, K = H.nblocks, H.bandwidth
    eye = torch.eye(H.block, dtype=H.diag.dtype, device=H.diag.device)
    Hs_diag = H.diag * s[..., :, None] * s[..., None, :] \
        + _lanes(lam, 4) * eye
    bands = []
    for k in range(1, K + 1):
        sk = torch.zeros_like(s)
        sk[:, : N - k] = s[:, k:]                            # s[t+k] rows
        bands.append(H.lower[:, k - 1] * sk[..., :, None] * s[..., None, :])
    Hs_lower = torch.stack(bands, 1)
    rhs = -(g * s)
    if linear_solver == "cuda":
        y = cuda_banded.solve(Hs_diag.contiguous(), Hs_lower.contiguous(),
                              rhs.contiguous())
    elif linear_solver == "cr":
        y = banded.cr_solve(banded.BlockBanded(Hs_diag, Hs_lower), rhs)
    else:
        y = banded.solve(banded.BlockBanded(Hs_diag, Hs_lower), rhs)
    return y * s


def _lm_step(s: LMState, cost_fn, normal_fn, config: LMConfig) -> LMState:
    """One damped-GN attempt per lane with Nielsen's gain-ratio update."""
    g, H = normal_fn(s.q)
    dq = _scaled_solve(g, H, s.lam, config.diag_floor, config.linear_solver)
    if config.step_cap != float("inf"):
        big = torch.clamp(dq.abs().flatten(1).amax(1), min=1e-30)
        dq = dq * _lanes(torch.clamp(config.step_cap / big, max=1.0), 3)
    qn = s.q + dq
    cn = cost_fn(qn)
    # predicted decrease under the quadratic model (H PSD => positive)
    pred = -((g * dq).sum((1, 2))
             + 0.5 * (dq * banded.matvec(H, dq)).sum((1, 2)))
    rho = (s.cost - cn) / torch.clamp(pred, min=1e-30)
    improved = cn < s.cost                       # False for NaN -> reject
    accept = improved & ~s.done
    q_new = torch.where(_lanes(accept, 3), qn, s.q)
    cost_new = torch.where(accept, cn, s.cost)
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_acc = torch.clamp(s.lam * shrink, config.lam_min, config.lam_max)
    lam_rej = torch.clamp(s.lam * s.nu, max=config.lam_max)
    lam_new = torch.where(accept, lam_acc, lam_rej)
    nu_new = torch.where(accept, torch.full_like(s.nu, 2.0),
                         torch.clamp(s.nu * 2.0, max=1e8))
    lam_new = torch.where(s.done, s.lam, lam_new)
    # ftol below the dtype's resolution is unreachable: floor at 8 eps
    ftol_eff = max(config.ftol, 8.0 * torch.finfo(s.cost.dtype).eps)
    scale = torch.clamp(s.cost.abs(), min=1e-30)
    rel_drop = (s.cost - cn) / scale
    small_step = dq.abs().flatten(1).amax(1) <= config.xtol
    converged = accept & ((rel_drop < ftol_eff) | small_step)
    # no-progress stall: the model predicts a negligible decrease and the
    # step still got rejected
    tiny_pred = pred <= ftol_eff * scale
    converged = converged | (~improved & tiny_pred)
    stalled = s.lam >= config.lam_max
    return LMState(q=q_new, cost=cost_new, lam=lam_new, nu=nu_new,
                   it=s.it + 1, done=s.done | converged | stalled,
                   n_accepted=s.n_accepted + accept.long())


def _init_state(cost_fn, q0: torch.Tensor, config: LMConfig) -> LMState:
    B = q0.shape[0]
    full = lambda v: torch.full((B,), v, dtype=q0.dtype, device=q0.device)
    zeros = torch.zeros(B, dtype=torch.long, device=q0.device)
    return LMState(q=q0, cost=cost_fn(q0), lam=full(config.lam0),
                   nu=full(2.0), it=zeros,
                   done=torch.zeros(B, dtype=torch.bool, device=q0.device),
                   n_accepted=zeros.clone())


def _select(mask: torch.Tensor, new: LMState, old: LMState) -> LMState:
    return LMState(*[torch.where(_lanes(mask, a.ndim), a, b)
                     for a, b in zip(new, old)])


def lm_solve_scan(cost_fn: Callable, normal_fn: Callable, q0: torch.Tensor,
                  config: LMConfig = LMConfig()
                  ) -> Tuple[LMState, torch.Tensor]:
    """Fixed-iteration variant: ``max_iters`` steps on every lane (done
    lanes are frozen by the acceptance gate). Returns the final state and
    the cost trace (max_iters, B)."""
    state = _init_state(cost_fn, q0, config)
    trace = []
    for _ in range(config.max_iters):
        state = _lm_step(state, cost_fn, normal_fn, config)
        trace.append(state.cost)
    return state, torch.stack(trace) if trace else q0.new_zeros((0,
                                                                 q0.shape[0]))


def lm_solve_annealed(cost_fn: Callable, normal_fn: Callable,
                      q0: torch.Tensor,
                      stages: Tuple[Tuple[float, int], ...],
                      config: LMConfig = LMConfig()) -> LMState:
    """Graduated-non-convexity LM: ``cost_fn(q, scale)`` and
    ``normal_fn(q, scale)`` take a per-lane scale (B,). At a lane's stage
    boundary its cost is re-evaluated on the new surface, its convergence
    flag cleared and its damping reset; a stage that converged early
    fast-forwards to its boundary."""
    n_stages = len(stages)
    dev = q0.device
    scales = torch.tensor([s for s, _ in stages], dtype=q0.dtype, device=dev)
    bounds = torch.cumsum(torch.tensor([it for _, it in stages], device=dev),
                          0)
    total = int(sum(it for _, it in stages))
    last_stage_start = int(sum(it for _, it in stages[:-1]))

    prev_scale = scales[0].expand(q0.shape[0]).clone()
    s = _init_state(lambda q: cost_fn(q, prev_scale), q0, config)
    lam0 = torch.full_like(s.lam, config.lam0)
    two = torch.full_like(s.nu, 2.0)

    while True:
        final_done = s.done & (s.it >= last_stage_start)
        cond = (s.it < total) & ~final_done
        if not bool(cond.any()):
            return s
        idx = torch.clamp(torch.searchsorted(bounds, s.it, right=True),
                          max=n_stages - 1)
        scale = scales[idx]
        changed = scale != prev_scale
        cost = s.cost
        if bool(changed.any()):
            cost = torch.where(changed, cost_fn(s.q, scale), cost)
        s2 = s._replace(cost=cost, done=s.done & ~changed,
                        lam=torch.where(changed, lam0, s.lam),
                        nu=torch.where(changed, two, s.nu))
        ns = _lm_step(s2, lambda q: cost_fn(q, scale),
                      lambda q: normal_fn(q, scale), config)
        ff = ns.done & (idx < n_stages - 1)
        ns = ns._replace(it=torch.where(ff, bounds[idx], ns.it),
                         done=ns.done & ~ff,
                         lam=torch.where(ff, lam0, ns.lam))
        s = _select(cond, ns, s)
        prev_scale = torch.where(cond, scale, prev_scale)
