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
* **The fixed-length drivers** (:func:`lm_solve_scan`,
  :func:`lm_solve_annealed_scan`) run a step count known on the host, and
  every lane takes every step, so each step's annealing stage is the same
  on every lane and known on the host too: they make no host-side test of
  a tensor (no sync) per step. The while drivers read the lanes' loop
  condition on the host once per step.
* **The bordered solve** (:func:`_bordered_solve`, per-camera shutter
  delays as unknowns beside the trajectory) factors the banded block once
  per right-hand side on the card: the kernel takes one right-hand side,
  so the 1 + C columns go to it as B (1 + C) lanes of the same system.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..ops import banded, cuda_banded
from ..ops.banded import chol_nan

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


def scaled_system(g: torch.Tensor, H: banded.BlockBanded, lam: torch.Tensor,
                  diag_floor) -> Tuple[banded.BlockBanded, torch.Tensor,
                                       torch.Tensor]:
    """The damped, Jacobi-scaled system that the linear solver gets:
    (S H S + lam I) y = -S g with S = diag(H)^-1/2, and dq = S y. Returns
    (the scaled H, -S g, the scale s (B, N, d)). lam is per lane (B,)."""
    d = torch.diagonal(H.diag, dim1=-2, dim2=-1)
    d = torch.maximum(d, diag_floor.to(d.dtype)) if torch.is_tensor(
        diag_floor) else torch.clamp(d, min=diag_floor)
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
    return (banded.BlockBanded(Hs_diag, torch.stack(bands, 1)), -(g * s),
            s)


def _scaled_solve(g: torch.Tensor, H: banded.BlockBanded, lam: torch.Tensor,
                  diag_floor, linear_solver: Optional[str] = None
                  ) -> torch.Tensor:
    """Solve (H + lam * diag(H)) dq = -g via symmetric Jacobi scaling
    S = diag(H)^-1/2 (Marquardt damping, and the system's mixed scales
    normalized for the float32 factorization; :func:`scaled_system`).
    ``linear_solver=None`` picks the default for g's device."""
    if linear_solver is None:
        linear_solver = default_linear_solver(g)
    if linear_solver not in LINEAR_SOLVERS:
        raise ValueError(f"linear_solver={linear_solver!r}; one of "
                         f"{LINEAR_SOLVERS}")
    Hs, rhs, s = scaled_system(g, H, lam, diag_floor)
    if linear_solver == "cuda":
        y = cuda_banded.solve(Hs.diag.contiguous(), Hs.lower.contiguous(),
                              rhs.contiguous())
    elif linear_solver == "cr":
        y = banded.cr_solve(Hs, rhs)
    else:
        y = banded.solve(Hs, rhs)
    return y * s


def _lm_step(s: LMState, cost_fn, normal_fn, config: LMConfig,
             guard_fn: Optional[Callable] = None,
             guard_cap: Optional[torch.Tensor] = None) -> LMState:
    """One damped-GN attempt per lane with Nielsen's gain-ratio update.

    With ``guard_fn(q) -> (B,)`` and ``guard_cap`` (B,), a trial point whose
    guard value exceeds its lane's cap is rejected even if the cost fell
    (the physics stage guards its measurement and prior cost)."""
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
    if guard_fn is not None:
        improved = improved & (guard_fn(qn) <= guard_cap)
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


def lm_solve(cost_fn: Callable, normal_fn: Callable, q0: torch.Tensor,
             config: LMConfig = LMConfig()) -> LMState:
    """One-stage LM from q0 (B, N, d) (JAX ``gn.py:184-197``, the
    trajectory-generation tasks' solver): ``cost_fn(q) -> (B,)`` and
    ``normal_fn(q) -> (g, H)``. The loop runs while any lane is below
    ``max_iters`` and not done; a lane whose condition is false keeps its
    state (the batched ``while_loop``)."""
    s = _init_state(cost_fn, q0, config)
    while True:
        cond = (s.it < config.max_iters) & ~s.done
        if not bool(cond.any()):
            return s
        s = _select(cond, _lm_step(s, cost_fn, normal_fn, config), s)


def lm_solve_annealed(cost_fn: Callable, normal_fn: Callable,
                      q0: torch.Tensor,
                      stages: Tuple[Tuple[float, int], ...],
                      config: LMConfig = LMConfig(),
                      guard_fn: Optional[Callable] = None,
                      guard_cap: Optional[torch.Tensor] = None) -> LMState:
    """Graduated-non-convexity LM: ``cost_fn(q, scale)`` and
    ``normal_fn(q, scale)`` take a per-lane scale (B,). At a lane's stage
    boundary its cost is re-evaluated on the new surface, its convergence
    flag cleared and its damping reset; a stage that converged early
    fast-forwards to its boundary. ``guard_fn``/``guard_cap``: see
    :func:`_lm_step`."""
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
                      lambda q: normal_fn(q, scale), config,
                      guard_fn=guard_fn, guard_cap=guard_cap)
        ff = ns.done & (idx < n_stages - 1)
        ns = ns._replace(it=torch.where(ff, bounds[idx], ns.it),
                         done=ns.done & ~ff,
                         lam=torch.where(ff, lam0, ns.lam))
        s = _select(cond, ns, s)
        prev_scale = torch.where(cond, scale, prev_scale)


def lm_solve_annealed_scan(cost_fn: Callable, normal_fn: Callable,
                           q0: torch.Tensor,
                           stages: Tuple[Tuple[float, int], ...],
                           config: LMConfig = LMConfig(),
                           guard_fn: Optional[Callable] = None,
                           guard_cap: Optional[torch.Tensor] = None
                           ) -> LMState:
    """Graduated-non-convexity LM as a fixed-length loop (JAX
    ``gn.py:390-432``): every lane takes each stage's full step count
    (converged lanes stay frozen by the acceptance gate until the next
    stage instead of fast-forwarding). At a stage boundary whose scale
    differs from the last one, every lane's cost is re-evaluated on the
    new surface, its convergence flag cleared and its damping reset. The
    loop count and the stage boundaries come from ``stages`` alone, so no
    step reads a tensor on the host. ``guard_fn``/``guard_cap``: see
    :func:`_lm_step`."""
    B = q0.shape[0]
    scale = lambda v: torch.full((B,), v, dtype=q0.dtype, device=q0.device)
    prev = stages[0][0]
    s = _init_state(lambda q: cost_fn(q, scale(prev)), q0, config)
    for sc, iters in stages:
        if iters <= 0:
            continue
        s_t = scale(sc)
        if sc != prev:
            s = s._replace(cost=cost_fn(s.q, s_t),
                           done=torch.zeros_like(s.done),
                           lam=torch.full_like(s.lam, config.lam0),
                           nu=torch.full_like(s.nu, 2.0))
        prev = sc
        for _ in range(iters):
            s = _lm_step(s, lambda q: cost_fn(q, s_t),
                         lambda q: normal_fn(q, s_t), config,
                         guard_fn=guard_fn, guard_cap=guard_cap)
    return s


class BorderedState(NamedTuple):
    q: torch.Tensor           # (B, N, d)
    tau: torch.Tensor         # (B, C) border unknowns (shutter delays)
    cost: torch.Tensor        # (B,)
    lam: torch.Tensor
    nu: torch.Tensor
    it: torch.Tensor
    done: torch.Tensor
    n_accepted: torch.Tensor


def _solve_columns(Hs: banded.BlockBanded, rhs: torch.Tensor,
                   linear_solver: str) -> torch.Tensor:
    """Solve Hs X = rhs for the K columns of rhs (B, N, d, K). "cuda": the
    kernel on B K lanes, each column beside a copy of its system; "scan":
    one banded Cholesky per system and K substitutions."""
    B, N, d, K = rhs.shape
    if linear_solver == "cuda":
        rep = lambda x: x[:, None].expand((B, K) + x.shape[1:]).reshape(
            (B * K,) + x.shape[1:]).contiguous()
        x = cuda_banded.solve(rep(Hs.diag), rep(Hs.lower),
                              rhs.permute(0, 3, 1, 2).reshape(B * K, N, d)
                              .contiguous())
        return x.reshape(B, K, N, d).permute(0, 2, 3, 1)
    if linear_solver != "scan":
        raise ValueError(f"linear_solver={linear_solver!r}: the bordered "
                         "solve takes 'cuda' or 'scan'")
    L = banded.cholesky(Hs)
    return torch.stack([banded.solve_factored(L, rhs[..., k])
                        for k in range(K)], -1)


def _bordered_solve(gq: torch.Tensor, H: banded.BlockBanded,
                    gtau: torch.Tensor, Bmat: torch.Tensor,
                    Htt: torch.Tensor, lam: torch.Tensor, diag_floor,
                    linear_solver: Optional[str] = None):
    """Solve the bordered SPD systems (JAX ``gn.py:271-311``)

        [[H, Bmat], [Bmat^T, diag(Htt)]] [dq; dtau] = -[gq; gtau]

    per lane by the Schur complement on the banded block: the
    Jacobi-scaled, damped banded system (:func:`scaled_system`) is solved
    for 1 + C right-hand sides (-S gq and the scaled border columns), then
    the C x C Schur complement by a dense Cholesky. Shapes: gq (B, N, d),
    Bmat (B, N, d, C), Htt and gtau (B, C), lam (B,); ``diag_floor`` a
    scalar. Returns (dq (B, N, d), dtau (B, C)); a failed factorization
    gives NaN."""
    if linear_solver is None:
        linear_solver = default_linear_solver(gq)
    Hs, rhs0, s = scaled_system(gq, H, lam, diag_floor)
    st = torch.rsqrt(torch.clamp(Htt, min=diag_floor))
    Bs = Bmat * s[..., None] * st[:, None, None, :]
    Htt_s = 1.0 + _lanes(lam, 2)                  # Htt st^2 = 1 + lam
    X = _solve_columns(Hs, torch.cat([rhs0[..., None], Bs], -1),
                       linear_solver)
    y0, Y = X[..., 0], X[..., 1:]
    S = torch.diag_embed(Htt_s.expand_as(Htt)) \
        - torch.einsum("bndc,bndk->bck", Bs, Y)
    rt = -(gtau * st) - torch.einsum("bndc,bnd->bc", Bs, y0)
    dts = torch.cholesky_solve(rt[..., None], chol_nan(S))[..., 0]
    dqs = y0 - torch.einsum("bndc,bc->bnd", Y, dts)
    return dqs * s, dts * st


def _bordered_step(s: BorderedState, cost_fn, normal_fn,
                   config: LMConfig) -> BorderedState:
    """One damped-GN attempt per lane on the bordered state: the step of
    :func:`_lm_step` with the border's terms in the model's predicted
    decrease (and no step cap, guard or xtol, as in JAX)."""
    gq, H, gtau, Bmat, Htt = normal_fn(s.q, s.tau)
    dq, dtau = _bordered_solve(gq, H, gtau, Bmat, Htt, s.lam,
                               config.diag_floor, config.linear_solver)
    qn, taun = s.q + dq, s.tau + dtau
    cn = cost_fn(qn, taun)
    pred = -((gq * dq).sum((1, 2)) + (gtau * dtau).sum(1)
             + 0.5 * ((dq * banded.matvec(H, dq)).sum((1, 2))
                      + 2.0 * torch.einsum("bnd,bndc,bc->b", dq, Bmat, dtau)
                      + (Htt * dtau * dtau).sum(1)))
    rho = (s.cost - cn) / torch.clamp(pred, min=1e-30)
    improved = cn < s.cost
    accept = improved & ~s.done
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_new = torch.where(
        accept, torch.clamp(s.lam * shrink, config.lam_min, config.lam_max),
        torch.clamp(s.lam * s.nu, max=config.lam_max))
    nu_new = torch.where(accept, torch.full_like(s.nu, 2.0),
                         torch.clamp(s.nu * 2.0, max=1e8))
    ftol_eff = max(config.ftol, 8.0 * torch.finfo(s.cost.dtype).eps)
    scale = torch.clamp(s.cost.abs(), min=1e-30)
    converged = (accept & ((s.cost - cn) / scale < ftol_eff)) \
        | (~improved & (pred <= ftol_eff * scale))
    stalled = s.lam >= config.lam_max
    return BorderedState(
        q=torch.where(_lanes(accept, 3), qn, s.q),
        tau=torch.where(_lanes(accept, 2), taun, s.tau),
        cost=torch.where(accept, cn, s.cost),
        lam=torch.where(s.done, s.lam, lam_new), nu=nu_new, it=s.it + 1,
        done=s.done | converged | stalled,
        n_accepted=s.n_accepted + accept.long())


def lm_solve_bordered(cost_fn: Callable, normal_fn: Callable,
                      q0: torch.Tensor, tau0: torch.Tensor,
                      config: LMConfig = LMConfig()) -> BorderedState:
    """LM over the bordered state (q, tau) per lane (JAX ``gn.py:314-372``):
    ``cost_fn(q, tau) -> (B,)`` and ``normal_fn(q, tau) -> (gq, H, gtau,
    Bmat, Htt)`` with H block-banded and (Bmat, Htt) the border blocks. A
    tau entry with a huge Htt is pinned (its step scales to ~0). The loop
    runs while any lane is below ``max_iters`` and not done; a lane whose
    condition is false keeps its state."""
    st = _init_state(lambda q: cost_fn(q, tau0), q0, config)
    s = BorderedState(st.q, tau0, *st[1:])
    while True:
        cond = (s.it < config.max_iters) & ~s.done
        if not bool(cond.any()):
            return s
        ns = _bordered_step(s, cost_fn, normal_fn, config)
        s = BorderedState(*[torch.where(_lanes(cond, a.ndim), a, b)
                            for a, b in zip(ns, s)])
