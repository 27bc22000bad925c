"""Symmetric positive-definite block-banded linear algebra, batched.

Port of ``cheetah_pose_estimation_tpu/ops/banded.py`` in plain torch with an
explicit leading trial axis. These solvers are the CPU path of the port and
the oracle the CUDA kernel (``ops.cuda_banded``) is held against.

Storage layout for a batch of symmetric block-banded matrices with N
diagonal blocks of size d and lower bandwidth K:

* ``diag``: (B, N, d, d) — H[t, t]
* ``lower``: (B, K, N, d, d) — ``lower[:, k-1, t] = H[t+k, t]``; entries
  with t >= N-k are ignored.

A failed factorization yields NaN in that trial's lane (as
``jnp.linalg.cholesky`` does), so the LM driver rejects the step and raises
the damping: ``torch.linalg.cholesky`` would raise instead, so every
factorization here goes through ``cholesky_ex`` and writes NaN into the
failed lanes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch


class BlockBanded(NamedTuple):
    diag: torch.Tensor   # (B, N, d, d)
    lower: torch.Tensor  # (B, K, N, d, d); lower[:, k-1, t] = H[t+k, t]

    @property
    def nblocks(self) -> int:
        return self.diag.shape[-3]

    @property
    def bandwidth(self) -> int:
        return self.lower.shape[-4]

    @property
    def block(self) -> int:
        return self.diag.shape[-1]


def chol_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., d, d); NaN where A is not SPD."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(L, float("nan")), L)


def _trsm(L: torch.Tensor, X: torch.Tensor, transpose: bool = False
          ) -> torch.Tensor:
    """L^-1 X (or L^-T X) for lower-triangular L."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, X, upper=True)
    return torch.linalg.solve_triangular(L, X, upper=False)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def matvec(H: BlockBanded, x: torch.Tensor) -> torch.Tensor:
    """H @ x for x of shape (B, N, d)."""
    N = H.nblocks
    y = _mv(H.diag, x)
    for k in range(1, H.bandwidth + 1):
        if N - k <= 0:
            continue
        Lk = H.lower[:, k - 1, : N - k]                  # (B, N-k, d, d)
        lo = _mv(Lk, x[:, :-k])                           # y[t+k] += H x[t]
        up = _mv(Lk.mT, x[:, k:])                         # y[t] += H^T x[t+k]
        y = y + torch.cat([torch.zeros_like(y[:, :k]), lo], 1) \
            + torch.cat([up, torch.zeros_like(y[:, :k])], 1)
    return y


def to_dense(H: BlockBanded) -> torch.Tensor:
    """Materialize as (B, N*d, N*d) (tests only)."""
    Bt, N, d = H.diag.shape[0], H.nblocks, H.block
    A = H.diag.new_zeros((Bt, N * d, N * d))
    for t in range(N):
        A[:, t * d:(t + 1) * d, t * d:(t + 1) * d] = H.diag[:, t]
    for k in range(1, H.bandwidth + 1):
        for t in range(N - k):
            blk = H.lower[:, k - 1, t]
            A[:, (t + k) * d:(t + k + 1) * d, t * d:(t + 1) * d] = blk
            A[:, t * d:(t + 1) * d, (t + k) * d:(t + k + 1) * d] = blk.mT
    return A


def cholesky(H: BlockBanded) -> BlockBanded:
    """Blocked banded Cholesky H = L L^T, frame by frame over time.

    Row t of L: for j = K..1, L[t, t-j] = (H[t, t-j] - sum_{k>j}
    L[t, t-k] L[t-j, t-k]^T) L[t-j, t-j]^-T, then L[t, t] =
    chol(H[t, t] - sum_j L[t, t-j] L[t, t-j]^T). Blocks reaching before
    frame 0 are structurally zero and skipped."""
    N, K = H.nblocks, H.bandwidth
    Ldiag: List[torch.Tensor] = []
    band: List[dict] = []          # band[t][j] = L[t, t-j]
    for t in range(N):
        row = {}
        for j in range(min(K, t), 0, -1):
            M = H.lower[:, j - 1, t - j]                  # H[t, t-j]
            for k in range(j + 1, min(K, t) + 1):
                M = M - row[k] @ band[t - j][k - j].mT
            row[j] = _trsm(Ldiag[t - j], M.mT).mT
        S = H.diag[:, t]
        for j in row:
            S = S - row[j] @ row[j].mT
        Ldiag.append(chol_nan(S))
        band.append(row)
    lower = torch.zeros_like(H.lower)
    for k in range(1, K + 1):
        for t in range(N - k):
            lower[:, k - 1, t] = band[t + k][k]
    return BlockBanded(torch.stack(Ldiag, 1), lower)


def solve_factored(L: BlockBanded, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b given the banded Cholesky factor; b (B, N, d)."""
    N, K = L.nblocks, L.bandwidth
    ys: List[torch.Tensor] = []
    for t in range(N):
        s = b[:, t]
        for k in range(1, min(K, t) + 1):
            s = s - _mv(L.lower[:, k - 1, t - k], ys[t - k])   # L[t, t-k]
        ys.append(_trsm(L.diag[:, t], s[..., None])[..., 0])
    xs: List[torch.Tensor] = [None] * N
    for t in range(N - 1, -1, -1):
        s = ys[t]
        for k in range(1, min(K, N - 1 - t) + 1):
            s = s - _mv(L.lower[:, k - 1, t].mT, xs[t + k])    # L[t+k, t]^T
        xs[t] = _trsm(L.diag[:, t], s[..., None], transpose=True)[..., 0]
    return torch.stack(xs, 1)


def solve(H: BlockBanded, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for a batch of SPD block-banded H; b (B, N, d)."""
    return solve_factored(cholesky(H), b)


# ---------------------------------------------------------------------------
# Block cyclic reduction over the time axis
# ---------------------------------------------------------------------------

def _tridiagonalize(H: BlockBanded, b: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group frames ``s = bandwidth`` at a time into super-blocks of size
    D = s*d: the system becomes block-tridiagonal,
    C_i x_{i-1} + A_i x_i + C_{i+1}^T x_{i+1} = b_i (padded frames get an
    identity diagonal and zero rhs). Returns A, C (B, M, D, D), bs (B, M, D)."""
    Bt, N, s, d = H.diag.shape[0], H.nblocks, H.bandwidth, H.block
    M = -(-N // s)
    Np = M * s
    eye = torch.eye(d, dtype=H.diag.dtype, device=H.diag.device)
    diag = torch.cat([H.diag, eye.expand(Bt, Np - N, d, d)], 1)
    lower = H.diag.new_zeros((Bt, s, Np, d, d))
    for k in range(1, s + 1):
        nv = max(N - k, 0)
        if nv:
            lower[:, k - 1, :nv] = H.lower[:, k - 1, :nv]
    A = H.diag.new_zeros((Bt, M, s, s, d, d))
    C = H.diag.new_zeros((Bt, M, s, s, d, d))
    idx = torch.arange(M, device=H.diag.device) * s
    for u in range(s):
        A[:, :, u, u] = diag[:, idx + u]
        for v in range(u):
            blk = lower[:, u - v - 1][:, idx + v]         # H[i*s+u, i*s+v]
            A[:, :, u, v] = blk
            A[:, :, v, u] = blk.mT
        for v in range(u, s):
            k = s + u - v                                  # offset in [1, s]
            blk = lower[:, k - 1][:, torch.clamp(idx - s + v, min=0)]
            C[:, 1:, u, v] = blk[:, 1:]
    A = A.permute(0, 1, 2, 4, 3, 5).reshape(Bt, M, s * d, s * d)
    C = C.permute(0, 1, 2, 4, 3, 5).reshape(Bt, M, s * d, s * d)
    bs = torch.cat([b, b.new_zeros((Bt, Np - N, d))], 1).reshape(Bt, M,
                                                                 s * d)
    return A, C, bs


def _chol_solve(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return _trsm(L, _trsm(L, X), transpose=True)


def _cr_factor_tridiag(A: torch.Tensor, C: torch.Tensor):
    """Cyclic-reduction factorization of SPD block-tridiagonal systems
    (leading trial axis). Returns per-level (Co, Cr, Ce, Lo) and the final
    one-block factor."""
    Bt, M, D = A.shape[0], A.shape[1], A.shape[-1]
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    levels = []
    while M > 1:
        if M % 2 == 1:
            A = torch.cat([A, eye.expand(Bt, 1, D, D)], 1)
            C = torch.cat([C, C.new_zeros((Bt, 1, D, D))], 1)
            M += 1
        Ao, Co = A[:, 1::2], C[:, 1::2]
        Ae, Ce = A[:, 0::2], C[:, 0::2]
        Lo = chol_nan(Ao)
        Cr = torch.cat([Ce[:, 1:], Ce.new_zeros((Bt, 1, D, D))], 1)
        sol = _chol_solve(Lo, torch.cat([Co, Cr.mT], -1))
        Gi, Hi = sol[..., :D], sol[..., D:]
        zero = Gi.new_zeros((Bt, 1, D, D))
        Hl = torch.cat([zero, Hi[:, :-1]], 1)
        Gl = torch.cat([zero, Gi[:, :-1]], 1)
        A_new = Ae - Ce @ Hl - Co.mT @ Gi
        C_new = -(Ce @ Gl)
        levels.append((Co, Cr, Ce, Lo))
        A, C = A_new, C_new
        M //= 2
    return levels, chol_nan(A[:, 0])


def _cr_apply(levels, L0: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Substitution pass of the CR factorization, b (B, M, D)."""
    Bt = b.shape[0]
    bos = []
    for Co, Cr, Ce, Lo in levels:
        if b.shape[1] % 2 == 1:
            b = torch.cat([b, b.new_zeros((Bt, 1, b.shape[-1]))], 1)
        bo, be = b[:, 1::2], b[:, 0::2]
        yi = _chol_solve(Lo, bo[..., None])[..., 0]
        yl = torch.cat([torch.zeros_like(yi[:, :1]), yi[:, :-1]], 1)
        b = be - _mv(Ce, yl) - _mv(Co.mT, yi)
        bos.append(bo)
    x = _chol_solve(L0, b[:, 0, :, None])[..., 0][:, None]
    for (Co, Cr, Ce, Lo), bo in zip(reversed(levels), reversed(bos)):
        K = Co.shape[1]
        x = x[:, :K]
        x_right = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], 1)
        r = bo - _mv(Co, x) - _mv(Cr.mT, x_right)
        xo = _chol_solve(Lo, r[..., None])[..., 0]
        x = torch.stack([x, xo], 2).reshape(Bt, 2 * K, -1)
    return x


def cr_solve(H: BlockBanded, b: torch.Tensor, refine: int = 1
             ) -> torch.Tensor:
    """Solve H x = b by block cyclic reduction over the time axis, with
    ``refine`` passes of iterative refinement reusing the factorization."""
    Bt, N, d = b.shape
    A, C, bs = _tridiagonalize(H, b)
    levels, L0 = _cr_factor_tridiag(A, C)
    M = bs.shape[1]
    x = _cr_apply(levels, L0, bs)[:, :M]
    xb = x.reshape(Bt, -1, d)[:, :N]
    for _ in range(refine):
        r = b - matvec(H, xb)
        rs = torch.cat([r, r.new_zeros((Bt, M * bs.shape[2] // d - N, d))],
                       1).reshape(bs.shape)
        dx = _cr_apply(levels, L0, rs)[:, :M]
        xb = xb + dx.reshape(Bt, -1, d)[:, :N]
    return xb
