"""Batched block-banded SPD solve as a hand-written CUDA kernel.

Counterpart of ``cheetah_pose_estimation_tpu/ops/pallas_banded.py`` (whose
two ``pallas_call``s, ``_fwd_kernel`` and ``_bwd_kernel``, factor and solve
the same systems on the TPU). Here one kernel,
``csrc/banded_solve.cu``, does both passes with one thread block per system,
keeping each diagonal factor as its inverse so that the triangular solves
are products; the source says what bounds it and why it is laid out so.

Layout (``ops.banded.BlockBanded``, batched): diag (B, N, 54, 54), lower
(B, 3, N, 54, 54) with ``lower[:, k-1, t] = H[t+k, t]``, rhs (B, N, 54)
-> x (B, N, 54).

:func:`solve` launches the kernel for CUDA float32 tensors and raises on
anything else the kernel does not take; for CPU tensors it runs
:func:`solve_reference`, the plain PyTorch version (substitutions), which is
also the chip check's yardstick. :func:`solve_reference_blocked` is the
plain twin of the kernel's own order of operations (blocked Cholesky,
explicit inverses, products); the tests hold its float32 conditioning.
There is no fallback from the card to the plain version. The kernel is
compiled with ``nvcc`` from the repository's source at first use into
``build/kernels/`` and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from .banded import BlockBanded, backward_error, row_sum_norm, to_dense

D = 54          # block size the kernel is compiled for
BW = 3          # bandwidth
PANEL = 18      # panel width of the kernel's blocked Cholesky and inverse

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "banded_solve.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches made through :func:`solve` (the main path's count), in
# all and per (B, N) shape; :func:`reset_launches` zeroes both
launches = 0
launches_by_shape = {}
# nvcc's output of this process's build (registers, shared memory, spills)
build_log = ""

_lib = None
# the CUDA devices the kernel's shared memory is allowed on, and the lock
# that the library, that set and the counts share (the trial mesh launches
# from one host thread per device)
_ready = set()
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build(defines: tuple = ()) -> Path:
    """Compile the kernel into ``build/kernels/`` (keyed by the source's
    hash and the flags, so an edited source never loads a stale library).
    ``defines`` are extra ``-D`` macros: only the phase probe of
    ``ops/banded_probe.py`` passes one. Returns the shared library's path."""
    global build_log
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libbanded_solve_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def load_library(path: Path):
    """Bind the kernel's C entry point in the library at ``path`` and allow
    the kernel its shared memory on the current device (once, here, not per
    launch)."""
    lib = ctypes.CDLL(str(path))
    fn = lib.banded_solve_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.banded_solve_init()
    if err != 0:
        raise RuntimeError(f"banded_solve kernel setup failed: CUDA error "
                           f"{err}")
    return lib


class KernelInputError(RuntimeError):
    """Tensors the kernel does not take. A ``RuntimeError``, like the
    build and launch errors: the physics-based mode's fallback, which
    catches ``ValueError``, never takes it for a failed solve."""


def _check(diag: torch.Tensor, lower: torch.Tensor, rhs: torch.Tensor):
    B, N = rhs.shape[0], rhs.shape[1]
    want = {"diag": (B, N, D, D), "lower": (B, BW, N, D, D), "rhs": (B, N, D)}
    for name, t in (("diag", diag), ("lower", lower), ("rhs", rhs)):
        if tuple(t.shape) != want[name]:
            raise KernelInputError(f"{name} has shape {tuple(t.shape)}, the "
                                   f"kernel takes {want[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.device != rhs.device:
            raise KernelInputError("diag, lower and rhs must be on one "
                                   "device")
        if not t.is_contiguous():
            raise KernelInputError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise KernelInputError(f"{name} must be 16-byte aligned (the "
                                   "kernel copies its blocks in 16-byte "
                                   "chunks)")


def solve(diag: torch.Tensor, lower: torch.Tensor, rhs: torch.Tensor
          ) -> torch.Tensor:
    """Solve B SPD block-banded systems. CUDA float32 tensors go through the
    kernel (or raise); CPU tensors through :func:`solve_reference`."""
    global launches
    if rhs.device.type == "cpu":
        return solve_reference(diag, lower, rhs)
    if rhs.device.type != "cuda":
        raise KernelInputError(f"no banded-solve kernel for device "
                               f"{rhs.device}")
    _check(diag, lower, rhs)
    B, N = rhs.shape[0], rhs.shape[1]
    x = torch.empty_like(rhs)
    if B == 0 or N == 0:
        return x
    work = torch.empty((B, N, BW + 1, D, D), dtype=rhs.dtype,
                       device=rhs.device)
    lib = _load(rhs.device)
    launch(lib, diag, lower, rhs, x, work)
    with _lock:
        launches += 1
        launches_by_shape[B, N] = launches_by_shape.get((B, N), 0) + 1
    return x


def reset_launches() -> None:
    global launches
    with _lock:
        launches = 0
        launches_by_shape.clear()


def _load(device: torch.device):
    """The main path's library, built and bound at first use, with the
    kernel's shared memory allowed on ``device`` (once per device)."""
    global _lib
    with _lock, torch.cuda.device(device):
        index = torch.cuda.current_device()
        if _lib is None:
            _lib = load_library(build())
        elif index not in _ready:
            err = _lib.banded_solve_init()
            if err != 0:
                raise RuntimeError(f"banded_solve kernel setup failed on "
                                   f"cuda:{index}: CUDA error {err}")
        _ready.add(index)
    return _lib


def launch(lib, diag, lower, rhs, x, work) -> None:
    """One launch of the kernel in ``lib`` on the current stream; raises if
    it was refused."""
    B, N = rhs.shape[0], rhs.shape[1]
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream(rhs.device).cuda_stream
        err = lib.banded_solve_f32(
            diag.data_ptr(), lower.data_ptr(), rhs.data_ptr(), x.data_ptr(),
            work.data_ptr(), B, N, stream)
    if err != 0:
        raise RuntimeError(f"banded_solve kernel launch failed: CUDA error "
                           f"{err}")


def random_systems(B: int, N: int, seed: int, device) -> list:
    """Block-diagonally dominant SPD systems in the kernel's layout, float32
    on ``device``, from a numpy seed (the kernel's tests, the chip check and
    the phase probe)."""
    rng = np.random.default_rng(seed)
    lower = 0.02 * rng.normal(size=(B, BW, N, D, D))
    for k in range(1, BW + 1):
        lower[:, k - 1, max(N - k, 0):] = 0.0
    sym = rng.normal(size=(B, N, D, D))
    diag = 0.1 * (sym + np.swapaxes(sym, -1, -2)) + 20.0 * np.eye(D)
    rhs = rng.normal(size=(B, N, D))
    return [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in (diag, lower, rhs)]


def solve_reference(diag: torch.Tensor, lower: torch.Tensor,
                    rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function: the same frame loop,
    each factor row built against the 3-deep window of earlier rows by
    triangular solves and kept for the backward pass, and a failed pivot
    turning the whole lane's solution to NaN. Any dtype and device; batched
    over the leading axis."""
    B, N, d = rhs.shape
    K = lower.shape[1]
    rows = []          # rows[t][j] = L[t, t-j] (j = 1..3), rows[t][0] = L[t, t]
    ys = []
    bad = torch.zeros(B, dtype=torch.bool, device=rhs.device)
    for t in range(N):
        nb = min(t, K)
        row = {j: lower[:, j - 1, t - j] for j in range(1, nb + 1)}
        for j in range(nb, 0, -1):
            M = row[j]                                   # H[t, t-j]
            for k in range(j + 1, nb + 1):
                M = M - row[k] @ rows[t - j][k - j].mT
            row[j] = torch.linalg.solve_triangular(rows[t - j][0], M.mT,
                                                   upper=False).mT
        S = diag[:, t]
        for j in range(1, nb + 1):
            S = S - row[j] @ row[j].mT
        Ld, info = torch.linalg.cholesky_ex(S)
        bad = bad | (info != 0)
        row[0] = Ld
        s = rhs[:, t]
        for j in range(1, nb + 1):
            s = s - (row[j] @ ys[t - j][..., None])[..., 0]
        ys.append(torch.linalg.solve_triangular(Ld, s[..., None],
                                                upper=False)[..., 0])
        rows.append(row)
    xs = [None] * N
    for t in range(N - 1, -1, -1):
        s = ys[t]
        for j in range(1, min(K, N - 1 - t) + 1):
            s = s - (rows[t + j][j].mT @ xs[t + j][..., None])[..., 0]
        xs[t] = torch.linalg.solve_triangular(rows[t][0].mT, s[..., None],
                                              upper=True)[..., 0]
    x = torch.stack(xs, 1)
    return torch.where(bad[:, None, None], torch.full_like(x, float("nan")),
                       x)


def solve_quality(diag: torch.Tensor, lower: torch.Tensor,
                  rhs: torch.Tensor, x: torch.Tensor) -> dict:
    """How good a float32 solution x of these systems is, per lane (B,), in
    float64 (tests and the chip check only):

    * ``forward``: max |x - x_ref| / max |x_ref|, x_ref the float64
      :func:`solve_reference` of the same (float32) inputs;
    * ``backward``: the normwise backward error (``banded.backward_error``);
    * ``spd_margin``: the system minus float32 eps * ||H||_inf I is still
      positive definite, so a float32 Cholesky must not fail on it (below
      that margin a failed pivot, and a NaN lane, is a right answer);
    * ``finite``: x has no NaN or inf.
    """
    H = BlockBanded(diag.double(), lower.double())
    b, xd = rhs.double(), x.double()
    ref = solve_reference(H.diag, H.lower, b)
    fwd = (xd - ref).abs().amax((1, 2)) / ref.abs().amax((1, 2))
    tau = torch.finfo(torch.float32).eps * row_sum_norm(H)
    dense = to_dense(H)
    dense.diagonal(dim1=-2, dim2=-1).sub_(tau[:, None])
    spd = torch.linalg.cholesky_ex(dense)[1] == 0
    del dense
    return {"forward": fwd, "backward": backward_error(H, xd, b),
            "spd_margin": spd, "finite": torch.isfinite(xd).all(2).all(1)}


def _chol_inv_blocked(S: torch.Tensor):
    """The kernel's factor of one diagonal block: blocked right-looking
    Cholesky by PANEL-wide panels, each panel's diagonal block factored and
    inverted on its own, the panels below it formed as products with that
    inverse, then the inverse's off-diagonal blocks as products. Returns
    (X = L^-1, ok (B,): no failed pivot)."""
    P, n = PANEL, S.shape[-1] // PANEL
    blk = {(a, b): S[..., a * P:(a + 1) * P, b * P:(b + 1) * P]
           for a in range(n) for b in range(a + 1)}
    eye = torch.eye(P, dtype=S.dtype, device=S.device)
    Lo, X = {}, {}
    ok = torch.ones(S.shape[0], dtype=torch.bool, device=S.device)
    for p in range(n):
        Lpp, info = torch.linalg.cholesky_ex(blk[p, p])
        ok = ok & (info == 0)
        X[p, p] = torch.linalg.solve_triangular(Lpp, eye.expand_as(Lpp),
                                                upper=False)
        for i in range(p + 1, n):
            Lo[i, p] = blk[i, p] @ X[p, p].mT
        for a in range(p + 1, n):
            for b in range(p + 1, a + 1):
                blk[a, b] = blk[a, b] - Lo[a, p] @ Lo[b, p].mT
    # X_ab = -X_aa sum_{b<=c<a} L_ac X_cb, by diagonals (the kernel's phases)
    for d in range(1, n):
        for a in range(d, n):
            b = a - d
            T = Lo[a, b] @ X[b, b]
            for c in range(b + 1, a):
                T = T + Lo[a, c] @ X[c, b]
            X[a, b] = -(X[a, a] @ T)
    zero = torch.zeros_like(X[0, 0])
    Xf = torch.cat([torch.cat([X[a, b] if b <= a else zero
                               for b in range(n)], -1) for a in range(n)], -2)
    return Xf, ok


def solve_reference_blocked(diag: torch.Tensor, lower: torch.Tensor,
                            rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel's arithmetic: the frame loop of
    :func:`solve_reference`, with each diagonal factor L[t,t] replaced by
    its inverse X[t] = L[t,t]^-1 (blocked Cholesky and inverse by 18-wide
    panels, :func:`_chol_inv_blocked`), so that the off-diagonal blocks
    L[t,t-j] = M X[t-j]^T and both substitutions, y[t] = X[t] s and x[t] =
    X[t]^T s, are products. A failed pivot makes the lane's solution NaN.
    Any dtype and device; the block size must be a multiple of 18."""
    B, N, d = rhs.shape
    if d % PANEL:
        raise ValueError(f"block size {d} is not a multiple of {PANEL}")
    K = lower.shape[1]
    rows, Xs, ys = [], [], []   # rows[t][j] = L[t, t-j]; Xs[t] = L[t,t]^-1
    bad = torch.zeros(B, dtype=torch.bool, device=rhs.device)
    for t in range(N):
        nb = min(t, K)
        row = {}
        for j in range(nb, 0, -1):
            M = lower[:, j - 1, t - j]                   # H[t, t-j]
            for k in range(j + 1, nb + 1):
                M = M - row[k] @ rows[t - j][k - j].mT
            row[j] = M @ Xs[t - j].mT
        S = diag[:, t]
        for j in range(nb, 0, -1):
            S = S - row[j] @ row[j].mT
        X, ok = _chol_inv_blocked(S)
        bad = bad | ~ok
        s = rhs[:, t]
        for j in range(1, nb + 1):
            s = s - (row[j] @ ys[t - j][..., None])[..., 0]
        ys.append((X @ s[..., None])[..., 0])
        rows.append(row)
        Xs.append(X)
    xs = [None] * N
    for t in range(N - 1, -1, -1):
        s = ys[t]
        for j in range(1, min(K, N - 1 - t) + 1):
            s = s - (rows[t + j][j].mT @ xs[t + j][..., None])[..., 0]
        xs[t] = (Xs[t].mT @ s[..., None])[..., 0]
    x = torch.stack(xs, 1)
    return torch.where(bad[:, None, None], torch.full_like(x, float("nan")),
                       x)
