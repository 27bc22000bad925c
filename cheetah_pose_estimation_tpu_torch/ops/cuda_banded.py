"""Batched block-banded SPD solve as a hand-written CUDA kernel.

Counterpart of ``cheetah_pose_estimation_tpu/ops/pallas_banded.py`` (whose
two ``pallas_call``s, ``_fwd_kernel`` and ``_bwd_kernel``, factor and solve
the same systems on the TPU). Here one kernel,
``csrc/banded_solve.cu``, does both passes with one thread block per system;
the source says what bounds it and why it is laid out so.

Layout (``ops.banded.BlockBanded``, batched): diag (B, N, 54, 54), lower
(B, 3, N, 54, 54) with ``lower[:, k-1, t] = H[t+k, t]``, rhs (B, N, 54)
-> x (B, N, 54).

:func:`solve` launches the kernel for CUDA float32 tensors and raises on
anything else the kernel does not take; for CPU tensors it runs
:func:`solve_reference`, the kernel's plain PyTorch twin. There is no
fallback from the card to the plain version. The kernel is compiled with
``nvcc`` from the repository's source at first use into ``build/kernels/``
and bound with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

D = 54          # block size the kernel is compiled for
BW = 3          # bandwidth

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "banded_solve.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches made through :func:`solve` (the main path's count)
launches = 0
# nvcc's output of this process's build (registers, shared memory, spills)
build_log = ""

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build() -> Path:
    """Compile the kernel into ``build/kernels/`` (keyed by the source's
    hash, so an edited source never loads a stale library). Returns the
    shared library's path."""
    global build_log
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"libbanded_solve_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.banded_solve_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(diag: torch.Tensor, lower: torch.Tensor, rhs: torch.Tensor):
    B, N = rhs.shape[0], rhs.shape[1]
    want = {"diag": (B, N, D, D), "lower": (B, BW, N, D, D), "rhs": (B, N, D)}
    for name, t in (("diag", diag), ("lower", lower), ("rhs", rhs)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, the kernel "
                             f"takes {want[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.device != rhs.device:
            raise ValueError("diag, lower and rhs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def solve(diag: torch.Tensor, lower: torch.Tensor, rhs: torch.Tensor
          ) -> torch.Tensor:
    """Solve B SPD block-banded systems. CUDA float32 tensors go through the
    kernel (or raise); CPU tensors through :func:`solve_reference`."""
    global launches
    if rhs.device.type == "cpu":
        return solve_reference(diag, lower, rhs)
    if rhs.device.type != "cuda":
        raise ValueError(f"no banded-solve kernel for device {rhs.device}")
    _check(diag, lower, rhs)
    B, N = rhs.shape[0], rhs.shape[1]
    x = torch.empty_like(rhs)
    if B == 0 or N == 0:
        return x
    work = torch.empty((B, N, BW + 1, D, D), dtype=rhs.dtype,
                       device=rhs.device)
    lib = _load()
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream(rhs.device).cuda_stream
        err = lib.banded_solve_f32(diag.data_ptr(), lower.data_ptr(),
                                   rhs.data_ptr(), x.data_ptr(),
                                   work.data_ptr(), B, N, stream)
    if err != 0:
        raise RuntimeError(f"banded_solve kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return x


def solve_reference(diag: torch.Tensor, lower: torch.Tensor,
                    rhs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the same frame loop, each factor row
    built against the 3-deep window of earlier rows and kept for the
    backward pass, and a failed pivot turning the whole lane's solution to
    NaN. Any dtype and device; batched over the leading axis."""
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
