"""ctypes bindings of the native DLC-table reader (``src/dlc_loader.cpp``).

Port of ``cheetah_pose_estimation_tpu/native/__init__.py`` with its own copy
of the C++ source. The library is compiled with ``g++`` at first use into
``build/native/`` at the repository's root (keyed by the source's hash and
the flags, so an edited source never loads a stale library). A failed build
raises with the compiler's output: there is no fallback to a Python parser
here. ``data.io.load_dlc_points`` reads CSV tables through
:func:`load_tables` by default (float32 pixels and likelihoods, as the JAX
package's default read gives them) and through its exact numpy reader only
when asked (``use_native=False``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "src" / "dlc_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)


def build() -> Path:
    """Compile the reader into ``build/native/`` unless that build exists;
    returns the shared library's path. Raises ``RuntimeError`` with the
    compiler's output when the build fails or the compiler is missing."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join((CXX,) + CXX_FLAGS).encode()
                         ).hexdigest()[:12]
    out = BUILD_DIR / f"libdlc_loader_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, check=False)
    except OSError as e:
        raise RuntimeError(f"the DLC reader needs a C++ compiler: {CXX!r} "
                           f"could not run ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{CXX} failed ({proc.returncode}) on "
                           f"{SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The reader's library, built and bound at first use (raises when it
    cannot be built)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.ctl_probe_csv.restype = ctypes.c_int
        lib.ctl_probe_csv.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
        lib.ctl_parse_dlc_csv.restype = ctypes.c_int
        lib.ctl_parse_dlc_csv.argtypes = [ctypes.c_char_p, _F, _F, _I,
                                          ctypes.c_int, ctypes.c_int]
        lib.ctl_load_trials.restype = ctypes.c_int
        lib.ctl_load_trials.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(_F), ctypes.POINTER(_F), ctypes.POINTER(_I),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int]
        lib.ctl_gate_weights.restype = None
        lib.ctl_gate_weights.argtypes = [_F, _F, ctypes.c_float, _F,
                                         ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the reader builds and loads here."""
    try:
        get_lib()
    except RuntimeError:
        return False
    return True


def probe_csv(path: str) -> Tuple[int, int]:
    """(frame rows, markers) of one DLC CSV table."""
    nf, nm = ctypes.c_int(), ctypes.c_int()
    rc = get_lib().ctl_probe_csv(path.encode(), ctypes.byref(nf),
                                 ctypes.byref(nm))
    if rc != 0:
        raise IOError(f"probe failed ({rc}) for {path}")
    return nf.value, nm.value


def parse_dlc_csv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xy (n, m, 2) float32, likelihood (n, m) float32, frame index (n,)
    int32) of one table."""
    n, m = probe_csv(path)
    xy = np.empty((n, m, 2), np.float32)
    lik = np.empty((n, m), np.float32)
    idx = np.empty((n,), np.int32)
    rows = get_lib().ctl_parse_dlc_csv(
        path.encode(), xy.ctypes.data_as(_F), lik.ctypes.data_as(_F),
        idx.ctypes.data_as(_I), n, m)
    if rows < 0:
        raise IOError(f"parse failed ({rows}) for {path}")
    return xy[:rows], lik[:rows], idx[:rows]


def load_tables(paths: List[str], n_threads: int = 0
                ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Parse many tables (a trial's cameras, or many trials') on
    ``n_threads`` threads (default: one per table, at most the CPU count).
    Returns one (xy, lik, index) per path, as :func:`parse_dlc_csv`."""
    lib = get_lib()
    n_threads = n_threads or min(len(paths), os.cpu_count() or 4)
    shapes = [probe_csv(p) for p in paths]
    m = shapes[0][1]
    xys = [np.empty((n, mm, 2), np.float32) for n, mm in shapes]
    liks = [np.empty((n, mm), np.float32) for n, mm in shapes]
    idxs = [np.empty((n,), np.int32) for n, _ in shapes]
    k = len(paths)
    rc = lib.ctl_load_trials(
        (ctypes.c_char_p * k)(*[p.encode() for p in paths]), k,
        (_F * k)(*[a.ctypes.data_as(_F) for a in xys]),
        (_F * k)(*[a.ctypes.data_as(_F) for a in liks]),
        (_I * k)(*[a.ctypes.data_as(_I) for a in idxs]),
        (ctypes.c_int * k)(*[s[0] for s in shapes]), m, n_threads)
    if rc != 0:
        raise IOError("parallel table load failed")
    return list(zip(xys, liks, idxs))


def gate_weights(lik: np.ndarray, inv_R: np.ndarray,
                 thresh: float) -> np.ndarray:
    """Likelihood gating in one pass: w = (lik > thresh) inv_R, float32
    (n, m) from lik (n, m) and inv_R (m,)."""
    lib = get_lib()
    lik = np.ascontiguousarray(lik, np.float32)
    inv_R = np.ascontiguousarray(inv_R, np.float32)
    n, m = lik.shape
    out = np.empty_like(lik)
    lib.ctl_gate_weights(lik.ctypes.data_as(_F), inv_R.ctypes.data_as(_F),
                         ctypes.c_float(thresh), out.ctypes.data_as(_F), n,
                         m)
    return out
