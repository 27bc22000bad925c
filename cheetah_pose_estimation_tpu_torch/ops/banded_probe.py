"""Phase probe of the banded-solve kernel (an experiment, never the main
path).

    python -m cheetah_pose_estimation_tpu_torch.ops.banded_probe [--B 10] [--N 64]

Builds ``csrc/banded_solve.cu`` a second time with ``-DBANDED_PHASE_PROBE``
(thread 0 of each block adds the clock64 cycles of each phase into a
per-system counter), solves ``cuda_banded.random_systems`` and prints the
cycles per frame of each phase, averaged over the systems, as one JSON
line, with the time of the plain build on the same systems (CUDA events, 20
launches after 3 warm-ups). The probed build carries the extra clock reads,
so its total is a little above the plain build's; the main path never
loads it.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch

from . import cuda_banded as cb

# the phase counters of csrc/banded_solve.cu, in its order
PHASES = ("load_wait", "offdiag_update", "offdiag_product", "schur",
          "chol_panel_warp", "panel_products", "forward_subst", "backward")


def probe(B: int, N: int, seed: int = 0) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    diag, lower, rhs = cb.random_systems(B, N, seed, dev)
    lib = cb.load_library(cb.build(("BANDED_PHASE_PROBE",)))
    plain = cb.load_library(cb.build())
    x = torch.empty_like(rhs)
    work = torch.empty((B, N, cb.BW + 1, cb.D, cb.D), device=dev)
    counts = torch.zeros((B, len(PHASES)), dtype=torch.int64, device=dev)
    if lib.banded_probe_set(ctypes.c_void_p(counts.data_ptr())) != 0:
        raise RuntimeError("banded_probe_set failed")
    cb.launch(lib, diag, lower, rhs, x, work)     # warm-up
    counts.zero_()
    cb.launch(lib, diag, lower, rhs, x, work)
    torch.cuda.synchronize()
    ref = cb.solve_reference(diag.double(), lower.double(), rhs.double())
    rel = float((x.double() - ref).abs().max() / ref.abs().max())
    per_frame = counts.double().mean(0) / N
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        cb.launch(plain, diag, lower, rhs, x, work)   # without probes
    start.record()
    for _ in range(20):
        cb.launch(plain, diag, lower, rhs, x, work)
    end.record()
    torch.cuda.synchronize()
    return {"B": B, "N": N, "rel_err": rel,
            "kernel_ms": start.elapsed_time(end) / 20,
            "kcycles_per_frame": {p: round(float(v) / 1e3, 2)
                                  for p, v in zip(PHASES, per_frame)},
            "kcycles_per_frame_total": round(float(per_frame.sum()) / 1e3, 2),
            "device": torch.cuda.get_device_name(0)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=10)
    ap.add_argument("--N", type=int, default=64)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("banded_probe: no CUDA device")
    print(json.dumps(probe(args.B, args.N)))


if __name__ == "__main__":
    main()
