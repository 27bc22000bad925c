#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits nonzero):

1. device  — require CUDA; print the card's name and power limit, the torch
   and CUDA versions; check that TF32 is off.
2. build   — compile ``csrc/banded_solve.cu`` from this checkout.
3. kernel  — the banded-solve kernel (float32) against its plain PyTorch
   version in float64 on the card, at (B, N) = (10, 64), (30, 64), (1, 256),
   on random SPD banded systems and on damped, Jacobi-scaled normal systems
   of the slice's own problems; relative error <= 7e-4. An indefinite lane
   must come back NaN with the other lanes finite. Kernel and plain times.
4. main    — stage 1 of the bench: 10 procedural monocular problems padded
   to 64 frames, ``make_kinematic_multistart`` once (warm-up, with the
   kernel's launch count) and 3 timed repeats; one more run with the probe
   and the finish timed apart; per-trial MPE, MPJPE and CoM-velocity RMSE.
5. agree   — the same problems with ``linear_solver="scan"``, and the JAX
   package's float32 stage-1 numbers (``tests/data/jax_stage1_f32.json``):
   mean MPJPE within 2 % of both.

The line before the last is a JSON object with the kernel's launches, error
and times; the last line is ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL_REL = 7e-4        # the JAX Pallas kernel's bar (linsolve_bench.json)
TOL_MPJPE = 0.02      # mean MPJPE agreement, relative
SHAPES = ((10, 64), (30, 64), (1, 256))
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_spd_banded(B, N, seed, dev):
    """Diagonally dominant SPD systems in the kernel's layout."""
    g = torch.Generator().manual_seed(seed)
    d = 54
    lower = 0.3 * torch.randn(B, 3, N, d, d, generator=g, dtype=torch.float64)
    for k in range(1, 4):
        lower[:, k - 1, max(N - k, 0):] = 0.0
    sym = 0.3 * torch.randn(B, N, d, d, generator=g, dtype=torch.float64)
    sym = 0.5 * (sym + sym.mT)
    rows = sym.abs().sum(-1) - sym.diagonal(dim1=-2, dim2=-1).abs()
    for k in range(1, 4):
        a = lower[:, k - 1].abs()
        rows = rows + a.sum(-1).roll(k, 1) * (torch.arange(N) >= k)[:, None]
        rows = rows + a.sum(-2)
    diag = sym + torch.diag_embed(rows + 1.0)
    rhs = torch.randn(B, N, d, generator=g, dtype=torch.float64)
    return diag.to(dev), lower.to(dev), rhs.to(dev)


def normal_systems(B, N, dev):
    """Damped, Jacobi-scaled normal systems (exactly what
    ``gn._scaled_solve`` hands the kernel) of the slice's problems at q0,
    annealing scale 1, lam = lam0. B = 30 replicates the 10 trials over the
    3 heading restarts, like the probe."""
    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    if N == 64:
        batched, q0, _, subject = bench_lib.build_batch(
            max_trials=10, n_frames=N, device=dev)
        if B == 30:
            q0 = torch.cat([q0 + torch.zeros_like(q0).index_fill_(
                2, torch.tensor([5], device=dev), o)
                for o in pbatch.HEADING_RESTARTS])
            batched = kin.map_data(
                lambda x: x.repeat((3,) + (1,) * (x.ndim - 1)), batched)
    else:
        d, q0n, _ = bench_lib.build_monocular_problem(
            syn.gallop_trajectory(N, seed=0), "acinoset", 120.0, seed=0)
        batched, q0 = pbatch.pad_and_stack([d], [q0n], device=dev)
        subject = bench_lib.P.get_subject("acinoset")
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    g, H = fte._normal(q0, batched, 1.0)
    s = torch.rsqrt(torch.clamp(torch.diagonal(H.diag, dim1=-2, dim2=-1),
                                min=1e-8))
    eye = torch.eye(54, dtype=g.dtype, device=dev)
    diag = H.diag * s[..., :, None] * s[..., None, :] + 1e-2 * eye
    bands = []
    for k in range(1, 4):
        sk = torch.zeros_like(s)
        sk[:, : N - k] = s[:, k:]
        bands.append(H.lower[:, k - 1] * sk[..., :, None] * s[..., None, :])
    return (diag.contiguous(), torch.stack(bands, 1).contiguous(),
            (-(g * s)).contiguous())


def phase_kernel(dev, results):
    from cheetah_pose_estimation_tpu_torch.ops import banded, cuda_banded

    worst_rel, worst_abs, rows = 0.0, 0.0, []
    for B, N in SHAPES:
        for kind in ("random_spd", "normal"):
            if kind == "normal":
                diag, lower, rhs = normal_systems(B, N, dev)
            else:
                diag, lower, rhs = random_spd_banded(B, N, B * 1000 + N, dev)
            d32, l32, r32 = (x.float().contiguous() for x in (diag, lower,
                                                              rhs))
            x = cuda_banded.solve(d32, l32, r32)
            torch.cuda.synchronize()
            ref = cuda_banded.solve_reference(d32.double(), l32.double(),
                                              r32.double())
            if not (torch.isfinite(x).all() and torch.isfinite(ref).all()):
                raise AssertionError(f"non-finite solve at {(B, N)} {kind}")
            abs_err = float((x.double() - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            row = {"B": B, "N": N, "systems": kind, "rel_err": rel,
                   "max_abs_err": abs_err}
            if kind == "normal":
                row["kernel_ms"] = cuda_ms(lambda: cuda_banded.solve(d32, l32,
                                                                     r32))
                row["plain_ms"] = cuda_ms(
                    lambda: cuda_banded.solve_reference(d32, l32, r32),
                    reps=3, warmup=1)
                H32 = banded.BlockBanded(d32, l32)
                row["scan_ms"] = cuda_ms(lambda: banded.solve(H32, r32),
                                         reps=3, warmup=1)
                row["cr_ms"] = cuda_ms(lambda: banded.cr_solve(H32, r32),
                                       reps=3, warmup=1)
            log(f"# kernel {row}")
            rows.append(row)
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs,
                                                            abs_err)
            if rel > TOL_REL:
                raise AssertionError(f"kernel rel err {rel:.3e} > {TOL_REL} "
                                     f"at {(B, N)} {kind}")
    # an indefinite lane comes back NaN; the other lanes are untouched
    diag, lower, rhs = (x.float().contiguous()
                        for x in normal_systems(10, 64, dev))
    x_ok = cuda_banded.solve(diag, lower, rhs)
    diag[3, 5] = -torch.eye(54, device=dev)
    x_bad = cuda_banded.solve(diag, lower, rhs)
    torch.cuda.synchronize()
    others = [i for i in range(10) if i != 3]
    if not (torch.isnan(x_bad[3]).all()
            and torch.isfinite(x_bad[others]).all()
            and torch.equal(x_bad[others], x_ok[others])):
        raise AssertionError("indefinite lane did not give NaN in that lane "
                             "alone")
    log("# kernel: indefinite lane -> NaN, other lanes unchanged")
    results["kernel"] = rows
    main_shape = next(r for r in rows
                      if (r["B"], r["N"], r["systems"]) == (10, 64, "normal"))
    return worst_rel, worst_abs, main_shape


def phase_main(dev, results):
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    t0 = time.perf_counter()
    batched, q0b, trials, subject = bench_lib.build_batch(
        max_trials=10, n_frames=64, dtype=torch.float32, device=dev)
    fpss = [f for _, _, f in bench_lib.load_reference_trajectories(10)]
    log(f"# main: problem build {time.perf_counter() - t0:.2f} s (host)")
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    run = pbatch.make_kinematic_multistart(fte)

    cuda_banded.launches = 0
    t0 = time.perf_counter()
    st = run(q0b, batched)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_banded.launches
    if launches <= 0:
        raise AssertionError("the main path did not launch the kernel")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        st = run(q0b, batched)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    if not torch.isfinite(st.cost).all():
        raise AssertionError(f"non-finite final cost {st.cost.tolist()}")
    split = probe_finish_split(fte, q0b, batched)
    B = q0b.shape[0]
    s_trial = float(np.mean(times)) / B
    rows = bench_lib.score_per_trial(st.q.double().cpu().numpy(), trials,
                                     fpss, subject)
    log(f"# main: first call {first_s:.3f} s, repeats {times} s, "
        f"{s_trial:.4f} s/trial, {60.0 / s_trial:.1f} trials/min, "
        f"kernel launches {launches}")
    log(f"# main: probe {split['probe_s']:.3f} s (accepted steps per lane "
        f"max {split['probe_max_accepted']}), finish "
        f"{split['finish_s']:.3f} s, probe share "
        f"{split['probe_s'] / (split['probe_s'] + split['finish_s']):.3f}")
    for i, r in enumerate(rows):
        log(f"# main: trial {i} MPE {r[0]:.2f} mm MPJPE {r[1]:.2f} mm "
            f"CoM-vel {r[2]:.4f} m/s cost {float(st.cost[i]):.3f}")
    results["main"] = {"first_call_s": first_s, "repeat_s": times,
                       "s_per_trial": s_trial,
                       "trials_per_min": 60.0 / s_trial,
                       "launches": launches, "split": split,
                       "per_trial": rows,
                       "final_cost": st.cost.tolist(),
                       "iterations": st.it.tolist()}
    return launches, rows, (fte, batched, q0b, trials, fpss, subject)


def probe_finish_split(fte, q0b, batched):
    """One more run of the main path with the probe (3 heading restarts x
    30 fixed iterations) and the finish timed apart, each ending in a sync.
    """
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch

    split = {"probe_s": 0.0, "finish_s": 0.0}

    def timed(fn, key):
        def run(q0, data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(q0, data)
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
            if key == "probe_s":
                split["probe_max_accepted"] = int(out.n_accepted.max())
            return out
        return run

    pbatch.make_multistart_probe(
        timed(fte.make_solver(stages=pbatch.PROBE_STAGES, driver="fixed"),
              "probe_s"),
        timed(fte.make_solver(stages=pbatch.FULL_STAGES), "finish_s"))(
            q0b, batched)
    return split


def phase_agree(ctx, rows_kernel, results):
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib

    fte, batched, q0b, trials, fpss, subject = ctx
    t0 = time.perf_counter()
    st = pbatch.make_kinematic_multistart(fte, linear_solver="scan")(
        q0b, batched)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    rows_scan = bench_lib.score_per_trial(st.q.double().cpu().numpy(),
                                          trials, fpss, subject)
    with open(os.path.join(HERE, "tests", "data", "jax_stage1_f32.json"),
              encoding="utf-8") as f:
        jax_ref = json.load(f)
    mk = np.array([r[1] for r in rows_kernel])
    ms = np.array([r[1] for r in rows_scan])
    mj = np.array(jax_ref["mpjpe_mm"])
    for name, other in (("scan", ms), ("jax_f32", mj)):
        for i in np.nonzero(np.abs(mk - other) > 5.0)[0]:
            log(f"# agree: trial {i} kernel {mk[i]:.2f} mm vs {name} "
                f"{other[i]:.2f} mm")
    d_scan = abs(mk.mean() - ms.mean()) / ms.mean()
    d_jax = abs(mk.mean() - mj.mean()) / mj.mean()
    log(f"# agree: mean MPJPE kernel {mk.mean():.3f} scan {ms.mean():.3f} "
        f"(rel {d_scan:.4f}, scan run {scan_s:.2f} s) jax_f32 "
        f"{mj.mean():.3f} (rel {d_jax:.4f})")
    results["agree"] = {"mean_mpjpe_kernel": mk.mean(),
                        "mean_mpjpe_scan": ms.mean(),
                        "mean_mpjpe_jax_f32": mj.mean(), "scan_run_s": scan_s,
                        "rel_scan": d_scan, "rel_jax": d_jax}
    if d_scan > TOL_MPJPE or d_jax > TOL_MPJPE:
        raise AssertionError(f"mean MPJPE disagrees: vs scan {d_scan:.4f}, "
                             f"vs jax {d_jax:.4f} (limit {TOL_MPJPE})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write all results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.utils.device import resolve_device

    results = {}
    # 1. device
    dev = resolve_device("cuda")
    gpu = gpu_name_and_limit()
    log(f"# device: {gpu} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    results["device"] = {"nvidia_smi": gpu, "torch": torch.__version__,
                         "cuda": torch.version.cuda}
    # 2. build
    t0 = time.perf_counter()
    cuda_banded.build()
    build_s = time.perf_counter() - t0
    log(f"# build: {build_s:.2f} s")
    for line in cuda_banded.build_log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"# build: {line.strip()}")
    results["build_s"] = build_s
    # 3-5
    worst_rel, worst_abs, main_shape = phase_kernel(dev, results)
    launches, rows, ctx = phase_main(dev, results)
    phase_agree(ctx, rows, results)

    kernels = {"kernels": [{
        "name": "banded_solve",
        "route": "cuda",
        "source": "cheetah_pose_estimation_tpu_torch/csrc/banded_solve.cu",
        "replaces": "cheetah_pose_estimation_tpu/ops/pallas_banded.py:262,309",
        "launches": launches,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"]}]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump({**results, **kernels}, f, indent=1, default=float)
    print(json.dumps(kernels))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
