#!/usr/bin/env python
"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--out results.json]

Phases (any failure exits nonzero):

1. device  — require CUDA; print the card's name and power limit, the torch
   and CUDA versions; check that TF32 is off.
2. build   — compile ``csrc/banded_solve.cu`` from this checkout.
3. kernel  — the banded-solve kernel (float32) against its plain PyTorch
   version in float64 on the card, at (B, N) = (10, 64), (30, 64), (70, 64)
   (the depth line-scan's 7 shifts x 10 trials), (1, 256), on random SPD
   banded systems and on damped (lam = 1e-2), Jacobi-scaled normal systems
   of the slice's own problems; relative error <= 7e-4.
   At the LM loop's small dampings (lam = 1e-6, 1e-12; 10x64, 30x64) each
   lane is NaN or has a normwise backward error <= 1e-5, and every lane
   that is positive definite by a float32 margin is finite, and the kernel
   has no more NaN lanes than the plain float32 substitution on the same
   inputs. An indefinite lane and an all-NaN lane come back NaN with the
   other lanes bit-identical. Kernel, plain, scan, CR and one-call library
   (``torch.linalg.solve`` on the dense matrix) times; the bound from the
   FLOPs and bytes the solve needs.
4. main    — stage 1 of the bench: 10 procedural monocular problems padded
   to 64 frames, ``make_kinematic_multistart`` once (warm-up, with the
   kernel's launch count) and 3 timed repeats; one more run with the probe
   and the finish timed apart; per-trial MPE, MPJPE and CoM-velocity RMSE.
5. agree   — the same problems with ``linear_solver="scan"``, and the JAX
   package's float32 stage-1 numbers (``tests/data/jax_stage1_f32.json``):
   mean MPJPE within 2 % of both.
6. profile — one more stage-1 run under torch.profiler: device time, the
   kernel's share of it, and the device's busy share of the unprofiled
   stage-1 wall (phase 4's repeats).
7. dd      — stage 1.5 of the bench, the data-driven mode. Priors: the
   procedural pose tables, the port's priors trained on the card (set-up,
   timed), held against the JAX-trained priors of
   ``tests/data/jax_dd_inputs.npz`` (GMM score on the training table within
   0.5 nats per sample, AR predictions on its windows within 1e-6). Main
   path: phase 4's stage-1 result through ``run_data_driven`` with the
   port's priors, once (warm-up, with the kernel's launches per shape, both
   > 0, and each phase timed) and 2 timed repeats; per-trial MPE, MPJPE,
   CoM-velocity, ``prior_ok`` and shifts. Agreement: ``run_data_driven`` from JAX's
   float32 stage-1 trajectories with the JAX-trained priors (both from the
   npz), mean MPJPE within 2 % of the JAX float64 dd run from the same
   inputs (``tests/data/jax_stage15_f32.json``, ``f64``); the JAX float32
   run's mean MPJPE, gate decisions and shifts are printed beside it.
   Profile: one more dd run under torch.profiler.
8. physics — stage 2 of the bench, the physics-based mode, from phase 7's
   dd trajectories with the port's GMM prior: host prep
   (``bench_lib.build_physics_batch``: foot kinematics, contact detection,
   stance pruning; ground heights from each trial's ground truth), then the
   kernel against its plain version in float64 on the kinetic normal
   systems at the warm start (annealing scales 3 and 1, damped and
   Jacobi-scaled as ``gn.scaled_system`` does at lam = 10 and 1e-2),
   relative error <= 7e-4, and the peak device memory of the frozen EOM
   curvature blocks. Main path: ``run_physics`` once (warm-up, the kernel's
   launches at 10x64 > 0) and 2 timed repeats, host prep, curvature blocks
   and LM loop timed apart; per-trial MPE, MPJPE, CoM-velocity, accepted
   steps, RMS torque and peak GRFz, and bench's ``ok`` (finite, mean MPE
   and CoM-velocity < 1.02x the warm start's). Agreement: ``run_physics``
   from JAX's float32 stage-1 trajectories with the JAX-trained GMM
   (``tests/data/jax_dd_inputs.npz``) against the JAX float64 stage-2 run
   from the same inputs (``tests/data/jax_stage2_f32.json``, ``f64``): the
   same pruned stance matrices, mean MPJPE within 2 %, mean CoM-velocity
   within 5 %, the same ``ok``; the JAX float32 run beside it. Profile: one
   more physics run under torch.profiler.

Before the last two lines: a JSON object with the kernel's launches (in all
and per path and shape), error, times and bound (at 10x64, and per shape),
then the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.
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
TOL_BACKWARD = 1e-5   # normwise backward error, float32 (eps 1.2e-7)
PEAK_F32_FLOP_S = 67e12   # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
TOL_MPJPE = 0.02      # mean MPJPE agreement, relative
TOL_GMM_NATS = 0.5    # port vs JAX GMM, mean log-likelihood per sample
TOL_AR = 1e-6         # port vs JAX AR predictions on the training windows
TOL_COMVEL = 0.05     # stage-2 mean CoM-velocity agreement, relative
SHAPES = ((10, 64), (30, 64), (70, 64), (1, 256))
HERE = os.path.dirname(os.path.abspath(__file__))


T0 = time.perf_counter()


def log(msg):
    """A progress line, stamped with the seconds since the script began."""
    print(f"{msg}  [t={time.perf_counter() - T0:.1f} s]", flush=True)


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


def normal_systems(B, N, dev, lam=1e-2):
    """Damped, Jacobi-scaled normal systems (exactly what
    ``gn._scaled_solve`` hands the kernel) of the slice's problems at q0,
    annealing scale 1, damping ``lam`` (lam0 = 1e-2; the LM loop takes it
    down to lam_min = 1e-12). B = 30 replicates the 10 trials over the 3
    heading restarts, like the probe; B = 70 over the 7 depth shifts along
    the camera rays, like the line-scan. Float32, contiguous."""
    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    if N == 64:
        batched, q0, _, subject = bench_lib.build_batch(
            max_trials=10, n_frames=N, device=dev)
        if B == 30:
            q0 = torch.cat([q0 + torch.zeros_like(q0).index_fill_(
                2, torch.tensor([5], device=dev), o)
                for o in pbatch.HEADING_RESTARTS])
        elif B == 70:
            q0n = q0.double().cpu().numpy()
            rays = torch.as_tensor(np.stack([depth_anchor.camera_ray(
                q0n[i], *[x[i, 0].cpu().numpy() for x in (batched.cam.R,
                                                          batched.cam.t)])
                for i in range(10)]), dtype=q0.dtype, device=dev)
            q0 = torch.cat([torch.cat([q0[..., :3] + s * rays, q0[..., 3:]],
                                      -1) for s in depth_anchor.SCAN_SHIFTS])
        if B > 10:
            batched = kin.map_data(
                lambda x: x.repeat((B // 10,) + (1,) * (x.ndim - 1)), batched)
    else:
        d, q0n, _ = bench_lib.build_monocular_problem(
            syn.gallop_trajectory(N, seed=0), "acinoset", 120.0, seed=0)
        batched, q0 = pbatch.pad_and_stack([d], [q0n], device=dev)
        subject = params.get_subject("acinoset")
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    g, H = fte._normal(q0, batched, 1.0)
    Hs, rhs, _ = gn.scaled_system(g, H, torch.full((B,), lam, device=dev),
                                  1e-8)
    return (Hs.diag.contiguous(), Hs.lower.contiguous(), rhs.contiguous())


def solve_flops(N):
    """Floating-point operations that one system's banded Cholesky solve
    needs (not what the kernel does: its products with the triangular
    inverse are dense). Per frame t with nb = min(t, 3) earlier and nbb =
    min(N-1-t, 3) later neighbours: the 54x54 Cholesky (54^3/3), nb
    triangular solves for L[t,t-j] (54^3 each), nb(nb-1)/2 products for the
    M_j updates (2 54^3 each), nb symmetric Schur updates (54^2 55 each), and
    the two substitutions (54^2 for the triangle, 2 54^2 per neighbour)."""
    d = 54
    total = 0.0
    for t in range(N):
        nb, nbb = min(t, 3), min(N - 1 - t, 3)
        total += (d ** 3 / 3 + nb * d ** 3 + nb * (nb - 1) // 2 * 2 * d ** 3
                  + nb * d * d * (d + 1) + 2 * d * d + 2 * (nb + nbb) * d * d)
    return total


def bound(B, N):
    """(bound_ms, bound_by): the larger of the bytes the solve must move
    (inputs read once, x written once) over HBM bandwidth and the FLOPs it
    needs (``solve_flops``) over the float32 (non-tensor-core) peak."""
    nbytes = 4 * B * N * (4 * 54 * 54 + 2 * 54)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = B * solve_flops(N) / PEAK_F32_FLOP_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations")


def check_nan_lane(solve, diag, lower, rhs, lane, poison, what):
    """Poisoning one lane makes that lane's x all NaN and leaves the other
    lanes bit-identical."""
    x_ok = solve(diag, lower, rhs)
    d, l, r = diag.clone(), lower.clone(), rhs.clone()
    poison(d, l, r)
    x_bad = solve(d, l, r)
    torch.cuda.synchronize()
    others = [i for i in range(diag.shape[0]) if i != lane]
    if not (torch.isnan(x_bad[lane]).all()
            and torch.isfinite(x_bad[others]).all()
            and torch.equal(x_bad[others], x_ok[others])):
        raise AssertionError(f"{what} lane did not give NaN in that lane "
                             "alone")
    log(f"# kernel: {what} lane -> NaN, other lanes bit-identical")


def phase_kernel(dev, results):
    from cheetah_pose_estimation_tpu_torch.ops import banded, cuda_banded

    worst_rel, worst_abs, rows = 0.0, 0.0, []
    for B, N in SHAPES:
        for kind in ("random_spd", "normal"):
            if kind == "normal":
                d32, l32, r32 = normal_systems(B, N, dev)
            else:
                d32, l32, r32 = cuda_banded.random_systems(B, N, B * 1000 + N,
                                                           dev)
            x = cuda_banded.solve(d32, l32, r32)
            torch.cuda.synchronize()
            ref = cuda_banded.solve_reference(d32.double(), l32.double(),
                                              r32.double())
            if not (torch.isfinite(x).all() and torch.isfinite(ref).all()):
                raise AssertionError(f"non-finite solve at {(B, N)} {kind}")
            abs_err = float((x.double() - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            H32 = banded.BlockBanded(d32, l32)
            row = {"B": B, "N": N, "systems": kind, "rel_err": rel,
                   "max_abs_err": abs_err, "backward_err": float(
                       banded.backward_error(H32, x, r32).max())}
            if kind == "normal":
                row["kernel_ms"] = cuda_ms(lambda: cuda_banded.solve(d32, l32,
                                                                     r32))
                row["plain_ms"] = cuda_ms(
                    lambda: cuda_banded.solve_reference(d32, l32, r32),
                    reps=3, warmup=1)
                row["scan_ms"] = cuda_ms(lambda: banded.solve(H32, r32),
                                         reps=3, warmup=1)
                row["cr_ms"] = cuda_ms(lambda: banded.cr_solve(H32, r32),
                                       reps=3, warmup=1)
                dense = banded.to_dense(H32)
                rhs_col = r32.reshape(r32.shape[0], -1, 1)
                row["library_ms"] = cuda_ms(
                    lambda: torch.linalg.solve(dense, rhs_col), reps=3,
                    warmup=1)
                del dense
                row["bound_ms"], row["bound_by"] = bound(B, N)
                row["roofline_share"] = row["bound_ms"] / row["kernel_ms"]
            log(f"# kernel {row}")
            rows.append(row)
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs,
                                                            abs_err)
            if rel > TOL_REL:
                raise AssertionError(f"kernel rel err {rel:.3e} > {TOL_REL} "
                                     f"at {(B, N)} {kind}")
    # the LM loop's small dampings: float32 forward error cannot reach the
    # bar there (condition 1e6-1e9; at 1e-12 the float32 systems are
    # indefinite), so each lane is NaN or has a small backward error, and
    # the kernel fails no more lanes than the plain float32 substitution
    # on the same inputs
    hard = []
    for B, N in SHAPES[:2]:
        for lam in (1e-6, 1e-12):
            d32, l32, r32 = normal_systems(B, N, dev, lam)
            row = {"B": B, "N": N, "lam": lam}
            for name, fn in (("kernel", cuda_banded.solve),
                             ("plain_f32", cuda_banded.solve_reference)):
                x = fn(d32, l32, r32)
                torch.cuda.synchronize()
                q = cuda_banded.solve_quality(d32, l32, r32, x)
                fin = q["finite"]
                fwd = q["forward"][fin & torch.isfinite(q["forward"])]
                row[name] = {
                    "nan_lanes": int((~fin).sum()),
                    "spd_margin_lanes": int(q["spd_margin"].sum()),
                    "max_backward_err": float(q["backward"][fin].max())
                    if fin.any() else None,
                    # against the float64 solve of the same inputs, where
                    # that factorization succeeds
                    "max_rel_err_finite": float(fwd.max())
                    if fwd.numel() else None}
                if name == "kernel" and not (
                        (q["backward"][fin] <= TOL_BACKWARD).all()
                        and fin[q["spd_margin"]].all()
                        and torch.isnan(x[~fin]).all()):
                    raise AssertionError(f"kernel at lam={lam} {(B, N)}: "
                                         f"{row}")
            log(f"# kernel {row}")
            if row["kernel"]["nan_lanes"] > row["plain_f32"]["nan_lanes"]:
                raise AssertionError(f"kernel fails more lanes than the "
                                     f"plain float32 solve: {row}")
            hard.append(row)
    results["kernel_small_damping"] = hard
    diag, lower, rhs = normal_systems(10, 64, dev)

    def indefinite(d, l, r):
        d[3, 5] = -torch.eye(54, device=dev)

    def all_nan(d, l, r):
        d[6].fill_(float("nan"))
        l[6].fill_(float("nan"))
        r[6].fill_(float("nan"))

    check_nan_lane(cuda_banded.solve, diag, lower, rhs, 3, indefinite,
                   "indefinite")
    check_nan_lane(cuda_banded.solve, diag, lower, rhs, 6, all_nan,
                   "all-NaN")
    results["kernel"] = rows
    return worst_rel, worst_abs, [r for r in rows if r["systems"] == "normal"]


def phase_main(dev, results):
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    t0 = time.perf_counter()
    datas, q0s, trials, subject = bench_lib.build_problems(max_trials=10)
    batched, q0b = pbatch.pad_and_stack(datas, q0s, n_frames=64,
                                        dtype=torch.float32, device=dev)
    fpss = [f for _, _, f in bench_lib.load_reference_trajectories(10)]
    log(f"# main: problem build {time.perf_counter() - t0:.2f} s (host)")
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    run = pbatch.make_kinematic_multistart(fte)

    cuda_banded.reset_launches()
    t0 = time.perf_counter()
    st = run(q0b, batched)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_banded.launches
    by_shape = dict(cuda_banded.launches_by_shape)
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
                       "launches": launches,
                       "launches_by_shape": shape_keys(by_shape),
                       "split": split, "per_trial": rows,
                       "final_cost": st.cost.tolist(),
                       "iterations": st.it.tolist()}
    return by_shape, rows, (fte, batched, q0b, trials, fpss, subject, st.q,
                            datas)


def shape_keys(by_shape: dict) -> dict:
    """{(B, N): n} -> {"BxN": n} (JSON keys)."""
    return {f"{b}x{n}": c for (b, n), c in sorted(by_shape.items())}


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


def profiled(fn, wall_unprofiled_s: float) -> dict:
    """Run ``fn`` once under torch.profiler: the sum of kernel times on the
    one stream, the banded-solve kernel's share of it, and the count of
    kernel launches. The device's busy share is that device time over
    ``wall_unprofiled_s``, the mean wall of unprofiled runs of the same work
    (the profiler's own event recording stretches the profiled wall, which
    is reported beside it)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    # the profiler's raw events: building its Python event tree
    # (prof.events()) takes minutes for the ~300k device events of a run
    dev_us, solve_us, n = 0.0, 0.0, 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        us = ev.duration_ns() / 1e3
        dev_us += us
        n += 1
        if "banded_solve_kernel" in ev.name():
            solve_us += us
    if n == 0:
        raise AssertionError("the profiler saw no kernel on the card")
    return {"wall_unprofiled_s": wall_unprofiled_s,
            "device_busy_share": dev_us / 1e6 / wall_unprofiled_s,
            "wall_profiled_s": wall_s,
            "device_busy_share_of_profiled_wall": dev_us / 1e6 / wall_s,
            "device_s": dev_us / 1e6, "banded_solve_s": solve_us / 1e6,
            "banded_solve_share_of_device": solve_us / max(dev_us, 1e-9),
            "device_kernel_launches": n}


def phase_profile(ctx, results):
    """One more stage-1 run under torch.profiler (``profiled``), against
    phase 4's unprofiled repeats."""
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch

    fte, batched, q0b = ctx[:3]
    run = pbatch.make_kinematic_multistart(fte)
    out = profiled(lambda: run(q0b, batched),
                   float(np.mean(results["main"]["repeat_s"])))
    log(f"# profile: {out}")
    results["profile"] = out


def load_jax_priors(dev):
    """The JAX-trained priors of ``tests/data/jax_dd_inputs.npz`` as port
    objects, and JAX's float32 stage-1 trajectories."""
    from cheetah_pose_estimation_tpu_torch import convert
    from cheetah_pose_estimation_tpu_torch.priors import armodel

    z = np.load(os.path.join(HERE, "tests", "data", "jax_dd_inputs.npz"))
    params = convert.gmm_params((z["gmm_weights"], z["gmm_means"],
                                 z["gmm_covs"]), device=dev)
    mm = armodel.MotionModel(
        coef=z["ar_coef"], intercept=z["ar_intercept"],
        error_variance=z["ar_error_variance"],
        train_rmse=float(z["ar_train_rmse"]),
        validation_rmse=float(z["ar_validation_rmse"]),
        window_size=int(z["ar_window_size"]),
        window_time=int(z["ar_window_time"]), lasso=bool(z["ar_lasso"]))
    return params, mm, z["stage1_q"]


def phase_dd(dev, ctx, results):
    """Stage 1.5: priors, the main path with the port's priors, agreement
    with the JAX float32 run, one profiled run. Returns the launches per
    shape of the counted run."""
    from cheetah_pose_estimation_tpu_torch import convert
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.pipeline.batched import (
        run_data_driven)
    from cheetah_pose_estimation_tpu_torch.priors import dataset, gmm

    _, batched, _, trials, fpss, subject, q_stage1 = ctx[:7]
    B = q_stage1.shape[0]
    out = {}
    # priors: tables, training on the card (set-up), against JAX's
    t0 = time.perf_counter()
    train = bench_lib.procedural_pose_table(bench_lib.TRAIN_SEEDS)
    val = bench_lib.procedural_pose_table(bench_lib.VAL_SEEDS)
    out["tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pri = bench_lib.train_priors(train, val, device=dev)
    torch.cuda.synchronize()
    out["prior_training_s"] = time.perf_counter() - t0
    jparams, jmm, jq1 = load_jax_priors(dev)
    X22 = train.data[:, 6:28]
    out["gmm_score"] = {"port": gmm.score(pri.gmm_params, X22),
                        "jax": gmm.score(jparams, X22)}
    Xw, _ = dataset.windowed_dataset(train.data, train.index, 4)
    out["ar_max_abs_diff"] = float(np.abs(
        pri.motion_model.predict(Xw) - jmm.predict(Xw)).max())
    out["ar_rmse"] = {"port": [pri.motion_model.train_rmse,
                               pri.motion_model.validation_rmse],
                      "jax": [jmm.train_rmse, jmm.validation_rmse]}
    log(f"# dd: tables {out['tables_s']:.2f} s, prior training "
        f"{out['prior_training_s']:.2f} s, GMM score {out['gmm_score']}, AR "
        f"max |pred diff| {out['ar_max_abs_diff']:.3e}, AR rmse "
        f"{out['ar_rmse']}")
    d_gmm = abs(out["gmm_score"]["port"] - out["gmm_score"]["jax"])
    if not (d_gmm <= TOL_GMM_NATS and out["ar_max_abs_diff"] <= TOL_AR):
        raise AssertionError(f"priors disagree with JAX's: GMM {d_gmm:.3f} "
                             f"nats, AR {out['ar_max_abs_diff']:.3e}")

    # main path: the port's priors, from phase 4's stage-1 result
    gp = convert.gmm_prior(pri.gmm_prior, B, device=dev)

    def run():
        q, ok, shifts = run_data_driven(q_stage1, batched, gp,
                                        pri.motion_model, subject)
        torch.cuda.synchronize()
        return q, ok, shifts

    # the warm-up run counts the kernel's launches and times each phase
    # (synced); then 2 timed repeats (3 made the smoke too long)
    phases = {}
    cuda_banded.reset_launches()
    t0 = time.perf_counter()
    run_data_driven(q_stage1, batched, gp, pri.motion_model, subject,
                    timings=phases)
    out["first_call_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    out["phases_s"] = phases
    log(f"# dd: phases of the warm-up run (synced) {phases}")
    if not (by_shape.get((10, 64), 0) > 0 and by_shape.get((70, 64), 0) > 0):
        raise AssertionError(f"the dd stage did not launch the kernel at "
                             f"10x64 and 70x64: {by_shape}")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        q, ok, shifts = run()
        times.append(time.perf_counter() - t0)
    if not (q.shape == q_stage1.shape and torch.isfinite(q).all()):
        raise AssertionError("non-finite or misshapen dd trajectories")
    rows = bench_lib.score_per_trial(q.double().cpu().numpy(), trials, fpss,
                                     subject)
    s_trial = float(np.mean(times)) / B
    out.update({"repeat_s": times, "s_per_trial": s_trial,
                "trials_per_min": 60.0 / s_trial,
                "launches_by_shape": shape_keys(by_shape),
                "prior_ok": ok.tolist(), "shifts": shifts.tolist(),
                "per_trial": rows})
    log(f"# dd: first call {out['first_call_s']:.3f} s, repeats {times} s, "
        f"{s_trial:.4f} s/trial, {60.0 / s_trial:.1f} trials/min, kernel "
        f"launches {out['launches_by_shape']}, prior_ok {ok.tolist()}, "
        f"shifts {shifts.tolist()}")
    for i, r in enumerate(rows):
        log(f"# dd: trial {i} MPE {r[0]:.2f} mm MPJPE {r[1]:.2f} mm "
            f"CoM-vel {r[2]:.4f} m/s")

    # agreement: JAX's stage-1 output and JAX's priors through the port
    with open(os.path.join(HERE, "tests", "data", "jax_stage15_f32.json"),
              encoding="utf-8") as f:
        jref = json.load(f)
    qa, oka, sha = run_data_driven(
        torch.as_tensor(jq1, dtype=torch.float32, device=dev), batched,
        convert.gmm_prior(gmm.to_solver_prior(jparams), B, device=dev), jmm,
        subject)
    ra = bench_lib.score_per_trial(qa.double().cpu().numpy(), trials, fpss,
                                   subject)
    mp = np.array([r[1] for r in ra])
    agree = {"mean_mpjpe_port": mp.mean(), "per_trial": ra,
             "prior_ok_port": oka.tolist(), "shifts_port": sha.tolist()}
    # held to the float64 run; the float32 run stops where its gradient
    # noise lets it (tests/data/jax_stage15_reference.py) and is reported
    for name, ref in (("jax_f64", jref["f64"]), ("jax_f32", jref)):
        mj = np.array(ref["mpjpe_mm"])
        for i in np.nonzero(np.abs(mp - mj) > 5.0)[0]:
            log(f"# dd agree: trial {i} port {mp[i]:.2f} mm vs {name} "
                f"{mj[i]:.2f} mm")
        agree[name] = {"mean_mpjpe": mj.mean(),
                       "rel": abs(mp.mean() - mj.mean()) / mj.mean(),
                       "prior_ok": ref["prior_ok"], "shifts": ref["shifts"]}
        log(f"# dd agree: mean MPJPE port {mp.mean():.3f} {name} "
            f"{mj.mean():.3f} (rel {agree[name]['rel']:.4f}); prior_ok port "
            f"{oka.tolist()} {name} {ref['prior_ok']}; shifts port "
            f"{sha.tolist()} {name} {ref['shifts']}")
    out["agree"] = agree
    results["dd"] = out
    if agree["jax_f64"]["rel"] > TOL_MPJPE:
        raise AssertionError(f"dd mean MPJPE disagrees with JAX's float64 "
                             f"run: {agree['jax_f64']['rel']:.4f} (limit "
                             f"{TOL_MPJPE})")

    prof = profiled(run, float(np.mean(times)))
    log(f"# dd profile: {prof}")
    out["profile"] = prof
    return by_shape, q, pri.gmm_prior, out


def forces_summary(fte, q, kbat):
    """Per trial: RMS joint torque and peak vertical GRF (body weights)
    over the frames whose EOM residual is active."""
    with torch.no_grad():
        tau, gz, _ = fte.forces(q, kbat)
    valid = fte._eom_valid(kbat)
    rms = torch.sqrt((valid[..., None] * tau * tau).sum((1, 2))
                     / (valid.sum(1) * tau.shape[-1]))
    peak = (valid[..., None] * gz).amax((1, 2))
    return rms.double().cpu().numpy(), peak.double().cpu().numpy()


def bench_ok(q, rows, warm_rows) -> bool:
    """bench.py's stage-2 flag: finite, mean MPE and mean CoM-velocity
    RMSE below 1.02x the warm start's."""
    mean = lambda rs, k: float(np.mean([r[k] for r in rs]))
    return bool(torch.isfinite(q).all()) \
        and mean(rows, 0) < 1.02 * mean(warm_rows, 0) \
        and mean(rows, 2) < 1.02 * mean(warm_rows, 2)


def physics_kernel_check(dev, fte, kbat, qw):
    """The kernel on the kinetic normal systems at the warm start, against
    the plain version in float64; the peak device memory of the frozen EOM
    curvature assembly; the time of one kinetic normal and one kinetic cost.
    Returns (rows, worst rel err, worst abs err, memory and times)."""
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    blocks = fte.eom_curvature_blocks(qw, kbat)
    torch.cuda.synchronize()
    curv_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base_mem
    b = kbat.base
    H_acc = kin.acc_banded(b.h, b.acc_weight, b.frame_valid)
    floor = torch.clamp(torch.diagonal(H_acc.diag, dim1=-2, dim2=-1),
                        min=1e-8)
    B = qw.shape[0]
    rows, worst_rel, worst_abs = [], 0.0, 0.0
    for scale in (3.0, 1.0):
        g, H = fte._normal(qw, kbat, scale, eom_blocks=blocks)
        for lam in (10.0, 1e-2):
            Hs, rhs, _ = gn.scaled_system(g, H, torch.full((B,), lam,
                                                           device=dev),
                                          floor)
            d32, l32, r32 = (x.contiguous() for x in (Hs.diag, Hs.lower,
                                                      rhs))
            x = cuda_banded.solve(d32, l32, r32)
            torch.cuda.synchronize()
            ref = cuda_banded.solve_reference(d32.double(), l32.double(),
                                              r32.double())
            if not (torch.isfinite(x).all() and torch.isfinite(ref).all()):
                raise AssertionError(f"non-finite physics solve at scale "
                                     f"{scale}, lam {lam}")
            abs_err = float((x.double() - ref).abs().max())
            rel = abs_err / float(ref.abs().max())
            rows.append({"scale": scale, "lam": lam, "rel_err": rel,
                         "max_abs_err": abs_err})
            worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs,
                                                            abs_err)
    # one kinetic normal and one kinetic cost at the warm start, each synced:
    # the two halves of an LM step's assembly
    normal_s, cost_s = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        fte._normal(qw, kbat, 1.0, eom_blocks=blocks)
        torch.cuda.synchronize()
        normal_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        fte._cost(qw, kbat, 1.0)
        torch.cuda.synchronize()
        cost_s.append(time.perf_counter() - t0)
    card = torch.cuda.get_device_properties(dev).total_memory
    log(f"# physics: kernel on the kinetic normal systems {rows}; EOM "
        f"curvature blocks {curv_s:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB over {base_mem / 2**30:.3f} GiB in use "
        f"(card {card / 2**30:.1f} GiB); one kinetic normal {normal_s} s, "
        f"one kinetic cost {cost_s} s")
    if worst_rel > TOL_REL:
        raise AssertionError(f"kernel rel err {worst_rel:.3e} > {TOL_REL} on "
                             "the kinetic normal systems")
    return rows, worst_rel, worst_abs, {"curvature_s": curv_s,
                                        "curvature_peak_bytes": peak,
                                        "bytes_in_use_before": base_mem,
                                        "normal_s": normal_s,
                                        "cost_s": cost_s}


def phase_physics(dev, ctx, q_dd, gmm_prior, dd_out, results):
    """Stage 2: host prep, the kernel on the physics systems, the main path
    from phase 7's output, agreement with the JAX runs from JAX's inputs, one
    profiled run. Returns the kernel's launches per shape of the counted
    run."""
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.pipeline import contacts
    from cheetah_pose_estimation_tpu_torch.pipeline.batched import (
        run_physics)
    from cheetah_pose_estimation_tpu_torch.priors import gmm
    from cheetah_pose_estimation_tpu_torch.solver import kinetic as kn

    _, _, _, trials, fpss, subject, _, datas = ctx
    B = q_dd.shape[0]
    out = {}
    gphs = [contacts.estimate_ground_height(tr.q_gt, subject)
            for tr in trials]
    fte = kn.KineticFTE(kn.KineticConfig(use_gmm=True), subject)

    # host prep alone, and the kernel on the physics systems
    t0 = time.perf_counter()
    kbat, qw = bench_lib.build_physics_batch(
        datas, [q_dd[i, : d.meas.shape[0]].double().cpu().numpy()
                for i, d in enumerate(datas)], fpss, subject,
        gmm_prior=gmm_prior, n_frames=q_dd.shape[1], dtype=q_dd.dtype,
        ground_heights=gphs, device=dev)
    out["host_prep_s"] = time.perf_counter() - t0
    out["stance_frames"] = kbat.stance.sum((1, 2)).tolist()
    log(f"# physics: host prep {out['host_prep_s']:.3f} s, stance frames "
        f"per trial {out['stance_frames']}")
    out["kernel"], worst_rel, worst_abs, mem = physics_kernel_check(
        dev, fte, kbat, qw)
    out.update(mem)

    def run(q_warm, gp, timings=None):
        st, kb = run_physics(q_warm, datas, fpss, subject, gp,
                             ground_heights=gphs, timings=timings)
        torch.cuda.synchronize()
        return st, kb

    # the warm-up run counts the kernel's launches; then 2 timed repeats
    cuda_banded.reset_launches()
    phases = {}
    t0 = time.perf_counter()
    run(q_dd, gmm_prior, phases)
    out["first_call_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    log(f"# physics: warm-up {out['first_call_s']:.3f} s, phases "
        f"{phases}, kernel launches {shape_keys(by_shape)}")
    if not by_shape.get((B, q_dd.shape[1]), 0) > 0:
        raise AssertionError(f"the physics stage did not launch the kernel "
                             f"at {B}x{q_dd.shape[1]}: {by_shape}")
    times, phase_runs = [], []
    for _ in range(2):
        phases = {}
        t0 = time.perf_counter()
        st, kb = run(q_dd, gmm_prior, phases)
        times.append(time.perf_counter() - t0)
        phase_runs.append(phases)
    if not (st.q.shape == q_dd.shape and torch.isfinite(st.q).all()):
        raise AssertionError("non-finite or misshapen physics trajectories")
    q_np = st.q.double().cpu().numpy()
    rows = bench_lib.score_per_trial(q_np, trials, fpss, subject)
    rms_tau, peak_gz = forces_summary(fte, st.q, kb)
    warm = dd_out["per_trial"]
    ok = bench_ok(st.q, rows, warm)
    s_trial = float(np.mean(times)) / B
    steps = int(st.it.max())
    lm_s = float(np.mean([p["lm"] for p in phase_runs]))
    out.update({"repeat_s": times, "phases_s": phase_runs,
                "s_per_trial": s_trial, "trials_per_min": 60.0 / s_trial,
                "lm_iterations": steps, "lm_ms_per_step": 1e3 * lm_s / steps,
                "launches_by_shape": shape_keys(by_shape),
                "n_accepted": st.n_accepted.tolist(), "it": st.it.tolist(),
                "per_trial": rows, "rms_tau_bw": rms_tau.tolist(),
                "peak_grf_z_bw": peak_gz.tolist(), "ok": ok})
    log(f"# physics: repeats {times} s, {s_trial:.4f} s/trial, "
        f"{60.0 / s_trial:.1f} trials/min, phases {phase_runs}, "
        f"{steps} LM steps ({out['lm_ms_per_step']:.1f} ms per step), "
        f"accepted steps per lane {st.n_accepted.tolist()}, ok {ok}")
    mean = lambda rs, k: float(np.mean([r[k] for r in rs]))
    log(f"# physics: mean MPE {mean(rows, 0):.2f} mm MPJPE "
        f"{mean(rows, 1):.3f} mm CoM-vel {mean(rows, 2):.4f} m/s (warm "
        f"{mean(warm, 0):.2f} / {mean(warm, 1):.3f} / {mean(warm, 2):.4f})")
    for i, r in enumerate(rows):
        log(f"# physics: trial {i} MPE {r[0]:.2f} mm MPJPE {r[1]:.2f} mm "
            f"CoM-vel {r[2]:.4f} m/s RMS torque {rms_tau[i]:.4f} BW peak "
            f"GRFz {peak_gz[i]:.3f} BW")

    # agreement: JAX's stage-1 output and JAX's GMM through the port
    with open(os.path.join(HERE, "tests", "data", "jax_stage2_f32.json"),
              encoding="utf-8") as f:
        jref = json.load(f)
    jparams, _, jq1 = load_jax_priors(dev)
    q1 = torch.as_tensor(jq1, dtype=torch.float32, device=dev)
    sta, kba = run(q1, gmm.to_solver_prior(jparams))
    ra = bench_lib.score_per_trial(sta.q.double().cpu().numpy(), trials,
                                   fpss, subject)
    warm_a = bench_lib.score_per_trial(jq1.astype(np.float64), trials, fpss,
                                       subject)
    ok_a = bench_ok(sta.q, ra, warm_a)
    rms_a, peak_a = forces_summary(fte, sta.q, kba)
    stance_a = kba.stance.cpu().numpy().astype(int)
    agree = {"mean_mpjpe_port": mean(ra, 1), "mean_comvel_port": mean(ra, 2),
             "mean_mpe_port": mean(ra, 0), "ok_port": ok_a,
             "n_accepted_port": sta.n_accepted.tolist(), "per_trial": ra,
             "rms_tau_bw_port": rms_a.tolist(),
             "peak_grf_z_bw_port": peak_a.tolist()}
    for name, ref in (("jax_f64", jref["f64"]), ("jax_f32", jref)):
        same_stance = bool(np.array_equal(stance_a, np.asarray(ref["stance"])))
        a = {"mean_mpjpe": ref["mean_mpjpe_mm"],
             "mean_comvel": ref["mean_comvel_rmse_ms"],
             "rel_mpjpe": abs(mean(ra, 1) - ref["mean_mpjpe_mm"])
             / ref["mean_mpjpe_mm"],
             "rel_comvel": abs(mean(ra, 2) - ref["mean_comvel_rmse_ms"])
             / ref["mean_comvel_rmse_ms"],
             "ok": ref["ok"], "same_stance": same_stance,
             "n_accepted": ref["n_accepted"]}
        agree[name] = a
        log(f"# physics agree: port vs {name}: mean MPJPE {mean(ra, 1):.3f} "
            f"vs {a['mean_mpjpe']:.3f} (rel {a['rel_mpjpe']:.4f}), CoM-vel "
            f"{mean(ra, 2):.4f} vs {a['mean_comvel']:.4f} (rel "
            f"{a['rel_comvel']:.4f}), ok {ok_a} vs {a['ok']}, same stance "
            f"{same_stance}, accepted {sta.n_accepted.tolist()} vs "
            f"{a['n_accepted']}")
    out["agree"] = agree
    results["physics"] = out
    a = agree["jax_f64"]
    if not (a["same_stance"] and a["rel_mpjpe"] <= TOL_MPJPE
            and a["rel_comvel"] <= TOL_COMVEL and ok_a == a["ok"]):
        raise AssertionError(f"physics stage disagrees with JAX's float64 "
                             f"run: {a}, port ok {ok_a}")

    prof = profiled(lambda: run(q_dd, gmm_prior), float(np.mean(times)))
    log(f"# physics profile: {prof}")
    out["profile"] = prof
    return by_shape, worst_rel, worst_abs


def phase_agree(ctx, rows_kernel, results):
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib

    fte, batched, q0b, trials, fpss, subject = ctx[:6]
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
    # 1. device (the port's default: the current CUDA device)
    dev = resolve_device()
    if dev.type != "cuda":
        raise AssertionError(f"resolve_device() gave {dev}")
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
    # 3-8
    worst_rel, worst_abs, timed = phase_kernel(dev, results)
    stage1_shapes, rows, ctx = phase_main(dev, results)
    phase_agree(ctx, rows, results)
    phase_profile(ctx, results)
    dd_shapes, q_dd, gmm_dd, dd_out = phase_dd(dev, ctx, results)
    physics_shapes, phys_rel, phys_abs = phase_physics(
        dev, ctx, q_dd, gmm_dd, dd_out, results)
    worst_rel, worst_abs = max(worst_rel, phys_rel), max(worst_abs, phys_abs)

    main_shape = timed[0]                     # (10, 64): the finish's shape
    keys = ("kernel_ms", "plain_ms", "cr_ms", "library_ms", "bound_ms",
            "bound_by", "roofline_share")
    kernels = {"kernels": [{
        "name": "banded_solve",
        "route": "cuda",
        "source": "cheetah_pose_estimation_tpu_torch/csrc/banded_solve.cu",
        "replaces": "cheetah_pose_estimation_tpu/ops/pallas_banded.py:262,309",
        "launches": sum(stage1_shapes.values()) + sum(dd_shapes.values())
        + sum(physics_shapes.values()),
        "launches_by_path": {"stage1": shape_keys(stage1_shapes),
                             "dd": shape_keys(dd_shapes),
                             "physics": shape_keys(physics_shapes)},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "roofline_share": main_shape["roofline_share"],
        "shapes": [{"B": r["B"], "N": r["N"], **{k: r[k] for k in keys}}
                   for r in timed]}]}
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
