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
   FLOPs and bytes the solve needs. Then, on random SPD systems, the error,
   kernel, plain and library times and bound at every shape the dataset
   CLI launches: the batched path's 6x64, 4x64, 18x64, 12x64, 42x64, 28x64
   and the serial path's 3xN, 1xN, 7xN for its two trials' N = 40, 42,
   the force-plate pipeline's 1x50, the AcinoSet flag's 3xN, 1xN, 7xN for
   its other two trials' N = 44, 46, the analysis flag's 36x64, 24x64,
   108x64, 72x64, 252x64 and 168x64 (the last two in two waves of CTAs:
   more systems than SMs), and the studies' 48x48, 6x48, 2x48 and the
   full-depth grid's 144x64 (two waves) and 96x64.
4. main    — stage 1 of the bench: 10 procedural monocular problems padded
   to 64 frames, ``make_kinematic_multistart`` once (warm-up, with the
   kernel's launch count) and 1 timed repeat; one more run with the probe
   and the finish timed apart; per-trial MPE, MPJPE and CoM-velocity RMSE.
5. agree   — the same problems with ``linear_solver="scan"``, and the JAX
   package's float32 stage-1 numbers (``tests/data/jax_stage1_f32.json``):
   mean MPJPE within 2 % of both.
6. profile — a 20-step window of stage 1's finish under torch.profiler
   (``profiled_window``): device time, the
   kernel's share of it, device events per LM step, and the device's busy
   share of the window's unprofiled wall.
7. dd      — stage 1.5 of the bench, the data-driven mode. Priors: the
   procedural pose tables, the port's priors trained on the card (set-up,
   timed), held against the JAX-trained priors of
   ``tests/data/jax_dd_inputs.npz`` (GMM score on the training table within
   0.5 nats per sample, AR predictions on its windows within 1e-6). Main
   path: phase 4's stage-1 result through ``run_data_driven`` with the
   port's priors, once (warm-up, with the kernel's launches per shape, both
   > 0, and each phase timed) and 1 timed repeat; per-trial MPE, MPJPE,
   CoM-velocity, ``prior_ok`` and shifts. Agreement: ``run_data_driven`` from JAX's
   float32 stage-1 trajectories with the JAX-trained priors (both from the
   npz), mean MPJPE within 2 % of the JAX float64 dd run from the same
   inputs (``tests/data/jax_stage15_f32.json``, ``f64``); the JAX float32
   run's mean MPJPE, gate decisions and shifts are printed beside it.
   Profile: a 20-step window of the stage's GMM chain solve under
   torch.profiler.
8. physics — stage 2 of the bench, the physics-based mode, from phase 7's
   dd trajectories with the port's GMM prior: host prep
   (``bench_lib.build_physics_batch``: foot kinematics, contact detection,
   stance pruning; ground heights from each trial's ground truth), then the
   kernel against its plain version in float64 on the kinetic normal
   systems at the warm start (annealing scales 3 and 1, damped and
   Jacobi-scaled as ``gn.scaled_system`` does at lam = 10 and 1e-2),
   relative error <= 7e-4, and the peak device memory of the frozen EOM
   curvature blocks. Main path: ``run_physics`` once (warm-up, the kernel's
   launches at 10x64 > 0) and 1 timed repeat, host prep, curvature blocks
   and LM loop timed apart; per-trial MPE, MPJPE, CoM-velocity, accepted
   steps, RMS torque and peak GRFz, and bench's ``ok`` (finite, mean MPE
   and CoM-velocity < 1.02x the warm start's). Agreement: ``run_physics``
   from JAX's float32 stage-1 trajectories with the JAX-trained GMM
   (``tests/data/jax_dd_inputs.npz``) against the JAX float64 stage-2 run
   from the same inputs (``tests/data/jax_stage2_f32.json``, ``f64``): the
   same pruned stance matrices, mean MPJPE within 2 %, mean CoM-velocity
   within 5 %, the same ``ok``; the JAX float32 run beside it. Profile: a
   20-step window of the LM solve from the warm start under
   torch.profiler, against an unprofiled run of the window.
9. cli     — the dataset CLI (``pipeline/run_dataset.main``) on the
   synthetic test set: write the procedural pose tables and render the
   10-trial tree (6 fisheye cameras, correlated DLC failures), its digest
   held against the JAX CLI's tree (``tests/data/jax_cli_f32.json``: the
   same likelihood gate pattern, pixels within 1e-3 px); then
   ``--run_monocular --batched --clean`` once, all four modes (multi-view
   ground truth, default with the ground-plane polish, data-driven,
   physics-based), with the kernel's launches per mode and shape (each
   mode > 0), s/trial, and per-trial MPE, MPJPE and CoM-velocity RMSE
   against the multi-view solve (MPJPE against the synthetic truth too).
   The kernel against its plain version in float64 on the 6-camera normal
   systems and on the anchored polish's systems (lam = 1e-2, rel error <=
   7e-4). Agreement with the JAX float32 CLI run on the same input (the
   JAX CLI run on the port's rendering of the tree, which the tree is
   checked to equal within 1e-9 px): the ground-truth mode's mean MPJPE
   against the truth within 2 % either way; each monocular mode's mean MPE
   and MPJPE within 2 %, mean CoM-velocity within 5 %, either way, as they
   are or once the witnessed trials are set aside: those on which the
   port's value is the lower and its saved final objective is lower than
   the JAX run's (the same problem, solved further down), and those on
   which the JAX reference does not reproduce itself (its runs on its own
   and on the port's rendering, which differ by float32 round-off, differ
   there by more than the bar); the prior gate, scan shifts, polish
   shifts and changes and the physics stance matrices printed beside the
   JAX run's. The same comparison with the JAX run on its own tree is
   printed beside. Every artifact the JAX run wrote (``fte.pickle``,
   ``cam*_fte.csv``, the contact JSON files, ``dataset_results.csv``)
   present with the same keys and shapes. Then 20-step windows of the
   6-camera solves under torch.profiler (device events per LM step, busy
   share of the windows' unprofiled wall).
10. serial — the dataset CLI's serial per-trial path on phase 9's tree:
   ``--run_monocular --clean --trials 2`` without ``--batched`` (each trial
   alone at its own length, mode after mode; the physics-based mode in up
   to three attempts), the kernel's launches per mode and shape (each mode
   > 0, every shape one phase 3 timed), s/trial, each trial's decisions
   (prior gate, line-scan shift, ground-plane ray shift and polish, stance,
   the accepted physics attempt), MPE, MPJPE, CoM-velocity RMSE and
   objective. Agreement with the JAX package's serial float32 run on the
   same input (``tests/data/jax_serial_f32.json``, ``port_tree``): the
   means held as in phase 9 (the saved objectives compared directly: both
   packages save it under the data before a line-scan shift), the same accepted
   physics attempt on every trial, every JAX artifact present with its
   keys and shapes; the JAX run on its own tree printed beside (both on
   the reference's first two trials). Then the
   batched path on the same two trials (its s/trial beside the serial
   path's), and one trial's 1-lane ground-truth solve and 3-lane default
   multistart, each kinematic solve cut to 20 steps, under
   torch.profiler (the card's idle share).
11. kinetic — the force-plate pipeline (``run_dataset.main --run_kinetic
   --clean``) on the first trial of the synthetic kinetic test set
   (50 frames, 4 pinhole cameras at 200 fps), its tree's digest held
   against the JAX
   trees' (``tests/data/jax_kinetic_f32.json``): per stage (kinematic,
   kinetic with synthesized GRFs, GRF re-estimation with the torque anchor)
   s/trial, LM steps and launches per shape (each stage of each trial > 0,
   only 1x50); per trial MPJPE and MPE against the synthetic truth,
   CoM-velocity RMSE, the pruned stance, RMS torque, peak GRFz,
   ``check_grf`` and the saved objective; the static GRFs (GRFz over the
   stance frames); the kernel against its plain version in float64 on the
   4-camera pinhole and the torque-anchored kinetic normal systems (lam =
   1e-2, rel error <= 7e-4); the plots written or skipped. Agreement with
   the JAX float64 run on the same input: per stage mean MPJPE within 2 %
   and mean CoM-velocity within 5 % of it either way (``kinetic_gate``);
   the same pruned stances, the port's
   static GRF solver on the JAX run's trajectories within 1e-3 body weights
   frame by frame, every JAX artifact present with its keys and shapes,
   nothing set aside; the JAX float32 runs and JAX's own MPE bars printed
   beside. Then a 20-step window of one trial's 1-lane kinetic solve (the
   GRF re-estimation) under torch.profiler (device events per LM step, the
   card's idle share).
12. acinoset — the AcinoSet flag (``run_dataset.main --run_acinoset
   --clean``) on trials 0 and 2 of the first four of the synthetic test
   set (jules flick2 with its pairwise pseudo-measurements, W = 3, and
   phantom run; the four rendered, the other two removed), its tree's and
   PPM pickles' digests held against the JAX trees'
   (``tests/data/jax_acinoset_f64.json``): per trial and mode (ground
   truth, default, data-driven) s, LM steps, launches per shape, W, MPJPE
   and MPE against the synthetic truth, the saved objective;
   ``validate_dataset``'s dict. Agreement with the JAX float64 run on the
   same input: the ground-truth mode's mean MPJPE against the truth within
   2 % either way, over both trials and over the flick, nothing set
   aside; W = 3 on the flick and 1 on the run on both sides;
   ``validate_dataset`` equal to JAX's on those trials; every JAX artifact
   of those trials present with its keys and shapes. The monocular modes are printed beside JAX float64 and
   float32.
13. analysis — the analysis flag (``run_dataset.main --run_analysis
   --clean --batched``) on phase 9's tree: the multi-view ground truth of
   the 10 trials, then all 60 (trial, camera) combinations as lanes of the
   default and data-driven modes (line-scans at 252x64 and 168x64), the
   distance-vs-error table and the per-camera robustness; per mode the
   wall, LM steps and launches per shape. Checks: every solution present
   and finite, ``dist_vs_error.csv`` with JAX's columns, each combination's
   CoM distance and view angle within 1 % of JAX's on the JAX float64
   ground truth; the kernel against its plain version on the 252-lane
   line-scan's own normal systems (lam = 1e-2, rel error <= 7e-4) and a
   NaN lane of the second wave isolated. Printed: each combination's MPE
   against the multi-view solve and its depth, across and rest parts,
   beside JAX float64's on the two trials it swept; a window of 10 LM
   steps of that line-scan under torch.profiler.
14. studies — the study flags on phase 9's tree and output directory
   (``run_dataset.main --run_grid_search --run_data_driven_ablation_study
   --run_physics_based_ablation_study --batched --trials 2``: the
   24-configuration grid over two trials as one 48-lane batch, the model
   selection at its defaults, both ablations, the physics ablation's LM
   schedule cut to 30 steps, the figures), then the
   degradation sweep with its physics column (rate 0, 4
   bench trials); per study the wall, LM steps and launches per shape,
   each CSV's rows, the plots written or skipped. Checks: every CSV and
   ``grid_search.pickle`` with the JAX package's columns or keys and row
   counts, every value finite, ``n``
   = 2 in every study row; the AR statistics within 1e-6 of JAX's with
   equal non-zero counts; the studies' own GMM likelihoods per component
   count within 0.5 nats per sample of JAX's (the port's k-means++ draw is
   JAX's); the kernel against its plain version on the grid's first
   finite 48-lane systems (rel error <= 7e-4); the sweep's mean MPJPE per rate and column within
   2 % of JAX float64's, a rate where JAX float32 misses its own float64
   by more than that printed, not gated (``sweep_gate``), against
   ``tests/data/jax_studies_f64.json``. The studies' monocular rows are
   printed beside the JAX float64 and float32 runs' on the same trials
   where that file recorded them.
15. options — the estimator's solver options (``phase_options``) against
   the JAX float64 runs of ``tests/data/jax_options_f64.json``: on one
   4-camera, 64-frame gallop whose camera 2 is 0.4 frame periods late, the
   joint shutter-delay solve (``estimate_kinematics`` with
   ``shutter_delay_estimation``: the kernel on 5x64 systems, 1 + 4
   right-hand sides; camera 2's relative delay within 0.05 h of the
   injected one, every delay within 0.01 h of JAX float32's, MPJPE within
   2 % of JAX float64's),
   then ``estimate_kinetics`` with ``enable_lcp`` (``check_lcp`` ok, or
   its largest violation within 10 % of the JAX run's, which fails the
   check itself) and with ``use_2d_reprojections=False`` (each MPJPE
   within 2 %, CoM-velocity within 5 % of JAX's); the stage-1 batch with
   the fixed-length and the while drivers (equal step counts, mean MPJPE
   within 0.1 %, each driver's ms and host syncs per step printed); the
   serial path's first trial in the data-driven mode with
   ``motion_prior_rolling`` 1 and 0 (finite; printed beside JAX's).

16. dynamics — the dynamics tools and the remaining prior options
   (``phase_dynamics``) against the JAX runs of
   ``tests/data/jax_dynamics_f64.json``: the kernel on the stop task's
   first normal system (1x40, lam = 1e-2, rel error <= 7e-4);
   ``tasks.high_speed_stop()`` at the JAX defaults and
   ``periodic_gallop()`` at them cut to its first 20 LM steps (the kernel
   at 1x40 and 1x44 on every LM step, float32): the JAX test's bars that
   JAX float64 meets, each score (the gallop's: cost, stride, speed,
   periodicity, EOM slack) within 2 % of JAX float64 at the same depth
   (printed, not gated, where JAX float32 misses its float64 by more,
   ``task_gate``); the drop test cut to 0.1 s
   (upright, base height, feet, the base path within 1e-4 m of JAX
   float64's to the first contact, the state at 0.1 s within 1e-3 m of
   JAX float64's record there) and the
   ballistic throw (CoM within 2e-3 m of free fall), ms per RK4 step and
   launches per derivative; ``pca.fit`` and the PCA-space AR model (axes
   1e-8, coefficients 1e-6 of JAX's); phase 7's 70-lane line-scan, three
   trials pushed 0.3 m back, with and without ``finish_stages``
   (unaccepted lanes bit for bit, finished prior-free cost <= unfinished).
17. responses — the three response studies (``phase_responses``) against
   ``tests/data/jax_responses_f64.json``, priors from phase 9's pose
   tables: ``run_forced_vs_gated_bench`` at its size (10 procedural bench
   trials x 64 frames: the kernel at 30x64 and 10x64): JAX's columns, 10
   rows, finite values, each ratio the chain's prior-free cost over the
   free solve's, each gate ``prior_gate_accept`` of them, a rejected
   trial's dd_gated scores equal to default's, an unaccepted anchor's
   scores unchanged; each variant's mean MPE, MPJPE and CoM-velocity
   before and after the anchor within 2 % (CoM-vel 5 %) of JAX float32's
   as it is or with witnessed trials set aside (``fvg_agree``), the gap
   to JAX float64 and the acceptance counts printed.
   ``run_deadband_sweep`` (the floor and 0.05, GRF cap 5) and
   ``run_physics_lever_sweep`` (production and one variant with every
   override route) at 2 trials x 48 frames (2x48 and 6x48): JAX's
   columns; the warm start's MPE and CoM-velocity (2 %) and each row (2 %,
   CoM-vel 5 %) within their bars of JAX float64 unless JAX float32
   misses its float64 by more (``sweep_gate``; a row where it misses on
   any column is printed whole), a value that either JAX run did not
   record printed; the accepted LM
   steps printed beside JAX's; the kernel on the first kinetic system
   (lam = 1e-2, rel error <= 7e-4). Then the results layer on phases 9
   and 11's trees (``results_layer``): ``compare_traj_error``,
   ``check_joint_estimation`` and ``plot_eom_error`` of the force-plate
   solution against itself (MPJPE 0, torque RMSE 0), the power and
   torque errors, the plots False without matplotlib.

Before the last two lines: a JSON object with the kernel's launches (in all
and per path and shape), error, times and bound (at 10x64, and per shape),
then the card's name and power limit; the last line is ``{"ok": true,
"device": {...}}``.
"""
import argparse
import contextlib
import json
import os
import shutil
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
TOL_LCP = 0.10        # phase 15: largest complementarity violation vs JAX
SHAPES = ((10, 64), (30, 64), (70, 64), (1, 256))
# the dataset CLI's kernel shapes: the batched path's two subject groups
# (jules 6, phantom 4 trials; probes x3, line-scans x7, padded to 64
# frames), and the serial path's first SERIAL_TRIALS trials at their own
# lengths (trial i of the synthetic test set has 40 + 2 i frames): the
# heading multistart (3 lanes), the single solves (1) and the line-scan (7).
# Two of the serial reference's three trials, to keep the smoke's time
SERIAL_TRIALS = 2
CLI_SHAPES = ((6, 64), (4, 64), (18, 64), (12, 64), (42, 64), (28, 64))
SERIAL_SHAPES = tuple((b, 40 + 2 * i) for i in range(SERIAL_TRIALS)
                      for b in (3, 1, 7))
# the force-plate pipeline: every solve one trial of 50 frames
KINETIC_SHAPES = ((1, 50),)
# the AcinoSet flag's serial solves of its four trials past the serial
# path's (the first SERIAL_TRIALS are SERIAL_SHAPES'), and the every-camera
# sweep of the analysis flag: 36 and 24 (trial, camera) lanes of the two
# subject groups, their heading probes (x3) and data-driven line-scans (x7)
ACINOSET_SHAPES = tuple((b, 40 + 2 * i) for i in range(SERIAL_TRIALS, 4)
                        for b in (3, 1, 7))
ANALYSIS_SHAPES = ((36, 64), (24, 64), (108, 64), (72, 64), (252, 64),
                   (168, 64))
# the studies (phase 14, two jules trials of 40 and 42 frames padded to
# 48): the grid's 24 configurations x 2 trials as one batch, the
# bootstrap's heading probe (3 x 2) and its 2-lane solves (the ablations'
# too); the degradation sweep's 4 bench trials at 64 frames (their probe
# and solves are CLI_SHAPES' 12x64 and 4x64); and the grid at the CLI's
# full depth (10 trials: jules 6 and phantom 4, 24 configurations each)
STUDY_SHAPES = ((48, 48), (6, 48), (2, 48), (144, 64), (96, 64))
# phase 15 (options): one 4-camera trial of 64 frames with a shutter delay
# on camera 2; the joint (q, tau) solve hands the kernel 1 + 4 lanes per
# system
OPTIONS_PATH = os.path.join("2019_03_07", "phantom", "run")
OPTIONS_FRAMES = 64
OPTIONS_TAU_H = 0.4
OPTIONS_SHAPES = ((5, 64), (1, 64))
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
    cli_rows = kernel_cli_shapes(dev)
    results["kernel_cli_shapes"] = cli_rows
    worst_rel = max([worst_rel] + [r["rel_err"] for r in cli_rows])
    worst_abs = max([worst_abs] + [r["max_abs_err"] for r in cli_rows])
    return worst_rel, worst_abs, [r for r in rows if r["systems"] == "normal"
                                  ] + cli_rows


def kernel_cli_shapes(dev):
    """The kernel at the dataset CLI's shapes (``CLI_SHAPES``,
    ``SERIAL_SHAPES``, ``KINETIC_SHAPES``, ``ACINOSET_SHAPES``,
    ``ANALYSIS_SHAPES``, ``STUDY_SHAPES``) and the options'
    (``OPTIONS_SHAPES``: the joint shutter solve's 5x64, the single
    solves' 1x64) on random SPD systems: its
    error against the plain
    version in float64 (<= 7e-4), its time (CUDA events, 20 launches after
    3 warm-ups) beside the plain float32 version's, the one-call library
    time (dense ``torch.linalg.solve``) and the bound."""
    from cheetah_pose_estimation_tpu_torch.ops import banded, cuda_banded

    rows = []
    for path, shapes in (("batched CLI", CLI_SHAPES),
                         ("serial CLI", SERIAL_SHAPES),
                         ("kinetic CLI", KINETIC_SHAPES),
                         ("acinoset CLI", ACINOSET_SHAPES),
                         ("analysis CLI", ANALYSIS_SHAPES),
                         ("studies", STUDY_SHAPES),
                         ("options", OPTIONS_SHAPES)):
        for B, N in shapes:
            d32, l32, r32 = cuda_banded.random_systems(B, N, B * 1000 + N,
                                                       dev)
            x = cuda_banded.solve(d32, l32, r32)
            torch.cuda.synchronize()
            ref = cuda_banded.solve_reference(d32.double(), l32.double(),
                                              r32.double())
            abs_err = float((x.double() - ref).abs().max())
            row = {"B": B, "N": N, "systems": "random_spd", "path": path,
                   "rel_err": abs_err / float(ref.abs().max()),
                   "max_abs_err": abs_err,
                   "kernel_ms": cuda_ms(lambda: cuda_banded.solve(d32, l32,
                                                                  r32)),
                   "plain_ms": cuda_ms(lambda: cuda_banded.solve_reference(
                       d32, l32, r32), reps=3, warmup=1)}
            dense = banded.to_dense(banded.BlockBanded(d32, l32))
            rhs_col = r32.reshape(B, -1, 1)
            row["library_ms"] = cuda_ms(
                lambda: torch.linalg.solve(dense, rhs_col), reps=3, warmup=1)
            del dense
            row["bound_ms"], row["bound_by"] = bound(B, N)
            row["roofline_share"] = row["bound_ms"] / row["kernel_ms"]
            log(f"# kernel {row}")
            if not (torch.isfinite(x).all() and row["rel_err"] <= TOL_REL):
                raise AssertionError(f"kernel at {(B, N)}: {row}")
            rows.append(row)
    return rows


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
    for _ in range(1):
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
        timed(fte.make_solver(stages=pbatch.PROBE_STAGES, driver="scan"),
              "probe_s"),
        timed(fte.make_solver(stages=pbatch.FULL_STAGES), "finish_s"))(
            q0b, batched)
    return split


def profiled(fn, wall_unprofiled_s: float) -> dict:
    """Run ``fn`` once under torch.profiler: the sum of kernel times on the
    one stream, the banded-solve kernel's share of it, the count of kernel
    launches, and the five kernels that took the most device time (by
    the first 72 characters of their names: a template's instances are
    summed). The device's busy share is that device time over
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
    dev_us, solve_us, n, by_name = 0.0, 0.0, 0, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA":
            continue
        us = ev.duration_ns() / 1e3
        dev_us += us
        n += 1
        name = ev.name()[:72]
        by_name[name] = by_name.get(name, 0.0) + us
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
            "device_kernel_launches": n,
            "top_kernels_share_of_device": {
                k: v / max(dev_us, 1e-9) for k, v in sorted(
                    by_name.items(), key=lambda kv: -kv[1])[:5]}}


def profiled_window(run_w, reps=1, warm=True) -> dict:
    """A window of LM steps ``run_w`` (a solver of ``PROFILE_STEPS`` steps or
    so) under ``profiled``: one warm-up run (unless ``warm`` is False: the
    caller's run warmed its shapes), ``reps`` unprofiled runs timed, then one
    profiled. Adds the LM steps (the kernel's launches), device events and ms
    per step and the device's idle share. Profiling whole solves took
    30-45 s each of the smoke's time, nearly all of it the profiler's own
    processing of ~200k events."""
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded

    if warm:
        run_w()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_w()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    cuda_banded.reset_launches()
    prof = profiled(run_w, float(np.mean(walls)))
    prof["lm_steps"] = cuda_banded.launches
    prof["unprofiled_walls_s"] = walls
    prof["device_events_per_step"] = prof["device_kernel_launches"] / \
        prof["lm_steps"]
    prof["device_idle_share"] = 1.0 - prof["device_busy_share"]
    prof["ms_per_step"] = float(np.mean(walls)) / prof["lm_steps"] * 1e3
    return prof


def phase_profile(ctx, results):
    """A ``PROFILE_STEPS``-step window of stage 1's finish (10 lanes, first
    annealing stage) under torch.profiler (``profiled_window``)."""
    fte, batched, q0b = ctx[:3]
    window = fte.make_solver(stages=((10.0, PROFILE_STEPS),))
    out = profiled_window(lambda: window(q0b, batched))
    log(f"# profile: {PROFILE_STEPS}-step window of stage 1's finish {out}")
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
    shape of the counted run, its trajectories, the GMM prior, the phase's
    results and the inputs of its line-scan (``widest_linescan``)."""
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
    # (synced); then 1 timed repeat (more made the smoke too long)
    phases = {}
    cuda_banded.reset_launches()
    t0 = time.perf_counter()
    with widest_linescan() as scan_rec:
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
    for _ in range(1):
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

    # a window of the stage's first solve (the GMM chain with the base
    # anchor, 10 lanes)
    from cheetah_pose_estimation_tpu_torch.pipeline.batched import (
        DD_BASE_ANCHOR)
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    chain = kin.KinematicFTE(kin.KinematicConfig(
        use_gmm=True, fisheye=True, robust=True, **DD_BASE_ANCHOR),
        subject).make_solver(stages=((10.0, PROFILE_STEPS),))
    bat0 = batched._replace(gmm=gp, base_ref=q_stage1[:, :, :6])
    prof = profiled_window(lambda: chain(q_stage1, bat0))
    log(f"# dd profile: {PROFILE_STEPS}-step window of the GMM chain "
        f"solve {prof}")
    out["profile"] = prof
    return by_shape, q, pri.gmm_prior, out, scan_rec


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
    from phase 7's output, agreement with the JAX runs from JAX's inputs, a
    ``PROFILE_STEPS``-step window of the LM solve under torch.profiler.
    Returns the kernel's launches per shape of the counted run."""
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

    # the warm-up run counts the kernel's launches; then 1 timed repeat
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
    for _ in range(1):
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

    # a window of the LM solve under torch.profiler, from the warm start
    # with its curvature blocks, against an unprofiled run of the window
    # (the whole stage under the profiler took ~120 s of the smoke's time)
    blocks = fte.eom_curvature_blocks(qw, kbat)
    window = fte.make_solver(stages=((3.0, PROFILE_STEPS),))
    prof = profiled_window(lambda: window(qw, kbat, eom_blocks=blocks))
    log(f"# physics profile: {PROFILE_STEPS}-step window of the LM solve "
        f"{prof}")
    out["profile"] = prof
    return by_shape, worst_rel, worst_abs



@contextlib.contextmanager
def plain_solves_counted():
    """Count the calls of the plain banded solvers (scan, CR, and the
    banded Cholesky of the bordered solve's CPU path) made inside the
    block, into the yielded dict: none may run on the card's path."""
    from cheetah_pose_estimation_tpu_torch.ops import banded

    names = ("solve", "cr_solve", "cholesky")
    plain = {"scan": 0, "cr": 0, "cholesky": 0}
    saved = [getattr(banded, n) for n in names]

    def counted(name, fn):
        def run(*a, **k):
            plain[name] += 1
            return fn(*a, **k)
        return run

    for n, key, fn in zip(names, plain, saved):
        setattr(banded, n, counted(key, fn))
    try:
        yield plain
    finally:
        for n, fn in zip(names, saved):
            setattr(banded, n, fn)


# -- phase 9: the dataset CLI ------------------------------------------------

CLI_MODES = ("ground-truth", "default", "data-driven", "physics-based")
CLI_DIRS = {"ground-truth": "fte_kinematic", "default": "fte_kinematic_orig_{c}",
            "data-driven": "fte_kinematic_{c}",
            "physics-based": "fte_kinetic_{c}"}
TOL_PX = 1e-3         # rendered pixels: port (float64) vs JAX CLI (float32)
TOL_PX_SAME = 1e-9    # the port's float64 rendering on two hosts
TOL_OBJ = 1e-4        # a lower final objective: lower by more than this share


# How a rendered tree and the CLI's outputs are recorded, the same for both
# packages: tests/data/jax_cli_reference.py imports these three.

def digest(xy, lik, thresh=0.5):
    """Digest of one trial's DLC arrays: xy (F, C, L, 2), likelihood
    (F, C, L). The gate pattern is held exactly (md5 of the packed mask);
    the pixels through four projections on random weights whose absolute
    values sum to 1, so that two trees whose pixels differ by at most d
    give projections that differ by at most d."""
    import hashlib

    xy = np.nan_to_num(np.asarray(xy, np.float64)).ravel()
    lik = np.asarray(lik, np.float64)
    gate = lik > thresh
    proj = []
    for k in range(4):
        w = np.random.default_rng(1234 + k).normal(size=xy.size)
        proj.append(float(w @ xy / np.abs(w).sum()))
    return {"shape": list(np.shape(lik)),
            "gate_md5": hashlib.md5(np.packbits(gate).tobytes()).hexdigest(),
            "n_gated": int(gate.sum()), "lik_sum": float(lik.sum()),
            "px_proj": proj}


def describe(v):
    """Keys and shapes of a pickled artifact value."""
    if isinstance(v, dict):
        return {k: describe(x) for k, x in sorted(v.items())}
    if v is None or isinstance(v, (int, float, str)):
        return type(v).__name__ if v is not None else "None"
    return list(np.shape(v))


def artifacts(out_dir):
    """Layout of the CLI's artifacts under ``out_dir``, by relative path."""
    import csv
    import pickle
    from glob import glob

    out = {}
    for p in sorted(glob(os.path.join(out_dir, "**", "*"), recursive=True)):
        rel = os.path.relpath(p, out_dir)
        if os.path.isdir(p):
            continue
        name = os.path.basename(p)
        if name == "fte.pickle":
            with open(p, "rb") as f:
                out[rel] = describe(pickle.load(f))
        elif name.startswith("cam") and name.endswith("_fte.csv"):
            with open(p, encoding="utf-8") as f:
                rows = list(csv.reader(f))
            # the 2-level (bodyparts, coords) header, then one row a frame
            out[rel] = {"header": rows[:2], "rows": len(rows) - 2,
                        "frames": [rows[2][0], rows[-1][0]]}
        elif name.startswith("autogen-contact") and name.endswith(".json"):
            with open(p, encoding="utf-8") as f:
                out[rel] = sorted(json.load(f))
        elif name.startswith("data_synth") and name.endswith(".csv"):
            # the synthesized force-plate table's header (its rows follow
            # the detected stances)
            with open(p, encoding="utf-8") as f:
                out[rel] = {"header": next(csv.reader(f))}
        elif name == "dataset_results.csv":
            with open(p, encoding="utf-8") as f:
                rows = list(csv.reader(f))
            out[rel] = {"header": rows[:2],
                        "index": [r[0] for r in rows[2:]]}
    return out


def trial_artifacts(arts, paths):
    """The layout ``arts`` (``artifacts``) of a run cut to its trials
    ``paths``: their files, and ``dataset_results.csv`` with only their
    columns."""
    out = {k: v for k, v in arts.items()
           if any(k.startswith(p + os.sep) for p in paths)}
    for k, v in arts.items():
        if os.path.basename(k) == "dataset_results.csv":
            keep = [i for i, t in enumerate(v["header"][0])
                    if i == 0 or t in paths]
            out[k] = dict(v, header=[[row[i] for i in keep]
                                     for row in v["header"]])
    return out


def cli_kernel_check(dev, root, out):
    """The kernel against its plain version in float64 on the ground-truth
    mode's 6-camera normal systems at the multi-view initialisation and on
    the anchored polish's normal systems at the default mode's solutions
    (each trial's detected stance and its plane, ground, penetration and
    no-slip terms on), damped and Jacobi-scaled at lam = 1e-2."""
    import dataclasses
    import pickle

    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import batched as pb
    from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    rows = []
    for kind in ("ground-truth 6 cameras", "polish"):
        monocular = kind == "polish"
        groups = pb._groups(root, run_dataset.TEST_SET, None, monocular)
        for subject_name, ests in groups.items():
            subject = params.get_subject(subject_name)
            datas = [e.data for e in ests]
            cfg = kin.KinematicConfig()
            if monocular:
                qs, gz, stance = [], [], []
                for e in ests:
                    with open(os.path.join(out, e.data_path, CLI_DIRS[
                            "default"].format(c=e.scene.cam_idx),
                            "fte.pickle"), "rb") as f:
                        q = pickle.load(f)["q"]
                    ci = e.scene.cam_idx
                    g = e.params.ground_plane_height
                    _, stw, _ = depth_anchor.ray_depth_correction(
                        q, subject, e.scene.fps, g, e.scene.r_arr[ci],
                        e.scene.t_arr[ci])
                    qs.append(q)
                    gz.append(g)
                    stance.append(stw)
                data_list = [d._replace(ground_z=np.asarray(g),
                                        stance_w=s)
                             for d, g, s in zip(datas, gz, stance)]
                cfg = dataclasses.replace(cfg, **depth_anchor.POLISH_CFG)
            else:
                qs, data_list = [e.q0 for e in ests], datas
            batched, q = pbatch.pad_and_stack(
                data_list, qs, n_frames=pb._n_frames(datas), device=dev)
            fte = kin.KinematicFTE(cfg, subject)
            g, H = fte._normal(q, batched, 1.0)
            B = q.shape[0]
            Hs, rhs, _ = gn.scaled_system(g, H, torch.full((B,), 1e-2,
                                                           device=dev), 1e-8)
            d32, l32, r32 = (x.contiguous() for x in (Hs.diag, Hs.lower,
                                                      rhs))
            x = cuda_banded.solve(d32, l32, r32)
            torch.cuda.synchronize()
            ref = cuda_banded.solve_reference(d32.double(), l32.double(),
                                              r32.double())
            if not (torch.isfinite(x).all() and torch.isfinite(ref).all()):
                raise AssertionError(f"non-finite solve on the {kind} "
                                     "systems")
            abs_err = float((x.double() - ref).abs().max())
            row = {"systems": kind, "B": B, "N": q.shape[1],
                   "cameras": int(batched.meas.shape[2]),
                   "stance_frames": float(batched.stance_w.sum()),
                   "rel_err": abs_err / float(ref.abs().max()),
                   "max_abs_err": abs_err}
            log(f"# cli: kernel {row}")
            rows.append(row)
            if row["rel_err"] > TOL_REL:
                raise AssertionError(f"kernel rel err {row['rel_err']:.3e} > "
                                     f"{TOL_REL} on the {kind} systems")
    return rows


def cli_scores(root, odir, paths, cam):
    """Per mode, per trial: ``run_dataset.trial_scores`` of the mode's
    ``fte.pickle`` against the multi-view solve, MPJPE against the
    synthetic truth, and the final objective the mode saved."""
    import pickle

    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    out = {}
    for m in CLI_MODES:
        rows = []
        for p in paths:
            with open(os.path.join(odir, p, "fte_kinematic", "fte.pickle"),
                      "rb") as f:
                gt = pickle.load(f)
            with open(os.path.join(odir, p, CLI_DIRS[m].format(c=cam),
                                   "fte.pickle"), "rb") as f:
                d = pickle.load(f)
            with open(os.path.join(root, p, "synthetic_gt.pickle"),
                      "rb") as f:
                true = np.asarray(pickle.load(f)["positions"], np.float64)
            if not np.isfinite(d["q"]).all():
                raise AssertionError(f"non-finite {m} solution for {p}")
            s = run_dataset.trial_scores(gt, d)
            pos = np.asarray(d["positions"], np.float64)
            err = (pos - pos.mean(1, keepdims=True)) \
                - (true - true.mean(1, keepdims=True))
            s["mpjpe_vs_truth"] = float(np.linalg.norm(err, axis=2).mean()
                                        * 1e3)
            s["obj_cost"] = float(d["obj_cost"])
            rows.append(s)
        out[m] = rows
    return out


def cli_gap(port, jax, port_obj, jax_obj, comparable, unstable=None):
    """Agreement of one per-mode mean with the JAX run's, and the part of
    the gap no witness accounts for. A trial is witnessed when (a) the
    port's value is the lower one, its saved final objective is lower than
    the JAX run's by more than ``TOL_OBJ`` of it and the two objectives are
    of the same problem (``comparable``): the port's solve went further
    down the same objective; or (b) ``unstable``: the JAX reference itself
    does not reproduce its value on that trial (its runs on two renderings
    of the tree that differ by float32 round-off disagree by more than the
    bar). The unexplained gap is the mean's gap with JAX's value in place
    of the port's on each witnessed trial; the check holds the smaller of
    the two gaps to its bar."""
    port, jax = np.asarray(port), np.asarray(jax)
    further = (port < jax) & (np.asarray(port_obj) < np.asarray(jax_obj)
                              * (1.0 - TOL_OBJ)) & np.asarray(comparable)
    unstable = np.zeros(len(port), bool) if unstable is None \
        else np.asarray(unstable)
    witnessed = further | unstable
    scale = max(abs(float(jax.mean())), 1e-12)
    return {"port": float(port.mean()), "jax_f32": float(jax.mean()),
            "rel": float(port.mean() - jax.mean()) / scale,
            "witnessed": int(witnessed.sum()),
            "witnessed_objective": int(further.sum()),
            "witnessed_unstable": int(unstable.sum()),
            "rel_unexplained": float(np.where(witnessed, jax, port).mean()
                                     - jax.mean()) / scale}


def agree_means(m, rows, rm, paths, comparable, jax_obj, other_m, label,
                bad, tag="cli"):
    """Mode ``m``'s per-mode means (the port's per-trial ``rows``) against
    one recorded JAX run's (``rm``: per trial, its metrics), each within 2 %
    (CoM-velocity 5 %), both ways, as it is or once the witnessed trials are
    set aside (``cli_gap``: the port's objective lower than ``jax_obj`` on
    a ``comparable`` problem, or, given the JAX run on the other rendering
    ``other_m``, the reference does not reproduce itself there); the
    multi-view truth with no trial set aside. Means outside their bars are
    appended to ``bad``; the per-trial values are printed."""
    keys = (("mpjpe_vs_truth", TOL_MPJPE),) if m == "ground-truth" \
        else (("mpe", TOL_MPJPE), ("mpjpe", TOL_MPJPE),
              ("CoM vel rmse", TOL_COMVEL))
    a = {}
    for k, tol in keys:
        rk = "com_vel_rmse" if k == "CoM vel rmse" else k
        jx = np.array([rm[p][rk] for p in paths])
        unstable = None
        if other_m is not None and m != "ground-truth":
            jo = np.array([other_m[p][rk] for p in paths])
            unstable = np.abs(jx - jo) > tol * np.abs(jo)
        a[k] = dict(cli_gap(
            [s[k] for s in rows], jx, [s["obj_cost"] for s in rows], jax_obj,
            comparable if m != "ground-truth" else [False] * len(paths),
            unstable), tol=tol)
        if min(abs(a[k]["rel"]), abs(a[k]["rel_unexplained"])) > tol:
            bad.append((m, k, a[k]))
    log(f"# {tag} agree ({label}): {m}: " + ", ".join(
        f"{k} port {v['port']:.3f} jax_f32 {v['jax_f32']:.3f} (rel "
        f"{v['rel']:+.4f}; witnessed trials {v['witnessed']} (objective "
        f"{v['witnessed_objective']}, reference unstable "
        f"{v['witnessed_unstable']}), unexplained "
        f"{v['rel_unexplained']:+.4f}, bar ±{v['tol']})"
        for k, v in a.items()))
    for p, s, c, jo in zip(paths, rows, comparable, jax_obj):
        log(f"# {tag} agree ({label}): {m} {p} MPE port {s['mpe']:.2f} jax"
            f" {rm[p]['mpe']:.2f}, MPJPE port {s['mpjpe']:.2f} jax "
            f"{rm[p]['mpjpe']:.2f}, CoM-vel port {s['CoM vel rmse']:.4f}"
            f" jax {rm[p]['com_vel_rmse']:.4f}, objective port "
            f"{s['obj_cost']:.6g} jax {jo:.6g}"
            + ("" if c else " (different stance)"))
    return a


def cli_agree(modes, paths, run, label, other=None):
    """The port's CLI modes against one recorded JAX CLI run ``run`` (its
    ``modes`` and ``decisions``): each per-mode mean within 2 %
    (CoM-velocity 5 %) of the JAX run's, both ways, as it is or once the
    witnessed trials are set aside (``cli_gap``: the port's solve reached a
    lower objective of the same problem, or, given ``other``, the JAX run
    on the other rendering of the tree, the reference does not reproduce
    itself there); the discrete decisions printed beside the JAX run's.
    Returns the comparison, with the means outside their bars under
    ``bad``."""
    dec = run["decisions"]
    same_stance = [modes["physics-based"]["stance"].get(p)
                   == dec["stance"].get(p) for p in paths]
    agree, bad = {}, []
    for m in CLI_MODES:
        rm = run["modes"][m]
        agree[m] = agree_means(
            m, modes[m]["per_trial"], rm, paths,
            same_stance if m == "physics-based" else [True] * len(paths),
            [rm[p]["obj_cost"] for p in paths],
            None if other is None else other["modes"][m], label, bad)
    for k, m in (("prior_ok", "data-driven"), ("scan_shifts", "data-driven"),
                 ("polish_ray_shift", "default"),
                 ("polish_changed", "default"),
                 ("stance", "physics-based")):
        port = [modes[m][k].get(p) for p in paths]
        jax = [dec[k].get(p) for p in paths]
        same = port == jax
        agree[k] = {"same": same}
        if k == "stance":
            for p, sp, sj in zip(paths, port, jax):
                if sp != sj:
                    log(f"# cli agree ({label}): stance {p} differs: port "
                        f"frames {int(np.sum(sp))} jax {int(np.sum(sj))}")
            log(f"# cli agree ({label}): stance frames per trial port "
                f"{[int(np.sum(s)) for s in port]} jax "
                f"{[int(np.sum(s)) for s in jax]} "
                f"({'same' if same else 'different'})")
        else:
            log(f"# cli agree ({label}): {k} port {port} jax {jax} "
                f"({'same' if same else 'different'})")
    agree["bad"] = bad
    return agree


def phase_cli(dev, results, ref):
    """The dataset CLI on the synthetic test set: render the tree, run all
    four modes through ``run_dataset.main``, check the kernel on the
    6-camera and polish systems, hold the results against the JAX float32
    CLI run ``ref`` (``tests/data/jax_cli_f32.json``), and profile the
    6-camera solves. Returns (launches per shape of the CLI run, worst rel
    err, worst abs err, (the tree's root, the training table, the output
    directory))."""
    import tempfile

    from cheetah_pose_estimation_tpu_torch.data import io as dio
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import batched as pb
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.priors import dataset
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    out = {}
    work = tempfile.mkdtemp(prefix="cli_")
    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    dset = os.path.join(work, "priors", "dataset_full_pose.csv")
    paths = [os.path.join(d, c, t) for c, d, t in run_dataset.TEST_SET]

    # 1. the training tables and the tree, and the tree's digest
    t0 = time.perf_counter()
    dataset.save_pose_dataset(dset, bench_lib.procedural_pose_table(
        bench_lib.TRAIN_SEEDS))
    dataset.save_pose_dataset(
        os.path.join(os.path.dirname(dset), "validation_dataset.csv"),
        bench_lib.procedural_pose_table(bench_lib.VAL_SEEDS))
    run_dataset.main(["--materialize_synthetic", "--root_dir", root])
    out["render_s"] = time.perf_counter() - t0
    tree_ok = True
    for p in paths:
        xy, lik, _ = dio.load_dlc_points(os.path.join(root, p, "dlc"))
        dg = digest(xy, lik)
        gph = dio.load_metadata(os.path.join(root, p))["ground_plane_height"]
        r = ref["tree"][p]
        dpx = max(abs(a - b) for a, b in zip(dg["px_proj"], r["px_proj"]))
        same = (dg["gate_md5"] == r["gate_md5"]
                and dg["n_gated"] == r["n_gated"]
                and abs(dg["lik_sum"] - r["lik_sum"]) <= 1e-9
                and dpx <= TOL_PX
                and abs(gph - r["ground_plane_height"]) <= 1e-6)
        rp = ref["port_tree"]["tree"][p]
        dpp = max(abs(a - b) for a, b in zip(dg["px_proj"], rp["px_proj"]))
        same_input = (dg["gate_md5"] == rp["gate_md5"] and dpp <= TOL_PX_SAME
                      and abs(gph - rp["ground_plane_height"]) <= 1e-12)
        tree_ok &= same and same_input
        log(f"# cli: tree {p} {dg['shape']} gated {dg['n_gated']} md5 "
            f"{dg['gate_md5'][:8]} | jax md5 {r['gate_md5'][:8]}, |px proj "
            f"diff| {dpx:.2e}, ground {gph:.6f} vs "
            f"{r['ground_plane_height']:.6f}: "
            f"{'same' if same else 'DIFFERENT'} | the reference run's input"
            f": |px proj diff| {dpp:.2e}, "
            f"{'same' if same_input else 'DIFFERENT'}")
    log(f"# cli: tables and tree rendered in {out['render_s']:.2f} s (host)")
    if not tree_ok:
        raise AssertionError("the rendered tree differs from the JAX CLI's "
                             "or from the reference run's input")

    # 2. the main path: the four modes through the CLI's main, with the
    # plain banded solvers counted (none may run on the card path)
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    cuda_banded.reset_launches()
    report = {}
    t0 = time.perf_counter()
    with plain_solves_counted() as plain:
        run_dataset.main(["--run_monocular", "--batched", "--clean",
                          "--root_dir", root, "--out_dir_prefix", odir],
                         report=report)
        torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    out["plain_solves"] = plain
    log(f"# cli: run_dataset.main {out['cli_s']:.2f} s, kernel launches "
        f"{shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the CLI ran plain banded solves on the card: "
                             f"{plain}")
    prev, modes = {}, {}
    cam = dio.load_metadata(os.path.join(root, paths[0]))["monocular_cam"]
    per_mode = cli_scores(root, odir, paths, cam)
    for m in CLI_MODES:
        rep = report["modes"][m]
        snap = rep["launches"]
        launches = {k: v - prev.get(k, 0) for k, v in snap.items()
                    if v - prev.get(k, 0)}
        prev = snap
        n = len(rep["trials"])
        scores = per_mode[m]
        mo = {"trials": n, "wall_s": rep["wall_s"],
              "solve_s": rep["solve_s"], "s_per_trial": rep["wall_s"] / n,
              "lm_steps": int(sum(launches.values())),
              "launches_by_shape": shape_keys(launches), "per_trial": scores}
        for k in ("prior_ok", "scan_shifts", "polish_ray_shift",
                  "polish_changed", "stance"):
            if k in rep:        # per trial, in the subject groups' order
                mo[k] = dict(zip(rep["trials"], rep[k]))
        modes[m] = mo
        log(f"# cli: mode {m}: {n} trials, wall {rep['wall_s']:.2f} s "
            f"({mo['s_per_trial']:.4f} s/trial), solve {rep['solve_s']:.2f}"
            f" s, LM steps {mo['lm_steps']}, launches "
            f"{mo['launches_by_shape']}")
        if not launches:
            raise AssertionError(f"mode {m} did not launch the kernel")
        for p, s in zip(paths, scores):
            log(f"# cli: {m} {p} MPE {s['mpe']:.2f} mm MPJPE "
                f"{s['mpjpe']:.2f} mm CoM-vel {s['CoM vel rmse']:.4f} m/s "
                f"(vs truth: MPJPE {s['mpjpe_vs_truth']:.2f} mm) objective "
                f"{s['obj_cost']:.6g}")
    out["modes"] = modes

    # 3. the kernel on the new kinds of system
    out["kernel"] = cli_kernel_check(dev, root, odir)
    worst_rel = max(r["rel_err"] for r in out["kernel"])
    worst_abs = max(r["max_abs_err"] for r in out["kernel"])

    # 4. agreement with the JAX float32 CLI run on the same input (the
    # port's tree), decisions beside it, trials where the JAX runs on the
    # two renderings disagree set aside; the JAX run on its own tree is
    # printed beside
    agree = {"same_input": cli_agree(modes, paths, ref["port_tree"],
                                     "same input", other=ref),
             "jax_tree": cli_agree(modes, paths, ref, "JAX tree")}
    bad = agree["same_input"].pop("bad")
    agree["jax_tree"].pop("bad")
    # the artifacts the JAX run wrote, with the same keys and shapes
    mine = artifacts(odir)
    missing = [p for p in ref["artifacts"] if p not in mine]
    differ = [p for p, v in ref["artifacts"].items()
              if p in mine and mine[p] != v]
    agree["artifacts"] = {"jax": len(ref["artifacts"]), "port": len(mine),
                          "missing": missing, "differ": differ}
    log(f"# cli agree: artifacts: JAX {len(ref['artifacts'])}, port "
        f"{len(mine)}, missing {missing[:5]} ({len(missing)}), differ "
        f"{differ[:5]} ({len(differ)})")
    for p in differ[:3]:
        log(f"# cli agree: {p}: port {mine[p]} jax {ref['artifacts'][p]}")
    out["agree"] = agree
    if bad or missing or differ:
        raise AssertionError(f"the CLI disagrees with the JAX run: {bad}, "
                             f"missing {missing[:5]}, differ {differ[:5]}")

    # 5. a window of the ground-truth mode's 6-camera solves (one per
    # subject group) under torch.profiler
    solves = []
    for subject_name, ests in pb._groups(root, run_dataset.TEST_SET, None,
                                         monocular=False).items():
        datas = [e.data for e in ests]
        batched, q0b = pbatch.pad_and_stack(
            datas, [e.q0 for e in ests], n_frames=pb._n_frames(datas),
            device=dev)
        solves.append((kin.KinematicFTE(
            kin.KinematicConfig(), params.get_subject(subject_name))
            .make_solver(stages=((10.0, PROFILE_STEPS),)), q0b, batched))

    def run():
        for fn, q0b, batched in solves:
            fn(q0b, batched)

    gt = modes["ground-truth"]
    prof = profiled_window(run)
    log(f"# cli profile: {PROFILE_STEPS}-step windows of the ground-truth "
        f"solves (the CLI run's: {gt['solve_s']:.3f} s, {gt['lm_steps']} LM "
        f"steps) {prof}")
    out["profile_ground_truth"] = prof
    results["cli"] = out
    return by_shape, worst_rel, worst_abs, (root, dset, odir)


# -- phase 10: the dataset CLI's serial per-trial path ------------------------

def serial_modes(report, root, odir, paths, cam):
    """Per mode of a serial CLI run's ``report``: s/trial (the mean of the
    trials' walls), LM steps and kernel launches per shape, per-trial
    decisions and scores (``cli_scores``)."""
    scores = cli_scores(root, odir, paths, cam)
    modes = {}
    for m in CLI_MODES:
        rep = report["modes"][m]
        pt = [rep["per_trial"][p] for p in paths]
        launches = {}
        for t in pt:
            for k, v in t["launches"].items():
                launches[k] = launches.get(k, 0) + v
        modes[m] = {
            "trials": rep["trials"],
            "s_per_trial": float(np.mean([t["wall_s"] for t in pt])),
            "wall_s": [t["wall_s"] for t in pt],
            "lm_steps": int(sum(launches.values())),
            "launches_by_shape": shape_keys(launches),
            "decisions": {p: {k: v for k, v in t.items()
                              if k not in ("wall_s", "launches")}
                          for p, t in zip(paths, pt)},
            "per_trial": scores[m]}
    return modes


def phase_serial(dev, results, ref, root, dset):
    """The dataset CLI's serial per-trial path (``run_dataset.main
    --run_monocular --clean --trials 2``, no ``--batched``) on phase 9's
    tree: every trial alone at its own length, mode after mode, the
    physics-based mode in up to three attempts. Held against the JAX
    package's serial float32 run on the same input
    (``tests/data/jax_serial_f32.json``, ``port_tree``): the means as phase
    9 holds them (``agree_means``, on the saved objectives), each trial's
    accepted physics attempt equal to the JAX run's,
    every JAX artifact of those trials present with its keys and shapes
    (``trial_artifacts``). Then the batched
    path on the same trials (s/trial), and one trial's ground-truth solve
    (one lane) and default solve (the 3-lane multistart, the 1-lane polish),
    each kinematic solve cut to ``PROFILE_STEPS`` steps, under
    torch.profiler. Returns the launches per shape."""
    import tempfile

    from cheetah_pose_estimation_tpu_torch.data import io as dio
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    out = {}
    odir = tempfile.mkdtemp(prefix="serial_")
    paths = ref["trials"][:SERIAL_TRIALS]
    cam = dio.load_metadata(os.path.join(root, paths[0]))["monocular_cam"]
    for p in paths:
        xy, lik, _ = dio.load_dlc_points(os.path.join(root, p, "dlc"))
        dg, rp = digest(xy, lik), ref["port_tree"]["tree"][p]
        dpp = max(abs(a - b) for a, b in zip(dg["px_proj"], rp["px_proj"]))
        if not (dg["gate_md5"] == rp["gate_md5"] and dpp <= TOL_PX_SAME):
            raise AssertionError(f"the tree's {p} differs from the serial "
                                 f"reference run's input ({dpp:.2e} px)")

    # the main path, with the plain banded solvers counted (none may run)
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    cuda_banded.reset_launches()
    report = {}
    t0 = time.perf_counter()
    with plain_solves_counted() as plain:
        run_dataset.main(["--run_monocular", "--clean", "--trials",
                          str(len(paths)), "--root_dir", root,
                          "--out_dir_prefix", odir], report=report)
        torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    out["plain_solves"] = plain
    log(f"# serial: run_dataset.main {out['cli_s']:.2f} s, kernel launches "
        f"{shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the serial CLI ran plain banded solves on the "
                             f"card: {plain}")
    untimed = sorted(set(by_shape) - set(SERIAL_SHAPES))
    if untimed:
        raise AssertionError(f"shapes not timed in phase 3: {untimed}")
    modes = serial_modes(report, root, odir, paths, cam)
    for m in CLI_MODES:
        mo = modes[m]
        log(f"# serial: mode {m}: {mo['s_per_trial']:.4f} s/trial (walls "
            f"{[round(w, 3) for w in mo['wall_s']]} s), LM steps "
            f"{mo['lm_steps']}, launches {mo['launches_by_shape']}")
        if not mo["lm_steps"]:
            raise AssertionError(f"mode {m} did not launch the kernel")
        for p, sc in zip(paths, mo["per_trial"]):
            dec = dict(mo["decisions"][p])
            if "stance" in dec:
                dec["stance"] = f"{int(np.sum(dec['stance']))} frames"
            log(f"# serial: {m} {p} MPE {sc['mpe']:.2f} mm MPJPE "
                f"{sc['mpjpe']:.2f} mm CoM-vel {sc['CoM vel rmse']:.4f} m/s "
                f"(vs truth: MPJPE {sc['mpjpe_vs_truth']:.2f} mm) objective "
                f"{sc['obj_cost']:.6g} decisions {dec}")
    out["modes"] = modes

    # agreement with the JAX serial run on the same input; its run on its
    # own tree is printed beside, and names the trials where the reference
    # does not reproduce itself
    agree, bad = {}, []
    run, own = ref["port_tree"], ref
    for label, r, other in (("same input", run, own),
                            ("JAX tree", own, None)):
        dec = r["decisions"]
        stance_same = [modes["physics-based"]["decisions"][p].get("stance")
                       == dec["physics-based"][p].get("stance")
                       for p in paths]
        a = {}
        for m in CLI_MODES:
            jax_obj = [r["modes"][m][p]["obj_cost"] for p in paths]
            a[m] = agree_means(
                m, modes[m]["per_trial"], r["modes"][m], paths,
                stance_same if m == "physics-based" else [True] * len(paths),
                jax_obj, None if other is None else other["modes"][m], label,
                bad if label == "same input" else [], tag="serial")
        for m in ("default", "data-driven", "physics-based") \
                if label == "same input" else ():
            for p in paths:
                mine = modes[m]["decisions"][p]
                theirs = {k: v for k, v in dec[m][p].items()
                          if k not in ("ok", "attempts")}
                for k, v in sorted(theirs.items()):
                    if k == "stance":
                        same = "same" if mine.get(k) == v else "different"
                        log(f"# serial agree ({label}): {m} {p} stance "
                            f"frames port {int(np.sum(mine.get(k, 0)))} jax "
                            f"{int(np.sum(v))} ({same})")
                    else:
                        log(f"# serial agree ({label}): {m} {p} {k} port "
                            f"{mine.get(k)} jax {v}")
        attempts = {p: (modes["physics-based"]["decisions"][p]["attempt"],
                        dec["physics-based"][p].get("attempt"))
                    for p in paths}
        a["physics_attempt"] = attempts
        log(f"# serial agree ({label}): physics attempt (port, jax) "
            f"{attempts}")
        if label == "same input" and any(x != y for x, y in
                                         attempts.values()):
            bad.append(("physics-based", "attempt", attempts))
        agree[label] = a
    mine, theirs = artifacts(odir), trial_artifacts(ref["artifacts"], paths)
    missing = [p for p in theirs if p not in mine]
    differ = [p for p, v in theirs.items() if p in mine and mine[p] != v]
    agree["artifacts"] = {"jax": len(theirs), "port": len(mine),
                          "missing": missing, "differ": differ}
    log(f"# serial agree: artifacts: JAX {len(theirs)}, port "
        f"{len(mine)}, missing {missing[:5]} ({len(missing)}), differ "
        f"{differ[:5]} ({len(differ)})")
    for p in differ[:3]:
        log(f"# serial agree: {p}: port {mine[p]} jax {theirs[p]}")
    out["agree"] = agree
    if bad or missing or differ:
        raise AssertionError(f"the serial CLI disagrees with the JAX run: "
                             f"{bad}, missing {missing[:5]}, differ "
                             f"{differ[:5]}")

    # the batched path on the same trials (two subject groups), for its
    # s/trial beside the serial path's; after the serial path's launches
    # were read
    brep = {}
    run_dataset.main(["--run_monocular", "--batched", "--clean", "--trials",
                      str(len(paths)), "--root_dir", root, "--out_dir_prefix",
                      tempfile.mkdtemp(prefix="serial_batched_")],
                     report=brep)
    out["batched_s_per_trial"] = {
        m: brep["modes"][m]["wall_s"] / len(paths) for m in CLI_MODES}
    log("# serial: s/trial serial vs batched on the same trials: " + ", ".join(
        f"{m} {modes[m]['s_per_trial']:.4f} vs "
        f"{out['batched_s_per_trial'][m]:.4f}" for m in CLI_MODES))

    # the card's idle share in a 1-lane solve (the multi-view ground truth)
    # and in the default mode (the 3-lane multistart and the 1-lane
    # polish), one trial each, every kinematic solve cut to a
    # PROFILE_STEPS-step window, under torch.profiler (``profiled_window``)
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    p, (cheetah, date, trial) = paths[0], run_dataset.TEST_SET[0]
    full = kin.KinematicFTE.make_solver.__defaults__
    for m, kw in (("ground-truth", {}), ("default", dict(
            monocular_enable=True))):
        def solve():
            est = estimator.init_trajectory(root, p, cheetah, **kw)
            estimator.estimate_kinematics(est, save=False)
        kin.KinematicFTE.make_solver.__defaults__ = (
            ((10.0, PROFILE_STEPS),),) + full[1:]
        try:
            prof = profiled_window(solve, warm=False)
        finally:
            kin.KinematicFTE.make_solver.__defaults__ = full
        prof["launches_by_shape"] = shape_keys(cuda_banded.launches_by_shape)
        log(f"# serial profile: {m} {p}, {PROFILE_STEPS}-step windows (the "
            f"CLI run's whole solve: {modes[m]['wall_s'][0]:.3f} s) {prof}")
        out[f"profile_{m}"] = prof
    results["serial"] = out
    return by_shape


# -- phase 11: the force-plate pipeline --------------------------------------

# phase 11 runs the first force-plate trial (of 5): 92 % of its wall is
# the two 180-step kinetic solves of each trial, and the smoke's limit
# leaves room for one next to phases 12-14
KINETIC_TRIALS = 1
KINETIC_STAGE_DIRS = (("kinematic", "fte_kinematic"),
                      ("kinetic", "fte_kinetic"), ("grf", "fte_grf"))
TOL_STATIC_GRF = 1e-3    # body weights, frame by frame, same trajectory
# JAX's own sanity bars on one force-plate trial's MPE against the truth
# (tests/test_kinetic_dataset.py), printed beside the port's
JAX_MPE_BARS = {"kinematic": 20.0, "kinetic": 40.0}
PROFILE_STEPS = 20       # the profiled window of an LM solve (phases 6-11)


# How a force-plate run is scored, the same for both packages:
# tests/data/jax_kinetic_reference.py imports these.

def truth_com_vel(root, path, fps=200.0):
    """The synthetic truth's CoM velocity (N - 1, 3) of trial ``path``
    (the port's skeleton in float64 on the CPU)."""
    import pickle

    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.models import skeleton as sk

    with open(os.path.join(root, path, "synthetic_gt.pickle"), "rb") as f:
        q = np.asarray(pickle.load(f)["q"], np.float64)
    subject = params.get_subject(path.split(os.sep)[-2])
    com = sk.com_position(torch.as_tensor(q), subject).numpy()
    return (com[1:] - com[:-1]) * fps


def kinetic_scores(root, odir, path, com_vel_true):
    """Per stage of the force-plate pipeline, trial ``path``'s saved
    solution against the synthetic truth: MPJPE (frame-centred) and MPE in
    mm, CoM-velocity RMSE in m/s (``com_vel_true``: ``truth_com_vel``), the
    saved objective, RMS torque (body-weight units), the mean and largest
    |q| entry."""
    import pickle

    with open(os.path.join(root, path, "synthetic_gt.pickle"), "rb") as f:
        true = np.asarray(pickle.load(f)["positions"], np.float64)
    out = {}
    for stage, sub in KINETIC_STAGE_DIRS:
        p = os.path.join(odir, path, sub, "fte.pickle")
        if not os.path.exists(p):
            continue
        with open(p, "rb") as f:
            d = pickle.load(f)
        pos = np.asarray(d["positions"], np.float64)
        err = (pos - pos.mean(1, keepdims=True)) \
            - (true - true.mean(1, keepdims=True))
        dv = np.asarray(d["com_vel"], np.float64) - com_vel_true
        tau = np.concatenate([np.asarray(v, np.float64).reshape(len(pos), -1)
                              for _, v in sorted(d["tau"].items())], 1) \
            if d["tau"] else np.zeros((len(pos), 0))
        q = np.asarray(d["q"], np.float64)
        out[stage] = {
            "mpjpe": float(np.linalg.norm(err, axis=2).mean() * 1e3),
            "mpe": float(np.linalg.norm(pos - true, axis=2).mean() * 1e3),
            "com_vel_rmse": float(np.sqrt(np.mean(dv ** 2))),
            "obj_cost": float(d["obj_cost"]),
            "rms_torque": float(np.sqrt(np.mean(tau ** 2)))
            if tau.size else 0.0,
            "q_mean_abs": float(np.abs(q).mean()),
            "q_max_abs": float(np.abs(q).max())}
    return out


def grf_summary(grf_z, grf_xy, stance):
    """Peak GRFz, the GRFz sum over the stance frames (body weights), and
    the friction-polygon check (the port's ``results.check_grf``) of one
    solution's GRFs."""
    from cheetah_pose_estimation_tpu_torch.pipeline import results

    gz = np.asarray(grf_z, np.float64)
    return {"peak_grf_z": float(gz.max()) if gz.size else 0.0,
            "grf_z_stance_sum": float((gz * np.asarray(stance)).sum()),
            "check_grf_invalid": results.check_grf(grf_xy)["n_invalid"]}


def kinetic_gate(port, jax_f64, jax_f32, tol):
    """Agreement of one per-stage mean of the port's float32 run with the
    JAX float64 run on the same input: within ``tol`` of it, either way.
    Every trial is in the mean. The JAX float32 run on the same input is
    reported beside it and widens nothing."""
    rel64 = (port - jax_f64) / jax_f64
    return {"port": port, "jax_f64": jax_f64, "jax_f32": jax_f32,
            "rel_f64": rel64, "rel_f32": (port - jax_f32) / jax_f32,
            "jax_f32_vs_f64": (jax_f32 - jax_f64) / jax_f64,
            "ok": abs(rel64) <= tol, "tol": tol}


def kinetic_kernel_check(dev, root, odir, paths):
    """The kernel against its plain version in float64 on each trial's
    4-camera pinhole normal systems at its saved kinematic solution and on
    its torque-anchored kinetic normal systems at the GRF re-estimation's
    warm start (``estimator.grf_problem``), damped at lam = 1e-2 and
    scaled as ``gn.scaled_system`` does. Returns the rows."""
    import pickle

    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    lam = torch.full((1,), 1e-2, device=dev)
    rows = []
    for p in paths:
        est = estimator.init_trajectory(root, p, p.split(os.sep)[-2],
                                        kinetic_dataset=True)
        with open(os.path.join(odir, p, "fte_kinematic", "fte.pickle"),
                  "rb") as f:
            q = pickle.load(f)["q"]
        batched, qb = pbatch.pad_and_stack([est.data], [q], device=dev)
        fte = kin.KinematicFTE(kin.KinematicConfig(
            fisheye=False, kinetic_dataset=True,
            cam_multipliers=(1.0, 1.0, 0.6, 0.6)), est.subject)
        g, H = fte._normal(qb, batched, 1.0)
        systems = [("pinhole 4 cameras", gn.scaled_system(g, H, lam, 1e-8))]
        kfte, kd, q_warm, _ = estimator.grf_problem(est, odir)
        kbat, qw = pbatch.pad_and_stack_kinetic([kd], [q_warm], device=dev)
        g, H = kfte._normal(qw, kbat, 1.0,
                            eom_blocks=kfte.eom_curvature_blocks(qw, kbat))
        b = kbat.base
        floor = torch.clamp(torch.diagonal(kin.acc_banded(
            b.h, b.acc_weight, b.frame_valid).diag, dim1=-2, dim2=-1),
            min=1e-8)
        systems.append(("torque-anchored kinetic",
                        gn.scaled_system(g, H, lam, floor)))
        for kind, (Hs, rhs, _) in systems:
            d32, l32, r32 = (x.contiguous() for x in (Hs.diag, Hs.lower,
                                                      rhs))
            x = cuda_banded.solve(d32, l32, r32)
            torch.cuda.synchronize()
            ref = cuda_banded.solve_reference(d32.double(), l32.double(),
                                              r32.double())
            abs_err = float((x.double() - ref).abs().max())
            row = {"systems": kind, "trial": p, "B": 1, "N": d32.shape[1],
                   "rel_err": abs_err / float(ref.abs().max()),
                   "max_abs_err": abs_err}
            log(f"# kinetic: kernel {row}")
            if not (torch.isfinite(x).all() and torch.isfinite(ref).all()
                    and row["rel_err"] <= TOL_REL):
                raise AssertionError(f"kernel on the {kind} systems: {row}")
            rows.append(row)
    return rows


def static_grf_same_input(dev, root, ref, paths):
    """The port's static GRF solver on the card in float64, on the JAX
    float64 run's saved kinematic trajectories of the trials ``paths`` with
    the JAX run's stances (pruned, and the contact files' own), against the
    JAX run's static GRFs: the largest difference per trial in body
    weights."""
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.solver import static_grf

    out = {}
    for p in paths:
        q = ref["kinematic_q"][p]
        est = estimator.init_trajectory(root, p, p.split(os.sep)[-2],
                                        kinetic_dataset=True)
        est.q = np.asarray(q, np.float64)
        T = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=dev)
        r = ref["static_grf"][p]
        diff = {}
        for sfx in ("", "_contacts"):
            gz, gxy = static_grf.estimate_static_grf(
                T(est.q), *(T(a) for a in est.derivatives()),
                T(r["stance" + sfx]), est.subject)
            diff["stance" + sfx] = max(
                float(np.abs(gz.cpu().numpy() - r["grf_z" + sfx]).max()),
                float(np.abs(gxy.cpu().numpy() - r["grf_xy" + sfx]).max()))
            diff["grf_z_sum" + sfx] = float(gz.sum())
        out[p] = diff
    return out


def phase_kinetic(dev, results, ref):
    """The force-plate pipeline (``run_dataset.main --run_kinetic --clean``)
    on the synthetic kinetic test set: render the tree and hold its digest
    against the JAX trees' (``tests/data/jax_kinetic_f32.json``), run the
    CLI (each stage of each trial launching the kernel at 1x50), score
    every stage against the truth, solve the static GRFs, check the kernel
    on the pinhole and torque-anchored kinetic systems, hold the results
    against the JAX float64 run on the same input (per stage mean MPJPE
    within 2 % and mean CoM-velocity within 5 %: ``kinetic_gate``; the
    same pruned stances, the static GRFs within 1e-3 body weights on the
    same trajectories, every JAX artifact present with its keys and
    shapes, nothing set aside), print the JAX float32 runs beside it, and
    profile a window of one trial's 1-lane kinetic solve. Returns (the
    launches per shape of the CLI run, worst rel err, worst abs err)."""
    import tempfile

    from cheetah_pose_estimation_tpu_torch.data import io as dio
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    out = {}
    work = tempfile.mkdtemp(prefix="kinetic_")
    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    paths = ref["trials"][:KINETIC_TRIALS]

    # 1. the tree (its first KINETIC_TRIALS trials), held against the JAX
    # rendering and the reference's input
    t0 = time.perf_counter()
    kset = run_dataset.KINETIC_SET
    run_dataset.KINETIC_SET = kset[:KINETIC_TRIALS]
    try:
        made = run_dataset.materialize_synthetic_kinetic_testset(root)
    finally:
        run_dataset.KINETIC_SET = kset
    out["render_s"] = time.perf_counter() - t0
    if made != paths:
        raise AssertionError(f"rendered {made}, the reference has {paths}")
    tree_ok = True
    for p in paths:
        xy, lik, _ = dio.load_dlc_points(os.path.join(root, p, "dlc"))
        dg = digest(xy, lik)
        gph = dio.load_metadata(os.path.join(root, p))["ground_plane_height"]
        checks = []
        for r, tol, tol_g in ((ref["tree"][p], TOL_PX, 1e-6),
                              (ref["port_tree"][p], TOL_PX_SAME, 1e-12)):
            dpx = max(abs(a - b) for a, b in zip(dg["px_proj"],
                                                 r["px_proj"]))
            checks.append((dpx, dg["gate_md5"] == r["gate_md5"]
                           and dg["n_gated"] == r["n_gated"] and dpx <= tol
                           and abs(gph - r["ground_plane_height"]) <= tol_g))
        tree_ok &= all(ok for _, ok in checks)
        log(f"# kinetic: tree {p} {dg['shape']} gated {dg['n_gated']} md5 "
            f"{dg['gate_md5'][:8]}: JAX tree |px proj diff| "
            f"{checks[0][0]:.2e} ({'same' if checks[0][1] else 'DIFFERENT'})"
            f", the reference run's input {checks[1][0]:.2e} "
            f"({'same' if checks[1][1] else 'DIFFERENT'})")
    log(f"# kinetic: tree rendered in {out['render_s']:.2f} s (host)")
    if not tree_ok:
        raise AssertionError("the kinetic tree differs from the JAX tree or "
                             "from the reference run's input")

    # 2. the main path: the three stages of every trial through the CLI
    cuda_banded.reset_launches()
    report = {}
    t0 = time.perf_counter()
    with plain_solves_counted() as plain:
        run_dataset.main(["--run_kinetic", "--clean", "--root_dir", root,
                          "--out_dir_prefix", odir], report=report)
        torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    out["plain_solves"] = plain
    log(f"# kinetic: run_dataset.main {out['cli_s']:.2f} s, kernel launches "
        f"{shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the kinetic CLI ran plain banded solves on "
                             f"the card: {plain}")
    untimed = sorted(set(by_shape) - set(KINETIC_SHAPES))
    if untimed:
        raise AssertionError(f"shapes not timed in phase 3: {untimed}")
    scores = {p: kinetic_scores(root, odir, p, truth_com_vel(root, p))
              for p in paths}
    stages = {}
    for stage, _ in KINETIC_STAGE_DIRS:
        rep = report["kinetic"][stage]
        if rep["trials"] != paths:
            raise AssertionError(f"stage {stage} ran {rep['trials']}")
        pt = [rep["per_trial"][p] for p in paths]
        launches = {}
        for t in pt:
            if not (t["ok"] and sum(t["launches"].values())):
                raise AssertionError(f"stage {stage} failed or did not "
                                     f"launch the kernel: {t}")
            for k, v in t["launches"].items():
                launches[k] = launches.get(k, 0) + v
        rows = []
        for p, t in zip(paths, pt):
            row = dict(scores[p][stage], wall_s=t["wall_s"],
                       lm_steps=int(sum(t["launches"].values())))
            if "stance" in t:
                row.update(grf_summary(t["grf_z"], t["grf_xy"],
                                       t["stance"]), stance=t["stance"])
            rows.append(row)
        stages[stage] = {"s_per_trial": float(np.mean([t["wall_s"]
                                                        for t in pt])),
                         "wall_s": [t["wall_s"] for t in pt],
                         "lm_steps": int(sum(launches.values())),
                         "launches_by_shape": shape_keys(launches),
                         "per_trial": rows}
        log(f"# kinetic: stage {stage}: {stages[stage]['s_per_trial']:.4f} "
            f"s/trial (walls {[round(w, 3) for w in stages[stage]['wall_s']]}"
            f" s), LM steps {stages[stage]['lm_steps']}, launches "
            f"{stages[stage]['launches_by_shape']}")
        for p, r in zip(paths, rows):
            extra = "" if "stance" not in r else (
                f", stance frames {int(np.sum(r['stance']))}, RMS torque "
                f"{r['rms_torque']:.4f}, peak GRFz {r['peak_grf_z']:.4f} BW, "
                f"check_grf invalid pairs {r['check_grf_invalid']}")
            log(f"# kinetic: {stage} {p} MPJPE {r['mpjpe']:.2f} mm MPE "
                f"{r['mpe']:.2f} mm CoM-vel {r['com_vel_rmse']:.4f} m/s "
                f"objective {r['obj_cost']:.6g}, LM steps {r['lm_steps']}"
                + extra)
    out["stages"] = stages

    # 3. the static GRFs: the port's pipeline on its own solution (float32)
    # and the port's solver on the JAX float64 run's trajectories (float64)
    static = {}
    for p in paths:
        est = estimator.init_trajectory(root, p, p.split(os.sep)[-2],
                                        kinetic_dataset=True,
                                        kinematic_model=False)
        gz, _ = estimator.estimate_static_grf(est, out_dir_prefix=odir)
        static[p] = {"grf_z_sum": float(gz.sum())}
    same = static_grf_same_input(dev, root, ref["f64"], paths)
    for p in paths:
        static[p]["same_input"] = same[p]
        log(f"# kinetic: static GRF {p}: GRFz over the stance frames "
            f"{static[p]['grf_z_sum']:.6f} BW (JAX f64 on its own solution "
            f"{float(np.sum(ref['f64']['static_grf'][p]['grf_z'])):.6f}); "
            f"on the JAX f64 trajectory: {same[p]}")
    out["static_grf"] = static

    # 4. the kernel on the new kinds of system (one trial: every trial's
    # systems have the same shape and structure)
    out["kernel"] = kinetic_kernel_check(dev, root, odir, paths[:1])
    worst_rel = max(r["rel_err"] for r in out["kernel"])
    worst_abs = max(r["max_abs_err"] for r in out["kernel"])

    # 5. the analysis' plots
    plots = {p: report["kinetic_analysis"][p]["plots"] for p in paths}
    out["plots"] = plots
    written = [x for v in plots.values() for x in v["written"]]
    skipped = [x for v in plots.values() for x in v["skipped"]]
    log(f"# kinetic: plots written {len(written)}, skipped {len(skipped)} "
        f"{[os.path.basename(x) for x in skipped][:2]}")

    # 6. agreement with the JAX float64 run on the same input; the JAX
    # float32 runs beside it
    bad, agree = [], {}
    for stage, _ in KINETIC_STAGE_DIRS:
        mine = stages[stage]["per_trial"]
        a = {}
        for key, tol in (("mpjpe", TOL_MPJPE), ("com_vel_rmse", TOL_COMVEL)):
            port = float(np.mean([r[key] for r in mine]))
            vals = {run: float(np.mean([ref[run]["stages"][stage][p][key]
                                        for p in paths]))
                    for run in ("f64", "f32", "f32_own") if run in ref}
            a[key] = dict(kinetic_gate(port, vals["f64"], vals["f32"], tol),
                          jax_f32_own_tree=vals.get("f32_own"))
            if not a[key]["ok"]:
                bad.append((stage, key, a[key]))
            log(f"# kinetic agree: {stage} mean {key} port {port:.4f} jax_f64"
                f" {vals['f64']:.4f} (rel {a[key]['rel_f64']:+.4f}, bar "
                f"±{tol}: {'ok' if a[key]['ok'] else 'FAILED'}); printed "
                f"only: jax_f32 {vals['f32']:.4f} (jax_f32 vs f64 "
                f"{a[key]['jax_f32_vs_f64']:+.4f}, port vs jax_f32 "
                f"{a[key]['rel_f32']:+.4f}), jax_f32 on its own tree "
                f"{vals.get('f32_own', 'not recorded')}")
        if stage != "kinematic":
            same_st = [r["stance"] == ref["f64"]["stages"][stage][p]["stance"]
                       for p, r in zip(paths, mine)]
            a["stance_same"] = same_st
            theirs = [int(np.sum(ref["f64"]["stages"][stage][p]["stance"]))
                      for p in paths]
            log(f"# kinetic agree: {stage} stance frames per trial port "
                f"{[int(np.sum(r['stance'])) for r in mine]} jax_f64 "
                f"{theirs} ({'same' if all(same_st) else 'DIFFERENT'})")
            if not all(same_st):
                bad.append((stage, "stance", same_st))
        for p, r in zip(paths, mine):
            j = ref["f64"]["stages"][stage][p]
            log(f"# kinetic agree: {stage} {p} MPJPE port {r['mpjpe']:.2f} "
                f"jax {j['mpjpe']:.2f}, CoM-vel port {r['com_vel_rmse']:.4f}"
                f" jax {j['com_vel_rmse']:.4f}, objective port "
                f"{r['obj_cost']:.6g} jax {j['obj_cost']:.6g}")
        if stage in JAX_MPE_BARS:
            jax_mpe = [round(ref["f64"]["stages"][stage][p]["mpe"], 2)
                       for p in paths]
            log(f"# kinetic: JAX's own bar for the {stage} stage, MPE < "
                f"{JAX_MPE_BARS[stage]} mm (tests/test_kinetic_dataset.py, "
                f"printed only): port "
                f"{[round(r['mpe'], 2) for r in mine]}, jax_f64 {jax_mpe}")
        agree[stage] = a
    worst_static = max(v for d in same.values() for k, v in d.items()
                       if k.startswith("stance"))
    agree["static_grf_max_abs_bw"] = worst_static
    if worst_static > TOL_STATIC_GRF:
        bad.append(("static_grf", worst_static))
    mine = artifacts(odir)
    theirs = {k: v for k, v in ref["f64"]["artifacts"].items()
              if any(k.startswith(p + os.sep) for p in paths)}
    missing = [p for p in theirs if p not in mine]
    differ = [p for p, v in theirs.items() if p in mine and mine[p] != v]
    agree["artifacts"] = {"jax": len(theirs), "port": len(mine),
                          "missing": missing, "differ": differ}
    log(f"# kinetic agree: static GRF on the same trajectories, largest "
        f"|port - jax| {worst_static:.3e} BW (bar {TOL_STATIC_GRF}); "
        f"artifacts: JAX {len(theirs)}, port {len(mine)}, missing "
        f"{missing[:5]} ({len(missing)}), differ {differ[:5]} "
        f"({len(differ)})")
    for p in differ[:3]:
        log(f"# kinetic agree: {p}: port {mine[p]} jax {theirs[p]}")
    out["agree"] = agree
    if bad or missing or differ:
        raise AssertionError(f"the kinetic CLI disagrees with the JAX run: "
                             f"{bad}, missing {missing[:5]}, differ "
                             f"{differ[:5]}")

    # 7. a 20-step window of one trial's 1-lane kinetic solve (the GRF
    # re-estimation's, first annealing stage) under torch.profiler,
    # against an unprofiled run of the same window
    p = paths[0]
    est = estimator.init_trajectory(root, p, p.split(os.sep)[-2],
                                    kinetic_dataset=True,
                                    kinematic_model=False)
    kfte, kd, q_warm, _ = estimator.grf_problem(est, odir)
    kbat, qw = pbatch.pad_and_stack_kinetic([kd], [q_warm], device=dev)
    window = kfte.make_solver(stages=((3.0, PROFILE_STEPS),))
    # the CLI run above warmed this solver up
    prof = profiled_window(lambda: window(qw, kbat), warm=False)
    log(f"# kinetic profile: GRF re-estimation {p}, {PROFILE_STEPS}-step "
        f"window {prof}")
    out["profile_kinetic"] = prof
    out["tree"] = {"out": odir, "trials": paths}
    results["kinetic"] = out
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


# -- phases 12 and 13: the AcinoSet and analysis flags ----------------------

ACINOSET_TRIALS = 4       # jules flick2, flick1 (with PPMs), phantom run, run1_2
# of those, the trials phase 12 solves (one flick with PPMs, one run): the
# smoke's limit leaves room for two next to phase 14
ACINOSET_RUN = (0, 2)
ACINOSET_MODES = ("ground-truth", "default", "data-driven")
TOL_ANALYSIS = 0.01       # distance and view angle against JAX's, relative
LINESCAN_PROFILE_STEPS = 10   # the profiled window of the widest line-scan


# How phase 12's tree and results are recorded, the same for both packages:
# tests/data/jax_acinoset_reference.py imports these three.

def render_acinoset_tree(rd, root, n_trials=ACINOSET_TRIALS):
    """The first ``n_trials`` trials of the synthetic test set, rendered
    into ``root`` by ``rd.materialize_synthetic_testset`` (``rd``: either
    package's ``run_dataset``) exactly as it renders them, the flick trials
    with their pairwise pseudo-measurements (``write_trial_dir(
    write_ppm=True)``). Returns the trials' paths."""
    write, test_set = rd.syn.write_trial_dir, rd.TEST_SET

    def write_flick_ppm(trial, root_dir, data_path, **kw):
        return write(trial, root_dir, data_path,
                     write_ppm="flick" in data_path, **kw)

    rd.syn.write_trial_dir = write_flick_ppm
    rd.TEST_SET = test_set[:n_trials]
    try:
        return rd.materialize_synthetic_testset(root)
    finally:
        rd.syn.write_trial_dir, rd.TEST_SET = write, test_set


def ppm_digest(trial_dir):
    """Per camera, ``digest`` of a trial's pairwise pickles
    (``dlc_pw/cam*.pickle``): the part poses and offsets as the pixels, the
    part likelihoods as the likelihoods; {} without the folder."""
    import pickle
    from glob import glob

    out = {}
    for p in sorted(glob(os.path.join(trial_dir, "dlc_pw", "*.pickle"))):
        with open(p, "rb") as f:
            frames = pickle.load(f)
        flat = np.stack([np.asarray(fr["pose"]) for fr in frames])
        pws = np.stack([np.asarray(fr["pws"]) for fr in frames])
        out[os.path.basename(p)] = digest(
            np.concatenate([flat[:, 0::3].ravel(), flat[:, 1::3].ravel(),
                            pws.ravel()]), flat[:, 2::3])
    return out


def acinoset_scores(root, odir, paths):
    """Per mode of ``ACINOSET_MODES``, per trial with a saved solution:
    MPJPE and MPE (mm) against the synthetic truth
    (``synthetic_gt.pickle``), the saved objective, and whether q is
    finite."""
    import pickle

    out = {}
    for m in ACINOSET_MODES:
        for p in paths:
            with open(os.path.join(root, p, "metadata.json"),
                      encoding="utf-8") as fh:
                cam = json.load(fh)["monocular_cam"]
            f = os.path.join(odir, p, CLI_DIRS[m].format(c=cam),
                             "fte.pickle")
            if not os.path.exists(f):
                continue
            with open(f, "rb") as fh:
                d = pickle.load(fh)
            with open(os.path.join(root, p, "synthetic_gt.pickle"),
                      "rb") as fh:
                true = np.asarray(pickle.load(fh)["positions"], np.float64)
            pos = np.asarray(d["positions"], np.float64)[:len(true)]
            cen = lambda a: a - a.mean(1, keepdims=True)
            out.setdefault(m, {})[p] = {
                "mpjpe_vs_truth": float(np.linalg.norm(
                    cen(pos) - cen(true), axis=2).mean() * 1e3),
                "mpe_vs_truth": float(np.linalg.norm(
                    pos - true, axis=2).mean() * 1e3),
                "obj_cost": float(d["obj_cost"]),
                "finite": bool(np.isfinite(d["q"]).all())}
    return out


def sweep_errors(root, odir, paths, cams=range(6)):
    """Per trial, camera and monocular mode of the every-camera sweep under
    ``odir``: the MPE (mm) against the multi-view solve, as
    ``distance_vs_error`` takes it, and its parts: the mean offset's
    component along the camera's line of sight to the multi-view CoM
    (``depth_mm``, positive away from the camera), the rest of that offset
    (``across_mm``), and the MPE left once the mean offset is taken away
    (``rest_mm``: the trajectory's drift about its mean, and the pose)."""
    import pickle

    from cheetah_pose_estimation_tpu_torch.data import io as dio

    def load(p, sub):
        with open(os.path.join(odir, p, sub, "fte.pickle"), "rb") as fh:
            return np.asarray(pickle.load(fh)["positions"], np.float64)

    out = {}
    for p in paths:
        _, _, r_arr, t_arr, *_ = dio.find_scene_file(os.path.join(root, p))
        gt = load(p, "fte_kinematic")
        for cam in cams:
            centre = -np.linalg.inv(r_arr[cam]) @ np.reshape(t_arr[cam], 3)
            sight = gt.mean(axis=(0, 1)) - centre
            sight /= np.linalg.norm(sight)
            for m, sub in (("default", "fte_kinematic_orig"),
                           ("data-driven", "fte_kinematic")):
                pos = load(p, f"{sub}_{cam}")
                n = min(len(pos), len(gt))
                e = pos[:n] - gt[:n]
                off = e.mean(axis=(0, 1))
                out.setdefault(p, {}).setdefault(str(cam), {})[m] = {
                    "mpe_mm": float(np.linalg.norm(e, axis=2).mean() * 1e3),
                    "depth_mm": float(off @ sight * 1e3),
                    "across_mm": float(np.linalg.norm(
                        off - (off @ sight) * sight) * 1e3),
                    "rest_mm": float(np.linalg.norm(
                        e - off, axis=2).mean() * 1e3)}
    return out


def log_sweep_errors(errors, jax_errors):
    """One line per (trial, camera) of ``sweep_errors``' readings, with
    JAX's beside them on the trials ``jax_errors`` holds."""
    for p, cams in errors.items():
        for c, modes in cams.items():
            line = "  ".join(
                f"{m} MPE {e['mpe_mm']:.1f} (depth {e['depth_mm']:+.1f}, "
                f"across {e['across_mm']:.1f}, rest {e['rest_mm']:.1f})"
                + (f" JAX f64 MPE {jax_errors[p][c][m]['mpe_mm']:.1f} "
                   f"(depth {jax_errors[p][c][m]['depth_mm']:+.1f})"
                   if p in jax_errors else "")
                for m, e in modes.items())
            log(f"# analysis: {p} cam {c}: {line} mm")


def phase_acinoset(dev, results, ref, dset):
    """``run_dataset.main --run_acinoset --clean`` on trials
    ``ACINOSET_RUN`` of the first ``ACINOSET_TRIALS`` of the synthetic test
    set (the flicks with their PPMs, ``render_acinoset_tree``; the tree's
    other trials removed after the digest), the tree's digest held against
    the JAX package's own rendering and the reference run's input
    (``tests/data/jax_acinoset_f64.json``). Each trial alone at its own
    length through the ground-truth, default and data-driven modes (the
    priors trained on ``dset``, phase 9's tables). Gate, against the JAX
    float64 run on the same input: the ground-truth mode's mean MPJPE
    against the truth within 2 %, over all trials and over the PPM flicks
    alone; W = 3 on the flicks and 1 on the runs, on both sides;
    ``validate_dataset`` equal to JAX's; every JAX artifact present with
    its keys and shapes. The monocular modes are printed beside JAX
    float64 and float32. Returns the launches per shape."""
    import tempfile

    from cheetah_pose_estimation_tpu_torch.data import io as dio
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    out = {}
    work = tempfile.mkdtemp(prefix="acinoset_")
    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")

    # 1. the tree, held against the JAX rendering and the reference's input
    t0 = time.perf_counter()
    paths = render_acinoset_tree(run_dataset, root)
    out["render_s"] = time.perf_counter() - t0
    if paths != ref["trials"]:
        raise AssertionError(f"rendered {paths}, the reference has "
                             f"{ref['trials']}")
    for i, p in enumerate(paths):
        if i not in ACINOSET_RUN:
            shutil.rmtree(os.path.join(root, p))
    paths = [paths[i] for i in ACINOSET_RUN]
    tree_ok = True
    for p in paths:
        xy, lik, _ = dio.load_dlc_points(os.path.join(root, p, "dlc"))
        mine = dict(digest(xy, lik), ppm=ppm_digest(os.path.join(root, p)))
        checks = []
        for r, tol in ((ref["tree"][p], TOL_PX),
                       (ref["port_tree"][p], TOL_PX_SAME)):
            pairs = [(mine, r)] + [(mine["ppm"][k], r["ppm"].get(k, {}))
                                   for k in mine["ppm"]]
            dpx = max(max(abs(a - b) for a, b in zip(
                m["px_proj"], o.get("px_proj", [np.inf] * 4)))
                for m, o in pairs)
            checks.append((dpx, sorted(mine["ppm"]) == sorted(r["ppm"])
                           and all(m["gate_md5"] == o.get("gate_md5")
                                   for m, o in pairs) and dpx <= tol))
        tree_ok &= all(ok for _, ok in checks)
        log(f"# acinoset: tree {p} {mine['shape']} gated {mine['n_gated']}, "
            f"PPM pickles {len(mine['ppm'])}: JAX tree |px proj diff| "
            f"{checks[0][0]:.2e} ({'same' if checks[0][1] else 'DIFFERENT'})"
            f", the reference run's input {checks[1][0]:.2e} "
            f"({'same' if checks[1][1] else 'DIFFERENT'})")
    log(f"# acinoset: tree rendered in {out['render_s']:.2f} s (host)")
    if not tree_ok:
        raise AssertionError("the AcinoSet tree differs from the JAX tree or "
                             "from the reference run's input")

    # 2. the main path: every trial, mode after mode, through the CLI
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    cuda_banded.reset_launches()
    report = {}
    t0 = time.perf_counter()
    with plain_solves_counted() as plain:
        run_dataset.main(["--run_acinoset", "--clean", "--root_dir", root,
                          "--out_dir_prefix", odir], report=report)
        torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    log(f"# acinoset: run_dataset.main {out['cli_s']:.2f} s, kernel "
        f"launches {shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the AcinoSet CLI ran plain banded solves on "
                             f"the card: {plain}")
    untimed = sorted(set(by_shape) - set(SERIAL_SHAPES + ACINOSET_SHAPES))
    if untimed:
        raise AssertionError(f"shapes not timed in phase 3: {untimed}")
    scores = acinoset_scores(root, odir, paths)
    bad, modes = [], {}
    for m in ACINOSET_MODES:
        rep = report["acinoset"][m]
        if sorted(rep["trials"]) != sorted(paths):  # in the tree's order
            raise AssertionError(f"mode {m} ran {rep['trials']}")
        rows, launches = [], {}
        for p in paths:
            t = rep["per_trial"][p]
            if not sum(t["launches"].values()):
                raise AssertionError(f"{m} {p} did not launch the kernel")
            for k, v in t["launches"].items():
                launches[k] = launches.get(k, 0) + v
            w_jax = ref["f64"]["modes"][m][p]["W"]
            want = 3 if "flick" in p else 1
            if not (t["W"] == w_jax == want):
                bad.append((m, p, "W", t["W"], w_jax))
            if not scores[m][p]["finite"]:
                bad.append((m, p, "non-finite q"))
            rows.append(dict(scores[m][p], wall_s=t["wall_s"], W=t["W"],
                             lm_steps=int(sum(t["launches"].values())),
                             launches_by_shape=shape_keys(t["launches"])))
        modes[m] = {"s_per_trial": float(np.mean([r["wall_s"]
                                                   for r in rows])),
                    "lm_steps": int(sum(launches.values())),
                    "launches_by_shape": shape_keys(launches),
                    "per_trial": dict(zip(paths, rows))}
        log(f"# acinoset: mode {m}: {modes[m]['s_per_trial']:.4f} s/trial, "
            f"LM steps {modes[m]['lm_steps']}, launches "
            f"{modes[m]['launches_by_shape']}")
        for p, r in zip(paths, rows):
            j64, j32 = ref["f64"]["modes"][m][p], ref["f32"]["modes"][m][p]
            log(f"# acinoset: {m} {p} W {r['W']} {r['wall_s']:.3f} s, LM "
                f"steps {r['lm_steps']} {r['launches_by_shape']}, MPJPE "
                f"{r['mpjpe_vs_truth']:.2f} mm (jax f64 "
                f"{j64['mpjpe_vs_truth']:.2f}, f32 "
                f"{j32['mpjpe_vs_truth']:.2f}), MPE {r['mpe_vs_truth']:.2f} "
                f"mm (jax f64 {j64['mpe_vs_truth']:.2f}, f32 "
                f"{j32['mpe_vs_truth']:.2f}), objective "
                f"{r['obj_cost']:.6g} (jax f64 {j64['obj_cost']:.6g})")
    out["modes"] = modes

    # 3. the gate: the well-posed multi-view mode against JAX float64,
    # nothing set aside; the monocular modes printed beside it
    agree = {}
    flicks = [p for p in paths if "flick" in p]
    for m in ACINOSET_MODES:
        for label, sub in (("all", paths), ("PPM flicks", flicks)):
            port = float(np.mean([modes[m]["per_trial"][p]["mpjpe_vs_truth"]
                                  for p in sub]))
            j64, j32 = (float(np.mean([ref[r]["modes"][m][p][
                "mpjpe_vs_truth"] for p in sub])) for r in ("f64", "f32"))
            rel = (port - j64) / j64
            gated = m == "ground-truth"
            ok = abs(rel) <= TOL_MPJPE
            agree[f"{m} {label}"] = {"port": port, "jax_f64": j64,
                                     "jax_f32": j32, "rel_f64": rel,
                                     "gated": gated, "ok": ok}
            log(f"# acinoset agree: {m} mean MPJPE vs truth ({label}) port "
                f"{port:.3f} jax_f64 {j64:.3f} (rel {rel:+.4f}"
                + (f", bar ±{TOL_MPJPE}: {'ok' if ok else 'FAILED'})"
                   if gated else ", printed only)")
                + f" jax_f32 {j32:.3f}")
            if gated and not ok:
                bad.append((m, label, rel))
    jvalid = {k: v for k, v in ref["f64"]["validate"].items()
              if any(k.startswith(p + "/") for p in paths)}
    valid_ok = report["validate"] == jvalid
    log(f"# acinoset agree: validate_dataset {report['validate']} "
        f"({'same' if valid_ok else 'DIFFERENT'} as JAX f64's)")
    if not valid_ok:
        bad.append(("validate", report["validate"]))
    mine = artifacts(odir)
    theirs = {k: v for k, v in trial_artifacts(ref["f64"]["artifacts"],
                                               paths).items()
              if not k.endswith(".h5")}
    missing = [p for p in theirs if p not in mine]
    differ = [p for p, v in theirs.items() if p in mine and mine[p] != v]
    agree["artifacts"] = {"jax": len(theirs), "port": len(mine),
                          "missing": missing, "differ": differ}
    log(f"# acinoset agree: artifacts: JAX {len(theirs)}, port {len(mine)}, "
        f"missing {missing[:5]} ({len(missing)}), differ {differ[:5]} "
        f"({len(differ)})")
    out["agree"] = agree
    results["acinoset"] = out
    if bad or missing or differ:
        raise AssertionError(f"the AcinoSet CLI disagrees with the JAX run: "
                             f"{bad}, missing {missing[:5]}, differ "
                             f"{differ[:5]}")
    return by_shape


@contextlib.contextmanager
def widest_linescan():
    """Record the inputs (q, batched, rays, scale medians) of the widest
    depth line-scan made inside the block (the data-driven mode's, 7 x B
    lanes), into the yielded dict; the line-scans run as they would."""
    from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor

    rec = {}
    orig = depth_anchor.make_depth_linescan

    def make(subject, *a, **k):
        scan = orig(subject, *a, **k)

        def run(q_in, batched, rays, *aa, **kk):
            if q_in.shape[0] > rec.get("B", 0):
                rec.update(B=q_in.shape[0], q=q_in, batched=batched,
                           rays=np.asarray(rays), subject=subject,
                           scale_med=aa[0] if aa else kk.get("scale_med"))
            return scan(q_in, batched, rays, *aa, **kk)
        return run

    depth_anchor.make_depth_linescan = make
    try:
        yield rec
    finally:
        depth_anchor.make_depth_linescan = orig


def linescan_problem(rec):
    """The widest line-scan's own problem, as ``make_depth_linescan``
    builds it: its judge solver's model, and every trial shifted by each
    of ``SCAN_SHIFTS`` along its camera rays (7 x B lanes)."""
    from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    q, rays = rec["q"], torch.as_tensor(rec["rays"], dtype=rec["q"].dtype,
                                        device=rec["q"].device)
    qks = torch.cat([torch.cat([q[..., :3] + s * rays, q[..., 3:]], -1)
                     for s in depth_anchor.SCAN_SHIFTS])
    K = len(depth_anchor.SCAN_SHIFTS)
    rep = kin.map_data(lambda x: torch.cat([x] * K), rec["batched"])
    fte = kin.KinematicFTE(kin.KinematicConfig(fisheye=True, robust=True),
                           rec["subject"])
    return fte, qks, rep


def phase_analysis(dev, results, ref, root):
    """``run_dataset.main --run_analysis --clean --batched`` on phase 9's
    10-trial tree: the multi-view ground truth of each trial, then every
    (trial, camera) combination as one lane of the default and data-driven
    modes (60 lanes in two subject groups, 36 and 24; the data-driven
    line-scan at 7 x 36 = 252 and 7 x 24 = 168 lanes, more than the card
    has SMs), then ``distance_vs_error`` and ``example_robustness``. Gate:
    every expected solution present and finite; ``dist_vs_error.csv`` with
    JAX's columns; each (trial, camera)'s distance and view angle within 1
    % of JAX's on the JAX float64 ground truth
    (``tests/data/jax_acinoset_f64.json``, ``analysis``). Then the kernel
    against its plain version on the widest line-scan's own normal
    systems (lam = 1e-2, scaled as ``gn.scaled_system`` does; rel error <=
    7e-4), a NaN lane of the second wave isolated, and a window of
    ``LINESCAN_PROFILE_STEPS`` LM steps of that line-scan under
    torch.profiler. Printed only: each (trial, camera)'s MPE against the
    multi-view solve and its parts (``sweep_errors``), beside JAX
    float64's on the trials of ``analysis["sweep"]``. Returns (launches
    per shape, worst rel err, worst abs err)."""
    import csv
    import pickle
    import tempfile

    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    from cheetah_pose_estimation_tpu_torch.solver import gn

    out = {}
    odir = os.path.join(tempfile.mkdtemp(prefix="analysis_"), "out")
    paths = [os.path.join(d, c, t) for c, d, t in run_dataset.TEST_SET]

    # 1. the main path: the every-camera sweep and the analysis
    cuda_banded.reset_launches()
    report = {}
    t0 = time.perf_counter()
    with plain_solves_counted() as plain, widest_linescan() as scan_in:
        run_dataset.main(["--run_analysis", "--clean", "--batched",
                          "--root_dir", root, "--out_dir_prefix", odir],
                         report=report)
        torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    log(f"# analysis: run_dataset.main {out['cli_s']:.2f} s, kernel "
        f"launches {shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the analysis ran plain banded solves on the "
                             f"card: {plain}")
    untimed = sorted(set(by_shape) - set(CLI_SHAPES + ANALYSIS_SHAPES))
    if untimed:
        raise AssertionError(f"shapes not timed in phase 3: {untimed}")
    if not all(by_shape.get(s) for s in ANALYSIS_SHAPES[-2:]):
        raise AssertionError(f"the line-scans did not launch the kernel at "
                             f"{ANALYSIS_SHAPES[-2:]}")
    prev, modes = {}, {}
    for m in ("ground-truth", "default", "data-driven"):
        rep = report["analysis"][m]
        snap = rep["launches"]
        launches = {k: v - prev.get(k, 0) for k, v in snap.items()
                    if v - prev.get(k, 0)}
        prev = snap
        modes[m] = {"lanes": len(rep["trials"]), "wall_s": rep["wall_s"],
                    "solve_s": rep["solve_s"],
                    "lm_steps": int(sum(launches.values())),
                    "launches_by_shape": shape_keys(launches)}
        log(f"# analysis: mode {m}: {modes[m]['lanes']} lanes, wall "
            f"{rep['wall_s']:.2f} s, solve {rep['solve_s']:.2f} s, LM steps "
            f"{modes[m]['lm_steps']}, launches "
            f"{modes[m]['launches_by_shape']}")
        if not launches:
            raise AssertionError(f"mode {m} did not launch the kernel")
    out["modes"] = modes

    # 2. the solutions, the table and the distances
    bad, dist_err = [], 0.0
    expected = [os.path.join(p, "fte_kinematic") for p in paths] + [
        os.path.join(p, f"{sub}_{c}") for p in paths for c in range(6)
        for sub in ("fte_kinematic_orig", "fte_kinematic")]
    for e in expected:
        f = os.path.join(odir, e, "fte.pickle")
        if not os.path.exists(f):
            bad.append(("missing", e))
            continue
        with open(f, "rb") as fh:
            if not np.isfinite(pickle.load(fh)["q"]).all():
                bad.append(("non-finite", e))
    with open(os.path.join(odir, "dist_vs_error.csv"), encoding="utf-8") as f:
        table = list(csv.reader(f))
    rows = report["dist_vs_error"]
    if tuple(table[0]) != run_dataset.DIST_COLUMNS or \
            not len(table) - 1 == len(rows) == 120:
        bad.append(("dist_vs_error.csv", table[0], len(table) - 1))
    for r in rows:
        jd, ja = ref["analysis"]["distance"][r["trial"]][str(r["cam"])]
        e = max(abs(r["distance_m"] - jd) / jd, abs(r["angle_deg"] - ja)
                / max(ja, 1e-12))
        dist_err = max(dist_err, e)
    if dist_err > TOL_ANALYSIS:
        bad.append(("distance/angle vs JAX f64", dist_err))
    mpe = {m: float(np.mean([r["mpe_mm"] for r in rows if r["mode"] == m]))
           for m in ("default", "data-driven")}
    errors = sweep_errors(root, odir, paths)
    log_sweep_errors(errors, ref["analysis"]["sweep"]["errors"])
    pdfs = {n: os.path.exists(os.path.join(odir, n))
            for n in ("dist_vs_error.pdf", "example-cam-robustness.pdf")}
    out.update(expected=len(expected), rows=len(rows), mean_mpe_mm=mpe,
               sweep_errors=errors,
               distance_max_rel_err=dist_err,
               robustness=report["robustness"], pdfs_written=pdfs)
    log(f"# analysis: {len(expected)} solutions expected, "
        f"{len([b for b in bad if b[0] in ('missing', 'non-finite')])} "
        f"missing or non-finite; dist_vs_error rows {len(rows)}; mean MPE "
        f"vs the multi-view solve over the 60 combinations {mpe} (printed "
        f"only); distance and angle vs JAX f64 ground truth, largest rel "
        f"err {dist_err:.2e} (bar {TOL_ANALYSIS}); example_robustness "
        f"{report['robustness']} (no physics-based solutions: "
        f"--run_analysis solves the default and data-driven modes); PDFs "
        f"written {pdfs}")

    # 3. the kernel on the widest line-scan's own normal systems, and a
    # NaN lane of the second wave
    fte, qks, rep = linescan_problem(scan_in)
    g, H = fte._normal(qks, rep, 1.0)
    B = qks.shape[0]
    Hs, rhs, _ = gn.scaled_system(g, H, torch.full((B,), 1e-2, device=dev),
                                  1e-8)
    d32, l32, r32 = (x.contiguous() for x in (Hs.diag, Hs.lower, rhs))
    del g, H, Hs
    x = cuda_banded.solve(d32, l32, r32)
    torch.cuda.synchronize()
    ref64 = cuda_banded.solve_reference(d32.double(), l32.double(),
                                        r32.double())
    abs_err = float((x.double() - ref64).abs().max())
    kern = {"systems": "data-driven line-scan", "B": B, "N": qks.shape[1],
            "rel_err": abs_err / float(ref64.abs().max()),
            "max_abs_err": abs_err}
    del ref64
    log(f"# analysis: kernel {kern}")
    if not (torch.isfinite(x).all() and kern["rel_err"] <= TOL_REL):
        raise AssertionError(f"kernel on the line-scan systems: {kern}")

    lane = min(200, B - 1)      # past the first wave of 132 CTAs

    def all_nan(d, l, r):
        d[lane].fill_(float("nan"))

    check_nan_lane(cuda_banded.solve, d32, l32, r32, lane, all_nan,
                   f"second-wave (lane {lane} of {B}) all-NaN")
    out["kernel"] = kern
    del d32, l32, r32, x

    # 4. a window of LM steps of the widest line-scan under
    # torch.profiler, against three unprofiled runs of it (the CLI run
    # warmed the solver's shapes up)
    window = fte.make_solver(stages=((1.0, LINESCAN_PROFILE_STEPS),),
                             driver="scan")
    prof = profiled_window(lambda: window(qks, rep), reps=3)
    log(f"# analysis profile: a {prof['lm_steps']}-step window of the "
        f"line-scan at {B} lanes {prof}")
    out["profile_linescan_window"] = prof
    results["analysis"] = out
    if bad:
        raise AssertionError(f"the analysis failed its checks: {bad[:8]}")
    return by_shape, kern["rel_err"], kern["max_abs_err"]


# -- phase 14: the studies ---------------------------------------------------

STUDY_TRIALS = 2          # jules flick2 and flick1: one subject group
# the sweep's rate 8 had no JAX reference (its rows were printed only)
# and is cut for the smoke's time limit
# the physics ablation's LM schedule (the smoke's time limit): 30 steps a
# configuration instead of the default 180; no JAX run of the ablation was
# recorded at any depth (tests/data/jax_studies_f64.json), so its rows are
# printed and its form gated at either depth
STUDY_PHYSICS_STAGES = ((3.0, 10), (1.0, 20))
SWEEP_RATES = (0.0,)
SWEEP_TRIALS = 4
# each study CSV: its name, the JAX package's columns (the rows it builds:
# pipeline/studies.py:236-241 with the model statistics of :184-189,
# :626-633, :527-554) and row count
ABLATION_COLUMNS = ["config", "mpe", "mpjpe", "cvr", "n"]
STUDY_CSVS = {
    "grid": ("grid_search_results.csv", [
        "n_components", "window", "lasso", "mpe", "mpjpe", "n",
        "lr_non_zeros", "lr_train_rmse", "lr_validation_rmse",
        "gmm_train_likelihood", "gmm_validation_likelihood"], 24),
    "dd_ablation": ("data_driven_ablation_results.csv", ABLATION_COLUMNS, 4),
    "physics_ablation": ("physics_based_ablation_results.csv",
                         ABLATION_COLUMNS, 4),
    "degradation": ("degradation_sweep.csv", [
        "rate", "default_mpjpe", "dd_mpjpe", "improvement_pct",
        "physics_mpjpe", "physics_vs_dd_pct"], len(SWEEP_RATES))}
STUDY_PDFS = ("gmm_model_selection.pdf", "ar_model_selection.pdf",
              "gmm_components_vs_error.pdf", "ar_window_vs_error.pdf",
              "ablation-study.pdf")
SWEEP_COLUMNS = ("default_mpjpe", "dd_mpjpe", "physics_mpjpe")


def sweep_gate(port, jax_f64, jax_f32, tol=TOL_MPJPE):
    """Agreement of one degradation-sweep mean (one column at one rate) of
    the port's float32 run with the JAX float64 run on the same problems:
    within ``tol`` of it, either way. Where the JAX float32 run itself
    misses the float64 one by more than ``tol`` (the reference does not
    reproduce itself in float32 there), the value is printed and not
    gated."""
    rel = (port - jax_f64) / jax_f64
    f32 = (jax_f32 - jax_f64) / jax_f64
    aside = abs(f32) > tol
    return {"port": port, "jax_f64": jax_f64, "jax_f32": jax_f32,
            "rel_f64": rel, "jax_f32_vs_f64": f32, "set_aside": aside,
            "ok": aside or abs(rel) <= tol, "tol": tol}


def sweep_agree(rep, ref):
    """The degradation sweep's ``sweep_gate`` per rate and column: the
    port's unrounded means (``rep``: ``run_degradation_sweep``'s report)
    against the JAX float64 and float32 runs' (``ref``: per dtype its
    ``rows``), printed with the prior gate and the per-trial values. A rate
    that either JAX run did not record (its CPU runs take hours a rate)
    is printed, not gated. Returns the gates."""
    jax_rows = {d: {r["rate"]: r for r in ref[d]["rows"]}
                for d in ("f64", "f32")}
    gates = []
    for i, (raw, ok) in enumerate(zip(rep["rows"], rep["prior_ok"])):
        rate = raw["rate"]
        log(f"# studies: sweep rate {rate} prior gate {ok}, per-trial "
            f"MPJPE {rep['per_trial'][i]}")
        j64, j32 = (jax_rows[d].get(rate) for d in ("f64", "f32"))
        for c in SWEEP_COLUMNS:
            if j64 is None or j32 is None:
                log(f"# studies agree: sweep rate {rate} {c}: port "
                    f"{raw[c]:.3f}, jax_f64 "
                    + (f"{j64[c]:.3f}" if j64 else "not recorded")
                    + ", jax_f32 "
                    + (f"{j32[c]:.3f}" if j32 else "not recorded")
                    + " (printed, not gated)")
                continue
            g = dict(sweep_gate(raw[c], j64[c], j32[c]), rate=rate,
                     column=c)
            gates.append(g)
            log(f"# studies agree: sweep rate {rate} {c}: port "
                f"{g['port']:.3f} jax_f64 {g['jax_f64']:.3f} jax_f32 "
                f"{g['jax_f32']:.3f} (rel {g['rel_f64']:+.4f}, jax f32 vs "
                f"f64 {g['jax_f32_vs_f64']:+.4f}, bar ±{g['tol']}"
                + (", set aside: JAX f32 misses its f64)" if g["set_aside"]
                   else ")") + ("" if g["ok"] else " FAILS"))
    return gates


@contextlib.contextmanager
def first_systems(B):
    """Record the first finite damped, scaled normal systems the kernel is
    given at B lanes inside the block (copies), into the yielded dict;
    every solve runs as it would. (A float32 solve's first stage, at the
    redescending loss's scale 10, hands the kernel NaN systems: ROADMAP
    Queue 3 #1.)"""
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded

    rec = {}
    orig = cuda_banded.solve

    def solve(diag, lower, rhs, *a, **k):
        if diag.shape[0] == B and "diag" not in rec and all(
                bool(torch.isfinite(t).all()) for t in (diag, lower, rhs)):
            rec.update(diag=diag.clone(), lower=lower.clone(),
                       rhs=rhs.clone())
        return orig(diag, lower, rhs, *a, **k)

    cuda_banded.solve = solve
    try:
        yield rec
    finally:
        cuda_banded.solve = orig


def gmm_vs_jax(jm, sel, grid_rows):
    """The studies' own GMM likelihoods on the training and validation
    tables (the port's fits with seed 42, whose k-means++ draw is JAX's:
    ``priors/gmm.kmeanspp_indices``) against JAX's (``jm``:
    ``ref["models"]``), per component count. Returns the largest
    difference in nats per sample and the per-count values."""
    own = {k + 1: (sel["gmm_train_likelihood"][k],
                   sel["gmm_validation_likelihood"][k])
           for k in range(len(sel["gmm_train_likelihood"]))}
    own.update({r["n_components"]: (r["gmm_train_likelihood"],
                                    r["gmm_validation_likelihood"])
                for r in grid_rows})
    per, worst = {}, 0.0
    for k in sorted(own):
        jg = jm["grid"].get(f"gmm_{k}")
        jax_tv = ((jg["gmm_train_likelihood"], jg["gmm_validation_likelihood"])
                  if jg else (jm["selection"]["gmm_train_likelihood"][k - 1],
                              jm["selection"]["gmm_validation_likelihood"][
                                  k - 1]))
        worst = max([worst] + [abs(a - b) for a, b in zip(own[k], jax_tv)])
        per[k] = {"jax": jax_tv, "port": own[k]}
        log(f"# studies: GMM K={k} train/validation likelihood jax "
            f"{jax_tv[0]:.4f}/{jax_tv[1]:.4f}, port "
            f"{own[k][0]:.4f}/{own[k][1]:.4f}")
    return {"max_nats": worst, "per_k": per}


def study_rows_vs_jax(name, rows, ref, key):
    """Print a study's rows beside those of the JAX float64 and float32
    runs on the same trials (``ref["studies"]``; a run the reference did
    not record is left out). Not gated: float32 monocular results move
    10-80 % under round-off."""
    runs = {r: ref["studies"].get(r, {}).get(name) for r in ("f64", "f32")}
    for i, r in enumerate(rows):
        label = {k: r[k] for k in key}
        log(f"# studies vs jax ({name}): {label} " + ", ".join(
            f"{c} port {r[c]:.3f}" + "".join(
                f" jax_{d} {v[i][c]:.3f}" for d, v in runs.items() if v)
            for c in ("mpe", "mpjpe", "cvr") if c in r)
            + ("" if any(runs.values()) else " (no JAX run recorded)"))


@contextlib.contextmanager
def kinetic_stages(stages):
    """``KineticFTE.make_solver``'s default schedule is ``stages`` inside
    the block."""
    from cheetah_pose_estimation_tpu_torch.solver import kinetic as kn

    saved = kn.KineticFTE.make_solver.__defaults__
    kn.KineticFTE.make_solver.__defaults__ = (stages,) + saved[1:]
    try:
        yield
    finally:
        kn.KineticFTE.make_solver.__defaults__ = saved


def phase_studies(dev, results, ref, root, dset, odir):
    """The study flags on phase 9's tree and output directory:
    ``run_dataset.main(["--run_grid_search",
    "--run_data_driven_ablation_study", "--batched", "--trials", "2",
    ...])`` (the 24-configuration grid over the first two trials as one
    48-lane batch, ``model_selection_analysis`` at its defaults, the
    data-driven ablation, the figures), ``run_dataset.main(
    ["--run_physics_based_ablation_study", ...])`` with the kinetic
    schedule cut to ``STUDY_PHYSICS_STAGES``, then
    ``studies.run_degradation_sweep(rates=SWEEP_RATES,
    max_trials=SWEEP_TRIALS, include_physics=True)``; per study the wall,
    LM steps and launches per shape. Gate: every CSV and
    ``grid_search.pickle`` present with the JAX package's columns or keys
    and row counts (``STUDY_CSVS``; the pickle's keys and lengths from
    ``tests/data/jax_studies_f64.json``); every value
    finite and every study row's ``n`` = 2; the AR statistics within 1e-6
    relative of JAX's with equal non-zero counts, the studies' own GMM
    likelihoods within 0.5 nats per sample of JAX's (``gmm_vs_jax``: the
    port draws its k-means++ means as ``jax.random`` does); the kernel
    against its plain version in float64 on the grid's first finite
    48-lane normal systems (rel error <= 7e-4);
    each sweep column's mean MPJPE per rate within 2 % of the JAX float64
    run's (``sweep_gate``). Printed only: the studies' monocular rows
    beside the JAX float64 and float32 runs' on the same trials, where the
    reference recorded them. Returns (launches
    per shape, the kernel's rel err, abs err)."""
    import csv
    import tempfile

    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    from cheetah_pose_estimation_tpu_torch.pipeline import studies
    from cheetah_pose_estimation_tpu_torch.utils import data_ops

    out, bad = {}, []
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    B_grid = 24 * STUDY_TRIALS
    before = set(os.listdir(odir))

    # 1. the main path: the three study flags, then the sweep
    cuda_banded.reset_launches()
    report = {}
    t0 = time.perf_counter()
    with plain_solves_counted() as plain, first_systems(B_grid) as grid_in:
        run_dataset.main(["--run_grid_search",
                          "--run_data_driven_ablation_study", "--batched",
                          "--trials", str(STUDY_TRIALS), "--root_dir", root,
                          "--out_dir_prefix", odir], report=report)
        with kinetic_stages(STUDY_PHYSICS_STAGES):
            run_dataset.main(["--run_physics_based_ablation_study",
                              "--batched", "--trials", str(STUDY_TRIALS),
                              "--root_dir", root, "--out_dir_prefix", odir],
                             report=report)
        sweep_dir = tempfile.mkdtemp(prefix="sweep_")
        sweep_rep = {}
        rows_sweep, tr = run_dataset._timed(
            dev, lambda tr: studies.run_degradation_sweep(
                rates=SWEEP_RATES, max_trials=SWEEP_TRIALS,
                include_physics=True, data_driven_dataset=dset,
                out_dir=sweep_dir, report=sweep_rep))
        report["studies"]["degradation"] = dict(tr, result=rows_sweep)
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    by_shape = dict(cuda_banded.launches_by_shape)
    log(f"# studies: phase main path {out['wall_s']:.2f} s, kernel launches "
        f"{shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the studies ran plain banded solves on the "
                             f"card: {plain}")
    untimed = sorted(set(by_shape) - set(CLI_SHAPES + STUDY_SHAPES))
    if untimed:
        raise AssertionError(f"shapes not timed in phase 3: {untimed}")
    per = {}
    for name, rep in report["studies"].items():
        per[name] = {"wall_s": rep["wall_s"],
                     "lm_steps": int(sum(rep["launches"].values())),
                     "launches_by_shape": shape_keys(rep["launches"])}
        log(f"# studies: {name}: wall {rep['wall_s']:.2f} s, LM steps "
            f"{per[name]['lm_steps']}, launches "
            f"{per[name]['launches_by_shape']}")
        if name != "model_selection" and not rep["launches"]:
            bad.append(("no kernel launch", name))
    out["studies"] = per

    # 2. the artifacts: columns, row counts, finite values, n
    if ref["sweep"]["f64"]["columns"] != STUDY_CSVS["degradation"][1]:
        bad.append(("JAX sweep columns", ref["sweep"]["f64"]["columns"]))
    for name, (fname, cols, n_rows) in STUDY_CSVS.items():
        path = os.path.join(sweep_dir if name == "degradation" else odir,
                            fname)
        if not os.path.exists(path):
            bad.append(("missing", fname))
            continue
        with open(path, encoding="utf-8", newline="") as f:
            table = list(csv.reader(f))
        log(f"# studies: {fname}: {table[0]}")
        for r in table[1:]:
            log(f"# studies: {fname}: {r}")
        if table[0] != cols or len(table) - 1 != n_rows:
            bad.append((fname, table[0], len(table) - 1, cols, n_rows))
        vals = [float(v) if v else np.nan for r in table[1:]
                for c, v in zip(table[0], r) if c not in ("config", "lasso")]
        if not all(np.isfinite(vals)):
            bad.append(("non-finite values", fname))
        if "n" in table[0] and any(int(r[table[0].index("n")])
                                   != STUDY_TRIALS for r in table[1:]):
            bad.append(("n", fname))
    sel = data_ops.load_pickle(os.path.join(odir, "grid_search.pickle"))
    jsel = ref["models"]["selection"]
    if sorted(sel) != sorted(jsel) or any(len(sel[k]) != len(jsel[k])
                                          for k in jsel):
        bad.append(("grid_search.pickle", {k: len(v) for k, v in
                                           sel.items()}))
    written = [n for n in sorted(set(os.listdir(odir)) - before)
               if n.endswith(".pdf")]
    skipped = [n for n in STUDY_PDFS if n not in written]
    log(f"# studies: plots written {written}, skipped (no matplotlib) "
        f"{skipped}")
    out["plots"] = {"written": written, "skipped": skipped}

    # 3. the model statistics against JAX's
    grid_rows = report["studies"]["grid"]["result"]
    ar_err, nz_same = 0.0, True
    for k in ("lr_train_rmse", "lr_validation_rmse"):
        for a, b in zip(sel[k], jsel[k]):
            ar_err = max(ar_err, abs(a - b) / abs(b))
    nz_same &= [int(x) for x in sel["lr_non_zeros"]] == [
        int(x) for x in jsel["lr_non_zeros"]]
    for r in grid_rows:
        ja = ref["models"]["grid"][f"ar_{r['window']}_{r['lasso']}"]
        for k in ("lr_train_rmse", "lr_validation_rmse"):
            ar_err = max(ar_err, abs(r[k] - ja[k]) / abs(ja[k]))
        nz_same &= int(r["lr_non_zeros"]) == int(ja["lr_non_zeros"])
    gmm = gmm_vs_jax(ref["models"], sel, grid_rows)
    log(f"# studies: model statistics vs JAX: AR RMSE largest rel err "
        f"{ar_err:.2e} (bar {TOL_AR}), non-zero counts equal {nz_same}; "
        f"the studies' GMM likelihoods, largest |diff| "
        f"{gmm['max_nats']:.2e} nats per sample (bar {TOL_GMM_NATS})")
    if ar_err > TOL_AR or not nz_same or gmm["max_nats"] > TOL_GMM_NATS:
        bad.append(("model statistics", ar_err, nz_same, gmm))
    out["model_stats"] = {"ar_max_rel_err": ar_err, "non_zeros_equal":
                          nz_same, "gmm": gmm}

    # 4. the kernel on the grid's first 48-lane normal systems
    if "diag" not in grid_in:
        raise AssertionError(f"the grid solved no {B_grid}-lane system")
    d32, l32, r32 = grid_in["diag"], grid_in["lower"], grid_in["rhs"]
    x = cuda_banded.solve(d32, l32, r32)
    torch.cuda.synchronize()
    ref64 = cuda_banded.solve_reference(d32.double(), l32.double(),
                                        r32.double())
    abs_err = float((x.double() - ref64).abs().max())
    kern = {"systems": "grid search", "B": d32.shape[0], "N": d32.shape[1],
            "rel_err": abs_err / float(ref64.abs().max()),
            "max_abs_err": abs_err}
    log(f"# studies: kernel {kern}")
    if not (torch.isfinite(x).all() and kern["rel_err"] <= TOL_REL):
        raise AssertionError(f"kernel on the grid's systems: {kern}")
    out["kernel"] = kern

    # 5. the degradation sweep against JAX float64 and float32
    gates = sweep_agree(sweep_rep, ref["sweep"])
    if not gates:
        bad.append(("sweep", "no rate the JAX reference recorded"))
    elif any(not g["ok"] for g in gates):
        bad.append(("sweep", [g for g in gates if not g["ok"]]))
    out["sweep"] = {"rows": sweep_rep["rows"], "gates": gates,
                    "per_trial": sweep_rep["per_trial"]}

    # printed only: the studies' monocular rows beside JAX's
    study_rows_vs_jax("grid", grid_rows, ref,
                      ("n_components", "window", "lasso"))
    for name in ("dd_ablation", "physics_ablation"):
        study_rows_vs_jax(name, report["studies"][name]["result"], ref,
                          ("config",))
    results["studies"] = out
    if bad:
        raise AssertionError(f"the studies failed their checks: {bad[:6]}")
    return by_shape, kern["rel_err"], kern["max_abs_err"]


def render_options_trial(root):
    """Phase 15's trial under ``root`` (``OPTIONS_PATH``): a procedural
    gallop of ``OPTIONS_FRAMES`` frames at 120 fps, subject phantom, seen
    by ``ring_cameras(n_cams=4, seed=3)`` with 1 px noise and no outliers
    or drops, camera 2's detections moved along their image velocity by
    ``OPTIONS_TAU_H`` frame periods (a shutter delay), the ground plane at
    the truth's lowest foot. Host work in float64 (the port's synthetic
    module). Returns the truth: positions (N, 24, 3), CoM velocity (N-1,
    3), the injected delay and h."""
    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.models import skeleton as sk
    from cheetah_pose_estimation_tpu_torch.pipeline import contacts

    subject = params.get_subject("phantom")
    q_gt = syn.gallop_trajectory(OPTIONS_FRAMES)
    markers = syn.fk_markers_np(q_gt, subject)
    scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=4, seed=3)
    trial = syn.synthesize(q_gt, subject, scene, noise_px=1.0,
                           outlier_frac=0.0, drop_frac=0.0, seed=3,
                           subject_name="phantom")
    h = 1.0 / scene.fps
    true_tau = OPTIONS_TAU_H * h
    meas = np.array(trial.meas)
    vel_px = np.zeros_like(meas[..., 0])
    vel_px[1:] = (meas[1:, ..., 0] - meas[:-1, ..., 0]) / h
    meas[:, 2, :, :, 0] += true_tau * vel_px[:, 2]
    syn.write_trial_dir(trial._replace(meas=meas), root, OPTIONS_PATH,
                        ground_plane_height=contacts.estimate_ground_height(
                            q_gt, subject))
    com = sk.com_position(torch.as_tensor(q_gt), subject).numpy()
    return {"positions": markers, "com_vel": (com[1:] - com[:-1]) * scene.fps,
            "true_tau": true_tau, "h": h}


def options_scores(q, truth, subject_name="phantom"):
    """A solved trajectory q (N, 54) against ``render_options_trial``'s
    truth: MPJPE (frame-centred) and MPE in mm, CoM-velocity RMSE in m/s
    (the port's skeleton in float64 on the CPU)."""
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.models import skeleton as sk

    subject = params.get_subject(subject_name)
    qt = torch.as_tensor(np.array(q, np.float64))
    pos = sk.fk_markers(qt, subject).numpy()
    true = truth["positions"]
    err = (pos - pos.mean(1, keepdims=True)) - (true - true.mean(1,
                                                                keepdims=True))
    com = sk.com_position(qt, subject).numpy()
    dv = (com[1:] - com[:-1]) / truth["h"] - truth["com_vel"]
    return {"mpjpe": float(np.linalg.norm(err, axis=2).mean() * 1e3),
            "mpe": float(np.linalg.norm(pos - true, axis=2).mean() * 1e3),
            "com_vel_rmse": float(np.sqrt(np.mean(dv ** 2)))}


def lcp_summary(q, grf_z, ground_z, subject_name="phantom"):
    """``results.check_lcp`` on a solution: the GRFz (N, 4) against the
    feet's heights above the plane (the port's dynamics in float64 on the
    CPU), with the number of loaded foot-frames."""
    from cheetah_pose_estimation_tpu_torch.dynamics import eom
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.pipeline import results as res

    feet = eom.foot_points(torch.as_tensor(np.array(q, np.float64)),
                           params.get_subject(subject_name)).numpy()
    out = res.check_lcp(np.asarray(grf_z), feet[..., 2] - ground_z)
    out["loaded_foot_frames"] = int((np.asarray(grf_z) > 1e-6).sum())
    return out


def count_syncs(fn):
    """Run ``fn`` with the CUDA sync debug mode on "warn" and count the
    synchronizing calls it warned of. Returns (fn's result, count)."""
    import warnings

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message).lower() for w in seen)


def within(a, b, tol):
    """|a - b| <= tol |b|."""
    return abs(a - b) <= tol * abs(b)


def phase_options(dev, results, ref, cli_root, dset):
    """The estimator's solver options on one 4-camera trial
    (``render_options_trial``: 64 frames, camera 2 late by 0.4 frame
    periods) and on the stage-1 batch, against the JAX float64 runs of
    ``tests/data/jax_options_f64.json``:

    * ``init_trajectory(..., shutter_delay_estimation=True)`` and
      ``estimate_kinematics``: the live-shutter solve, then the joint
      (q, tau) solve (the kernel on 1 + 4 lanes per system). Gates: camera
      2's delay relative to cameras 1 and 3 within 0.05 h of the injected
      one (the JAX package's own test's bar); each tau within 0.01 h of the
      JAX float32 run's (JAX float32 misses its own float64 by ~0.13 h:
      the distance to float64 and the JAX test's |tau_1|, |tau_3| < 0.15 h
      are printed); MPJPE against the truth within 2 % of JAX float64's;
    * ``determine_contacts``, then ``estimate_kinetics(enable_lcp=True)``
      and ``estimate_kinetics(use_2d_reprojections=False)`` on the same
      trial: with the penalty on, ``check_lcp`` ok or its largest
      violation within ``TOL_LCP`` of the JAX run's (whose own check fails
      on this trial); each MPJPE within 2 % and CoM-velocity RMSE within
      5 % of JAX's;
    * the stage-1 batch (10 x 64) with ``driver="scan"`` and "while", the
      JAX test's schedule ((3, 8), (1, 20)) and ftol = 0: equal step
      counts per lane (28), mean MPJPE within 0.1 %; max |dq|, ms per step
      and host syncs per step (``count_syncs``) of each driver printed;
    * the serial path's first monocular trial of phase 9's tree in the
      data-driven mode with ``motion_prior_rolling`` 1 and 0: finite;
      MPJPE and MPE printed beside JAX float64's (not gated: monocular
      float32 does not reproduce itself).

    The kernel's launches per shape over the phase (no plain solve may
    run). Returns the launches by shape."""
    import pickle
    import tempfile

    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator as est
    from cheetah_pose_estimation_tpu_torch.pipeline import metrics
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    out, bad = {}, []
    work = tempfile.mkdtemp(prefix="options_")
    root, odir = os.path.join(work, "tree"), os.path.join(work, "out")
    truth = render_options_trial(root)
    h = truth["h"]
    t_phase = time.perf_counter()
    cuda_banded.reset_launches()
    with plain_solves_counted() as plain:
        # 1. the joint shutter-delay solve
        t0 = time.perf_counter()
        e = est.init_trajectory(root, OPTIONS_PATH, "phantom",
                                kinematic_model=True,
                                shutter_delay_estimation=True)
        ok = est.estimate_kinematics(e, out_dir_prefix=odir, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        shutter_shapes = dict(cuda_banded.launches_by_shape)
        tau, jk = [float(t) for t in e.shutter_delay], ref["kinematic"]
        jk32 = ref["kinematic_f32"]
        rel = tau[2] - 0.5 * (tau[1] + tau[3])
        sc = options_scores(e.q, truth)
        out["shutter"] = {"ok": ok, "tau": tau, "tau_rel": rel,
                          "wall_s": wall, "launches": shape_keys(
                              shutter_shapes), **sc}
        log(f"# options: shutter solve {wall:.2f} s, launches "
            f"{shape_keys(shutter_shapes)}; tau/h "
            f"{np.round(np.array(tau) / h, 4).tolist()} (JAX f64 "
            f"{np.round(np.array(jk['tau']) / h, 4).tolist()}, JAX f32 "
            f"{np.round(np.array(jk32['tau']) / h, 4).tolist()}), "
            f"relative delay {rel / h:.4f} h (injected {OPTIONS_TAU_H} h); "
            f"MPJPE {sc['mpjpe']:.3f} mm (JAX f64 {jk['mpjpe']:.3f}), MPE "
            f"{sc['mpe']:.3f}, CoM-vel {sc['com_vel_rmse']:.4f} m/s, "
            f"objective {e.obj_cost:.6g} (JAX {jk['obj_cost']:.6g})")
        e.solution_details()
        err = {r: max(abs(a - b) for a, b in zip(tau, ref_tau)) / h
               for r, ref_tau in (("f64", jk["tau"]), ("f32", jk32["tau"]))}
        side = lambda t: max(abs(t[1]), abs(t[3])) / h
        out["shutter"].update(tau_err_h=err, abs_tau_13_h=side(tau))
        log(f"# options: shutter: largest |tau - JAX| {err['f64']:.4f} h "
            f"from float64, {err['f32']:.4f} h from float32 (bar 0.01 h); "
            f"largest |tau_1|, |tau_3| {side(tau):.4f} h (the JAX test's bar "
            f"0.15 h: JAX f64 {side(jk['tau']):.4f}, JAX f32 "
            f"{side(jk32['tau']):.4f}; printed only)")
        # JAX float32 misses its own float64 delays by ~0.13 h along the
        # weakly observed common shift of cameras 1-3 against camera 0: the
        # delays are held to the JAX float32 run of the same problem
        if not (ok and abs(rel - truth["true_tau"]) < 0.05 * h
                and err["f32"] <= 0.01 and tau[0] == 0.0
                and within(sc["mpjpe"], jk["mpjpe"], TOL_MPJPE)
                and shutter_shapes.get((5, 64), 0) > 0):
            bad.append(("shutter", out["shutter"]))
        # 2. the physics stage with each option
        est.determine_contacts(e, out_dir_prefix=odir)
        for name, kw in (("lcp", dict(enable_lcp=True)),
                         ("track", dict(use_2d_reprojections=False))):
            t0 = time.perf_counter()
            ok = est.estimate_kinetics(e, out_dir_prefix=odir, save=False,
                                       device=dev, **kw)
            torch.cuda.synchronize()
            sc = options_scores(e.q, truth)
            lcp = lcp_summary(e.q, e.grf_z, e.params.ground_plane_height)
            jr = ref[name]
            out[name] = {"ok": ok, "wall_s": time.perf_counter() - t0,
                         "check_lcp": lcp, **sc}
            log(f"# options: kinetics {name} {out[name]['wall_s']:.2f} s: "
                f"MPJPE {sc['mpjpe']:.3f} mm (JAX f64 {jr['mpjpe']:.3f}), "
                f"CoM-vel {sc['com_vel_rmse']:.4f} m/s (JAX "
                f"{jr['com_vel_rmse']:.4f}), MPE {sc['mpe']:.3f}, "
                f"check_lcp {lcp} (JAX {jr['check_lcp']}), objective "
                f"{e.obj_cost:.6g} (JAX {jr['obj_cost']:.6g})")
            # the JAX float64 run's own check_lcp fails on this trial (its
            # largest violation, 0.14, is over the check's 0.01): the port's
            # passes, or its largest violation is within TOL_LCP of JAX's
            lcp_ok = lcp["ok"] or lcp["max_violation"] <= (
                1.0 + TOL_LCP) * jr["check_lcp"]["max_violation"]
            if not (ok and within(sc["mpjpe"], jr["mpjpe"], TOL_MPJPE)
                    and within(sc["com_vel_rmse"], jr["com_vel_rmse"],
                               TOL_COMVEL)
                    and (name != "lcp" or lcp_ok)):
                bad.append((name, out[name]))
        # 3. the drivers on the stage-1 batch
        batched, q0, trials, subject = bench_lib.build_batch(
            max_trials=10, n_frames=64, device=dev)
        fpss = [f for _, _, f in bench_lib.load_reference_trajectories(10)]
        fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
        drivers = {}
        for driver in ("scan", "while"):
            run = fte.make_solver(stages=((3.0, 8), (1.0, 20)), ftol=0.0,
                                  driver=driver)
            t0 = time.perf_counter()
            st = run(q0, batched)
            torch.cuda.synchronize()
            steps = int(st.it.max())
            ms = (time.perf_counter() - t0) * 1e3 / steps
            # a second run, its tables on the card already: the syncs the
            # loop itself makes
            _, syncs = count_syncs(lambda: run(q0, batched))
            err = [r[1] for r in bench_lib.score_per_trial(
                st.q.double().cpu().numpy(), trials, fpss, subject)]
            drivers[driver] = {"it": st.it.tolist(), "ms_per_step": ms,
                               "syncs_per_step": syncs / steps,
                               "mpjpe": float(np.mean(err)), "q": st.q}
            log(f"# options: driver {driver}: steps {st.it.tolist()}, "
                f"{ms:.3f} ms per step, {syncs} host syncs "
                f"({syncs / steps:.2f} per step), mean MPJPE "
                f"{np.mean(err):.4f} mm")
        dq = float((drivers["scan"].pop("q") - drivers["while"].pop("q"))
                   .abs().max())
        out["drivers"] = dict(drivers, max_abs_dq=dq)
        log(f"# options: drivers max |dq| {dq:.3e}")
        if not (drivers["scan"]["it"] == drivers["while"]["it"]
                == [28] * len(drivers["scan"]["it"])
                and within(drivers["scan"]["mpjpe"], drivers["while"]["mpjpe"],
                           1e-3)):
            bad.append(("drivers", out["drivers"]))
        # 4. the rolling AR refinement on the serial path's first trial
        cheetah, date, name = run_dataset.TEST_SET[0]
        path = os.path.join(date, cheetah, name)
        with open(os.path.join(cli_root, path, "synthetic_gt.pickle"),
                  "rb") as f:
            true = pickle.load(f)["positions"]
        jr = ref["rolling"]
        for r in (1, 0):
            t0 = time.perf_counter()
            e = est.init_trajectory(cli_root, path, cheetah,
                                    monocular_enable=True,
                                    kinematic_model=True)
            ok = est.estimate_kinematics(
                e, monocular_constraints=True, data_driven_dataset=dset,
                motion_prior_rolling=r, save=False, device=dev)
            torch.cuda.synchronize()
            pos = options_positions(e.q, cheetah)
            mj = metrics.traj_error(true, pos, centered=True)[0].mean()
            me = metrics.traj_error(true, pos)[0].mean()
            out[f"rolling_{r}"] = {"ok": ok, "mpjpe": float(mj),
                                   "mpe": float(me),
                                   "wall_s": time.perf_counter() - t0}
            jj = jr[f"rolling_{r}"]
            log(f"# options: data-driven {path} motion_prior_rolling={r} "
                f"{out[f'rolling_{r}']['wall_s']:.2f} s: MPJPE {mj:.3f} mm "
                f"(JAX f64 {jj['mpjpe']:.3f}), MPE {me:.3f} mm (JAX f64 "
                f"{jj['mpe']:.3f})")
            if not (ok and np.isfinite(e.q).all()):
                bad.append((f"rolling_{r}", out[f"rolling_{r}"]))
    by_shape = dict(cuda_banded.launches_by_shape)
    out.update(plain_solves=plain, launches=shape_keys(by_shape),
               wall_s=time.perf_counter() - t_phase)
    log(f"# options: phase {out['wall_s']:.2f} s, kernel launches "
        f"{shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        bad.append(("plain solves on the card", plain))
    untimed = sorted(set(by_shape) - set(
        OPTIONS_SHAPES + SHAPES + SERIAL_SHAPES))
    if untimed:
        bad.append(("shapes not timed in phase 3", untimed))
    results["options"] = out
    if bad:
        raise AssertionError(f"options: {bad}")
    return by_shape


def options_positions(q, subject_name):
    """Marker positions (N, 24, 3) of a solved trajectory q (N, 54), in
    float64 on the CPU."""
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.models import skeleton as sk

    return sk.fk_markers(torch.as_tensor(np.array(q, np.float64)),
                         params.get_subject(subject_name)).numpy()


# -- phase 16: the dynamics tools and the remaining prior options ------------

TOL_TASK = 0.02          # task scores against JAX (sweep_gate's bar)
TOL_DROP = 1e-4          # drop-test base path to the first contact, metres
TOL_DROP_STATE = 1e-3    # drop-test base height and feet at the cut, metres
# the drop test's depth: 0.1 s of the JAX reference's 0.6 s (the smoke's
# time limit): the fall, the first contact at 0.048 s and the landing; the
# reference recorded its state there
DROP_DURATION = 0.1
TOL_THROW = 2e-3         # CoM free fall, metres (tests/test_simulate.py)
DYNAMICS_SHAPES = ((1, 40), (1, 44))
# the line-scan finish on phase 7's scan: two stages at the judge's own
# scale, the second restarting the damping (so each accepted step lowers
# the prior-free cost the gate compares); phase 7's scan accepts no lane,
# so these trials are first pushed LINESCAN_PUSH_M back along their camera
# rays (the CPU tests' setting)
LINESCAN_FINISH = ((1.0, 30), (1.0, 30))
LINESCAN_PUSHED = (0, 3, 6)
LINESCAN_PUSH_M = 0.3
# the gallop's depth: its first EARLY_STEPS LM steps of the JAX defaults'
# 200 (the smoke's time limit); its cost after 200 steps does not reproduce
# in float32, after 20 it does, and JAX recorded both depths
# (tests/data/jax_dynamics_reference.py)
EARLY_STEPS = 20
TASK_SCORES = {"stop": ("cost", "stop_distance", "final_speed"),
               "gallop": ("cost", "stride_length", "avg_speed",
                          "periodicity_error", "eom_rms_bw")}


def task_gate(port, jax_f64, jax_f32, tol=TOL_TASK):
    """Agreement of one task score of the port's float32 run with JAX
    float64's: within ``tol`` of it, either way. Where JAX float32 itself
    misses its float64 by more than ``tol`` (the score does not reproduce
    in float32: the gallop's cost after its 200 unconverged steps), the value
    is printed beside both and not gated (``sweep_gate``'s rule)."""
    rel = (port - jax_f64) / abs(jax_f64)
    f32 = (jax_f32 - jax_f64) / abs(jax_f64)
    aside = abs(f32) > tol
    return {"port": port, "jax_f64": jax_f64, "jax_f32": jax_f32,
            "rel_f64": rel, "rel_f32": (port - jax_f32) / abs(jax_f32),
            "jax_f32_vs_f64": f32, "set_aside": aside,
            "ok": aside or abs(rel) <= tol, "tol": tol}


def log_task_gate(name, key, g):
    log(f"# dynamics agree: {name} {key}: port {g['port']:.6g} jax_f64 "
        f"{g['jax_f64']:.6g} jax_f32 {g['jax_f32']:.6g} (rel f64 "
        f"{g['rel_f64']:+.4f}, rel f32 {g['rel_f32']:+.4f}, jax f32 vs f64 "
        f"{g['jax_f32_vs_f64']:+.4f}, bar ±{g['tol']}"
        + (", set aside: JAX f32 misses its f64)" if g["set_aside"]
           else ")") + ("" if g["ok"] else " FAILS"))


def task_bars(name, out, subject):
    """The bars of the JAX package's own test (``tests/test_tasks.py:17-65``)
    at the task's defaults, on a result of the port (foot heights in
    float64 on the host)."""
    from cheetah_pose_estimation_tpu_torch.dynamics import eom

    q = out["q"]
    heights = eom.foot_points(torch.as_tensor(q), subject)[..., 2].numpy()
    bars = {"finite": bool(np.isfinite(q).all()),
            "accepted": out["accepted"] > 5,
            "eom_rms_bw": out["eom_rms_bw"] < 0.5}
    if name == "stop":
        bars.update(start_speed=abs(out["dq"][1, 0] + 10.0) <= 0.5,
                    final_speed=out["final_speed"] < 1.0,
                    moved_forward=bool(q[-1, 0] < q[0, 0]),
                    feet_down=float(heights[12:].max()) < 0.3,
                    penetration=float(heights.min()) > -0.1)
    else:
        bars.update(avg_speed=abs(out["avg_speed"] - 14.0) <= 1.4,
                    periodicity=out["periodicity_error"] < 0.15,
                    grf_z=float(out["grf_z"].max()) > 0.2)
    return bars, {"foot_height_min": float(heights.min()),
                  "foot_height_max_after_12": float(heights[12:].max()),
                  "grf_z_max": float(out["grf_z"].max())}


def first_task_system(dev):
    """The stop task's first LM system at its defaults on the card: the
    task and q0 that ``high_speed_stop`` makes (its solve not run), the
    normal at q0, damped at lam = 1e-2 and Jacobi-scaled as
    ``gn.scaled_system`` does."""
    from cheetah_pose_estimation_tpu_torch.dynamics import tasks
    from cheetah_pose_estimation_tpu_torch.solver import gn

    got = {}
    solve = tasks.TrajectoryTask.solve

    def grab(self, q0, max_iters=None, ftol=1e-10):
        got.update(task=self, q0=np.asarray(q0))
        raise StopIteration

    tasks.TrajectoryTask.solve = grab
    try:
        tasks.high_speed_stop(device=dev)
    except StopIteration:
        pass
    finally:
        tasks.TrajectoryTask.solve = solve
    q0 = torch.as_tensor(got["q0"], dtype=torch.float32, device=dev)[None]
    g, H = got["task"]._normal(q0)
    Hs, rhs, _ = gn.scaled_system(g, H, torch.full((1,), 1e-2, device=dev),
                                  1e-8)
    return Hs.diag.contiguous(), Hs.lower.contiguous(), rhs.contiguous()


def phase_dynamics(dev, results, ref, dd_scan):
    """The dynamics tools and the remaining prior options on the card, at
    full width (17 links, 54 DoF, the acinoset subject), against the JAX
    runs of ``tests/data/jax_dynamics_f64.json``:

    * the kernel on the stop task's first normal system (lam = 1e-2)
      against the plain version in float64, rel error <= 7e-4;
    * ``tasks.high_speed_stop()`` at the JAX defaults (1x40, 200 LM steps
      at most, float32) and ``periodic_gallop()`` at them cut to its first
      ``EARLY_STEPS`` steps (1x44): the bars of the JAX package's own test
      that JAX float64 meets at the same depth (the rest printed), and
      each score within 2 % of JAX float64's at the same depth, printed
      and not gated where JAX float32 misses its float64 by more
      (``task_gate``);
    * ``simulate.drop_test(initial_height=0.8, duration=DROP_DURATION)``
      (0.1 s of the JAX reference's 0.6: its record at 0.1 s is the
      reference): upright, base height in (0.2, 0.8) m, lowest foot below
      0.1 m, the base path within 1e-4 m of JAX float64's up to JAX's
      first foot contact, the final base height and feet within 1e-3 m of
      JAX float64's state at ``DROP_DURATION``; the
      ballistic throw of ``tests/test_simulate.py``: CoM within 2e-3 m of
      free fall; ms per RK4 step, and the launches per derivative from a
      profiled 20-step window;
    * ``pca.fit`` on the procedural training table and
      ``train_motion_model(pose_model=...)`` on the card: the principal
      axes within 1e-8 and the AR coefficients within 1e-6 (relative) of
      JAX float64's;
    * phase 7's 70-lane line-scan (its input recorded in phase 7, trials
      ``LINESCAN_PUSHED`` moved ``LINESCAN_PUSH_M`` back along their rays)
      with and without ``finish_stages=LINESCAN_FINISH``: the same shifts,
      some lane accepted, the others returned bit for bit, and on each
      accepted lane the finished prior-free cost <= the unfinished.

    The kernel's launches per shape over the tasks and the line-scans
    (none may be a plain solve; each task's shape > 0). Returns the
    launches by shape."""
    from cheetah_pose_estimation_tpu_torch.dynamics import simulate, tasks
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.models import skeleton as sk
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.priors import armodel, pca

    out, bad = {}, []
    subject = params.get_subject("acinoset")
    t_phase = time.perf_counter()
    # 1. the kernel on the first task system (not counted)
    d32, l32, r32 = first_task_system(dev)
    x = cuda_banded.solve(d32, l32, r32)
    torch.cuda.synchronize()
    xr = cuda_banded.solve_reference(d32.double(), l32.double(),
                                     r32.double())
    abs_err = float((x.double() - xr).abs().max())
    rel = abs_err / float(xr.abs().max())
    out["kernel"] = {"rel_err": rel, "max_abs_err": abs_err}
    log(f"# dynamics: kernel on the stop task's first system (1x40, lam "
        f"1e-2): rel err {rel:.3e}, max abs err {abs_err:.3e}")
    if not (torch.isfinite(x).all() and rel <= TOL_REL):
        bad.append(("kernel", out["kernel"]))

    cuda_banded.reset_launches()
    with plain_solves_counted() as plain:
        # 2. the trajectory-generation tasks
        for name, build, shape, kw, key in (
                ("stop", tasks.high_speed_stop, (1, 40), {}, "stop"),
                ("gallop", tasks.periodic_gallop, (1, 44),
                 {"max_iters": EARLY_STEPS}, "gallop20")):
            before = cuda_banded.launches_by_shape.get(shape, 0)
            t0 = time.perf_counter()
            r = build(device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = cuda_banded.launches_by_shape.get(shape, 0) - before
            bars, extra = task_bars(name, r, subject)
            j64, j32 = ref[f"{key}_f64"], ref[f"{key}_f32"]
            gates = {k: task_gate(float(r[k]), j64[k], j32[k])
                     for k in TASK_SCORES[name]}
            rec = {"wall_s": wall, "iterations": r["iterations"],
                   "accepted": r["accepted"], "launches": n,
                   "ms_per_step": wall * 1e3 / max(r["iterations"], 1),
                   "eom_rms_bw": r["eom_rms_bw"], "bars": bars,
                   "jax_f64_bars": j64["bars"], "gates": gates, **extra}
            out[name] = rec
            log(f"# dynamics: {name} {wall:.2f} s, {r['iterations']} steps "
                f"({r['accepted']} accepted; JAX f64 {j64['iterations']} / "
                f"{j64['accepted']}, f32 {j32['iterations']} / "
                f"{j32['accepted']}), {rec['ms_per_step']:.1f} ms a step, "
                f"launches at {shape[0]}x{shape[1]} {n}; eom_rms_bw "
                f"{r['eom_rms_bw']:.4f} (JAX f64 {j64['eom_rms_bw']:.4f}); "
                f"{extra}")
            for k, g in gates.items():
                log_task_gate(name, k, g)
            for k, ok in bars.items():
                jok = j64["bars"].get(k)
                log(f"# dynamics: {name} bar {k}: port {ok}, JAX f64 {jok}"
                    + ("" if jok else " (printed: JAX f64 misses it)"))
            missed = [k for k, ok in bars.items()
                      if j64["bars"].get(k) and not ok]
            if missed or not all(g["ok"] for g in gates.values()) \
                    or n == 0:
                bad.append((name, {"missed_bars": missed, "gates": gates,
                                   "launches": n}))
        # 3. the line-scan finish on phase 7's scan
        out["linescan"] = linescan_finish(dev, dd_scan, bad)
    by_shape = dict(cuda_banded.launches_by_shape)
    out.update(plain_solves=plain, launches=shape_keys(by_shape))
    log(f"# dynamics: kernel launches {shape_keys(by_shape)}, plain banded "
        f"solves {plain}")
    if sum(plain.values()):
        bad.append(("plain solves on the card", plain))
    untimed = sorted(set(by_shape) - set(SHAPES + SERIAL_SHAPES
                                         + ACINOSET_SHAPES))
    if untimed:
        bad.append(("shapes not timed in phase 3", untimed))

    # 4. the simulator: the drop test, the ballistic throw, a profiled window
    jd = ref["sim"]["drop"]
    t0 = time.perf_counter()
    d = simulate.drop_test(subject, initial_height=0.8,
                           duration=DROP_DURATION, device=dev)
    torch.cuda.synchronize()
    drop_s = time.perf_counter() - t0
    steps = int(round(DROP_DURATION / 2e-4))
    k = jd["first_contact_record"]
    path_err = float(np.abs(d["q"][:k + 1, :3]
                            - np.asarray(jd["base_xyz"])[:k + 1]).max())
    # JAX float64's state at the cut (its records are 20 steps apart)
    j_end = int(round(DROP_DURATION / (20 * 2e-4)))
    j_height = float(jd["base_xyz"][j_end][2])
    j_feet = np.asarray(jd["foot_heights"][j_end])
    end_err = max(abs(d["final_base_height"] - j_height),
                  float(np.abs(d["final_foot_heights"] - j_feet).max()))
    out["drop"] = {"wall_s": drop_s, "ms_per_rk4_step": drop_s * 1e3 / steps,
                   "final_base_height": d["final_base_height"],
                   "upright": d["upright"],
                   "final_foot_heights": d["final_foot_heights"].tolist(),
                   "base_path_err_to_contact": path_err,
                   "first_contact_record": k, "state_err_at_cut": end_err}
    log(f"# dynamics: drop test {drop_s:.2f} s ({steps} RK4 steps, "
        f"{out['drop']['ms_per_rk4_step']:.3f} ms a step): final base "
        f"height {d['final_base_height']:.4f} m at {DROP_DURATION} s (JAX "
        f"f64 {j_height:.4f}), upright {d['upright']}, feet "
        f"{np.round(d['final_foot_heights'], 4).tolist()} (JAX f64 "
        f"{np.round(j_feet, 4).tolist()}), within {end_err:.2e} m of JAX "
        f"f64 there; base path to the first contact (record {k}) within "
        f"{path_err:.2e} m of JAX f64")
    if not (d["upright"] and 0.2 < d["final_base_height"] < 0.8
            and d["final_foot_heights"].min() < 0.1
            and np.isfinite(d["q"]).all() and path_err <= TOL_DROP
            and end_err <= TOL_DROP_STATE):
        bad.append(("drop", out["drop"]))
    q0 = simulate.drop_pose(subject, height=3.0)
    dq0 = np.zeros(54)
    dq0[0] = 4.0
    t0 = time.perf_counter()
    q, _ = simulate.simulate(subject, q0, dq0, 0.2, dt=5e-4, record_every=40,
                             device=dev)
    throw_s = time.perf_counter() - t0
    com = [sk.com_position(torch.as_tensor(q[i]), subject).numpy()
           for i in (0, -1)]
    t = (q.shape[0] - 1) * 40 * 5e-4
    err = float(np.abs(com[1] - com[0] - np.array(
        [4.0 * t, 0.0, -0.5 * 9.81 * t ** 2])).max())
    out["throw"] = {"wall_s": throw_s, "com_err": err,
                    "jax_f64_com_err": ref["sim"]["throw"]["err"]}
    log(f"# dynamics: ballistic throw {throw_s:.2f} s: CoM {err:.3e} m from "
        f"free fall (JAX f64 {ref['sim']['throw']['err']:.3e}; bar "
        f"{TOL_THROW})")
    if err > TOL_THROW:
        bad.append(("throw", out["throw"]))
    prof = profiled(lambda: simulate.simulate(
        subject, q0, dq0, 20 * 2e-4, record_every=20, device=dev),
        float("nan"))
    out["sim_profile"] = {"launches_per_derivative":
                          prof["device_kernel_launches"] / 80,
                          "device_s_per_rk4_step": prof["device_s"] / 20,
                          "wall_profiled_s_per_rk4_step":
                          prof["wall_profiled_s"] / 20,
                          "top_kernels": prof["top_kernels_share_of_device"]}
    log(f"# dynamics profile: 20 RK4 steps: {out['sim_profile']}")

    # 5. the PCA pose model and the AR model in its space
    t0 = time.perf_counter()
    train = bench_lib.procedural_pose_table(bench_lib.TRAIN_SEEDS)
    val = bench_lib.procedural_pose_table(bench_lib.VAL_SEEDS)
    pm = pca.fit(train)
    mm = armodel.train_motion_model(train, validation=val, pose_model=pm,
                                    device=dev)
    torch.cuda.synchronize()
    jp, ja = ref["priors"]["pca"], ref["priors"]["ar"]
    rel_rows = lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()
                                  / np.abs(np.asarray(b)).max())
    out["priors"] = {"wall_s": time.perf_counter() - t0,
                     "pca_P_rel": rel_rows(pm.P, jp["P"]),
                     "pca_rmse": pm.rmse, "jax_pca_rmse": jp["rmse"],
                     "ar_coef_rel": rel_rows(mm.coef, ja["coef"]),
                     "ar_intercept_rel": rel_rows(mm.intercept,
                                                  ja["intercept"]),
                     "ar_rmse": [mm.train_rmse, mm.validation_rmse],
                     "jax_ar_rmse": [ja["train_rmse"],
                                     ja["validation_rmse"]]}
    log(f"# dynamics: priors {out['priors']}")
    if not (out["priors"]["pca_P_rel"] <= 1e-8
            and out["priors"]["ar_coef_rel"] <= TOL_AR
            and out["priors"]["ar_intercept_rel"] <= TOL_AR):
        bad.append(("priors", out["priors"]))
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"# dynamics: phase {out['wall_s']:.2f} s")
    results["dynamics"] = out
    if bad:
        raise AssertionError(f"dynamics: {bad}")
    return by_shape


def linescan_finish(dev, rec, bad):
    """Phase 7's line-scan input with trials ``LINESCAN_PUSHED`` moved
    ``LINESCAN_PUSH_M`` back along their rays, scanned with and without the
    finish (``phase_dynamics``); failures go to ``bad``."""
    from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin

    subject, batched = rec["subject"], rec["batched"]
    q = rec["q"].clone()
    rays = np.array(rec["rays"])
    qn = q.double().cpu().numpy()
    R, tc = (x.cpu().numpy() for x in (batched.cam.R, batched.cam.t))
    for i in LINESCAN_PUSHED:
        qn[i, :, :3] += LINESCAN_PUSH_M * rays[i]
        rays[i] = depth_anchor.camera_ray(qn[i], R[i, 0], tc[i, 0])
    # their body-scale medians anew, as run_data_driven makes them
    med = np.array(rec["scale_med"], np.float64)
    cpu = kin.map_data(lambda x: x.double().cpu().numpy()
                       if torch.is_tensor(x) else x, batched)
    n_real = cpu.frame_valid.sum(1).astype(int)
    for i in LINESCAN_PUSHED:
        n = n_real[i]
        med[i] = depth_anchor.scale_median(
            qn[i, :n], subject, cpu.meas[i, :n, 0], cpu.weight[i, :n, 0],
            *[x[i, 0] for x in (cpu.cam.K, cpu.cam.D, cpu.cam.R,
                                cpu.cam.t)])
    q = torch.as_tensor(qn, dtype=q.dtype, device=dev)
    runs = {}
    for name, kw in (("plain", {}),
                     ("finish", {"finish_stages": LINESCAN_FINISH})):
        scan = depth_anchor.make_depth_linescan(subject, **kw)
        t0 = time.perf_counter()
        runs[name] = scan(q, batched, rays, med)
        torch.cuda.synchronize()
        runs[name] += (time.perf_counter() - t0,)
    (qp, sp, wp), (qf, sf, wf) = runs["plain"], runs["finish"]
    judge = kin.KinematicFTE(kin.KinematicConfig(fisheye=True, robust=True),
                             subject)
    cp = judge._cost(qp, batched, 1.0).double().cpu().numpy()
    cf = judge._cost(qf, batched, 1.0).double().cpu().numpy()
    acc = sf != 0.0
    kept = all(torch.equal(qf[i], q[i]) for i in np.flatnonzero(~acc))
    res = {"shifts": sf.tolist(), "shifts_plain": sp.tolist(),
           "wall_s": [wp, wf], "cost_unfinished": cp[acc].tolist(),
           "cost_finished": cf[acc].tolist(), "unaccepted_kept": kept}
    log(f"# dynamics: line-scan on phase 7's {rec['B'] * 7} lanes (trials "
        f"{list(LINESCAN_PUSHED)} pushed {LINESCAN_PUSH_M} m back), finish "
        f"{LINESCAN_FINISH}: shifts {sf.tolist()} (without the finish "
        f"{sp.tolist()}), {wp:.2f} / {wf:.2f} s; prior-free cost on the "
        f"accepted lanes {np.round(cp[acc], 3).tolist()} -> "
        f"{np.round(cf[acc], 3).tolist()}; unaccepted lanes returned bit "
        f"for bit: {kept}")
    if not (np.array_equal(sf, sp) and acc.any() and kept
            and (cf[acc] <= cp[acc]).all()):
        bad.append(("linescan", res))
    return res


# -- phase 17: the response studies and the rest of the results layer -------

# the sweeps' depth (the JAX reference's sweeps parts,
# tests/data/jax_responses_reference.py SMOKE_DEADBAND / SMOKE_LEVERS)
RESPONSE_SWEEP = dict(n_frames=48, max_trials=2)
RESPONSE_DEADBANDS = dict(base_deadbands=(None, 0.05), grf_maxes=(5.0,))
RESPONSE_LEVERS = {
    "production": {},
    "overrides": {"meas_guard": 0.0, "_stages": ((3.0, 10), (1.0, 20)),
                  "_lam0": 0.5, "_perturb": 0.02},
}
FVG_TRIALS = 10
FVG_VARIANTS = ("default", "chain", "dd_gated", "dd_forced")
FVG_METRICS = (("mpe", TOL_MPJPE), ("mpjpe", TOL_MPJPE),
               ("cvr", TOL_COMVEL))
RESPONSE_SHAPES = ((30, 64), (10, 64), (6, 48), (2, 48))


def fvg_agree(rows, rep, ref):
    """The forced-vs-gated bench's per-variant means, before and after the
    anchor, against the JAX float32 run's (``ref``: the ``fvg`` part of
    ``tests/data/jax_responses_f64.json``), each by ``cli_gap`` within 2 %
    (CoM-velocity 5 %) either way, as it is or once the witnessed trials
    are set aside: (a) the port's value is the lower one and its prior-free
    multistart, the start of every variant, reached a lower prior-free cost
    than JAX float32's (``c_free``), or (b) where the JAX float64 run was
    recorded, JAX float32 misses its own float64 on that trial by more than
    the bar. The gap to JAX float64 is printed where it was recorded.
    Returns (the gates, the failures)."""
    j32, j64 = ref["f32"], ref.get("f64") or {}
    if not j32.get("rows"):
        log("# responses agree: fvg: no JAX float32 record: printed only")
        return [], []
    gates, bad = [], []
    for v in FVG_VARIANTS:
        for suffix in ("", "_anch"):
            for m, tol in FVG_METRICS:
                k = f"{m}_{v}{suffix}"
                port = np.array([r[k] for r in rows])
                jx = np.array([r[k] for r in j32["rows"]])
                unstable = None
                if j64.get("rows"):
                    jo = np.array([r[k] for r in j64["rows"]])
                    unstable = np.abs(jx - jo) > tol * np.abs(jo)
                g = dict(cli_gap(port, jx, rep["c_free"], j32["c_free"],
                                 [True] * len(port), unstable), tol=tol,
                         column=k)
                if j64.get("rows"):
                    g["rel_f64"] = float(port.mean() / jo.mean() - 1.0)
                gates.append(g)
                ok = min(abs(g["rel"]), abs(g["rel_unexplained"])) <= tol
                if not ok:
                    bad.append(g)
                log(f"# responses agree: fvg {k}: port {g['port']:.4f} "
                    f"jax_f32 {g['jax_f32']:.4f} (rel {g['rel']:+.4f}; "
                    f"witnessed {g['witnessed']} (objective "
                    f"{g['witnessed_objective']}, reference unstable "
                    f"{g['witnessed_unstable']}), unexplained "
                    f"{g['rel_unexplained']:+.4f}, bar ±{tol})"
                    + (f", vs jax_f64 {g['rel_f64']:+.4f}"
                       if "rel_f64" in g else ", jax_f64 not recorded")
                    + ("" if ok else " FAILS"))
    return gates, bad


def jax_warm_start(rec):
    """The JAX run's shared warm start (mean MPE mm, CoM-vel m/s) from its
    sweeps part ``rec`` (a deadband row's warm columns, else the lever
    sweep's first scores), None where neither was recorded."""
    rows = rec["deadband"].get("rows") or []
    if rows:
        return {"mpe": rows[0]["mpe_warm_mm"],
                "comvel": rows[0]["comvel_warm"]}
    scores = rec["levers"].get("scores") or []
    if scores:
        w = scores[0][0]
        return {"mpe": float(np.mean([t[0] for t in w])),
                "comvel": float(np.mean([t[2] for t in w]))}
    return None


def sweep_rows_agree(name, rows, jax, label_key, keys, bad):
    """A response sweep's unrounded rows against the JAX float64 and
    float32 runs' (``jax``: per dtype the part's ``rows`` as far as it got):
    each column of ``keys`` ((column, bar)) of a row both recorded by
    ``sweep_gate``, and the whole row printed, not gated, where JAX
    float32 misses its own float64 on any of them (the row does not
    reproduce in float32: its columns come from one solve); a row either
    run did not record is printed, not gated. Gate failures go to
    ``bad``. Returns the gates."""
    rec = {d: {r[label_key]: r for r in (jax.get(d) or {}).get("rows", [])}
           for d in ("f64", "f32")}
    gates = []
    for raw in rows:
        lab = raw[label_key]
        j64, j32 = rec["f64"].get(lab), rec["f32"].get(lab)
        if j64 is None or j32 is None:
            log(f"# responses agree: {name} {lab}: port "
                + ", ".join(f"{k} {raw[k]:.4f}" + (
                    f" (jax_f64 {j64[k]:.4f})" if j64 else "")
                    for k, _ in keys)
                + " (JAX float64 or float32 not recorded: printed, not "
                "gated)")
            continue
        row = [dict(sweep_gate(raw[k], j64[k], j32[k], tol), study=name,
                    row=lab, column=k) for k, tol in keys]
        if any(g["set_aside"] for g in row):
            for g in row:
                g.update(set_aside=True, ok=True)
        for g in row:
            k = g["column"]
            gates.append(g)
            log(f"# responses agree: {name} {lab} {k}: port "
                f"{g['port']:.4f} jax_f64 {g['jax_f64']:.4f} jax_f32 "
                f"{g['jax_f32']:.4f} "
                + f"(rel {g['rel_f64']:+.4f}, bar ±{g['tol']}"
                + (", set aside: JAX f32 misses its f64)" if g["set_aside"]
                   else ")") + ("" if g["ok"] else " FAILS"))
            if not g["ok"]:
                bad.append(g)
    return gates


@contextlib.contextmanager
def physics_batches_kept():
    """Keep what ``bench_lib.build_physics_batch`` returns inside the block
    (into the yielded list); every call runs as it would."""
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib

    kept = []
    orig = bench_lib.build_physics_batch

    def build(*a, **k):
        out = orig(*a, **k)
        kept.append(out)
        return out

    bench_lib.build_physics_batch = build
    try:
        yield kept
    finally:
        bench_lib.build_physics_batch = orig


def response_kernel_check(dev, kbat, qw):
    """The kernel on the deadband sweep's first kinetic system (the
    ``"floor"`` configuration at the warm start, the first stage's scale 3,
    lam = 1e-2) against the plain version in float64."""
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.solver import gn
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin
    from cheetah_pose_estimation_tpu_torch.solver import kinetic as kn

    fte = kn.KineticFTE(kn.KineticConfig(use_gmm=True, base_deadband=None,
                                         grf_max=5.0),
                        params.get_subject("acinoset"))
    b = kbat.base
    floor = torch.clamp(torch.diagonal(kin.acc_banded(
        b.h, b.acc_weight, b.frame_valid).diag, dim1=-2, dim2=-1), min=1e-8)
    g, H = fte._normal(qw, kbat, 3.0,
                       eom_blocks=fte.eom_curvature_blocks(qw, kbat))
    Hs, rhs, _ = gn.scaled_system(g, H, torch.full((qw.shape[0],), 1e-2,
                                                   device=dev), floor)
    d32, l32, r32 = (x.contiguous() for x in (Hs.diag, Hs.lower, rhs))
    x = cuda_banded.solve(d32, l32, r32)
    torch.cuda.synchronize()
    ref64 = cuda_banded.solve_reference(d32.double(), l32.double(),
                                        r32.double())
    abs_err = float((x.double() - ref64).abs().max())
    kern = {"systems": "deadband sweep, first kinetic system", "B":
            d32.shape[0], "N": d32.shape[1], "lam": 1e-2,
            "rel_err": abs_err / float(ref64.abs().max()),
            "max_abs_err": abs_err}
    log(f"# responses: kernel {kern}")
    if not (torch.isfinite(x).all() and kern["rel_err"] <= TOL_REL):
        raise AssertionError(f"kernel on the kinetic system: {kern}")
    return kern


def response_studies(dev, ref, dset, work):
    """The three response studies (phase 17's main path) on the card with
    their reports, the kernel counted per study; then their checks.
    Returns (launches per shape, the phase's record, its failures)."""
    import csv

    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.pipeline import studies

    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    out, bad, reps, per = {}, [], {}, {}
    csvs = {"fvg": os.path.join(work, "forced_vs_gated.csv"),
            "deadband": os.path.join(work, "deadband_sweep.csv"),
            "levers": os.path.join(work, "physics_lever_sweep.csv")}
    runs = {
        "fvg": lambda rep: studies.run_forced_vs_gated_bench(
            out_csv=csvs["fvg"], report=rep),
        "deadband": lambda rep: studies.run_deadband_sweep(
            out_dir=work, report=rep, **RESPONSE_DEADBANDS,
            **RESPONSE_SWEEP),
        "levers": lambda rep: studies.run_physics_lever_sweep(
            out_csv=csvs["levers"], variants=RESPONSE_LEVERS, report=rep,
            **RESPONSE_SWEEP)}
    rows = {}
    cuda_banded.reset_launches()
    t_all = time.perf_counter()
    with plain_solves_counted() as plain, physics_batches_kept() as kept:
        for name, run in runs.items():
            before = dict(cuda_banded.launches_by_shape)
            reps[name] = {}
            t0 = time.perf_counter()
            rows[name] = run(reps[name])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {s: n - before.get(s, 0) for s, n in
                        cuda_banded.launches_by_shape.items()
                        if n - before.get(s, 0)}
            per[name] = {"wall_s": wall,
                         "lm_steps": int(sum(launches.values())),
                         "launches_by_shape": shape_keys(launches)}
            log(f"# responses: {name}: wall {wall:.2f} s, kernel launches "
                f"{per[name]['launches_by_shape']}")
            if not launches:
                bad.append(("no kernel launch", name))
    out["wall_s"] = time.perf_counter() - t_all
    by_shape = dict(cuda_banded.launches_by_shape)
    log(f"# responses: main path {out['wall_s']:.2f} s, kernel launches "
        f"{shape_keys(by_shape)}, plain banded solves {plain}")
    if sum(plain.values()):
        raise AssertionError(f"the response studies ran plain banded solves "
                             f"on the card: {plain}")
    untimed = sorted(set(by_shape) - set(SHAPES + STUDY_SHAPES))
    if untimed:
        raise AssertionError(f"shapes not timed in phase 3: {untimed}")
    out["studies"] = per

    # 1. the forced-vs-gated bench: form and the gate's own arithmetic
    fvg, rep = rows["fvg"], reps["fvg"]
    with open(csvs["fvg"], encoding="utf-8", newline="") as f:
        table = list(csv.reader(f))
    jcols = (ref["fvg"]["f32"] or ref["small"]["fvg"])["columns"]
    names = [r["trial"] for r in fvg]
    vals = [r[c] for r in fvg for c in jcols[3:]]
    if table[0] != jcols or names != [f"synthetic_gallop_{i}" for i in
                                      range(FVG_TRIALS)] \
            or len(table) != FVG_TRIALS + 1 or not np.isfinite(vals).all():
        bad.append(("fvg form", table[0], names))
    c_chain, c_free = np.array(rep["c_chain"]), np.array(rep["c_free"])
    gate = estimator.prior_gate_accept(c_chain, c_free, 1.10)
    if [r["ratio"] for r in fvg] != (c_chain / c_free).tolist() \
            or [r["gate"] for r in fvg] != gate.tolist():
        bad.append(("fvg gate arithmetic", [r["ratio"] for r in fvg]))
    for i, r in enumerate(fvg):
        if not r["gate"] and any(r[f"{m}_dd_gated"] != r[f"{m}_default"]
                                 for m in ("mpe", "mpjpe", "cvr")):
            bad.append(("fvg: a rejected trial's dd_gated is not default",
                        r["trial"]))
        for v in FVG_VARIANTS:
            if not rep["anchor"][v]["accept"][i] and any(
                    r[f"{m}_{v}_anch"] != r[f"{m}_{v}"]
                    for m in ("mpe", "mpjpe", "cvr")):
                bad.append(("fvg: an unaccepted anchor changed", v,
                            r["trial"]))
    j32 = ref["fvg"]["f32"]
    log(f"# responses: fvg gate accepts {int(gate.sum())}/{len(gate)} "
        f"(JAX float32 {j32.get('accepted', 'not recorded')}, JAX float64 "
        f"{(ref['fvg']['f64'] or {}).get('accepted', 'not recorded')}); "
        f"ratio {np.round(c_chain / c_free, 4).tolist()}; anchor accepts "
        + ", ".join(f"{v} {sum(rep['anchor'][v]['accept'])}"
                    for v in FVG_VARIANTS))
    for r in fvg:
        log(f"# responses: fvg {r['trial']} gate {r['gate']} ratio "
            f"{r['ratio']:.4f}: " + ", ".join(
                f"{v} MPE {r[f'mpe_{v}']:.1f}->{r[f'mpe_{v}_anch']:.1f}"
                for v in FVG_VARIANTS))
    gates, fails = fvg_agree(fvg, rep, ref["fvg"])
    bad += [("fvg agree", g["column"], g["rel"], g["rel_unexplained"])
            for g in fails]
    out["fvg"] = {"rows": fvg, "c_free": rep["c_free"],
                  "c_chain": rep["c_chain"], "anchor": rep["anchor"],
                  "gates": gates}

    # 2. the sweeps: columns, the warm start, the rows
    kern = response_kernel_check(dev, *kept[0])
    jsw = ref["sweeps"]
    jcols = {k: (jsw["f64"][k].get("columns") or jsw["f32"][k].get("columns")
                 or ref["small"]["sweeps"][f"{k}_production" if k == "levers"
                                           else "deadband_floor"]["columns"])
             for k in ("deadband", "levers")}
    for k in ("deadband", "levers"):
        with open(csvs[k], encoding="utf-8", newline="") as f:
            table = list(csv.reader(f))
        log(f"# responses: {os.path.basename(csvs[k])}: {table}")
        if table[0] != jcols[k] or len(table) != 3:
            bad.append((k, "columns", table[0], jcols[k]))
    warm = {}
    for k in ("deadband", "levers"):
        w = reps[k]["warm"]
        warm[k] = {"mpe": float(np.mean([s[0] for s in w])),
                   "comvel": float(np.mean([s[2] for s in w]))}
    jw = {d: jax_warm_start(jsw[d]) for d in ("f64", "f32")}
    for k in ("deadband", "levers"):
        for c in ("mpe", "comvel"):
            if jw["f64"] is None or jw["f32"] is None:
                log(f"# responses agree: {k} warm start {c}: port "
                    f"{warm[k][c]:.4f}, JAX {jw} (JAX float64 or float32 "
                    f"not recorded: printed, not gated)")
                continue
            g = sweep_gate(warm[k][c], jw["f64"][c], jw["f32"][c],
                           TOL_MPJPE)
            log(f"# responses agree: {k} warm start {c}: port "
                f"{g['port']:.4f} jax_f64 {g['jax_f64']:.4f} jax_f32 "
                f"{g['jax_f32']:.4f} "
                + f"(rel {g['rel_f64']:+.4f}, bar ±{TOL_MPJPE}"
                + (", set aside: JAX f32 misses its f64)" if g["set_aside"]
                   else ")") + ("" if g["ok"] else " FAILS"))
            if not g["ok"]:
                bad.append(("warm start", k, c, g))
    gates = sweep_rows_agree(
        "deadband", reps["deadband"]["rows"],
        {d: jsw[d]["deadband"] for d in ("f64", "f32")}, "base_deadband",
        (("comvel_rmse", TOL_COMVEL), ("mpe_mm", TOL_MPJPE)), bad)
    gates += sweep_rows_agree(
        "levers", reps["levers"]["rows"],
        {d: jsw[d]["levers"] for d in ("f64", "f32")}, "variant",
        (("comvel_rmse", TOL_COMVEL), ("mpe_mm", TOL_MPJPE),
         ("mpjpe_mm", TOL_MPJPE)), bad)
    for raw, acc in zip(reps["levers"]["rows"], reps["levers"]["accepted"]):
        log(f"# responses: levers {raw['variant']}: mean accepted LM steps "
            f"{raw['mean_accepted_iters']} (per lane {acc}), JAX "
            + ", ".join(f"{d} {r['mean_accepted_iters']}"
                        for d in ("f64", "f32")
                        for r in jsw[d]["levers"].get("rows", [])
                        if r["variant"] == raw["variant"])
            + "; dMPE {:.3f} dMPJPE {:.3f} mm, CoM-vel {:+.2f} %".format(
                raw["dmpe_mm"], raw["dmpjpe_mm"],
                raw["comvel_improvement_pct"]))
    for row, sc in zip(reps["deadband"]["rows"],
                       reps["deadband"]["per_trial"]):
        log(f"# responses: deadband {row['base_deadband']} grf_max "
            f"{row['grf_max']}: CoM-vel {row['comvel_rmse']:.4f} (warm "
            f"{row['comvel_warm']:.4f}, {row['comvel_improvement_pct']:+.3f}"
            f" %), MPE {row['mpe_mm']:.3f} mm; per trial {sc}")
    if not all(np.isfinite([r[k] for r in reps[s]["rows"] for k in r
                            if k not in ("base_deadband", "variant")]).all()
               for s in ("deadband", "levers")):
        bad.append(("sweeps", "non-finite values"))
    out["sweeps"] = {"rows": {k: reps[k]["rows"] for k in
                              ("deadband", "levers")},
                     "per_trial": {k: reps[k]["per_trial"] for k in
                                   ("deadband", "levers")},
                     "accepted": reps["levers"]["accepted"], "warm": warm,
                     "gates": gates}
    out["kernel"] = kern
    return by_shape, out, bad


def results_layer(dev, cli_root, cli_out, cli_trial, kinetic, work):
    """The rest of the results layer on the trees phases 9 and 11 wrote:
    ``compare_traj_error`` on phase 9's first trial for its camera (with
    the physics-based mode), ``check_joint_estimation`` and
    ``plot_eom_error`` on phase 11's force-plate solution against itself,
    ``get_power_values`` and ``torque_error`` on its torques, and the plots
    (False where matplotlib is not installed, as on the card). Gate:
    finite values; MPJPE 0 and torque RMSE 0 of the solution against
    itself, a zero torque error; each plot written exactly where
    matplotlib is installed. Returns (the record, the failures)."""
    import importlib.util

    from cheetah_pose_estimation_tpu_torch.data import io as dio
    from cheetah_pose_estimation_tpu_torch.dynamics.eom import tau_from_dict
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.pipeline import metrics
    from cheetah_pose_estimation_tpu_torch.pipeline import results as res
    from cheetah_pose_estimation_tpu_torch.pipeline import visualize

    bad, rec = [], {}
    plots = importlib.util.find_spec("matplotlib") is not None
    base = os.path.join(cli_out, cli_trial)
    cam = dio.load_metadata(os.path.join(cli_root,
                                         cli_trial))["monocular_cam"]
    t0 = time.perf_counter()
    cmp = metrics.compare_traj_error(base, cam, include_kinetic=True)
    rec["compare_traj_error"] = {
        "trial": cli_trial, "cam": cam,
        "modes": {m: {k: float(v) for k, v in s.items() if k != "per_joint"}
                  for m, s in cmp.items()}}
    log(f"# responses: compare_traj_error {cli_trial} camera {cam}: "
        f"{rec['compare_traj_error']['modes']}")
    if list(cmp) != ["single view", "data-driven", "physics-based"] or not \
            np.isfinite([v for s in rec["compare_traj_error"]["modes"]
                         .values() for v in s.values()]).all():
        bad.append(("compare_traj_error", rec["compare_traj_error"]))
    kp = kinetic["trials"][0]                  # kinetic_dataset/date/c/trialNN
    _, date, cheetah, trial = kp.split("/")
    fte_p = os.path.join(kinetic["out"], kp, "fte_kinetic", "fte.pickle")
    cje = res.check_joint_estimation(kinetic["out"], kinetic["out"],
                                     cheetah=cheetah, date=date,
                                     trial=trial[len("trial"):])
    eom = res.plot_eom_error(fte_p, params.get_subject(cheetah),
                             os.path.join(work, "eom_error.pdf"),
                             device=dev)
    d = dio.load_fte_pickle(fte_p)
    tau = tau_from_dict(d["tau"], d["q"].shape[0])
    power = res.get_power_values(d["q"], tau, 200.0)
    te, _, _ = res.torque_error(tau, tau)
    stats = res.plot_power_values(d["q"], tau, 200.0,
                                  os.path.join(work, "power.pdf"))
    drawn = {"plot_cost_functions": res.plot_cost_functions(
                 os.path.join(work, "cost.pdf")),
             "render_trial": visualize.render_trial(
                 fte_p, os.path.join(work, "animation.mp4")),
             "plot_pose": visualize.plot_pose(
                 d["positions"][0], os.path.join(work, "pose.pdf"))}
    rec.update(check_joint_estimation=cje, eom_rms_bw=float(np.sqrt(np.mean(
        eom ** 2))), eom_max_bw=float(eom.max()), power=stats,
        torque_error_max=float(np.max(te)), plots=drawn,
        wall_s=time.perf_counter() - t0)
    log(f"# responses: results on {kp}: check_joint_estimation {cje}, EOM "
        f"residual RMS {rec['eom_rms_bw']:.4f} max {rec['eom_max_bw']:.4f} "
        f"body weights over {eom.size} frames, power peak "
        f"{stats['peak']:.4f} mean {stats['mean']:.4f}, torque error "
        f"{rec['torque_error_max']}, plots {drawn} (matplotlib "
        f"{'installed' if plots else 'not installed'}), "
        f"{rec['wall_s']:.2f} s")
    if cje != {"mpjpe_mm": 0.0, "torque_rmse": 0.0} or \
            rec["torque_error_max"] != 0.0 or not np.isfinite(eom).all() \
            or not np.isfinite(np.hstack(list(power.values()))).all() \
            or not np.isfinite(list(stats.values())).all():
        bad.append(("results layer", rec))
    if any(bool(v) != plots for v in drawn.values()):
        bad.append(("plots", drawn, plots))
    return rec, bad


def phase_responses(dev, results, ref, dset, cli_root, cli_out, cli_trial,
                    kinetic):
    """Phase 17: the three response studies on the card
    (``studies.run_forced_vs_gated_bench`` at its size, 10 trials x 64
    frames, then ``run_deadband_sweep`` and ``run_physics_lever_sweep`` at
    2 trials x 48 frames) with phase 9's pose tables as the priors, held to
    ``tests/data/jax_responses_f64.json`` (``response_studies``), then the
    rest of the results layer on phases 9 and 11's trees
    (``results_layer``). Returns the kernel's launches per shape."""
    import tempfile

    work = tempfile.mkdtemp(prefix="responses_")
    by_shape, out, bad = response_studies(dev, ref, dset, work)
    out["results_layer"], bad_r = results_layer(
        dev, cli_root, cli_out, cli_trial, kinetic, work)
    results["responses"] = out
    bad += bad_r
    if bad:
        raise AssertionError(f"the response studies failed their checks: "
                             f"{bad[:6]}")
    return by_shape, out["kernel"]["rel_err"], out["kernel"]["max_abs_err"]


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
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
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
    dd_shapes, q_dd, gmm_dd, dd_out, dd_scan = phase_dd(dev, ctx, results)
    physics_shapes, phys_rel, phys_abs = phase_physics(
        dev, ctx, q_dd, gmm_dd, dd_out, results)
    with open(os.path.join(HERE, "tests", "data", "jax_cli_f32.json"),
              encoding="utf-8") as f:
        cli_ref = json.load(f)
    cli_shapes, cli_rel, cli_abs, (root, dset, cli_out) = phase_cli(
        dev, results, cli_ref)
    with open(os.path.join(HERE, "tests", "data", "jax_serial_f32.json"),
              encoding="utf-8") as f:
        serial_ref = json.load(f)
    serial_shapes = phase_serial(dev, results, serial_ref, root, dset)
    with open(os.path.join(HERE, "tests", "data", "jax_kinetic_f32.json"),
              encoding="utf-8") as f:
        kinetic_ref = json.load(f)
    kinetic_shapes, kin_rel, kin_abs = phase_kinetic(dev, results,
                                                     kinetic_ref)
    with open(os.path.join(HERE, "tests", "data", "jax_acinoset_f64.json"),
              encoding="utf-8") as f:
        acinoset_ref = json.load(f)
    acinoset_shapes = phase_acinoset(dev, results, acinoset_ref, dset)
    analysis_shapes, an_rel, an_abs = phase_analysis(dev, results,
                                                     acinoset_ref, root)
    with open(os.path.join(HERE, "tests", "data", "jax_studies_f64.json"),
              encoding="utf-8") as f:
        studies_ref = json.load(f)
    studies_shapes, st_rel, st_abs = phase_studies(
        dev, results, studies_ref, root, dset, cli_out)
    with open(os.path.join(HERE, "tests", "data", "jax_options_f64.json"),
              encoding="utf-8") as f:
        options_ref = json.load(f)
    options_shapes = phase_options(dev, results, options_ref, root, dset)
    with open(os.path.join(HERE, "tests", "data", "jax_dynamics_f64.json"),
              encoding="utf-8") as f:
        dynamics_ref = json.load(f)
    dynamics_shapes = phase_dynamics(dev, results, dynamics_ref, dd_scan)
    with open(os.path.join(HERE, "tests", "data", "jax_responses_f64.json"),
              encoding="utf-8") as f:
        responses_ref = json.load(f)
    cheetah, date, trial = run_dataset.TEST_SET[0]
    responses_shapes, rs_rel, rs_abs = phase_responses(
        dev, results, responses_ref, dset, root, cli_out,
        os.path.join(date, cheetah, trial), results["kinetic"]["tree"])
    worst_rel = max(worst_rel, phys_rel, cli_rel, kin_rel, an_rel, st_rel,
                    rs_rel)
    worst_abs = max(worst_abs, phys_abs, cli_abs, kin_abs, an_abs, st_abs,
                    rs_abs)

    main_shape = timed[0]                     # (10, 64): the finish's shape
    keys = ("kernel_ms", "plain_ms", "cr_ms", "library_ms", "bound_ms",
            "bound_by", "roofline_share")
    kernels = {"kernels": [{
        "name": "banded_solve",
        "route": "cuda",
        "source": "cheetah_pose_estimation_tpu_torch/csrc/banded_solve.cu",
        "replaces": "cheetah_pose_estimation_tpu/ops/pallas_banded.py:262,309",
        "launches": sum(stage1_shapes.values()) + sum(dd_shapes.values())
        + sum(physics_shapes.values()) + sum(cli_shapes.values())
        + sum(serial_shapes.values()) + sum(kinetic_shapes.values())
        + sum(acinoset_shapes.values()) + sum(analysis_shapes.values())
        + sum(studies_shapes.values()) + sum(options_shapes.values())
        + sum(dynamics_shapes.values()) + sum(responses_shapes.values()),
        "launches_by_path": {"stage1": shape_keys(stage1_shapes),
                             "dd": shape_keys(dd_shapes),
                             "physics": shape_keys(physics_shapes),
                             "cli": shape_keys(cli_shapes),
                             "serial_cli": shape_keys(serial_shapes),
                             "kinetic_cli": shape_keys(kinetic_shapes),
                             "acinoset": shape_keys(acinoset_shapes),
                             "analysis": shape_keys(analysis_shapes),
                             "studies": shape_keys(studies_shapes),
                             "options": shape_keys(options_shapes),
                             "dynamics": shape_keys(dynamics_shapes),
                             "responses": shape_keys(responses_shapes)},
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": main_shape["kernel_ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "roofline_share": main_shape["roofline_share"],
        "shapes": [{"B": r["B"], "N": r["N"], **{k: r.get(k) for k in keys}}
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
