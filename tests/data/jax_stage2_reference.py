"""Record the JAX package's stage-2 (physics-based) results on the procedural
bench batch, for the PyTorch port to be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_stage2_reference.py

Runs bench.py's stage 2 (``bench.py:440-519``: ``build_physics_batch``,
``KineticFTE(KineticConfig(use_gmm=True)).make_solver()`` vmapped in waves
of 5 lanes, ``forces``) on the host CPU, on the 10 procedural monocular
problems padded to 64 frames, in float32 and again in float64. Both start
from JAX's float32 stage-1 trajectories with the JAX-trained GMM pose
prior, both from ``tests/data/jax_dd_inputs.npz``: bench's warm start when
the data-driven stage did not run (``bench.py:444``). The ground heights
are ``contacts.estimate_ground_height`` of each trial's ground truth, as
``bench.py:220`` computes them.

Writes ``tests/data/jax_stage2_f32.json``: per-trial MPE, MPJPE, CoM-velocity
RMSE of the warm start and of the physics solve, bench's ``ok``
(``bench.py:517-519``), accepted steps and iterations per lane, RMS torque
and peak GRFz per trial (over the frames whose EOM residual is active), the
ground heights and the pruned stance matrices; the float64 run's under
``f64``. ``--trials``, ``--stages`` and ``--out`` make a short run for a
quick check of the script itself.
"""
import argparse
import json
import os
import platform
import time

import numpy as np

N_TRIALS = 10
N_FRAMES = 64
WAVE = 5                         # bench.py:460
HERE = os.path.dirname(os.path.abspath(__file__))


def problems(n_trials):
    """bench.py's per-trial problems (``bench.py:144-156``) with the
    JAX-trained GMM as their solver prior, and the ground heights."""
    from cheetah_pose_estimation_tpu.models import params as P
    from cheetah_pose_estimation_tpu.pipeline import bench_lib
    from cheetah_pose_estimation_tpu.pipeline import contacts as cmod
    from cheetah_pose_estimation_tpu.priors import gmm

    z = np.load(os.path.join(HERE, "jax_dd_inputs.npz"))
    gp = gmm.to_solver_prior(gmm.GMMParams(
        np.asarray(z["gmm_weights"], np.float64),
        np.asarray(z["gmm_means"], np.float64),
        np.asarray(z["gmm_covs"], np.float64)))
    subject = P.get_subject("acinoset")
    datas, trials, fpss = [], [], []
    for i, (q_gt, _, fps) in enumerate(
            bench_lib.load_reference_trajectories(n_trials)):
        d, _, tr = bench_lib.build_monocular_problem(q_gt, "acinoset", fps,
                                                     seed=i)
        datas.append(d._replace(gmm=gp))
        trials.append(tr)
        fpss.append(fps)
    gphs = [cmod.estimate_ground_height(tr.q_gt, subject) for tr in trials]
    q1 = np.asarray(z["stage1_q"], np.float64)[:n_trials]
    return datas, trials, fpss, gphs, q1, subject


def run_stage2(n_trials, dtype, stages):
    """bench.py's stage 2 from the npz's stage-1 q; returns the record."""
    import jax
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.pipeline import bench_lib
    from cheetah_pose_estimation_tpu.solver import kinetic as kn

    datas, trials, fpss, gphs, q1, subject = problems(n_trials)
    qs_warm = [q1[i, : tr.q_gt.shape[0]] for i, tr in enumerate(trials)]
    t0 = time.time()
    kbat, q_warm_b = bench_lib.build_physics_batch(
        datas, qs_warm, fpss, subject, n_frames=N_FRAMES, dtype=dtype,
        use_gmm=False, ground_heights=gphs)
    prep_s = time.time() - t0
    kfte = kn.KineticFTE(kn.KineticConfig(use_gmm=True), subject)
    solve_kw = {} if stages is None else {"stages": stages}
    kvrun = jax.jit(jax.vmap(kfte.make_solver(**solve_kw)))
    B = q_warm_b.shape[0]
    t0 = time.time()
    outs = [kvrun(q_warm_b[i:i + WAVE],
                  jax.tree.map(lambda x: x[i:i + WAVE], kbat))
            for i in range(0, B, WAVE)]
    jax.block_until_ready(outs)
    solve_s = time.time() - t0
    cat = lambda f: np.concatenate([np.asarray(getattr(s, f)) for s in outs])
    kq = cat("q").astype(np.float64)
    vforces = jax.jit(jax.vmap(kfte.forces))
    tau, gz, _ = (np.asarray(x, np.float64)
                  for x in vforces(jnp.asarray(kq, dtype), kbat))
    fv = np.asarray(kbat.base.frame_valid, np.float64)
    valid = np.zeros_like(fv)
    valid[:, 2:] = fv[:, 2:] * fv[:, 1:-1] * fv[:, :-2]
    rms_tau = [float(np.sqrt(np.sum(valid[i, :, None] * tau[i] ** 2)
                             / (valid[i].sum() * tau.shape[-1])))
               for i in range(B)]
    peak_gz = [float(np.max(valid[i, :, None] * gz[i])) for i in range(B)]
    warm = bench_lib.score_per_trial(q1, trials, fpss, subject)
    rows = bench_lib.score_per_trial(kq, trials, fpss, subject)
    mean = lambda rs, k: float(np.mean([r[k] for r in rs]))
    ok = bool(np.all(np.isfinite(kq))) \
        and mean(rows, 0) < 1.02 * mean(warm, 0) \
        and mean(rows, 2) < 1.02 * mean(warm, 2)
    return {
        "mpe_mm": [r[0] for r in rows],
        "mpjpe_mm": [r[1] for r in rows],
        "comvel_rmse_ms": [r[2] for r in rows],
        "mean_mpe_mm": mean(rows, 0), "mean_mpjpe_mm": mean(rows, 1),
        "mean_comvel_rmse_ms": mean(rows, 2),
        "warm_mpe_mm": [r[0] for r in warm],
        "warm_mpjpe_mm": [r[1] for r in warm],
        "warm_comvel_rmse_ms": [r[2] for r in warm],
        "ok": ok,
        "n_accepted": cat("n_accepted").tolist(), "it": cat("it").tolist(),
        "final_cost": cat("cost").astype(np.float64).tolist(),
        "rms_tau_bw": rms_tau, "peak_grf_z_bw": peak_gz,
        "ground_heights": [float(g) for g in gphs],
        "stance": np.asarray(kbat.stance).astype(int).tolist(),
        "host_prep_s_incl_compile": round(prep_s, 1),
        "solve_s_incl_compile": round(solve_s, 1),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=N_TRIALS)
    ap.add_argument("--stages", type=json.loads, default=None,
                    help='e.g. "[[3.0, 1], [1.0, 1]]" (default: the '
                         "solver's production schedule)")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_stage2_f32.json"))
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    stages = None if args.stages is None else tuple(
        (float(s), int(n)) for s, n in args.stages)
    out = run_stage2(args.trials, jnp.float32, stages)
    with jax.enable_x64(True):
        out["f64"] = run_stage2(args.trials, jnp.float64, stages)
    out.update({
        "what": "JAX package, bench.py stage 2 (build_physics_batch + "
                "KineticFTE(KineticConfig(use_gmm=True)).make_solver(), waves "
                "of 5 lanes, bench.py:440-519) from the float32 stage-1 q and "
                "the JAX-trained GMM of jax_dd_inputs.npz, procedural "
                "gallops, float32; the float64 run under f64",
        "n_trials": args.trials, "n_frames": N_FRAMES, "dtype": "float32",
        "stages": stages, "jax": jax.__version__,
        "backend": jax.default_backend(), "host": platform.machine()})
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: out[k] for k in (
        "mean_mpe_mm", "mean_mpjpe_mm", "mean_comvel_rmse_ms", "ok",
        "n_accepted", "solve_s_incl_compile")}))
    print(json.dumps({k: out["f64"][k] for k in (
        "mean_mpe_mm", "mean_mpjpe_mm", "mean_comvel_rmse_ms", "ok",
        "n_accepted", "solve_s_incl_compile")}))


if __name__ == "__main__":
    main()
