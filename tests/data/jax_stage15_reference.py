"""Record the JAX package's float32 stage-1.5 (data-driven) results on the
procedural bench batch, and the inputs the PyTorch port needs to repeat
them without JAX.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_stage15_reference.py

1. Writes the procedural pose tables (training seeds 100-139, validation
   seeds 200-209, 240 frames each; the port's
   ``bench_lib.procedural_pose_table`` recipe through the JAX package's
   ``gallop_trajectory`` and ``relative_pose``) as CSV to a temporary
   directory.
2. Trains the JAX priors on them in float64 (``gmm.fit``: K = 5, seed 42;
   ``armodel.train_motion_model``: window 4, lasso, with
   ``validation_fname``).
3. Runs bench.py's stage 1 and then its data-driven composition
   (``bench.py:305-397``, :func:`jax_data_driven`) in float32 on the host
   CPU, on the 10 procedural problems padded to 64 frames; then the same
   composition in float64 from the same float32 stage-1 trajectories and
   priors. Near the optimum the float32 gradient is dominated by rounding
   noise (the constant-acceleration term's cancellation), so the float32
   solves stop where that noise lets them; the float64 run is the answer
   without it.

Writes ``tests/data/jax_stage15_f32.json`` (per-trial MPE, MPJPE,
CoM-velocity, ``prior_ok``, the scan shifts, wall times; the float64 run's
under ``f64``) and
``tests/data/jax_dd_inputs.npz`` (the GMM's weights, means and covariances;
the AR model's coef, intercept, error variance, window and statistics; the
float32 stage-1 q, (10, 64, 54)).
"""
import json
import os
import platform
import tempfile
import time

import numpy as np

N_TRIALS = 10
N_FRAMES = 64
TRAIN_SEEDS = tuple(range(100, 140))
VAL_SEEDS = tuple(range(200, 210))
HERE = os.path.dirname(os.path.abspath(__file__))


def pose_table_frame(seeds, n_frames=240):
    """The procedural pose table as a pandas frame (index restarting at 0
    per segment, the 28 pose columns), float64."""
    import pandas as pd

    from cheetah_pose_estimation_tpu.data import synthetic as syn
    from cheetah_pose_estimation_tpu.models import skeleton as sk
    from cheetah_pose_estimation_tpu.priors.dataset import POSE_COLUMNS

    frames = []
    for s in seeds:
        q = syn.gallop_trajectory(n_frames, seed=s)
        q[:, 3:54] += np.random.default_rng(10_000 + s).normal(scale=0.05,
                                                               size=51)
        frames.append(pd.DataFrame(np.asarray(sk.relative_pose(q),
                                              np.float64),
                                   index=np.arange(n_frames),
                                   columns=POSE_COLUMNS))
    return pd.concat(frames)


def jax_data_driven(q_free, batched, gp, mm, subject, dtype, stages=None,
                    scan_stages=((1.0, 60),)):
    """bench.py's data-driven stage (``dd_host``, ``vdd``, ``dd_depth``,
    ``dd_pipeline``, ``bench.py:239-397``) on a stage-1 result ``q_free``
    and a stage-1 batch, with the solver prior ``gp`` (no trial axis) and
    the AR model ``mm``. ``stages=None`` is the solvers' production
    schedule. Each trial's real frame count is the sum of its
    ``frame_valid``. Returns (q (B, N, 54) jnp, prior_ok, shifts)."""
    import jax
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.models import skeleton as sk
    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as danchor
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu.priors import armodel
    from cheetah_pose_estimation_tpu.solver import kinematic as kin

    B, n_frames = q_free.shape[0], q_free.shape[1]
    solve_kw = {} if stages is None else {"stages": stages}
    bat_dd = jax.tree.map(jnp.asarray, batched)._replace(
        gmm=jax.tree.map(lambda x: jnp.broadcast_to(
            jnp.asarray(x, dtype), (B,) + np.asarray(x).shape), gp))
    chain = kin.KinematicFTE(
        kin.KinematicConfig(fisheye=True, robust=True, use_gmm=True,
                            **est_mod.DD_BASE_ANCHOR), subject)
    vchain = jax.jit(jax.vmap(chain.make_solver(**solve_kw)))
    free = kin.KinematicFTE(kin.KinematicConfig(), subject)
    vcost = jax.jit(jax.vmap(lambda q, d: free._cost(q, d, 1.0)))
    fte_dd = kin.KinematicFTE(
        kin.KinematicConfig(fisheye=True, robust=True, use_gmm=True,
                            use_ar=True, **est_mod.DD_BASE_ANCHOR), subject)
    vdd = jax.jit(jax.vmap(fte_dd.make_solver(**solve_kw)))
    scan = danchor.make_depth_linescan(subject, dtype, stages=scan_stages)
    fv = np.asarray(bat_dd.frame_valid)
    n_real = fv.sum(1).astype(int)

    # dd_host
    bat0 = bat_dd._replace(base_ref=q_free[:, :, :6])
    st_chain = vchain(q_free, bat0)
    c_free = np.asarray(vcost(q_free, bat0), np.float64)
    c_chain = np.asarray(vcost(st_chain.q, bat0), np.float64)
    broken = ~np.isfinite(c_chain) & np.isfinite(c_free)
    if broken.any():
        raise RuntimeError(f"dd chain non-finite on trials "
                           f"{np.flatnonzero(broken).tolist()}")
    prior_ok = est_mod.prior_gate_accept(c_chain, c_free)
    qb = jnp.where(jnp.asarray(prior_ok)[:, None, None], st_chain.q, q_free)
    qb_np = np.asarray(qb, np.float64)
    ypreds, ws, valids = [], [], []
    for i in range(B):
        x_boot = np.asarray(sk.relative_pose(qb_np[i]))
        yp, vl = armodel.anchor_predictions(mm, x_boot)
        vl = vl * fv[i]
        ws.append(armodel.adaptive_motion_weights(mm, yp, x_boot, vl))
        ypreds.append(yp)
        valids.append(vl * float(prior_ok[i]))
    bat = bat0._replace(
        ar=kin.ARAnchor(jnp.asarray(np.stack(ypreds), dtype),
                        jnp.asarray(np.stack(ws), dtype),
                        jnp.asarray(np.stack(valids), dtype)),
        gmm_scale=jnp.asarray(prior_ok.astype(np.float64), dtype))
    st_dd = vdd(qb, bat)

    # dd_depth
    qs_np = np.asarray(st_dd.q, np.float64)
    rays = np.zeros((B, n_frames, 3))
    veto = np.zeros(B)
    for i in range(B):
        n = n_real[i]
        cam = jax.tree.map(lambda x: np.asarray(x)[i], bat.cam)
        rays[i] = danchor.camera_ray(qs_np[i], cam.R[0], cam.t[0])
        veto[i] = danchor.scale_median(
            qs_np[i, :n], subject, np.asarray(bat.meas)[i, :n, 0],
            np.asarray(bat.weight)[i, :n, 0], cam.K[0], cam.D[0], cam.R[0],
            cam.t[0])
    _, shifts = scan(jnp.asarray(qs_np, dtype), bat, rays, veto)
    qs2 = qs_np
    moved = shifts != 0.0
    if moved.any():
        qs_shift = qs_np.copy()
        qs_shift[:, :, :3] += shifts[:, None, None] * rays
        yp2, vl2 = [], []
        for i in range(B):
            x_c = np.asarray(sk.relative_pose(qs_shift[i]))
            yp, vl = armodel.anchor_predictions(mm, x_c)
            yp2.append(yp)
            vl2.append(vl * fv[i])
        bat2 = bat._replace(
            base_ref=jnp.asarray(qs_shift[:, :, :6], dtype),
            ar=bat.ar._replace(y_pred=jnp.asarray(np.stack(yp2), dtype),
                               valid=jnp.asarray(np.stack(vl2), dtype)))
        st2 = vdd(jnp.asarray(qs_shift, dtype), bat2)
        qs2 = np.where(moved[:, None, None], np.asarray(st2.q, np.float64),
                       qs_np)
    q_dd = jnp.asarray(qs2, dtype)

    # dd_pipeline
    rej_unmoved = ~prior_ok & (shifts == 0.0)
    if rej_unmoved.any():
        q_dd = jnp.where(jnp.asarray(rej_unmoved)[:, None, None], q_free,
                         q_dd)
    return q_dd, prior_ok, shifts


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu.pipeline import bench_lib
    from cheetah_pose_estimation_tpu.priors import armodel, gmm
    from cheetah_pose_estimation_tpu.solver import kinematic as kin

    t0 = time.time()
    with jax.enable_x64(True), tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, seeds in (("train", TRAIN_SEEDS), ("val", VAL_SEEDS)):
            paths[name] = os.path.join(tmp, f"{name}.csv")
            pose_table_frame(seeds).to_csv(paths[name])
        X = pose_table_frame(TRAIN_SEEDS).iloc[:, 6:28].to_numpy()
        params = gmm.fit(X, n_components=5, seed=42)
        params = gmm.GMMParams(*[np.asarray(x, np.float64) for x in params])
        gp = gmm.to_solver_prior(params)
        mm = armodel.train_motion_model(paths["train"], window_size=4,
                                        lasso=True,
                                        validation_fname=paths["val"])
        gmm_score = gmm.score(params, X)
    prior_s = time.time() - t0

    trajs = bench_lib.load_reference_trajectories(N_TRIALS)
    fpss = [f for _, _, f in trajs]
    batched, q0b, trials, subject = bench_lib.build_batch(
        max_trials=N_TRIALS, n_frames=N_FRAMES, dtype=jnp.float32)
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    st = pbatch.make_kinematic_multistart(fte)(q0b, batched)
    st.q.block_until_ready()
    times = []
    for _ in range(2):
        t0 = time.time()
        q_dd, prior_ok, shifts = jax_data_driven(st.q, batched, gp, mm,
                                                 subject, jnp.float32)
        q_dd.block_until_ready()
        times.append(time.time() - t0)
    qs = np.asarray(q_dd, np.float64)
    rows = bench_lib.score_per_trial(qs, trials, fpss, subject)
    with jax.enable_x64(True):
        b64, _, _, _ = bench_lib.build_batch(
            max_trials=N_TRIALS, n_frames=N_FRAMES, dtype=jnp.float64)
        t0 = time.time()
        q64, ok64, sh64 = jax_data_driven(
            jnp.asarray(np.asarray(st.q), jnp.float64), b64, gp, mm, subject,
            jnp.float64)
        q64 = np.asarray(q64, np.float64)
        f64_s = time.time() - t0
    rows64 = bench_lib.score_per_trial(q64, trials, fpss, subject)
    out = {
        "what": "JAX package, bench.py stage 1.5 (data-driven composition, "
                "bench.py:305-397) after stage 1, procedural gallops, "
                "float32; priors trained in float64 on the procedural pose "
                "tables (seeds 100-139 / 200-209)",
        "n_trials": N_TRIALS, "n_frames": N_FRAMES, "dtype": "float32",
        "jax": jax.__version__, "backend": jax.default_backend(),
        "host": platform.machine(),
        "prior_training_s": round(prior_s, 1),
        "dd_wall_s_first_call_incl_compile": round(times[0], 1),
        "dd_wall_s_second_call": round(times[1], 1),
        "gmm_train_score": gmm_score,
        "ar_train_rmse": mm.train_rmse,
        "ar_validation_rmse": mm.validation_rmse,
        "prior_ok": [bool(v) for v in prior_ok],
        "shifts": [float(v) for v in shifts],
        "mpe_mm": [r[0] for r in rows],
        "mpjpe_mm": [r[1] for r in rows],
        "comvel_rmse_ms": [r[2] for r in rows],
        "f64": {"prior_ok": [bool(v) for v in ok64],
                "shifts": [float(v) for v in sh64],
                "wall_s_incl_compile": round(f64_s, 1),
                "mpe_mm": [r[0] for r in rows64],
                "mpjpe_mm": [r[1] for r in rows64],
                "comvel_rmse_ms": [r[2] for r in rows64],
                "mean_mpjpe_mm": float(np.mean([r[1] for r in rows64]))},
    }
    out["mean_mpjpe_mm"] = float(np.mean(out["mpjpe_mm"]))
    out["mean_mpe_mm"] = float(np.mean(out["mpe_mm"]))
    with open(os.path.join(HERE, "jax_stage15_f32.json"), "w",
              encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    np.savez_compressed(
        os.path.join(HERE, "jax_dd_inputs.npz"),
        gmm_weights=params.weights, gmm_means=params.means,
        gmm_covs=params.covs, ar_coef=mm.coef, ar_intercept=mm.intercept,
        ar_error_variance=mm.error_variance,
        ar_train_rmse=mm.train_rmse, ar_validation_rmse=mm.validation_rmse,
        ar_window_size=mm.window_size, ar_window_time=mm.window_time,
        ar_lasso=mm.lasso, stage1_q=np.asarray(st.q, np.float32))
    print(json.dumps({k: out[k] for k in (
        "mean_mpe_mm", "mean_mpjpe_mm", "prior_ok", "shifts", "f64",
        "prior_training_s", "dd_wall_s_first_call_incl_compile",
        "dd_wall_s_second_call")}))


if __name__ == "__main__":
    main()
