"""Record the JAX package's dynamics tools and prior options that
chip_smoke phase 16 runs, in float64 on the host CPU (the two
trajectory-generation tasks in float32 too), for the PyTorch port to be
held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_dynamics_reference.py

Parts, each in a process of its own (the task solves take minutes to
compile and run on a CPU):

* ``stop_f64``, ``stop_f32``: ``tasks.high_speed_stop()`` at its defaults
  (10 m/s, N = 40, h = 0.02, 200 LM steps at most);
* ``gallop_f64``, ``gallop_f32``: ``tasks.periodic_gallop()`` at its
  defaults (14 m/s, N = 44, h = 0.01, ``GALLOP_FOOT_ORDER``);
  each task part records the final cost, steps, accepted steps, the
  task's scores, the foot heights and the bars of the JAX package's own
  test (``tests/test_tasks.py``) that the run meets;
* ``gallop20_f64``, ``gallop20_f32``: the gallop's first ``EARLY_STEPS``
  LM steps (``max_iters=20``), the same records;
* ``sim``: ``simulate.drop_test(initial_height=0.8, duration=0.6)`` (the
  base trajectory, the feet's heights at every record, the first record
  with a foot on the ground) and the ballistic throw of
  ``tests/test_simulate.py``;
* ``priors``: ``pca.fit`` on the procedural training table
  (``bench_lib.TRAIN_SEEDS``) and ``armodel.train_motion_model`` with that
  pose model (validation table ``VAL_SEEDS``);
* ``small``: the CPU tests' fixture: both tasks at a small size
  (``SMALL``), their cost at q0, and at q0 moved off its lateral symmetry
  (``perturbed``) the cost, the gradient, the normal matrix applied to two
  seeded vectors and its diagonal, and the state after a few LM steps
  (``gn.lm_solve``) from there.

Writes ``tests/data/jax_dynamics_f64.json``. ``--run PART --out
DIR/PART.json --keep DIR`` makes one part; ``--merge --keep DIR`` joins
the parts DIR holds; the script with ``--keep DIR`` alone makes only the
parts DIR lacks and merges.
"""
import argparse
import json
import os
import platform
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
PARTS = ("stop_f64", "gallop_f64", "stop_f32", "gallop_f32",
         "gallop20_f64", "gallop20_f32", "sim", "priors", "small")
# the gallop's first LM steps (its 200-step cost does not reproduce in
# float32: the two JAX runs differ by 30 %)
EARLY_STEPS = 20
XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=2")
DROP = dict(initial_height=0.8, duration=0.6)
# the ballistic throw of tests/test_simulate.py:14-27
THROW = dict(height=3.0, vx=4.0, duration=0.2, dt=5e-4, record_every=40)
# the CPU tests' small tasks: keyword arguments and LM steps, from the
# tasks' q0 moved by SMALL_SCALE * normal(seed SMALL_SEED) (perturbed)
SMALL = {
    "stop": (dict(initial_vel=8.0, n_frames=16, h=0.02, settle_frames=4),
             12),
    "gallop": (dict(avg_vel=9.0, n_frames=12, h=0.015,
                    foot_order=((1, 4), (3, 7), (8, 11), (6, 10))), 10),
}
SMALL_SEED = 7
SMALL_SCALE = 1e-6


def task_scores(name, out, subject):
    """The task's scores and the bars of tests/test_tasks.py it meets."""
    import jax

    from cheetah_pose_estimation_tpu.dynamics import eom as dyn

    q = np.asarray(out["q"])
    heights = np.asarray(jax.vmap(
        lambda qq: dyn.foot_points(qq, subject))(q))[..., 2]
    rec = {k: float(out[k]) for k in ("cost", "eom_cost", "torque_cost",
                                      "eom_rms_bw")}
    rec.update(iterations=int(out["iterations"]),
               accepted=int(out["accepted"]),
               finite=bool(np.isfinite(q).all()),
               foot_height_min=float(heights.min()),
               foot_height_max_after_12=float(heights[12:].max()),
               grf_z_max=float(np.max(out["grf_z"])),
               base_xyz=q[:, :3].tolist())
    if name == "stop":
        rec.update(final_speed=out["final_speed"],
                   stop_distance=out["stop_distance"],
                   dq1_x=float(out["dq"][1, 0]),
                   moved_forward=bool(q[-1, 0] < q[0, 0]))
        bars = {"accepted": rec["accepted"] > 5,
                "start_speed": abs(rec["dq1_x"] + 10.0) <= 0.5,
                "final_speed": rec["final_speed"] < 1.0,
                "moved_forward": rec["moved_forward"],
                "eom_rms_bw": rec["eom_rms_bw"] < 0.5,
                "feet_down": rec["foot_height_max_after_12"] < 0.3,
                "penetration": rec["foot_height_min"] > -0.1}
    else:
        rec.update(stride_length=out["stride_length"],
                   avg_speed=out["avg_speed"],
                   periodicity_error=out["periodicity_error"])
        bars = {"accepted": rec["accepted"] > 5,
                "avg_speed": abs(rec["avg_speed"] - 14.0) <= 1.4,
                "periodicity": rec["periodicity_error"] < 0.15,
                "eom_rms_bw": rec["eom_rms_bw"] < 0.5,
                "grf_z": rec["grf_z_max"] > 0.2}
    rec["bars"] = {"finite": rec["finite"], **bars}
    return rec


def task(name, max_iters=None):
    from cheetah_pose_estimation_tpu.dynamics import tasks
    from cheetah_pose_estimation_tpu.models import params

    subject = params.get_subject("acinoset")
    t0 = time.time()
    out = (tasks.high_speed_stop if name == "stop"
           else tasks.periodic_gallop)(subject, max_iters=max_iters)
    return {**task_scores(name, out, subject),
            "wall_s_cpu": time.time() - t0}


def sim():
    import jax
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.dynamics import eom as dyn
    from cheetah_pose_estimation_tpu.dynamics import simulate
    from cheetah_pose_estimation_tpu.models import params
    from cheetah_pose_estimation_tpu.models import skeleton as sk

    subject = params.get_subject("acinoset")
    t0 = time.time()
    out = simulate.drop_test(subject, **DROP)
    feet = np.asarray(jax.vmap(lambda qq: dyn.foot_points(qq, subject))(
        jnp.asarray(out["q"])))[..., 2]
    contact = np.flatnonzero(feet.min(1) <= 0.0)
    drop = {"base_xyz": out["q"][:, :3].tolist(),
            "foot_heights": feet.tolist(),
            "first_contact_record": int(contact[0]) if contact.size else -1,
            "final_base_height": out["final_base_height"],
            "upright": bool(out["upright"]),
            "final_foot_heights": out["final_foot_heights"].tolist(),
            "finite": bool(np.isfinite(out["q"]).all()),
            "wall_s_cpu": time.time() - t0}
    q0 = simulate.drop_pose(subject, height=THROW["height"])
    dq0 = np.zeros(54)
    dq0[0] = THROW["vx"]
    t0 = time.time()
    q, _ = simulate.simulate(subject, q0, dq0, THROW["duration"],
                             dt=THROW["dt"],
                             record_every=THROW["record_every"])
    com0 = np.asarray(sk.com_position(q[0], subject))
    com1 = np.asarray(sk.com_position(q[-1], subject))
    t = (q.shape[0] - 1) * THROW["record_every"] * THROW["dt"]
    expect = com0 + np.array([THROW["vx"] * t, 0.0,
                              -0.5 * dyn.GRAVITY * t ** 2])
    throw = {"com0": com0.tolist(), "com1": com1.tolist(),
             "expect": expect.tolist(),
             "err": float(np.abs(com1 - expect).max()),
             "wall_s_cpu": time.time() - t0}
    return {"drop": drop, "throw": throw}


def priors(keep):
    from jax_stage15_reference import pose_table_frame

    from cheetah_pose_estimation_tpu.priors import armodel, pca
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib

    paths = {}
    for name, seeds in (("train", bench_lib.TRAIN_SEEDS),
                        ("val", bench_lib.VAL_SEEDS)):
        paths[name] = os.path.join(keep, f"{name}.csv")
        pose_table_frame(seeds).to_csv(paths[name])
    t0 = time.time()
    pm = pca.fit(paths["train"])
    mm = armodel.train_motion_model(paths["train"], pose_model=pm,
                                    validation_fname=paths["val"])
    return {"pca": {"P": pm.P.tolist(), "mean": pm.mean.tolist(),
                    "std": pm.std.tolist(), "rmse": pm.rmse,
                    "error_variance": pm.error_variance.tolist(),
                    "explained_variance": pm.explained_variance.tolist(),
                    "pc_std": pm.pc_std().tolist()},
            "ar": {"coef": mm.coef.tolist(),
                   "intercept": mm.intercept.tolist(),
                   "error_variance": mm.error_variance.tolist(),
                   "train_rmse": mm.train_rmse,
                   "validation_rmse": mm.validation_rmse},
            "wall_s_cpu": time.time() - t0}


def capture_task(build, subject, **kw):
    """The TrajectoryTask and q0 that a task function makes, without
    solving."""
    from cheetah_pose_estimation_tpu.dynamics import tasks

    got = {}
    solve = tasks.TrajectoryTask.solve

    def grab(self, q0, max_iters=None, ftol=1e-10):
        got.update(task=self, q0=np.asarray(q0))
        raise StopIteration

    tasks.TrajectoryTask.solve = grab
    try:
        build(subject, **kw)
    except StopIteration:
        pass
    finally:
        tasks.TrajectoryTask.solve = solve
    return got["task"], got["q0"]


def perturbed(q0, seed=SMALL_SEED, scale=SMALL_SCALE):
    """q0 moved off its lateral symmetry: at the tasks' q0 the stance
    feet's sideways polygon forces are zero up to round-off, so which of
    them the elimination treats as free is decided by rounding."""
    return q0 + scale * np.random.default_rng(seed).normal(size=q0.shape)


def small():
    import jax
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.dynamics import tasks
    from cheetah_pose_estimation_tpu.models import params
    from cheetah_pose_estimation_tpu.solver import gn as gn_mod

    subject = params.get_subject("acinoset")
    out = {}
    for name, (kw, steps) in SMALL.items():
        t0 = time.time()
        build = tasks.high_speed_stop if name == "stop" \
            else tasks.periodic_gallop
        task, q0 = capture_task(build, subject, **kw)
        qp = jnp.asarray(perturbed(q0))
        g, H = jax.jit(task._normal)(qp)
        rng = np.random.default_rng(SMALL_SEED + 1)
        vs = rng.normal(size=(2,) + q0.shape)
        Hv = [np.asarray(banded_matvec(H, jnp.asarray(v))) for v in vs]
        st = jax.jit(lambda qq: gn_mod.lm_solve(
            task._cost, task._normal, qq, gn_mod.LMConfig(
                max_iters=steps, ftol=1e-10, lam0=1.0)))(qp)
        out[name] = {"cost_q0": float(jax.jit(task._cost)(jnp.asarray(q0))),
                     "cost": float(jax.jit(task._cost)(qp)),
                     "g": np.asarray(g).tolist(),
                     "Hv": [h.tolist() for h in Hv],
                     "H_diag_diag": np.asarray(jnp.diagonal(
                         H.diag, axis1=1, axis2=2)).tolist(),
                     "q": np.asarray(st.q).tolist(),
                     "lm_cost": float(st.cost), "iterations": int(st.it),
                     "accepted": int(st.n_accepted), "steps": steps,
                     "wall_s_cpu": time.time() - t0}
    return out


def banded_matvec(H, v):
    """H @ v for one block-banded system (N, d, d) blocks, v (N, d)."""
    import jax.numpy as jnp

    y = jnp.einsum("tij,tj->ti", H.diag, v)
    for k in range(1, H.lower.shape[0] + 1):
        Lk = H.lower[k - 1][:-k]                  # block (t + k, t)
        y = y.at[k:].add(jnp.einsum("tij,tj->ti", Lk, v[:-k]))
        y = y.at[:-k].add(jnp.einsum("tji,tj->ti", Lk, v[k:]))
    return y


def run_part(part, keep):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", not part.endswith("_f32"))
    if part in ("stop_f64", "stop_f32", "gallop_f64", "gallop_f32"):
        return task(part.split("_")[0])
    if part.startswith("gallop20"):
        return task("gallop", EARLY_STEPS)
    if part == "sim":
        return sim()
    if part == "priors":
        return priors(keep)
    return small()


def spawn(part, keep):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=XLA_FLAGS)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--run", part, "--out",
         os.path.join(keep, f"{part}.json"), "--keep", keep], env=env)


def merge(keep, out):
    import jax

    rec = {"created_by": "tests/data/jax_dynamics_reference.py",
           "jax": jax.__version__, "machine": platform.machine(),
           "dtype": "float64; *_f32: float32",
           "drop": DROP, "throw": THROW,
           "small_settings": {k: [v[0], v[1]] for k, v in SMALL.items()},
           "small_seed": SMALL_SEED, "small_scale": SMALL_SCALE}
    for part in PARTS:
        p = os.path.join(keep, f"{part}.json")
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                rec[part] = json.load(f)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f)
    print(f"wrote {out}: {[p for p in PARTS if p in rec]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", choices=PARTS)
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_dynamics_f64.json"))
    ap.add_argument("--keep", help="work directory (kept)")
    ap.add_argument("--merge", action="store_true")
    args = ap.parse_args()
    keep = args.keep or tempfile.mkdtemp(prefix="jax_dynamics_")
    os.makedirs(keep, exist_ok=True)
    if args.run:
        rec = run_part(args.run, keep)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rec, f)
        return 0
    if not args.merge:
        procs = [spawn(p, keep) for p in PARTS
                 if not os.path.exists(os.path.join(keep, f"{p}.json"))]
        if any(pr.wait() != 0 for pr in procs):
            raise RuntimeError("a part failed")
    merge(keep, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
