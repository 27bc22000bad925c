"""Record the JAX package's three response studies
(``pipeline/studies.py``: ``run_forced_vs_gated_bench``,
``run_deadband_sweep``, ``run_physics_lever_sweep``) and its bench anchor
polish (``bench_lib.make_anchor_polish``) on the host CPU, for the PyTorch
port to be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_responses_reference.py

Parts, each in processes of their own:

* ``fvg_f32`` and ``fvg_f64``: ``run_forced_vs_gated_bench`` at its
  defaults (the 10 procedural bench trials, 64 frames), in float32 as it
  runs and in float64 (x64 on, ``dtype=float64``); the rows, the CSV's
  columns and the prior-free costs the gate compared;
* ``sweeps_f64`` and ``sweeps_f32``: ``run_deadband_sweep`` and
  ``run_physics_lever_sweep`` at ``SMOKE_DEADBAND`` and ``SMOKE_LEVERS``
  (2 trials, 48 frames), in float64 (x64 on and the studies' float32
  arrays made float64) and in float32 as they run; one process per row
  (``deadband_floor``, ``deadband_0.05``, ``levers_production``,
  ``levers_overrides``: the rows are independent, each process solves the
  shared warm start itself), rows unrounded, and the per-trial scores the
  lever sweep computed (``bench_lib.score_per_trial``: the warm start's,
  then the variant's);
* ``small``: the CPU tests' fixture, in float64: both sweeps and the
  forced-vs-gated bench cut to 2 trials at 48 frames with every schedule
  shortened (``small_schedules``; the stance pruning speeds raised), the
  priors trained on the small procedural tables (``small_tables``), the
  rows unrounded; and ``make_anchor_polish`` on the 2-trial batch with the
  first trial's truth pushed ``PUSH`` m along its camera ray
  (``anchor_inputs``).

The priors are trained under x64 into the prior cache beside the training
table before each part runs, so the float32 runs load the float64 priors
(as ``jax_studies_reference.py`` does).

Writes ``tests/data/jax_responses_f64.json``: ``fvg`` (``f32``, ``f64``),
``sweeps`` (``f64``, ``f32``: ``deadband`` and ``levers``, each with its
rows in the configured order), ``small``, ``parts_complete``. A part that
did not reach its end is merged as far as it got: a sweep with the rows
whose processes finished (``recorded``), an fvg part as ``{}``. The
float64 sweep rows take hours each on a busy 8-core CPU.

``--run PART [--row ROW] --out DIR/PART.json --keep DIR`` makes one part
(one sweep row); the script with ``--keep DIR`` alone makes the parts
DIR lacks, and ``--merge --keep DIR`` only merges what DIR holds.
"""
import argparse
import contextlib
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
PARTS = ("fvg_f32", "sweeps_f64", "small", "fvg_f64", "sweeps_f32")
XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=2")
# the smoke's sweeps (phase 17)
SMOKE_DEADBAND = dict(base_deadbands=(None, 0.05), grf_maxes=(5.0,),
                      n_frames=48, max_trials=2)
SMOKE_LEVERS = {
    "production": {},
    "overrides": {"meas_guard": 0.0, "_stages": ((3.0, 10), (1.0, 20)),
                  "_lam0": 0.5, "_perturb": 0.02},
}
SWEEP_ROWS = ("deadband_floor", "deadband_0.05", "levers_production",
              "levers_overrides")
# the CPU tests' fixture: shortened schedules (the annealed kinematic solve,
# the multistart's probe and finish, the polish, the kinetic solve)
SHORT = ((10.0, 3), (3.0, 3), (1.0, 8))
POLISH_SHORT = ((1.0, 4),)
KSHORT = ((3.0, 3), (1.0, 5))
SMALL_TRIALS = 2
SMALL_FRAMES = 48
SMALL_DEADBAND = dict(SMOKE_DEADBAND)
SMALL_LEVERS = {
    "production": {"_stages": KSHORT},
    "overrides": {"meas_guard": 0.0, "_stages": ((3.0, 2), (1.0, 3)),
                  "_lam0": 0.5, "_perturb": 0.02},
}
PUSH = 0.3


def _jsonable(rows):
    return [{k: (v.item() if hasattr(v, "item") else v)
             for k, v in r.items()} for r in rows]


def small_schedules(setattr_, kin_cls, kn_cls, batch_mod, danchor_mod,
                    kn_mod):
    """One package's schedules shortened to the fixture's (``setattr_`` is
    ``setattr`` or a test's ``monkeypatch.setattr``), and its stance
    pruning speeds raised: the procedural feet slide faster than the
    pruning allows, which would leave no stance to solve."""
    setattr_(kin_cls.make_solver, "__defaults__",
             (SHORT,) + kin_cls.make_solver.__defaults__[1:])
    setattr_(batch_mod, "PROBE_STAGES", SHORT[:1])
    setattr_(batch_mod, "FULL_STAGES", SHORT[1:])
    setattr_(danchor_mod, "POLISH_STAGES", POLISH_SHORT)
    setattr_(kn_cls.make_solver, "__defaults__",
             (KSHORT,) + kn_cls.make_solver.__defaults__[1:])
    d = kn_mod.prune_stance.__defaults__
    setattr_(kn_mod.prune_stance, "__defaults__",
             (1e3,) + d[1:2] + (1e3,) + d[3:])


def small_tables(priors):
    """The small procedural training and validation tables (seeds 100-102
    and 200, 80 frames) in directory ``priors``, written by the port (the
    JAX package reads its validation table as .h5, written beside); returns
    the training table's path."""
    from cheetah_pose_estimation_tpu.data import io as jio
    from cheetah_pose_estimation_tpu.priors import dataset as jds
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.priors import dataset as tds

    os.makedirs(priors, exist_ok=True)
    dset = os.path.join(priors, "dataset_full_pose.csv")
    tds.save_pose_dataset(dset, bench_lib.procedural_pose_table(
        (100, 101, 102), n_frames=80))
    val = os.path.join(priors, "validation_dataset.csv")
    tds.save_pose_dataset(val, bench_lib.procedural_pose_table(
        (200,), n_frames=80))
    jio._write_pandas_h5_table(os.path.join(priors, "validation_dataset.h5"),
                               jds.load_pose_dataset(val))
    return dset


def anchor_inputs(trials, R, t, n_frames):
    """The anchor polish test's input: each trial's true q padded to
    ``n_frames`` by its last frame, the first trial's base moved ``PUSH``
    m along the ray from its camera (rotation ``R``, translation ``t``) to
    its mean base position."""
    B = len(trials)
    qs = np.zeros((B, n_frames, 54))
    for i, tr in enumerate(trials):
        n = tr.q_gt.shape[0]
        qs[i, :n] = tr.q_gt
        qs[i, n:] = tr.q_gt[-1]
    c = -np.asarray(R).T @ np.asarray(t)
    ray = qs[0, :trials[0].q_gt.shape[0], :3].mean(axis=0) - c
    qs[0, :, :3] += PUSH * ray / np.linalg.norm(ray)
    return qs


@contextlib.contextmanager
def float64_arrays():
    """``jnp.float32`` is float64 inside the block: the sweeps make their
    arrays with an explicit float32 dtype."""
    import jax.numpy as jnp

    saved = jnp.float32
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = saved


@contextlib.contextmanager
def captured_scores(rec):
    """Every ``bench_lib.score_per_trial`` result, in call order, appended
    to ``rec``."""
    from cheetah_pose_estimation_tpu.pipeline import bench_lib

    orig = bench_lib.score_per_trial

    def run(*a, **k):
        out = orig(*a, **k)
        rec.append([list(map(float, r)) for r in out])
        return out

    bench_lib.score_per_trial = run
    try:
        yield
    finally:
        bench_lib.score_per_trial = orig


def setup(work, x64, small=False):
    """JAX on the CPU, the pose tables and the priors (5-component GMM,
    window-4 lasso AR) trained under x64 into the prior cache in ``work``,
    the environment's training table set before the JAX package reads it;
    returns the training table's path."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    if small:
        dset = small_tables(os.path.join(work, "priors"))
        from cheetah_pose_estimation_tpu.priors import armodel, gmm
        from cheetah_pose_estimation_tpu.priors import dataset as prior_ds
        from cheetah_pose_estimation_tpu.utils import data_ops
        cache = data_ops.prior_cache_dir(dset)
        with jax.enable_x64(True):
            X = prior_ds.load_pose_dataset(dset).iloc[:, 6:28].to_numpy()
            gmm.fit(X, n_components=5, seed=42, cache_dir=cache)
            armodel.train_motion_model(dset, window_size=4, lasso=True,
                                       cache_dir=cache)
    else:
        os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = os.path.join(
            work, "priors", "dataset_full_pose.csv")
        from jax_acinoset_reference import train_priors
        dset = train_priors(work)
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    jax.config.update("jax_enable_x64", x64)
    from cheetah_pose_estimation_tpu.pipeline import estimator
    estimator.DATA_DRIVEN_DATASET = dset
    return dset


def fvg(f64, out_csv, n_frames=64):
    """The forced-vs-gated bench's rows, with the per-trial prior-free costs
    of the free and chain solves that its gate compared (``c_free``,
    ``c_chain``: the arguments of ``estimator.prior_gate_accept``)."""
    import jax.numpy as jnp
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu.pipeline import studies

    costs = {}
    orig = est_mod.prior_gate_accept

    def gate(c_chain, c_free, *a, **k):
        costs.update(c_chain=np.asarray(c_chain, np.float64).tolist(),
                     c_free=np.asarray(c_free, np.float64).tolist())
        return orig(c_chain, c_free, *a, **k)

    est_mod.prior_gate_accept = gate
    t0 = time.time()
    try:
        df = studies.run_forced_vs_gated_bench(
            out_csv=out_csv, n_frames=n_frames,
            dtype=jnp.float64 if f64 else jnp.float32)
    finally:
        est_mod.prior_gate_accept = orig
    rows = _jsonable(df.to_dict("records"))
    return {"columns": list(df.columns), "rows": rows,
            "accepted": int(sum(bool(r["gate"]) for r in rows)),
            "wall_s_cpu": time.time() - t0, **costs}


def sweep_row(work, row, deadband, levers):
    """One row of the deadband sweep (``deadband_floor``,
    ``deadband_<value>``) or of the lever sweep (``levers_<variant>``),
    unrounded."""
    from cheetah_pose_estimation_tpu.pipeline import studies

    studies.round = lambda v, nd=None: v     # the rows unrounded
    t0 = time.time()
    scores = []
    kind, name = row.split("_", 1)
    with captured_scores(scores):
        if kind == "deadband":
            bd = None if name == "floor" else float(name)
            df = studies.run_deadband_sweep(
                **dict(deadband, base_deadbands=(bd,)),
                out_dir=os.path.join(work, row))
        else:
            df = studies.run_physics_lever_sweep(
                n_frames=deadband["n_frames"],
                max_trials=deadband["max_trials"],
                out_csv=os.path.join(work, row, "physics_lever_sweep.csv"),
                variants={name: levers[name]})
    return {"columns": list(df.columns),
            "rows": _jsonable(df.to_dict("records")), "scores": scores,
            "wall_s_cpu": time.time() - t0}


def small_anchor(loads):
    """The JAX package's bench anchor polish on ``anchor_inputs`` of the
    first ``SMALL_TRIALS`` trajectories of ``loads`` at ``SMALL_FRAMES``,
    float64: the polished q, the ground heights and which trials changed."""
    import jax
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.models import params as P
    from cheetah_pose_estimation_tpu.parallel import batch as jbatch
    from cheetah_pose_estimation_tpu.pipeline import bench_lib
    from cheetah_pose_estimation_tpu.pipeline import contacts as cmod

    subject = P.get_subject("acinoset")
    datas, q0s, trials, fpss = [], [], [], []
    for i, (q_gt, _, fps) in enumerate(loads(SMALL_TRIALS)):
        d, q0, tr = bench_lib.build_monocular_problem(q_gt, "acinoset", fps,
                                                      seed=i)
        datas.append(d)
        q0s.append(q0)
        trials.append(tr)
        fpss.append(fps)
    bat, _ = jbatch.pad_and_stack(datas, q0s, n_frames=SMALL_FRAMES,
                                  dtype=jnp.float64)
    cam = jax.tree.map(lambda x: np.asarray(x)[0], bat.cam)
    qs = anchor_inputs(trials, cam.R[0], cam.t[0], SMALL_FRAMES)
    gphs = [float(cmod.estimate_ground_height(tr.q_gt, subject))
            for tr in trials]
    q_out = np.asarray(bench_lib.make_anchor_polish(subject, jnp.float64)(
        qs, bat, trials, fpss, gphs), np.float64)
    return {"q": q_out.tolist(), "gphs": gphs,
            "changed": [bool(np.any(q_out[i] != qs[i]))
                        for i in range(len(trials))]}


def small_run(work):
    setup(work, True, small=True)
    from cheetah_pose_estimation_tpu.parallel import batch as jbatch
    from cheetah_pose_estimation_tpu.pipeline import bench_lib
    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
    from cheetah_pose_estimation_tpu.solver import kinematic as jkin
    from cheetah_pose_estimation_tpu.solver import kinetic as jkn

    small_schedules(setattr, jkin.KinematicFTE, jkn.KineticFTE, jbatch, jda,
                    jkn)
    loads, paths = (bench_lib.load_reference_trajectories,
                    bench_lib.reference_trial_paths)
    bench_lib.load_reference_trajectories = \
        lambda m=None, **k: loads(SMALL_TRIALS, **k)
    bench_lib.reference_trial_paths = lambda m=None: paths(SMALL_TRIALS)
    rec = {"trials": SMALL_TRIALS, "n_frames": SMALL_FRAMES}
    t0 = time.time()
    with float64_arrays():
        rec["fvg"] = fvg(True, os.path.join(work, "fvg",
                                            "forced_vs_gated.csv"),
                         n_frames=SMALL_FRAMES)
        rec["sweeps"] = {}
        for row in SWEEP_ROWS:
            rec["sweeps"][row] = sweep_row(work, row, SMALL_DEADBAND,
                                           SMALL_LEVERS)
        rec["anchor"] = small_anchor(loads)
    rec["wall_s_cpu"] = time.time() - t0
    return rec


def run_part(part, work, row=None):
    if part == "small":
        return small_run(work)
    kind, dt = part.split("_")
    setup(work, dt == "f64")
    ctx = float64_arrays() if dt == "f64" else contextlib.nullcontext()
    with ctx:
        if kind == "fvg":
            return fvg(dt == "f64", os.path.join(work,
                                                 "forced_vs_gated.csv"))
        return sweep_row(work, row, SMOKE_DEADBAND, SMOKE_LEVERS)


def _units(part):
    """(name, --row) of the processes that make ``part``."""
    if part.startswith("sweeps"):
        return [(f"{part}_{r}", r) for r in SWEEP_ROWS]
    return [(part, None)]


def merge_sweeps(work, part):
    """The rows of a sweep part, from the row processes that finished."""
    out = {"deadband": {"rows": [], "scores": []},
           "levers": {"rows": [], "scores": []}, "recorded": []}
    for name, row in _units(part):
        path = os.path.join(work, f"{name}.json")
        if not os.path.exists(path):
            continue
        with open(path, encoding="utf-8") as f:
            rec = json.load(f)
        kind = row.split("_", 1)[0]
        out[kind]["columns"] = rec["columns"]
        out[kind]["rows"] += rec["rows"]
        out[kind]["scores"].append(rec["scores"])
        out[kind].setdefault("wall_s_cpu", []).append(rec["wall_s_cpu"])
        out["recorded"].append(row)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_responses_f64.json"))
    ap.add_argument("--run", choices=PARTS, default=None)
    ap.add_argument("--row", choices=SWEEP_ROWS, default=None)
    ap.add_argument("--keep", default=None,
                    help="keep the work and the part records here")
    ap.add_argument("--merge", action="store_true",
                    help="with --keep: make no run, merge the records there")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("CHEETAH_NO_COMPILE_CACHE", "1")
    work = args.keep or tempfile.mkdtemp(prefix="jax_responses_")
    if args.run:
        name = args.run + (f"_{args.row}" if args.row else "")
        rec = run_part(args.run, os.path.join(work, name), args.row)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rec, f, sort_keys=True)
        print(f"wrote {args.out}")
        return
    env = dict(os.environ, XLA_FLAGS=XLA_FLAGS)
    procs = []
    for part in PARTS if not args.merge else ():
        for name, row in _units(part):
            if os.path.exists(os.path.join(work, f"{name}.json")):
                continue
            cmd = [sys.executable, os.path.abspath(__file__), "--run", part,
                   "--out", os.path.join(work, f"{name}.json"),
                   "--keep", work] + (["--row", row] if row else [])
            with open(os.path.join(work, f"{name}.log"), "w") as log:
                procs.append(subprocess.Popen(
                    cmd, cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
    if any([p.wait() for p in procs]):
        raise SystemExit("a part failed")
    import jax
    parts = {}
    for part in PARTS:
        if part.startswith("sweeps"):
            parts[part] = merge_sweeps(work, part)
            continue
        path = os.path.join(work, f"{part}.json")
        parts[part] = {}
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                parts[part] = json.load(f)
    result = {
        "about": ("JAX package pipeline/studies.py response studies on the "
                  "host CPU: run_forced_vs_gated_bench (10 trials, 64 "
                  "frames) in f32 and f64; run_deadband_sweep and "
                  "run_physics_lever_sweep at SMOKE_DEADBAND/SMOKE_LEVERS "
                  "in f64 and f32 (rows unrounded); the small fixture of "
                  "the CPU tests; priors trained under x64 on the "
                  "procedural pose tables; tests/data/"
                  "jax_responses_reference.py"),
        "platform": platform.processor() or platform.machine(),
        "jax": jax.__version__,
        "smoke_deadband": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in SMOKE_DEADBAND.items()},
        "fvg": {"f32": parts["fvg_f32"], "f64": parts["fvg_f64"]},
        "sweeps": {"f64": parts["sweeps_f64"], "f32": parts["sweeps_f32"]},
        "small": parts["small"],
        "parts_complete": {
            p: all(os.path.exists(os.path.join(work, f"{n}.json"))
                   for n, _ in _units(p)) for p in PARTS}}
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, sort_keys=True, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
