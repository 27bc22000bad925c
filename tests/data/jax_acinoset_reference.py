"""Record the JAX package's AcinoSet flag (``run_dataset.run_acinoset``,
``validate_dataset``) and its distance-from-camera analysis on the
synthetic test set, on the host CPU, for the PyTorch port's
``--run_acinoset`` and ``--run_analysis`` to be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_acinoset_reference.py

Four runs, each in processes of its own (the script starts them and
merges their records):

* ``f64``: ``run_acinoset`` in float64 (x64 on) on the PyTorch port's
  rendering of the first four test trials (``chip_smoke.
  render_acinoset_tree``: jules flick2 and flick1 with their pairwise
  pseudo-measurements, phantom run and run1_2), the input the port solves
  and what its gate compares with;
* ``f32``: the same in float32 (x64 off, as the JAX CLI runs; printed);
* ``analysis``: the multi-view ground truth of the port's rendering of the
  whole 10-trial test set in float64 (``batched.run_monocular_batched``,
  ground-truth mode), then ``distance_from_camera`` of each trial's CoM
  from each of its 6 cameras;
* ``sweep``: the every-camera sweep of ``--run_analysis --batched`` in
  float64 on the test trials ``SWEEP_TRIALS`` (one per subject group):
  the multi-view ground truth, then each (trial, camera) through the
  default and data-driven modes as one lane (``batched.
  run_monocular_batched(cam_overrides=...)``, as ``run_monocular_all``
  does), and the errors of each lane against the multi-view solve
  (``chip_smoke.sweep_errors``).

The priors of the data-driven mode are trained as in
``jax_serial_reference.py`` (the procedural pose tables, under
``jax.enable_x64(True)``, into the CLI's own prior cache). The JAX package
reads a CSV tree through its C++ parser, which rounds the pixels by up to
~6e-5 px; these runs read it through pandas (``load_dlc_points(
use_native=False)``), exactly as the port reads it.

Writes ``tests/data/jax_acinoset_f64.json``, summaries only:

* ``tree`` and ``port_tree``: per trial, the digest (``chip_smoke.digest``)
  of the DLC tables and, per camera, of the pairwise pickles
  (``chip_smoke.ppm_digest``) of the JAX package's own rendering (float32,
  x64 off) and of the port's;
* ``f64`` and ``f32``: per mode and trial, the scores against the
  synthetic truth and the saved objective (``chip_smoke.acinoset_scores``),
  W (measurements per marker), whether ``estimate_kinematics`` succeeded
  and its wall seconds on this CPU (each trial compiles its own solvers:
  not a device time); ``done`` (the trials ``run_acinoset`` returned),
  ``validate`` (``validate_dataset``'s dict) and ``artifacts`` (the
  layout of every output file, ``chip_smoke.artifacts``);
* ``analysis``: per trial, per camera, the mean CoM distance (m) and view
  angle (deg) (``distance``), and the ground truth's MPJPE against the
  synthetic truth; ``sweep``: per trial, camera and mode, the MPE against
  the multi-view solve and its parts (``errors``), and the CPU seconds
  of each trial's sweep.

The f64 and f32 runs go one trial per process (``--only i``; each trial
compiles its own solvers), the analysis in one more and the sweep one
trial per process: 11 processes.
``--trials 1 --out /tmp/x.json`` checks the script on one trial (the
analysis and the sweep on one trial too); ``--run f64|f32|sweep [--only
i] --out
DIR/<run>[_i].json --keep DIR`` or ``--run analysis --out
DIR/analysis.json --keep DIR`` makes one part alone; the script without
``--run`` makes only the parts DIR lacks, and ``--merge --keep DIR`` only
merges what DIR holds.
"""
import argparse
import contextlib
import io as _io
import json
import os
import pickle
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
RUNS = ("f64", "f32", "analysis", "sweep")
SWEEP_TRIALS = (0, 2)     # jules flick2 and phantom run


def exact_csv_reader():
    """The JAX package reads DLC CSV tables through pandas, as the port
    does, instead of its C++ parser."""
    from cheetah_pose_estimation_tpu.data import io as jio

    d = list(jio.load_dlc_points.__defaults__)
    d[-1] = False
    jio.load_dlc_points.__defaults__ = tuple(d)


def tree_digests(root, paths):
    """Per trial: the DLC tables' digest (the exact read) and per camera
    the pairwise pickles' (as the port reads them)."""
    from chip_smoke import digest, ppm_digest

    from cheetah_pose_estimation_tpu_torch.data import io as pio

    out = {}
    for p in paths:
        xy, lik, _ = pio.load_dlc_points(os.path.join(root, p, "dlc"),
                                         use_native=False)
        out[p] = dict(digest(xy, lik),
                      ppm=ppm_digest(os.path.join(root, p)))
    return out


@contextlib.contextmanager
def instrumented(rec):
    """Record W, the outcome and the wall seconds of each
    ``estimate_kinematics`` call into ``rec[mode][trial]`` (nothing else
    changes)."""
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod

    orig = est_mod.estimate_kinematics

    def run(est, *a, **k):
        mode = ("ground-truth" if est.scene.cam_idx is None else
                "data-driven" if k.get("monocular_constraints") else
                "default")
        t0 = time.time()
        ok = orig(est, *a, **k)
        rec.setdefault(mode, {})[est.data_path] = {
            "W": int(np.shape(est.data.meas)[-1]), "ok": bool(ok),
            "wall_s_cpu": time.time() - t0}
        return ok

    est_mod.estimate_kinematics = run
    try:
        yield rec
    finally:
        est_mod.estimate_kinematics = orig


def train_priors(work):
    """The procedural pose tables in ``work/priors`` and the priors trained
    on them under x64 into the CLI's prior cache; returns the table's
    path (the CLI's ``CHEETAH_DATA_DRIVEN_DATASET``)."""
    import jax

    from jax_cli_reference import TRAIN_SEEDS, VAL_SEEDS
    from jax_stage15_reference import pose_table_frame

    from cheetah_pose_estimation_tpu.data import io as dio
    from cheetah_pose_estimation_tpu.priors import armodel, gmm
    from cheetah_pose_estimation_tpu.priors import dataset as prior_ds
    from cheetah_pose_estimation_tpu.utils import data_ops

    dset = os.path.join(work, "priors", "dataset_full_pose.csv")
    os.makedirs(os.path.dirname(dset), exist_ok=True)
    with jax.enable_x64(True):
        pose_table_frame(TRAIN_SEEDS).to_csv(dset)
        val = pose_table_frame(VAL_SEEDS)
        val.to_csv(os.path.join(os.path.dirname(dset),
                                "validation_dataset.csv"))
        dio._write_pandas_h5_table(os.path.join(
            os.path.dirname(dset), "validation_dataset.h5"), val)
        df = prior_ds.load_pose_dataset(dset)
        cache = data_ops.prior_cache_dir(dset)
        gmm.fit(df.iloc[:, 6:28].to_numpy(), n_components=5, seed=42,
                cache_dir=cache)
        armodel.train_motion_model(dset, window_size=4, lasso=True,
                                   cache_dir=cache)
    return dset


def acinoset_run(run, n_trials, work, only=None):
    """``run_acinoset`` (its defaults: ground truth, default, data-driven;
    PPMs on the flicks) on the port's rendering of the first ``n_trials``
    test trials (of those, the indices ``only``: the others' directories
    are removed after the rendering), then ``validate_dataset``."""
    import shutil

    import jax
    jax.config.update("jax_platforms", "cpu")
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = os.path.join(
        work, "priors", "dataset_full_pose.csv")
    dset = train_priors(work)
    jax.config.update("jax_enable_x64", run == "f64")
    exact_csv_reader()
    from chip_smoke import acinoset_scores, artifacts, render_acinoset_tree

    from cheetah_pose_estimation_tpu.pipeline import estimator
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as prd
    assert estimator.DATA_DRIVEN_DATASET == dset

    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    paths = render_acinoset_tree(prd, root, n_trials)
    if only is not None:
        for i, p in enumerate(paths):
            if i not in only:
                shutil.rmtree(os.path.join(root, p))
        paths = [p for i, p in enumerate(paths) if i in only]
    rec, calls = {"trials": paths}, {}
    log = _io.StringIO()
    t0 = time.time()
    try:
        with instrumented(calls), contextlib.redirect_stdout(log):
            rec["done"] = rd.run_acinoset(root, odir)
    finally:
        sys.stdout.write(log.getvalue())
    rec["wall_s_cpu"] = time.time() - t0
    rec["stdout"] = log.getvalue().splitlines()[-40:]
    scores = acinoset_scores(root, odir, paths)
    rec["modes"] = {m: {p: dict(calls[m][p], **s) for p, s in d.items()}
                    for m, d in scores.items()}
    rec["validate"] = rd.validate_dataset(odir)
    rec["artifacts"] = artifacts(odir)
    rec["tree"] = tree_digests(root, paths)
    return rec


def analysis_run(n_trials, work):
    """The float64 multi-view ground truth of the port's rendering of the
    test set, and each trial's CoM distance and view angle from each
    camera."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    exact_csv_reader()
    from cheetah_pose_estimation_tpu.pipeline import batched
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as prd

    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    prd.materialize_synthetic_testset(root)
    test_set = rd.TEST_SET[:n_trials]
    t0 = time.time()
    batched.run_monocular_batched(root, odir, test_set,
                                  modes=("ground-truth",),
                                  dtype=jax.numpy.float64, mesh=None)
    rec = {"wall_s_cpu": time.time() - t0, "distance": {},
           "gt_mpjpe_vs_truth": {}}
    for c, d, t in test_set:
        p = os.path.join(d, c, t)
        with open(os.path.join(odir, p, "fte_kinematic", "fte.pickle"),
                  "rb") as f:
            gt = pickle.load(f)
        with open(os.path.join(root, p, "synthetic_gt.pickle"), "rb") as f:
            true = np.asarray(pickle.load(f)["positions"], np.float64)
        pos = np.asarray(gt["positions"], np.float64)
        cen = lambda a: a - a.mean(1, keepdims=True)
        rec["gt_mpjpe_vs_truth"][p] = float(np.linalg.norm(
            cen(pos) - cen(true), axis=2).mean() * 1e3)
        rec["distance"][p] = {}
        for cam in range(6):
            dist, ang = rd.distance_from_camera(
                os.path.join(root, p), np.asarray(gt["com_pos"]), cam)
            rec["distance"][p][str(cam)] = [float(np.mean(dist)),
                                            float(np.mean(ang))]
    return rec


def sweep_run(only, work):
    """The every-camera sweep in float64 on the test trials ``only`` of the
    port's rendering of the test set, and each lane's errors against the
    multi-view solve."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = os.path.join(
        work, "priors", "dataset_full_pose.csv")
    dset = train_priors(work)
    jax.config.update("jax_enable_x64", True)
    exact_csv_reader()
    from chip_smoke import sweep_errors

    from cheetah_pose_estimation_tpu.pipeline import batched, estimator
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as prd
    assert estimator.DATA_DRIVEN_DATASET == dset

    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    prd.materialize_synthetic_testset(root)
    test_set = [rd.TEST_SET[i] for i in only]
    combos = [t for t in test_set for _ in range(6)]
    f64 = dict(dtype=jax.numpy.float64, mesh=None)
    t0 = time.time()
    batched.run_monocular_batched(root, odir, test_set,
                                  modes=("ground-truth",), **f64)
    batched.run_monocular_batched(root, odir, combos,
                                  cam_overrides=list(range(6)) * len(only),
                                  modes=("default", "data-driven"), **f64)
    paths = [os.path.join(d, c, t) for c, d, t in test_set]
    return {"wall_s_cpu": {p: (time.time() - t0) / len(paths)
                           for p in paths},
            "errors": sweep_errors(root, odir, paths)}


def _union(recs):
    """One run's record from the records of its parts (one trial each, in
    order)."""
    out = {"trials": [], "done": [], "modes": {}, "validate": {},
           "artifacts": {}, "tree": {}, "stdout": [], "wall_s_cpu": 0.0}
    for r in recs:
        for k in ("trials", "done", "stdout"):
            out[k] += r[k]
        for k in ("validate", "artifacts", "tree"):
            out[k].update(r[k])
        for m, d in r["modes"].items():
            out["modes"].setdefault(m, {}).update(d)
        out["wall_s_cpu"] += r["wall_s_cpu"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=4,
                    help="test trials of the AcinoSet runs (the analysis: "
                         "10, or this many if fewer than 4)")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_acinoset_f64.json"))
    ap.add_argument("--run", choices=RUNS, default=None)
    ap.add_argument("--only", default=None,
                    help="with --run f64|f32|sweep: the comma-separated "
                         "trial indices")
    ap.add_argument("--keep", default=None,
                    help="keep the trees and the outputs in this directory")
    ap.add_argument("--merge", action="store_true",
                    help="with --keep: make no run, merge the records there")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("CHEETAH_NO_COMPILE_CACHE", "1")
    work = args.keep or tempfile.mkdtemp(prefix="jax_acinoset_")
    n_analysis = 10 if args.trials >= 4 else args.trials
    if args.run:
        only = None if args.only is None else [
            int(i) for i in args.only.split(",")]
        sub = os.path.join(work, args.run + ("" if only is None else "_"
                                             + "-".join(map(str, only))))
        rec = (analysis_run(n_analysis, sub) if args.run == "analysis"
               else sweep_run(SWEEP_TRIALS if only is None else only, sub)
               if args.run == "sweep"
               else acinoset_run(args.run, args.trials, sub, only))
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rec, f, sort_keys=True)
        print(f"wrote {args.out}")
        return
    # one process per trial of the f64 and f32 runs (each trial compiles
    # its own solvers) and one for the analysis; a part with a record in
    # the work directory is not made again. XLA's CPU thread pools
    # oversubscribe the cores when processes share them: each runs on two
    # threads
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=2")
    sweep = [i for i in SWEEP_TRIALS if i < n_analysis]
    parts = [("analysis", None)] + [(run, str(i)) for run in RUNS[:2]
                                    for i in range(args.trials)] + [
        ("sweep", str(i)) for i in sweep]
    procs = []
    for run, only in parts if not args.merge else ():
        name = run if only is None else f"{run}_{only}"
        if os.path.exists(os.path.join(work, f"{name}.json")):
            continue
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--run", run,
             "--trials", str(args.trials), "--out",
             os.path.join(work, f"{name}.json"), "--keep", work]
            + ([] if only is None else ["--only", only]), cwd=REPO, env=env))
    if any([p.wait() for p in procs]):
        raise SystemExit("a run failed")
    import jax
    jax.config.update("jax_platforms", "cpu")
    from chip_smoke import render_acinoset_tree

    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    result = {
        "about": ("JAX package run_dataset.run_acinoset (ground truth, "
                  "default, data-driven; PPMs on the flicks) and "
                  "validate_dataset on the PyTorch port's rendering of the "
                  "first test trials, f64 (x64 on) and f32, host CPU; "
                  "analysis: the f64 multi-view ground truth of the port's "
                  "rendering of the test set and distance_from_camera per "
                  "trial and camera, and the f64 every-camera sweep of "
                  "two trials with each lane's errors against the "
                  "multi-view solve; priors trained under x64 on the "
                  "procedural pose tables; tests/data/"
                  "jax_acinoset_reference.py"),
        "platform": platform.processor() or platform.machine(),
        "jax": jax.__version__}
    with open(os.path.join(work, "analysis.json"), encoding="utf-8") as f:
        result["analysis"] = json.load(f)
    result["analysis"]["sweep"] = {"errors": {}, "wall_s_cpu": {}}
    for i in sweep:
        with open(os.path.join(work, f"sweep_{i}.json"),
                  encoding="utf-8") as f:
            part = json.load(f)
        for k, v in part.items():
            result["analysis"]["sweep"][k].update(v)
    for run in RUNS[:2]:
        recs = []
        for i in range(args.trials):
            with open(os.path.join(work, f"{run}_{i}.json"),
                      encoding="utf-8") as f:
                recs.append(json.load(f))
        result[run] = _union(recs)
    result["trials"] = result["f64"].pop("trials")
    if result["f32"].pop("trials") != result["trials"]:
        raise SystemExit("f32 has other trials than f64")
    result["port_tree"] = result["f64"].pop("tree")
    result["f32"].pop("tree")
    # the JAX package's own rendering (x64 off, host work, seconds)
    own = os.path.join(work, "jax_tree")
    render_acinoset_tree(rd, own, len(result["trials"]))
    result["tree"] = tree_digests(own, result["trials"])
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, sort_keys=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
