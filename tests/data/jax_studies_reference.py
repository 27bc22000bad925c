"""Record the JAX package's study drivers (``pipeline/studies.py``) on the
host CPU, for the PyTorch port's studies to be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_studies_reference.py

Five parts, each in a process of its own (the script starts them and
merges their records):

* ``models``: the model statistics on the procedural pose tables
  (``TRAIN_SEEDS``, ``VAL_SEEDS``; x64 on): ``model_selection_analysis``
  at its defaults (7 GMMs, 14 AR models: ``grid_search.pickle``'s lists),
  and per (components, window, lasso) of the grid search's default grid
  the statistics its rows carry (GMM train and validation mean
  log-likelihood per sample, AR non-zero count, train and validation
  RMSE);
* ``sweep_f64`` and ``sweep_f32``: ``run_degradation_sweep(rates=(0.0,
  8.0), max_trials=4, include_physics=True)``, in float64 (x64 on and the
  sweep's float32 arrays made float64) and in float32 as it runs; the rows
  unrounded (the function rounds to 0.1 mm) and the CSV's columns;
* ``studies_f64`` and ``studies_f32``: on the port's rendering of the
  first two test trials (``--trials 2``), the JAX package's batched
  ground-truth and data-driven modes in float64 make the output tree the
  studies read (the multi-view solutions and the data-driven warm
  starts); then ``run_grid_search_batched`` (the default 24
  configurations), ``run_data_driven_ablation_batched`` and
  ``run_physics_ablation_batched`` in that dtype; their rows and each
  CSV's columns (``columns``).

The priors are trained under x64 into the prior cache beside the training
table before each part runs (the grid's GMMs and AR models too), so the
float32 runs load the float64 priors, as ``jax_cli_reference.py`` does.
DLC tables are read through pandas (``jax_acinoset_reference.
exact_csv_reader``).

Writes ``tests/data/jax_studies_f64.json``: ``models``, ``sweep`` (``f64``
and ``f32``: the rates, the rows, the CPU seconds) and ``studies`` (``f64``
and ``f32``: the trials, ``grid``, ``dd_ablation``, ``physics_ablation``,
the CPU seconds). The merge takes a part that did not reach its end as
far as it got: a sweep part with the rates its log printed
(``<part>.log``, ``sweep_from_log``), a studies part with the studies it
finished (its ``partial.json``), or none. Each part takes hours on a
busy 8-core CPU (the float64 sweep ~2.8 h for its first rate).

``--trials 1 --out /tmp/x.json`` checks the script in small form (the
sweep on one trial, the studies on one, model selection over 1-2
components and windows); ``--run PART --out DIR/PART.json --keep DIR``
makes one part alone; the script without ``--run`` makes only the parts
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


HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
sys.path.insert(0, HERE)
PARTS = ("models", "sweep_f64", "sweep_f32", "studies_f64", "studies_f32")
SWEEP_RATES = (0.0, 8.0)
GRID = dict(pose_components=(3, 5, 8), windows=(2, 4, 6, 10),
            lasso_options=(True, False))


def _jsonable(rows):
    return [{k: (v.item() if hasattr(v, "item") else v)
             for k, v in r.items()} for r in rows]


@contextlib.contextmanager
def float64_arrays():
    """``jnp.float32`` is float64 inside the block: the sweep makes its
    arrays with an explicit float32 dtype."""
    import jax.numpy as jnp

    saved = jnp.float32
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = saved


def grid_priors(dset, grid=GRID):
    """The grid's GMMs and AR models, trained under x64 into the prior
    cache beside ``dset``."""
    import jax

    from cheetah_pose_estimation_tpu.priors import armodel, gmm
    from cheetah_pose_estimation_tpu.priors import dataset as prior_ds
    from cheetah_pose_estimation_tpu.utils import data_ops

    cache = data_ops.prior_cache_dir(dset)
    with jax.enable_x64(True):
        X = prior_ds.load_pose_dataset(dset).iloc[:, 6:28].to_numpy()
        for k in grid["pose_components"]:
            gmm.fit(X, n_components=k, seed=42, cache_dir=cache)
        for w in grid["windows"]:
            for lasso in grid["lasso_options"]:
                armodel.train_motion_model(dset, window_size=w, lasso=lasso,
                                           cache_dir=cache)


def setup(work, x64):
    """JAX on the CPU, the pose tables and the priors in ``work``, the
    environment's training table set before the JAX package is imported;
    returns the training table's path."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = os.path.join(
        work, "priors", "dataset_full_pose.csv")
    from jax_acinoset_reference import exact_csv_reader, train_priors
    dset = train_priors(work)
    grid_priors(dset)
    jax.config.update("jax_enable_x64", x64)
    exact_csv_reader()
    from cheetah_pose_estimation_tpu.pipeline import estimator
    assert estimator.DATA_DRIVEN_DATASET == dset
    return dset


def models_run(work, small):
    import jax
    dset = setup(work, True)
    from cheetah_pose_estimation_tpu.pipeline import studies
    from cheetah_pose_estimation_tpu.priors import armodel, gmm
    from cheetah_pose_estimation_tpu.priors import dataset as prior_ds
    from cheetah_pose_estimation_tpu.utils import data_ops

    kw = dict(pose_components=(1, 2), window_sizes=(1, 2)) if small else {}
    t0 = time.time()
    sel = studies.model_selection_analysis(dset, **kw)
    rec = {"selection": {k: [float(x) for x in v] for k, v in sel.items()},
           "selection_args": {k: list(v) for k, v in kw.items()}}
    X = prior_ds.load_pose_dataset(dset).iloc[:, 6:28].to_numpy()
    Xv = prior_ds.load_pose_dataset(os.path.join(
        os.path.dirname(dset), "validation_dataset.h5")).iloc[:, 6:28] \
        .to_numpy()
    cache = data_ops.prior_cache_dir(dset)
    grid = {}
    with jax.enable_x64(True):
        for k in GRID["pose_components"]:
            p = gmm.fit(X, n_components=k, seed=42, cache_dir=cache)
            grid[f"gmm_{k}"] = {"gmm_train_likelihood": gmm.score(p, X),
                                "gmm_validation_likelihood": gmm.score(p, Xv)}
        for w in GRID["windows"]:
            for lasso in GRID["lasso_options"]:
                mm = armodel.train_motion_model(dset, window_size=w,
                                                lasso=lasso, cache_dir=cache)
                grid[f"ar_{w}_{lasso}"] = {
                    "lr_non_zeros": int(mm.model_non_zeros),
                    "lr_train_rmse": float(mm.train_rmse),
                    "lr_validation_rmse": float(mm.validation_rmse)}
    rec["grid"] = {k: {kk: float(vv) for kk, vv in v.items()}
                   for k, v in grid.items()}
    rec["wall_s_cpu"] = time.time() - t0
    return rec


def sweep_run(work, f64, n_trials):
    import jax
    dset = setup(work, f64)
    from cheetah_pose_estimation_tpu.pipeline import studies

    studies.round = lambda v, nd=None: v     # the rows unrounded
    t0 = time.time()
    ctx = float64_arrays() if f64 else contextlib.nullcontext()
    with ctx:
        df = studies.run_degradation_sweep(
            rates=SWEEP_RATES, max_trials=n_trials, data_driven_dataset=dset,
            include_physics=True)
    return {"rates": list(SWEEP_RATES), "max_trials": n_trials,
            "columns": list(df.columns),
            "rows": _jsonable(df.to_dict("records")),
            "wall_s_cpu": time.time() - t0, "x64": bool(
                jax.config.jax_enable_x64)}


def sweep_from_log(path):
    """A sweep part that did not reach its end: the rates its run printed
    (the JAX function prints each rate's row as it finishes; here
    unrounded, so the values are exact)."""
    import re

    cols = ["rate", "default_mpjpe", "dd_mpjpe", "improvement_pct",
            "physics_mpjpe", "physics_vs_dd_pct"]
    pat = re.compile(r"\[sweep\] rate=(\S+): default (\S+) dd (\S+) "
                     r"\((\S+)%\) physics (\S+) \((\S+)% vs dd\)")
    with open(path, encoding="utf-8") as f:
        rows = [dict(zip(cols, map(float, m.groups())))
                for m in map(pat.match, f) if m]
    return {"rates": list(SWEEP_RATES), "columns": cols, "rows": rows,
            "recorded": [r["rate"] for r in rows],
            "from_log": os.path.basename(path)}


def studies_run(work, f64, n_trials):
    import jax
    dset = setup(work, True)
    from cheetah_pose_estimation_tpu.pipeline import batched, studies
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as prd

    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    prd.materialize_synthetic_testset(root)
    test_set = rd.TEST_SET[:n_trials]
    t0 = time.time()
    batched.run_monocular_batched(root, odir, test_set,
                                  modes=("ground-truth", "data-driven"),
                                  data_driven_dataset=dset,
                                  dtype=jax.numpy.float64, mesh=None)
    rec = {"trials": [os.path.join(d, c, t) for c, d, t in test_set],
           "tree_wall_s_cpu": time.time() - t0}
    jax.config.update("jax_enable_x64", f64)
    kw = dict(data_driven_dataset=dset,
              dtype=jax.numpy.float64 if f64 else jax.numpy.float32)
    t0 = time.time()
    rec["columns"] = {}
    for name, run in (
            ("grid", lambda: studies.run_grid_search_batched(
                root, odir, test_set, **GRID, mesh=None, **kw)),
            ("dd_ablation", lambda: studies.run_data_driven_ablation_batched(
                root, odir, test_set, **kw)),
            ("physics_ablation", lambda: studies.run_physics_ablation_batched(
                root, odir, test_set, **kw))):
        df = run()
        rec["columns"][name] = list(df.columns)
        rec[name] = _jsonable(df.to_dict("records"))
        with open(os.path.join(work, "partial.json"), "w",
                  encoding="utf-8") as f:       # kept if a later study fails
            json.dump(rec, f, sort_keys=True)
    rec["wall_s_cpu"] = time.time() - t0
    return rec


def run_part(part, work, n_trials):
    small = n_trials < 2
    if part == "models":
        return models_run(work, small)
    kind, dt = part.split("_")
    if kind == "sweep":
        return sweep_run(work, dt == "f64", 1 if small else 4)
    return studies_run(work, dt == "f64", n_trials)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=2,
                    help="test trials of the studies (1: the small check, "
                         "which also cuts the sweep and model selection)")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_studies_f64.json"))
    ap.add_argument("--run", choices=PARTS, default=None)
    ap.add_argument("--keep", default=None,
                    help="keep the trees and the outputs in this directory")
    ap.add_argument("--merge", action="store_true",
                    help="with --keep: make no run, merge the records there")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("CHEETAH_NO_COMPILE_CACHE", "1")
    work = args.keep or tempfile.mkdtemp(prefix="jax_studies_")
    if args.run:
        rec = run_part(args.run, os.path.join(work, args.run), args.trials)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rec, f, sort_keys=True)
        print(f"wrote {args.out}")
        return
    # XLA's CPU thread pools oversubscribe the cores when processes share
    # them: each runs on two threads
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=2")
    procs = []
    for part in PARTS if not args.merge else ():
        if os.path.exists(os.path.join(work, f"{part}.json")):
            continue
        with open(os.path.join(work, f"{part}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--run", part,
                 "--trials", str(args.trials), "--out",
                 os.path.join(work, f"{part}.json"), "--keep", work],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    if any([p.wait() for p in procs]):
        raise SystemExit("a part failed")
    import jax
    parts = {}
    for part in PARTS:
        path = os.path.join(work, f"{part}.json")
        if part.startswith("sweep") and not os.path.exists(path):
            parts[part] = sweep_from_log(os.path.join(work, f"{part}.log"))
            continue
        if part.startswith("studies") and not os.path.exists(path):
            # a studies part stopped before its end: the studies it
            # finished (printed only by the smoke)
            path = os.path.join(work, part, "partial.json")
            if not os.path.exists(path):
                parts[part] = {}
                continue
        with open(path, encoding="utf-8") as f:
            parts[part] = json.load(f)
    result = {
        "about": ("JAX package pipeline/studies.py on the host CPU: "
                  "model_selection_analysis and the grid's model statistics "
                  "(x64), run_degradation_sweep(rates=(0, 8), max_trials=4, "
                  "include_physics=True) in f64 and f32 (rows unrounded), "
                  "and the batched grid search and both ablations on the "
                  "port's rendering of the first test trials with a "
                  "float64 output tree, in f64 and f32; priors trained "
                  "under x64 on the procedural pose tables; tests/data/"
                  "jax_studies_reference.py"),
        "platform": platform.processor() or platform.machine(),
        "jax": jax.__version__, "trials": args.trials,
        "models": parts["models"],
        "sweep": {"f64": parts["sweep_f64"], "f32": parts["sweep_f32"]},
        "studies": {"f64": parts["studies_f64"],
                    "f32": parts["studies_f32"]},
        "parts_complete": {p: os.path.exists(os.path.join(work, f"{p}.json"))
                           for p in PARTS}}
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, sort_keys=True, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
