"""Record the JAX package's force-plate pipeline (``run_kinetic``,
``estimate_static_grf``, ``kinetic_analysis``) on the synthetic kinetic test
set, on the host CPU, for the PyTorch port's ``--run_kinetic`` to be held
against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_kinetic_reference.py

Three runs, each in a process of its own (the script starts them and
merges their records):

* ``f64``: float64 (x64 on) on the PyTorch port's rendering of the test set
  (``materialize_synthetic_kinetic_testset``, float64): the input the port
  solves, and what its gate compares with;
* ``f32``: float32 (x64 off, as the JAX CLI runs) on the same rendering;
* ``f32_own``: float32 on the JAX package's own rendering (printed only;
  left out of the record where it was not made).

Writes ``tests/data/jax_kinetic_f32.json``:

* ``tree`` and ``port_tree``: per trial, the digest (``chip_smoke.digest``)
  and the ground plane height of the JAX package's own (float32, x64 off)
  and of the port's rendering;
* per run: ``stages``, per stage (kinematic, kinetic, grf) and trial, the
  scores against the synthetic truth (``chip_smoke.kinetic_scores``), the
  pruned stance matrix (kinetic, grf), the GRF summary
  (``chip_smoke.grf_summary``) and the wall seconds on this CPU (each trial
  compiles its own solvers: not a device time); ``static_grf``, per trial,
  ``estimate_static_grf``'s GRFs with its pruned stance, and the static
  solver's GRFs on the contact file's unpruned stance; ``analysis``, what
  ``kinetic_analysis`` returned, each trial's gait contact table and curve
  names and the plots it wrote; ``artifacts``, the layout of every output
  file (``chip_smoke.artifacts``); and for ``f64`` the saved kinematic
  trajectory of each trial (``kinematic_q``), from which the port's static
  solver is held against JAX's on the card.

``--trials 1 --out /tmp/x.json`` checks the script on one trial;
``--run f64|f32|f32_own [--only 3,4] --out DIR/<run>[_3-4].json --keep
DIR`` runs one run (on some trials) alone; the script without ``--run``
and with ``--keep DIR`` makes no run that has records in DIR and merges
the parts, so runs can be split over processes; ``--merge --keep DIR``
only merges what DIR holds.
"""
import argparse
import contextlib
import io as _io
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
RUNS = ("f64", "f32", "f32_own")


@contextlib.contextmanager
def instrumented(rec):
    """Record each force-plate stage's wall seconds, outcome, pruned stance
    and GRFs into ``rec[stage][trial]`` by wrapping the estimator functions
    ``run_kinetic`` calls (nothing else changes)."""
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu.solver import kinetic as kn

    names = {"estimate_kinematics": "kinematic",
             "estimate_kinetics": "kinetic", "estimate_grf": "grf"}
    orig = {n: getattr(est_mod, n) for n in names}
    orig_prune = kn.prune_stance
    cur = {}

    def wrap(name):
        def run(est, *a, **k):
            cur.clear()
            t0 = time.time()
            ok = orig[name](est, *a, **k)
            r = {"ok": bool(ok), "wall_s_cpu": time.time() - t0}
            if "stance" in cur:
                r["stance"] = cur["stance"]
            if est.grf_z is not None:
                r["grf"] = {"grf_z": np.asarray(est.grf_z, np.float64),
                            "grf_xy": np.asarray(est.grf_xy, np.float64)}
            rec.setdefault(names[name], {})[est.data_path] = r
            return ok
        return run

    def prune(*a, **k):
        s = orig_prune(*a, **k)
        cur["stance"] = np.asarray(s, np.float64).astype(int).tolist()
        return s

    for n in names:
        setattr(est_mod, n, wrap(n))
    kn.prune_stance = prune
    try:
        yield rec
    finally:
        for n in names:
            setattr(est_mod, n, orig[n])
        kn.prune_stance = orig_prune


def digests(root, paths):
    from chip_smoke import digest

    from cheetah_pose_estimation_tpu.data import io as dio

    tree = {}
    for path in paths:
        xy, lik, _ = dio.load_dlc_points(os.path.join(root, path, "dlc"),
                                         use_native=False)
        tree[path] = dict(digest(xy, lik), ground_plane_height=float(
            dio.load_metadata(os.path.join(root, path))[
                "ground_plane_height"]))
    return tree


def truth_com_vel(root, path, fps=200.0):
    """The synthetic truth's CoM velocity (N - 1, 3) of trial ``path``,
    from the JAX package's skeleton in float64 on the CPU (what
    ``chip_smoke.truth_com_vel`` computes with the port's)."""
    import pickle

    import jax

    from cheetah_pose_estimation_tpu.models import params
    from cheetah_pose_estimation_tpu.models import skeleton as sk

    with open(os.path.join(root, path, "synthetic_gt.pickle"), "rb") as f:
        q = np.asarray(pickle.load(f)["q"], np.float64)
    subject = params.get_subject(path.split(os.sep)[-2])
    with jax.enable_x64(True):
        com = np.asarray(sk.com_position(jax.numpy.asarray(q), subject),
                         np.float64)
    return (com[1:] - com[:-1]) * fps


def one_run(run, trials, work):
    """One run on the trials of ``KINETIC_SET`` at the indices ``trials``:
    render (the port's tree, or JAX's own for ``f32_own``), then
    ``run_kinetic``, the static GRFs and ``kinetic_analysis``."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", run == "f64")
    from chip_smoke import artifacts, grf_summary, kinetic_scores

    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    from cheetah_pose_estimation_tpu.solver import kinetic as kn
    from cheetah_pose_estimation_tpu.solver import static_grf
    from cheetah_pose_estimation_tpu.utils.device import enable_compile_cache
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as prd

    # the trials share their shapes: a cache under the work directory
    # compiles each solver once
    enable_compile_cache(os.path.join(work, "jax_cache"))
    kset = [rd.KINETIC_SET[i] for i in trials]
    paths = [os.path.join("kinetic_dataset", d, c, f"trial{t}")
             for c, d, t in kset]
    root, odir = os.path.join(work, "videos"), os.path.join(work, "out")
    t0 = time.time()
    if run == "f32_own":
        rd.materialize_synthetic_kinetic_testset(root)
    else:
        prd.materialize_synthetic_kinetic_testset(root)
    rec = {"wall_s_cpu": {"render": time.time() - t0}, "trials": paths}
    stages = {}
    log = _io.StringIO()
    t0 = time.time()
    try:
        with instrumented(stages), contextlib.redirect_stdout(log):
            rd.run_kinetic(root, odir, kinetic_set=kset, verbose=True)
    finally:
        sys.stdout.write(log.getvalue())
    rec["wall_s_cpu"]["run_kinetic"] = time.time() - t0
    rec["stdout"] = log.getvalue().splitlines()[-60:]
    rec["stages"], rec["static_grf"], rec["kinematic_q"] = {}, {}, {}
    for (c, _, _), path in zip(kset, paths):
        scores = kinetic_scores(root, odir, path, truth_com_vel(root, path))
        for stage, sc in scores.items():
            r = dict(stages[stage][path], **sc)
            grf = r.pop("grf", None)
            if grf is not None:
                r.update(grf_summary(grf["grf_z"], grf["grf_xy"],
                                     r["stance"]))
            rec["stages"].setdefault(stage, {})[path] = r
        est = est_mod.init_trajectory(root, path, c, kinetic_dataset=True,
                                      kinematic_model=False)
        gz, gxy = est_mod.estimate_static_grf(est, out_dir_prefix=odir)
        d = est_mod._load_warm_start(est, False, odir)
        with open(os.path.join(odir, path, "grf", "autogen-contact.json"),
                  encoding="utf-8") as f:
            cj = json.load(f)
        N = d["q"].shape[0]
        contacts = kn.stance_matrix(cj["contacts"], cj["start_frame"], N)
        stance = kn.prune_stance(contacts, np.asarray(d["q"]), est.subject,
                                 1.0 / est.scene.fps)
        import jax.numpy as jnp
        gzc, gxyc = static_grf.estimate_static_grf(
            jnp.asarray(d["q"]), jnp.asarray(d["dq"]), jnp.asarray(d["ddq"]),
            jnp.asarray(contacts), est.subject)
        rec["static_grf"][path] = {
            "stance": np.asarray(stance).astype(int).tolist(),
            "grf_z": np.asarray(gz, np.float64).tolist(),
            "grf_xy": np.asarray(gxy, np.float64).tolist(),
            "stance_contacts": np.asarray(contacts).astype(int).tolist(),
            "grf_z_contacts": np.asarray(gzc, np.float64).tolist(),
            "grf_xy_contacts": np.asarray(gxyc, np.float64).tolist()}
        if run == "f64":
            rec["kinematic_q"][path] = np.asarray(d["q"],
                                                  np.float64).tolist()
    from cheetah_pose_estimation_tpu.pipeline import results as res_mod
    gait = {}
    orig_gait = res_mod.gait_analysis

    def record_gait(q, tau, contact_path, fps):
        ga = orig_gait(q, tau, contact_path, fps)
        gait[os.path.relpath(os.path.dirname(os.path.dirname(contact_path)),
                             odir)] = {
            "contacts": ga["contacts"],
            "curves": {k: sorted(ga[k]) for k in ("angle", "torque",
                                                  "power")}}
        return ga

    res_mod.gait_analysis = record_gait
    try:
        rec["analysis"] = {"returned": rd.kinetic_analysis(root, odir,
                                                           kinetic_set=kset),
                           "gait": gait}
    finally:
        res_mod.gait_analysis = orig_gait
    rec["artifacts"] = artifacts(odir)
    rec["tree"] = digests(root, paths)
    return rec


def _jsonable(x):
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def _union(recs):
    """One run's record from the records of its parts (disjoint trials)."""
    out = recs[0]
    for r in recs[1:]:
        out["trials"] += r["trials"]
        for k in ("static_grf", "kinematic_q", "artifacts", "tree"):
            out[k].update(r[k])
        for stage, d in r["stages"].items():
            out["stages"].setdefault(stage, {}).update(d)
        for k in ("returned", "gait"):
            out["analysis"][k].update(r["analysis"][k])
        out["stdout"] += r["stdout"]
        for k, v in r["wall_s_cpu"].items():
            out["wall_s_cpu"][k] = out["wall_s_cpu"].get(k, 0.0) + v
    return out


def parts(work, run):
    """The record files of ``run`` in ``work``: ``<run>.json`` and
    ``<run>_<indices>.json`` (``f32``'s are not ``f32_own``'s)."""
    import re

    pat = re.compile(re.escape(run) + r"(_[0-9-]+)?\.json")
    return sorted(os.path.join(work, f) for f in os.listdir(work)
                  if pat.fullmatch(f))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--only", default=None,
                    help="with --run: the comma-separated trial indices")
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_kinetic_f32.json"))
    ap.add_argument("--run", choices=RUNS, default=None)
    ap.add_argument("--keep", default=None,
                    help="keep the trees and the outputs in this directory")
    ap.add_argument("--merge", action="store_true",
                    help="with --keep: make no run, merge the records there")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    work = args.keep or tempfile.mkdtemp(prefix="jax_kinetic_")
    if args.run:
        trials = ([int(i) for i in args.only.split(",")] if args.only
                  else list(range(args.trials)))
        part = args.run + ("" if args.only is None
                           else "_" + "-".join(map(str, trials)))
        rec = one_run(args.run, trials, os.path.join(work, part))
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(_jsonable(rec), f, sort_keys=True)
        print(f"wrote {args.out}")
        return
    # the three runs as three processes (a run with records already in the
    # work directory, <run>.json or <run>_<indices>.json, is not made
    # again), then one record. XLA's CPU thread pools oversubscribe the
    # cores when three processes share them: each runs on two threads.
    env = dict(os.environ, XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=2")
    procs = []
    for run in RUNS if not args.merge else ():
        if parts(work, run):
            continue
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--run", run,
             "--trials", str(args.trials), "--out",
             os.path.join(work, f"{run}.json"), "--keep", work], cwd=REPO,
            env=env))
    if any([p.wait() for p in procs]):
        raise SystemExit("a run failed")
    import jax
    result = {
        "about": ("JAX package force-plate pipeline (run_dataset."
                  "run_kinetic, estimator.estimate_static_grf, run_dataset."
                  "kinetic_analysis) on the synthetic kinetic test set "
                  "(procedural 200 fps gallops, 4 pinhole cameras), host "
                  "CPU: f64 (x64 on) and f32 on the PyTorch port's "
                  "rendering, f32_own (where made) on the JAX package's "
                  "rendering; tree: the JAX rendering's digest; "
                  "tests/data/jax_kinetic_reference.py"),
        "platform": platform.processor() or platform.machine(),
        "jax": jax.__version__}
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as rd
    order = [os.path.join("kinetic_dataset", d, c, f"trial{t}")
             for c, d, t in rd.KINETIC_SET]
    for run in RUNS:
        recs = []
        for path in parts(work, run):
            with open(path, encoding="utf-8") as f:
                recs.append(json.load(f))
        if not recs:        # a run not made (f32_own is printed only)
            continue
        rec = _union(recs)
        rec["trials"] = [p for p in order if p in rec["trials"]]
        tree = rec.pop("tree")
        if run != "f32_own":
            result["port_tree"] = tree
        if run != "f64":
            rec.pop("kinematic_q")
        result[run] = rec
    result["trials"] = result["f64"].pop("trials")
    for run in RUNS[1:]:
        if run in result and result[run].pop("trials") != result["trials"]:
            raise SystemExit(f"run {run} has other trials than f64")
    # the JAX package's own rendering of the tree (host work, seconds)
    import jax
    jax.config.update("jax_platforms", "cpu")
    own = os.path.join(work, "jax_tree")
    rd.materialize_synthetic_kinetic_testset(own)
    result["tree"] = digests(own, result["trials"])
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, sort_keys=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
