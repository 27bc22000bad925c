"""Record the JAX package's estimator options that chip_smoke phase 15
runs (the joint shutter-delay solve, the kinetic complementarity penalty,
the kinetic 3D tracking mode and the rolling AR refinement), in float64 on
the host CPU (the shutter solve in float32 too), for the PyTorch port to
be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_options_reference.py

The input is the port's rendering of phase 15's trial
(``chip_smoke.render_options_trial``: a 64-frame procedural gallop seen by
four fisheye cameras, camera 2 late by 0.4 frame periods), read through
pandas as the port reads it. Five parts, each in a process of its own
(``kinematic`` first; ``lcp`` and ``track`` start from its solution):

* ``kinematic``: ``init_trajectory(..., shutter_delay_estimation=True)``
  and ``estimate_kinematics`` (saved under the work directory), then
  ``determine_contacts``: the solved delays, the scores against the truth
  (``chip_smoke.options_scores``) and the objective;
* ``lcp`` and ``track``: ``estimate_kinetics(enable_lcp=True)`` and
  ``estimate_kinetics(use_2d_reprojections=False)`` from that solution:
  scores, objective, ``check_lcp`` (``chip_smoke.lcp_summary``);
* ``kinematic_f32``: the same kinematic part in float32 (x64 off, as the
  JAX package runs by default): how far float32 moves the delays;
* ``rolling``: the dataset CLI's synthetic test set (the port's
  ``--materialize_synthetic``), the priors trained under x64 on the
  procedural pose tables, and the first trial's data-driven
  ``estimate_kinematics`` with ``motion_prior_rolling`` 1 and 0: MPJPE and
  MPE against the truth.

Writes ``tests/data/jax_options_f64.json``. ``--run PART --out
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
PARTS = ("kinematic", "lcp", "track", "rolling", "kinematic_f32")
XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=2")


def kinematic(keep, out="out"):
    import chip_smoke
    from jax_acinoset_reference import exact_csv_reader

    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod

    exact_csv_reader()
    root, odir = os.path.join(keep, "tree"), os.path.join(keep, out)
    truth = chip_smoke.render_options_trial(root)
    t0 = time.time()
    est = est_mod.init_trajectory(root, chip_smoke.OPTIONS_PATH, "phantom",
                                  kinematic_model=True,
                                  shutter_delay_estimation=True)
    ok = est_mod.estimate_kinematics(est, out_dir_prefix=odir)
    wall = time.time() - t0
    est_mod.determine_contacts(est, out_dir_prefix=odir)
    with open(os.path.join(odir, chip_smoke.OPTIONS_PATH, "grf",
                           "autogen-contact.json"), encoding="utf-8") as f:
        contacts = json.load(f)
    return {"ok": bool(ok), "tau": [float(t) for t in est.shutter_delay],
            "true_tau": truth["true_tau"], "h": truth["h"],
            "obj_cost": float(est.obj_cost),
            **chip_smoke.options_scores(est.q, truth),
            "contacts": contacts, "wall_s_cpu": wall}


def kinetic(keep, **options):
    import chip_smoke
    from jax_acinoset_reference import exact_csv_reader

    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod

    exact_csv_reader()
    root, odir = os.path.join(keep, "tree"), os.path.join(keep, "out")
    truth = chip_smoke.render_options_trial(os.path.join(keep, "tree_again"))
    t0 = time.time()
    est = est_mod.init_trajectory(root, chip_smoke.OPTIONS_PATH, "phantom",
                                  kinematic_model=True)
    ok = est_mod.estimate_kinetics(est, out_dir_prefix=odir, save=False,
                                   **options)
    return {"ok": bool(ok), "obj_cost": float(est.obj_cost),
            **chip_smoke.options_scores(est.q, truth),
            "check_lcp": chip_smoke.lcp_summary(
                est.q, est.grf_z, est.params.ground_plane_height),
            "grf_z_max": float(np.max(est.grf_z)),
            "wall_s_cpu": time.time() - t0}


def rolling(keep):
    import pickle

    import jax
    from jax_acinoset_reference import exact_csv_reader, train_priors

    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu_torch.pipeline import metrics
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    exact_csv_reader()
    root = os.path.join(keep, "cli_tree")
    run_dataset.TEST_SET = run_dataset.TEST_SET[:1]
    run_dataset.main(["--materialize_synthetic", "--root_dir", root])
    (cheetah, date, name), = run_dataset.TEST_SET
    path = os.path.join(date, cheetah, name)
    dset = train_priors(keep)
    with open(os.path.join(root, path, "synthetic_gt.pickle"), "rb") as f:
        true = pickle.load(f)["positions"]
    out = {"trial": path}
    with jax.enable_x64(True):
        for r in (1, 0):
            t0 = time.time()
            est = est_mod.init_trajectory(root, path, cheetah,
                                          monocular_enable=True,
                                          kinematic_model=True)
            ok = est_mod.estimate_kinematics(
                est, monocular_constraints=True, data_driven_dataset=dset,
                motion_prior_rolling=r, save=False)
            out[f"rolling_{r}"] = {
                "ok": bool(ok), "obj_cost": float(est.obj_cost),
                "mpjpe": float(metrics.traj_error(
                    true, _positions(est.q, cheetah), centered=True)[0]
                    .mean()),
                "mpe": float(metrics.traj_error(
                    true, _positions(est.q, cheetah))[0].mean()),
                "wall_s_cpu": time.time() - t0}
    return out


def _positions(q, cheetah):
    import torch

    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.models import skeleton as sk

    return sk.fk_markers(torch.as_tensor(np.asarray(q, np.float64)),
                         params.get_subject(cheetah)).numpy()


def run_part(part, keep):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", part != "kinematic_f32")
    if part == "kinematic":
        return kinematic(keep)
    if part == "kinematic_f32":
        return kinematic(keep, out="out_f32")
    if part == "lcp":
        return kinetic(keep, enable_lcp=True)
    if part == "track":
        return kinetic(keep, use_2d_reprojections=False)
    return rolling(keep)


def spawn(part, keep):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=XLA_FLAGS)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--run", part, "--out",
         os.path.join(keep, f"{part}.json"), "--keep", keep], env=env)


def merge(keep, out):
    import jax

    rec = {"created_by": "tests/data/jax_options_reference.py",
           "jax": jax.__version__, "machine": platform.machine(),
           "dtype": "float64; kinematic_f32: float32"}
    for part in PARTS:
        p = os.path.join(keep, f"{part}.json")
        if os.path.exists(p):
            with open(p, encoding="utf-8") as f:
                rec[part] = json.load(f)
    with open(out, "w", encoding="utf-8") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {out}: {[p for p in PARTS if p in rec]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", choices=PARTS)
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_options_f64.json"))
    ap.add_argument("--keep", help="work directory (kept)")
    ap.add_argument("--merge", action="store_true")
    args = ap.parse_args()
    keep = args.keep or tempfile.mkdtemp(prefix="jax_options_")
    os.makedirs(keep, exist_ok=True)
    if args.run:
        rec = run_part(args.run, keep)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rec, f, indent=1)
        return 0
    if not args.merge:
        todo = [p for p in PARTS
                if not os.path.exists(os.path.join(keep, f"{p}.json"))]
        procs = {p: spawn(p, keep) for p in todo
                 if p in ("kinematic", "rolling", "kinematic_f32")}
        if "kinematic" in procs and procs["kinematic"].wait() != 0:
            raise RuntimeError("the kinematic part failed")
        for p in todo:
            if p in ("lcp", "track"):
                procs[p] = spawn(p, keep)
        if any(pr.wait() != 0 for pr in procs.values()):
            raise RuntimeError("a part failed")
    merge(keep, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
