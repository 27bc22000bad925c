"""Record what chip_smoke phase 18 ("rest") holds the PyTorch port to: the
JAX package's native (C++) read of phase 9's tree, and its single-trial
example (``examples/single_trial.py``) in float64 and float32, on the host
CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_rest_reference.py

Parts, each in a process of its own:

* ``tree``: the port's rendering of the dataset CLI's synthetic test set
  (``run_dataset --materialize_synthetic``, phase 9's tree); per trial the
  digest (``chip_smoke.digest``) of the JAX package's default read
  (``load_dlc_points``, its C++ parser: float32 pixels and likelihoods),
  the digest of the exact read (the port's ``use_native=False``, as the
  earlier references read the tree) and the largest gaps between the two
  reads' pixels and likelihoods;
* ``example_f64``: the JAX example's trial as the example renders it (the
  procedural 60-frame gallop, 6 fisheye cameras, x64 on), read as the
  example reads it (the C++ parser), and its multi-view kinematic solve in
  float64: the MPE against the synthetic truth;
* ``example_f32``: the same in float32 (x64 off, as the example runs by
  default);
* ``example_rest_f64``: the example's remaining steps in float64 after its
  multi-view solve: the contacts, the physics solve's peak vertical GRF
  and largest torque, and the default and data-driven monocular modes
  against the multi-view solve (``compare_traj_error``); the data-driven
  priors trained under x64 on the procedural pose tables
  (``jax_acinoset_reference.train_priors``; the example's own dataset is
  not in the repository).

Writes ``tests/data/jax_rest_f64.json``. ``--run PART --out DIR/PART.json
--keep DIR`` makes one part; ``--merge --keep DIR`` joins the parts DIR
holds; the script with ``--keep DIR`` alone makes the parts DIR lacks.
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
PARTS = ("tree", "example_f64", "example_f32", "example_rest_f64")
XLA_FLAGS = ("--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=2")
EXAMPLE_PATH = os.path.join("2019_03_07", "phantom", "run")


def tree(keep):
    import chip_smoke

    from cheetah_pose_estimation_tpu.data import io as jio
    from cheetah_pose_estimation_tpu_torch.data import io as pio
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    root = os.path.join(keep, "cli_tree")
    run_dataset.main(["--materialize_synthetic", "--root_dir", root])
    out = {}
    for c, d, t in run_dataset.TEST_SET:
        p = os.path.join(d, c, t)
        dlc = os.path.join(root, p, "dlc")
        xn, ln, _ = jio.load_dlc_points(dlc)
        xe, le, _ = pio.load_dlc_points(dlc, use_native=False)
        out[p] = {"native": chip_smoke.digest(xn, ln),
                  "exact": chip_smoke.digest(xe, le),
                  "max_px_gap": float(np.nanmax(np.abs(xn - xe))),
                  "max_lik_gap": float(np.max(np.abs(ln - le))),
                  "max_px": float(np.nanmax(np.abs(xe)))}
    return {"trials": list(out), "tree": out}


def _render_example(root):
    """The JAX example's trial, rendered as the example renders it."""
    from cheetah_pose_estimation_tpu.data import synthetic as syn
    from cheetah_pose_estimation_tpu.models import params as P
    from cheetah_pose_estimation_tpu.models import skeleton as sk

    q_gt = syn.gallop_trajectory(60, seed=0)
    subject = P.get_subject("acinoset")
    markers = np.asarray(sk.fk_markers(q_gt, subject))
    scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=6, seed=3)
    trial = syn.synthesize(q_gt, subject, scene, noise_px=1.5, seed=3)
    syn.write_trial_dir(trial, root, EXAMPLE_PATH, monocular_cam=2)
    return trial


def example(keep, tag):
    from cheetah_pose_estimation_tpu.data import io as dio
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod

    root = os.path.join(keep, f"example_{tag}")
    trial = _render_example(root)
    t0 = time.time()
    est = est_mod.init_trajectory(root, EXAMPLE_PATH, "acinoset",
                                  kinematic_model=True)
    ok = est_mod.estimate_kinematics(est)
    d = dio.load_fte_pickle(os.path.join(root, EXAMPLE_PATH,
                                         "fte_kinematic", "fte.pickle"))
    err = np.linalg.norm(d["positions"] - trial.markers_gt, axis=2)
    return {"ok": bool(ok), "mv_mpe_mm": float(err.mean() * 1e3),
            "obj_cost": float(est.obj_cost), "wall_s_cpu": time.time() - t0}


def example_rest(keep):
    from jax_acinoset_reference import train_priors

    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu.pipeline import metrics

    root = os.path.join(keep, "example_rest")
    _render_example(root)
    t0 = time.time()
    est = est_mod.init_trajectory(root, EXAMPLE_PATH, "acinoset",
                                  kinematic_model=True)
    est_mod.estimate_kinematics(est)
    est2 = est_mod.init_trajectory(root, EXAMPLE_PATH, "acinoset",
                                   kinematic_model=False)
    contacts, _ = est_mod.determine_contacts(est2)
    est_mod.estimate_kinetics(est2, joint_estimation=True)
    out = {"contacts": contacts, "peak_grf_bw": float(est2.grf_z.max()),
           "tau_max": float(np.abs(est2.tau).max())}
    dset = train_priors(keep)
    est3 = est_mod.init_trajectory(root, EXAMPLE_PATH, "acinoset",
                                   kinematic_model=True,
                                   monocular_enable=True)
    est_mod.estimate_kinematics(est3)
    est4 = est_mod.init_trajectory(root, EXAMPLE_PATH, "acinoset",
                                   kinematic_model=True,
                                   monocular_enable=True)
    est_mod.estimate_kinematics(est4, monocular_constraints=True,
                                data_driven_dataset=dset)
    scores = metrics.compare_traj_error(os.path.join(root, EXAMPLE_PATH),
                                        cam_idx=2, save_plots=False)
    out["monocular"] = {m: {k: float(v) for k, v in s.items()
                            if k != "per_joint"} for m, s in scores.items()}
    out["wall_s_cpu"] = time.time() - t0
    return out


def run_part(part, keep):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", part != "example_f32")
    if part == "tree":
        return tree(keep)
    if part == "example_rest_f64":
        return example_rest(keep)
    return example(keep, part.split("_")[1])


def spawn(part, keep):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS=XLA_FLAGS)
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--run", part, "--out",
         os.path.join(keep, f"{part}.json"), "--keep", keep], env=env)


def merge(keep, out):
    import jax

    rec = {"created_by": "tests/data/jax_rest_reference.py",
           "jax": jax.__version__, "machine": platform.machine(),
           "dtype": "float64; example_f32: float32"}
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
    ap.add_argument("--out", default=os.path.join(HERE, "jax_rest_f64.json"))
    ap.add_argument("--keep", help="work directory (kept)")
    ap.add_argument("--merge", action="store_true")
    args = ap.parse_args()
    keep = args.keep or tempfile.mkdtemp(prefix="jax_rest_")
    os.makedirs(keep, exist_ok=True)
    if args.run:
        rec = run_part(args.run, keep)
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(rec, f, indent=1)
        return 0
    if not args.merge:
        todo = [p for p in PARTS
                if not os.path.exists(os.path.join(keep, f"{p}.json"))]
        procs = {p: spawn(p, keep) for p in todo}
        if any(pr.wait() != 0 for pr in procs.values()):
            raise RuntimeError("a part failed")
    merge(keep, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
