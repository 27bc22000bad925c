"""Record the JAX package's serial per-trial dataset CLI run
(``run_dataset --run_monocular --clean`` without ``--batched``) on the
first three trials of the synthetic test set, in float32 on the host CPU,
for the PyTorch port's serial path to be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_serial_reference.py

The training tables and the priors are made as in
``jax_cli_reference.py``: the procedural pose tables (seeds 100-139 /
200-209), the validation table also as ``validation_dataset.h5``, and the
GMM and AR model trained under ``jax.enable_x64(True)`` into the CLI's own
prior cache, which the CLI then loads. The CLI then runs with x64 off, as
it runs by default, twice: on the JAX package's float32 rendering of the
test set and on the PyTorch port's float64 rendering (the input the port
solves; the two differ by up to ~5e-4 px).

Writes ``tests/data/jax_serial_f32.json``:

* ``tree``: per trial, the digest of the JAX rendering
  (``chip_smoke.digest``) and its ground plane height;
* ``modes``: per mode, per trial, MPE, MPJPE and CoM-velocity RMSE against
  the multi-view solve, MPJPE against the synthetic truth and the saved
  final objective ``obj_cost`` (``jax_cli_reference.mode_scores``);
* ``decisions``: per mode, per trial, what the serial path decided: the
  data-driven prior gate, the depth line-scan shift, the ground-plane ray
  shift, its stance frame count and whether the anchored polish changed
  the trajectory (default and data-driven modes), where the line-scan
  shifted, the objective of the saved q under the data of the re-polish
  that produced it (``obj_cost_repolish``: the JAX code saves the
  objective under the data of the solve before the shift), and for the
  physics-based mode the pruned stance matrix of the accepted attempt,
  each attempt's outcome and the 1-based index of the accepted attempt;
* ``artifacts``: the layout of every output file (``chip_smoke.artifacts``);
* ``wall_s_cpu``: per mode, per trial, the seconds on this CPU (each
  trial compiles its own solvers: not a device time);
* ``port_tree``: the same (``tree``, ``modes``, ``decisions``,
  ``wall_s_cpu``) for the run on the port's rendering.

* ``port_tree_exact`` (``--tree port_exact`` only): the run on the port's
  rendering with the tables read exactly (pandas, ``use_native=False``)
  instead of by the C++ parser that the CLI uses on CSV-only trees: how
  far the reference moves under its input's float32 read round-off
  (<= 6.1e-5 px on this tree).

``--trials 1 --out /tmp/x.json`` checks the script on one trial;
``--tree own``, ``--tree port`` or ``--tree port_exact`` runs one
rendering and writes a partial record, and ``--merge own.json port.json``
joins two partial records (``--merge_exact OUT.json PART.json`` adds a
``port_tree_exact`` record to a joined one).
"""
import argparse
import contextlib
import io as _io
import json
import os
import platform
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, HERE)
from chip_smoke import artifacts, digest  # noqa: E402

N_TRIALS = 3
ATTEMPTS = ("joint", "synthesised GRF", "synthesised GRF, no pose prior")


def _mode(est, monocular_constraints):
    if est.scene.cam_idx is None:
        return "ground-truth"
    return "data-driven" if monocular_constraints else "default"


@contextlib.contextmanager
def instrumented(rec):
    """Record the serial path's decisions into ``rec[mode][trial]`` and the
    wall seconds of each estimate into ``rec["wall_s"]``, by wrapping the
    module functions it calls (nothing else changes)."""
    import jax.numpy as jnp

    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as danchor
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod
    from cheetah_pose_estimation_tpu.solver import kinematic as kin
    from cheetah_pose_estimation_tpu.solver import kinetic as kn

    orig = {
        "estimate_kinematics": est_mod.estimate_kinematics,
        "estimate_kinetics": est_mod.estimate_kinetics,
        "prior_gate_accept": est_mod.prior_gate_accept,
        "make_depth_linescan": danchor.make_depth_linescan,
        "ray_depth_correction": danchor.ray_depth_correction,
        "prune_stance": kn.prune_stance,
        "make_solver": kin.KinematicFTE.make_solver,
    }
    cur = {}

    def kinematics(est, *a, **k):
        mode = _mode(est, k.get("monocular_constraints", False))
        cur.clear()
        cur.update(mode=mode, solves=[])
        t0 = time.time()
        ok = orig["estimate_kinematics"](est, *a, **k)
        r = rec.setdefault(mode, {}).setdefault(est.data_path, {})
        rec.setdefault("wall_s", {}).setdefault(mode, {})[est.data_path] = \
            time.time() - t0
        q = np.asarray(est.q, np.float64)
        if "ray_in" in cur:
            r["polish_ray_shift"] = cur["ray_shift"]
            r["polish_stance_frames"] = cur["ray_stance"]
            after = cur.get("scan_in", q)
            r["polish_changed"] = bool(np.any(after != cur["ray_in"]))
        if "prior_ok" in cur:
            r["prior_ok"] = cur["prior_ok"]
        if "scan_shift" in cur:
            r["scan_shift"] = cur["scan_shift"]
            if cur["scan_shift"] != 0.0:
                # the saved q came from the re-polish, the last solve
                data2 = cur["solves"][-1]
                r["obj_cost_repolish"] = float(est.fte.objective(
                    jnp.asarray(q, jnp.float32), data2))
        r["ok"] = bool(ok)
        return ok

    def kinetics(est, *a, **k):
        mode = "physics-based"
        cur.clear()
        cur.update(mode=mode)
        r = rec.setdefault(mode, {}).setdefault(est.data_path, {})
        atts = r.setdefault("attempts", [])
        t0 = time.time()
        try:
            ok = orig["estimate_kinetics"](est, *a, **k)
        except Exception as e:
            atts.append({"kw": k_of(k), "error": f"{type(e).__name__}: {e}"})
            raise
        finally:
            w = rec.setdefault("wall_s", {}).setdefault(mode, {})
            w[est.data_path] = w.get(est.data_path, 0.0) + time.time() - t0
        atts.append({"kw": k_of(k), "ok": bool(ok)})
        if ok and "attempt" not in r:
            r["attempt"] = len(atts)
            r["stance"] = cur["stance"]
        return ok

    def k_of(k):
        return {n: v for n, v in sorted(k.items())
                if n in ("joint_estimation", "synthesised_grf",
                         "disable_pose_prior")}

    def gate(*a, **k):
        ok = orig["prior_gate_accept"](*a, **k)
        cur["prior_ok"] = bool(np.asarray(ok))
        return ok

    def make_scan(*a, **k):
        scan = orig["make_depth_linescan"](*a, **k)

        def wrapped(*aa, **kk):
            cur["scan_in"] = np.asarray(aa[0], np.float64)[0]
            q, shifts = scan(*aa, **kk)
            cur["scan_shift"] = float(np.asarray(shifts)[0])
            return q, shifts
        return wrapped

    def ray(q, *a, **k):
        qc, stance, shift = orig["ray_depth_correction"](q, *a, **k)
        cur["ray_in"] = np.asarray(q, np.float64)
        cur["ray_shift"] = float(np.asarray(shift)[0])
        cur["ray_stance"] = int(np.asarray(stance).sum())
        return qc, stance, shift

    def prune(*a, **k):
        s = orig["prune_stance"](*a, **k)
        cur["stance"] = np.asarray(s, np.float64).astype(int).tolist()
        return s

    def make_solver(self, *a, **k):
        run = orig["make_solver"](self, *a, **k)

        def wrapped(q0, data, *aa, **kk):
            import jax
            if not isinstance(q0, jax.core.Tracer) and "solves" in cur:
                cur["solves"].append(data)
            return run(q0, data, *aa, **kk)
        return wrapped

    est_mod.estimate_kinematics = kinematics
    est_mod.estimate_kinetics = kinetics
    est_mod.prior_gate_accept = gate
    danchor.make_depth_linescan = make_scan
    danchor.ray_depth_correction = ray
    kn.prune_stance = prune
    kin.KinematicFTE.make_solver = make_solver
    try:
        yield rec
    finally:
        est_mod.estimate_kinematics = orig["estimate_kinematics"]
        est_mod.estimate_kinetics = orig["estimate_kinetics"]
        est_mod.prior_gate_accept = orig["prior_gate_accept"]
        danchor.make_depth_linescan = orig["make_depth_linescan"]
        danchor.ray_depth_correction = orig["ray_depth_correction"]
        kn.prune_stance = orig["prune_stance"]
        kin.KinematicFTE.make_solver = orig["make_solver"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=N_TRIALS)
    ap.add_argument("--out", default=os.path.join(HERE,
                                                  "jax_serial_f32.json"))
    ap.add_argument("--keep", default=None,
                    help="keep the trees and the outputs in this directory")
    ap.add_argument("--tree", choices=("own", "port", "both",
                                       "port_exact"), default="both")
    ap.add_argument("--merge", nargs=2, default=None,
                    metavar=("OWN_JSON", "PORT_JSON"))
    ap.add_argument("--merge_exact", nargs=2, default=None,
                    metavar=("JOINED_JSON", "EXACT_JSON"))
    args = ap.parse_args()
    if args.merge_exact:
        with open(args.merge_exact[0], encoding="utf-8") as f:
            result = json.load(f)
        with open(args.merge_exact[1], encoding="utf-8") as f:
            result["port_tree_exact"] = json.load(f)["port_tree_exact"]
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
        return
    if args.merge:
        with open(args.merge[0], encoding="utf-8") as f:
            result = json.load(f)
        with open(args.merge[1], encoding="utf-8") as f:
            result["port_tree"] = json.load(f)["port_tree"]
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(result, f, indent=1, sort_keys=True)
        print(f"wrote {args.out}")
        return

    work = args.keep or tempfile.mkdtemp(prefix="jax_serial_")
    dset = os.path.join(work, "priors", "dataset_full_pose.csv")
    # the CLI resolves its training table when the estimator is imported
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    os.environ.setdefault("CHEETAH_NO_COMPILE_CACHE", "1")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from jax_cli_reference import VAL_SEEDS, TRAIN_SEEDS, mode_scores
    from jax_stage15_reference import pose_table_frame

    from cheetah_pose_estimation_tpu.data import io as dio
    from cheetah_pose_estimation_tpu.priors import armodel, gmm
    from cheetah_pose_estimation_tpu.priors import dataset as prior_ds
    from cheetah_pose_estimation_tpu.utils import data_ops

    t0 = time.time()
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
    t_priors = time.time() - t0
    assert not jax.config.jax_enable_x64
    from cheetah_pose_estimation_tpu.pipeline import estimator
    from cheetah_pose_estimation_tpu.pipeline import run_dataset
    assert estimator.DATA_DRIVEN_DATASET == dset

    test_set = run_dataset.TEST_SET[: args.trials]
    paths = [os.path.join(d, c, t) for c, d, t in test_set]

    def digests(tree_root):
        tree = {}
        for path in paths:
            xy, lik, _ = dio.load_dlc_points(
                os.path.join(tree_root, path, "dlc"), use_native=False)
            tree[path] = dict(digest(xy, lik), ground_plane_height=float(
                dio.load_metadata(os.path.join(tree_root, path))[
                    "ground_plane_height"]))
        return tree

    def run_cli(tree_root, out_dir):
        """The serial CLI's four modes on the tree at ``tree_root``."""
        rec = {}
        log = _io.StringIO()
        t0 = time.time()
        try:
            with instrumented(rec), contextlib.redirect_stdout(log):
                run_dataset.main(["--run_monocular", "--clean",
                                  "--root_dir", tree_root,
                                  "--out_dir_prefix", out_dir,
                                  "--trials", str(args.trials)])
        finally:
            sys.stdout.write(log.getvalue())
        walls = rec.pop("wall_s", {})
        walls["cli"] = time.time() - t0
        return {"modes": mode_scores(tree_root, out_dir, test_set),
                "decisions": rec, "wall_s_cpu": walls,
                "stdout": log.getvalue().splitlines()[-80:]}

    result = {
        "about": ("JAX package serial dataset CLI (run_dataset "
                  "--run_monocular --clean), float32 (x64 off), host CPU; "
                  "priors trained under x64 on the procedural pose tables "
                  "(seeds 100-139 / 200-209), not AcinoSet data; "
                  "tests/data/jax_serial_reference.py"),
        "platform": platform.processor() or platform.machine(),
        "jax": jax.__version__, "trials": paths, "attempts": ATTEMPTS,
        "wall_s_cpu": {"priors": t_priors}}
    if args.tree in ("own", "both"):
        root, out_dir = os.path.join(work, "videos"), os.path.join(work,
                                                                   "out")
        t0 = time.time()
        run_dataset.main(["--materialize_synthetic", "--root_dir", root])
        result["wall_s_cpu"]["render"] = time.time() - t0
        own = run_cli(root, out_dir)
        result.update(tree=digests(root), modes=own["modes"],
                      decisions=own["decisions"], stdout=own["stdout"],
                      artifacts=artifacts(out_dir))
        result["wall_s_cpu"].update(own["wall_s_cpu"])
    if args.tree in ("port", "both", "port_exact"):
        from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset \
            as port_run_dataset
        root_port = os.path.join(work, "videos_port")
        out_port = os.path.join(work, "out_port")
        port_run_dataset.main(["--materialize_synthetic", "--root_dir",
                               root_port])
        key = "port_tree"
        if args.tree == "port_exact":
            from jax_acinoset_reference import exact_csv_reader
            exact_csv_reader()
            key = "port_tree_exact"
        result[key] = {"tree": digests(root_port),
                       **run_cli(root_port, out_port)}
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
