"""Record the JAX package's dataset CLI run on the synthetic test set, in
float32 on the host CPU, for the PyTorch port to be held against.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_cli_reference.py

1. Writes the procedural pose tables (training seeds 100-139 as
   ``dataset_full_pose.csv``, validation seeds 200-209 as
   ``validation_dataset.csv`` and, through the JAX package's h5py writer,
   as the ``validation_dataset.h5`` the CLI looks for; 240 frames each; the
   recipe of ``jax_stage15_reference.pose_table_frame``) to a temporary
   directory.
2. Trains the priors there under ``jax.enable_x64(True)``, with the CLI's
   own calls and cache directory: ``gmm.fit`` (K = 5, seed 42) and
   ``armodel.train_motion_model`` (window 4, lasso). The CLI trains its
   priors with x64 off, that is in float32, although the code intends
   float64; its prior caches are keyed by the data and the settings, not by
   the precision, so the CLI below loads these float64-trained priors.
3. Runs the CLI with x64 off: ``--materialize_synthetic`` (the 10-trial
   test set; without the reference tree its ground truth is the procedural
   gallops of 40 + 2i frames), then ``--run_monocular --batched --clean``
   with ``CHEETAH_DATA_DRIVEN_DATASET`` naming the training table: the
   multi-view ground-truth mode, the default mode with the ground-plane
   polish, the data-driven mode and the physics-based mode.
4. Runs the same CLI modes once more on the PyTorch port's rendering of
   the test set (``cheetah_pose_estimation_tpu_torch.pipeline.run_dataset
   --materialize_synthetic``, float64 on the host; the JAX CLI reads its
   CSV tables). The JAX CLI renders in float32, so the two trees differ by
   up to ~5e-4 px, and some monocular trials move by tens of mm under such
   a difference; this run solves exactly the input the port solves.

Writes ``tests/data/jax_cli_f32.json``:

* ``tree``: per trial, a digest of the rendered DLC tables
  (``chip_smoke.digest``:
  the likelihood gate pattern's md5, the gated count, the likelihood sum,
  four L1-normalised random projections of the pixels) and the metadata's
  ground plane height;
* ``modes``: per mode, per trial, MPE, MPJPE and CoM-velocity RMSE against
  the multi-view solve, unrounded (the metrics of ``dataset_post_process``
  from the ``fte.pickle`` files) and as ``dataset_results.csv`` gives them,
  MPJPE against the synthetic ground truth, and the final objective the
  mode saved (``obj_cost``); the wall seconds per mode on this CPU;
* ``decisions``: the data-driven prior gate, the depth line-scan shifts, the
  default mode's ray shifts and which trials its anchored polish changed,
  the contact JSON files and the physics mode's pruned stance matrices;
* ``artifacts``: the keys and shapes of every ``fte.pickle``, the header and
  row count of every ``cam*_fte.csv``, the keys of every contact JSON file
  and the layout of ``dataset_results.csv``, by path under the output
  directory;
* ``port_tree``: the digest of the port's rendering (``tree``) and the
  run of step 4 on it (``modes``, ``results_csv``, ``decisions``,
  ``wall_s_cpu``, ``stdout``).

``--trials 2 --out /tmp/x.json`` checks the script itself on two trials.
"""
import argparse
import contextlib
import csv
import io as _io
import json
import os
import pickle
import platform
import sys
import tempfile
import time
from glob import glob

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
# how a tree and the CLI's outputs are recorded, shared with the port's smoke
from chip_smoke import artifacts, digest  # noqa: E402
TRAIN_SEEDS = tuple(range(100, 140))
VAL_SEEDS = tuple(range(200, 210))
MODE_DIRS = (("default", "fte_kinematic_orig_{c}"),
             ("data-driven", "fte_kinematic_{c}"),
             ("physics-based", "fte_kinetic_{c}"))


def mode_scores(root_dir, out_dir, test_set, cam_overrides=None):
    """Per mode, per trial: MPE, MPJPE and CoM-velocity RMSE against the
    multi-view solve (``dataset_post_process``'s metrics, unrounded) and
    MPJPE against the synthetic ground truth."""
    from cheetah_pose_estimation_tpu.pipeline import metrics

    res = {}
    for idx, (cheetah, date, trial) in enumerate(test_set):
        path = os.path.join(date, cheetah, trial)
        base = os.path.join(out_dir, path)
        with open(os.path.join(base, "fte_kinematic", "fte.pickle"),
                  "rb") as f:
            gt = pickle.load(f)
        with open(os.path.join(root_dir, path, "synthetic_gt.pickle"),
                  "rb") as f:
            true = np.asarray(pickle.load(f)["positions"], np.float64)
        with open(os.path.join(root_dir, path, "metadata.json"),
                  encoding="utf-8") as f:
            cam = json.load(f)["monocular_cam"]
        if cam_overrides is not None:
            cam = cam_overrides[idx]
        for mode, sub in (("ground-truth", "fte_kinematic"),) + MODE_DIRS:
            p = os.path.join(base, sub.format(c=cam), "fte.pickle")
            if not os.path.exists(p):
                continue
            with open(p, "rb") as f:
                d = pickle.load(f)
            n = min(len(d["positions"]), len(gt["positions"]))
            mpjpe, _, _ = metrics.traj_error(
                gt["positions"][:n].copy(), d["positions"][:n].copy(),
                mode, centered=True, verbose=False)
            mpe, _, smooth = metrics.traj_error(
                gt["positions"][:n].copy(), d["positions"][:n].copy(),
                mode, verbose=False)
            cv = metrics.rmse(np.asarray(gt["com_vel"])[:n - 1],
                              np.asarray(d["com_vel"])[:n - 1])
            pos = np.asarray(d["positions"], np.float64)[:len(true)]
            err = (pos - pos.mean(1, keepdims=True)) \
                - (true - true.mean(1, keepdims=True))
            res.setdefault(mode, {})[path] = {
                "mpe": float(mpe.mean().iloc[0]),
                "mpjpe": float(mpjpe.mean().iloc[0]),
                "com_vel_rmse": float(cv), "smoothness": float(smooth),
                "obj_cost": float(d["obj_cost"]),
                "mpjpe_vs_truth": float(np.linalg.norm(err, axis=2).mean()
                                        * 1e3)}
    return res


def results_table(out_dir):
    """``dataset_results.csv`` as {trial: {mode: {metric: value}}}."""
    with open(os.path.join(out_dir, "dataset_results.csv"),
              encoding="utf-8") as f:
        rows = list(csv.reader(f))
    trials, modes = rows[0][1:], rows[1][1:]
    out = {}
    for r in rows[2:]:
        for t, m, v in zip(trials, modes, r[1:]):
            out.setdefault(t, {}).setdefault(m, {})[r[0]] = float(v)
    return out


@contextlib.contextmanager
def instrumented(rec):
    """Record the discrete decisions the CLI takes into ``rec``, by
    wrapping the module functions it calls (nothing else changes)."""
    from cheetah_pose_estimation_tpu.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu.pipeline import batched
    from cheetah_pose_estimation_tpu.pipeline import depth_anchor as danchor
    from cheetah_pose_estimation_tpu.pipeline import estimator as est_mod

    saved = [(est_mod, "prior_gate_accept"), (danchor, "make_depth_linescan"),
             (danchor, "ray_depth_correction"), (batched, "_anchor_polish"),
             (pbatch, "pad_and_stack_kinetic")]
    orig = {(m, n): getattr(m, n) for m, n in saved}

    # each mode solves one batch per subject, in the order of their first
    # trials in the test set: the per-group lists are appended in that order
    def gate(*a, **k):
        ok = orig[(est_mod, "prior_gate_accept")](*a, **k)
        rec.setdefault("prior_ok", []).extend(np.asarray(ok, bool).tolist())
        return ok

    def make_scan(*a, **k):
        scan = orig[(danchor, "make_depth_linescan")](*a, **k)

        def wrapped(*aa, **kk):
            q, shifts = scan(*aa, **kk)
            rec.setdefault("scan_shifts", []).extend(
                np.asarray(shifts, np.float64).tolist())
            return q, shifts
        return wrapped

    def ray(*a, **k):
        q, stance, shift = orig[(danchor, "ray_depth_correction")](*a, **k)
        rec.setdefault("polish_ray_shift", []).append(float(shift[0]))
        rec.setdefault("polish_stance_frames", []).append(
            int(np.asarray(stance).sum()))
        return q, stance, shift

    def polish(qs, ests, *a, **k):
        out, live = orig[(batched, "_anchor_polish")](qs, ests, *a, **k)
        rec.setdefault("polish_changed", []).extend(
            bool(np.any(out[i] != qs[i])) for i in range(len(ests)))
        return out, live

    def stack_kinetic(kds, *a, **k):
        rec.setdefault("stance", []).extend(
            np.asarray(kd.stance, np.float64).astype(int).tolist()
            for kd in kds)
        return orig[(pbatch, "pad_and_stack_kinetic")](kds, *a, **k)

    new = {"prior_gate_accept": gate, "make_depth_linescan": make_scan,
           "ray_depth_correction": ray, "_anchor_polish": polish,
           "pad_and_stack_kinetic": stack_kinetic}
    for m, n in saved:
        setattr(m, n, new[n])
    try:
        yield rec
    finally:
        for (m, n), f in orig.items():
            setattr(m, n, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=None)
    ap.add_argument("--out", default=os.path.join(HERE, "jax_cli_f32.json"))
    ap.add_argument("--keep", default=None,
                    help="keep the tree and the outputs in this directory")
    args = ap.parse_args()

    work = args.keep or tempfile.mkdtemp(prefix="jax_cli_")
    root, out_dir = os.path.join(work, "videos"), os.path.join(work, "out")
    root_port = os.path.join(work, "videos_port")
    out_port = os.path.join(work, "out_port")
    dset = os.path.join(work, "priors", "dataset_full_pose.csv")
    # the CLI resolves its training table when the estimator is imported
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    os.environ.setdefault("CHEETAH_NO_COMPILE_CACHE", "1")
    sys.path.insert(0, HERE)
    import jax
    jax.config.update("jax_platforms", "cpu")

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
        # the CLI reads its validation table as validation_dataset.h5
        # beside the training table, and falls back to the .csv only when
        # that file exists but cannot be read
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
    # imported once the training table exists: the estimator resolves it
    # when it is imported
    from cheetah_pose_estimation_tpu.pipeline import batched
    from cheetah_pose_estimation_tpu.pipeline import estimator
    from cheetah_pose_estimation_tpu.pipeline import run_dataset
    assert estimator.DATA_DRIVEN_DATASET == dset

    test_set = run_dataset.TEST_SET[: args.trials] if args.trials \
        else run_dataset.TEST_SET
    trial_args = ["--trials", str(args.trials)] if args.trials else []
    t0 = time.time()
    run_dataset.main(["--materialize_synthetic", "--root_dir", root])
    t_render = time.time() - t0
    # the port's rendering of the same test set (float64 on the host): the
    # input the port solves
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset \
        as port_run_dataset
    port_run_dataset.main(["--materialize_synthetic", "--root_dir",
                           root_port])

    def digests(tree_root):
        tree = {}
        for cheetah, date, trial in run_dataset.TEST_SET:
            path = os.path.join(date, cheetah, trial)
            xy, lik, _ = dio.load_dlc_points(
                os.path.join(tree_root, path, "dlc"), use_native=False)
            tree[path] = dict(digest(xy, lik), ground_plane_height=float(
                dio.load_metadata(os.path.join(tree_root, path))[
                    "ground_plane_height"]))
        return tree

    from cheetah_pose_estimation_tpu.models import params as params_mod
    subj = [params_mod.get_subject(c).name for c, _, _ in test_set]
    paths = [os.path.join(d, c, t) for c, d, t in test_set]
    order = [p for s in dict.fromkeys(subj)
             for p, s2 in zip(paths, subj) if s2 == s]

    def run_cli(tree_root, out_dir):
        """The CLI's four modes on the tree at ``tree_root``: scores,
        results table, decisions, walls and the tail of its output."""
        rec, walls = {}, {}
        orig_run = batched.run_monocular_batched

        def timed_run(*a, **k):
            out = orig_run(*a, **k)
            walls.update(out)
            return out

        batched.run_monocular_batched = timed_run
        log = _io.StringIO()
        t0 = time.time()
        try:
            with instrumented(rec), contextlib.redirect_stdout(log):
                run_dataset.main(["--run_monocular", "--batched", "--clean",
                                  "--root_dir", tree_root, "--out_dir_prefix",
                                  out_dir] + trial_args)
        finally:
            batched.run_monocular_batched = orig_run
            sys.stdout.write(log.getvalue())
        walls["cli"] = time.time() - t0
        contacts = {}
        for p in sorted(glob(os.path.join(out_dir, "**", "grf",
                                          "autogen-contact*.json"),
                             recursive=True)):
            with open(p, encoding="utf-8") as f:
                contacts[os.path.relpath(p, out_dir)] = json.load(f)
        return {
            "modes": mode_scores(tree_root, out_dir, test_set),
            "results_csv": results_table(out_dir),
            "decisions": {
                "group_order": order,
                **{k: dict(zip(order, rec.get(k, [])))
                   for k in ("prior_ok", "scan_shifts", "polish_ray_shift",
                             "polish_stance_frames", "polish_changed",
                             "stance")},
                "contacts": contacts,
            },
            "wall_s_cpu": walls,
            "stdout": log.getvalue().splitlines()[-60:],
        }

    own = run_cli(root, out_dir)
    on_port = run_cli(root_port, out_port)
    result = {
        "about": ("JAX package dataset CLI, float32 (x64 off), host CPU; "
                  "priors trained under x64 on the procedural pose tables "
                  "(seeds 100-139 / 200-209), not AcinoSet data; "
                  "tests/data/jax_cli_reference.py"),
        "platform": platform.processor() or platform.machine(),
        "jax": jax.__version__,
        "trials": paths,
        "tree": digests(root),
        **own,
        "artifacts": artifacts(out_dir),
        "port_tree": {"tree": digests(root_port), **on_port},
    }
    result["wall_s_cpu"].update(priors=t_priors, render=t_render)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
