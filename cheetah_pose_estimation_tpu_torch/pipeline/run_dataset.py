"""The dataset CLI: its monocular and force-plate paths.

Port of ``cheetah_pose_estimation_tpu/pipeline/run_dataset.py`` for
``--materialize_synthetic``, ``--run_monocular --clean`` (serial or
``--batched``) and ``--run_kinetic [--clean]``::

    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --materialize_synthetic --root_dir R
    CHEETAH_DATA_DRIVEN_DATASET=P \
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_monocular [--batched] --clean --root_dir R --out_dir_prefix O
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_kinetic --clean --root_dir R --out_dir_prefix O

The first renders the 10-trial synthetic test set (AcinoSet directory
layout, 6 fisheye cameras, correlated DLC failures) into R; the second
solves its four modes (multi-view ground truth, default, data-driven,
physics-based) on the card (``--device cpu`` for the CPU), writes each
trial's artifacts under O and the per-mode metrics against the multi-view
solve to ``O/dataset_results.csv``, in the layout pandas writes for the JAX
package. Without ``--batched`` each trial is solved alone, mode after mode
(:func:`run_monocular`); with it, each mode's trials of one subject are one
batch (``batched.run_monocular_batched``). The third runs the force-plate
pipeline (:func:`run_kinetic`) over the 5 trials of ``KINETIC_SET`` under
``R/kinetic_dataset`` and then its analysis (:func:`kinetic_analysis`); as
in the JAX CLI, no flag renders that tree
(:func:`materialize_synthetic_kinetic_testset` does). The study and
analysis flags are not defined, and the post-process plots are not made.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import io as dio
from ..data import synthetic as syn
from ..models import params as params_mod
from ..ops import cuda_banded
from ..utils.device import DeviceLike, resolve_device
from . import contacts as contacts_mod
from . import estimator as est_mod
from . import metrics as metrics_mod

# the reference's 10-trial monocular AcinoSet test set
TEST_SET: Tuple[Tuple[str, str, str], ...] = (
    ("jules", "2017_12_09/bottom", "flick2"),
    ("jules", "2019_03_09", "flick1"),
    ("phantom", "2019_03_03", "run"),
    ("phantom", "2017_09_02/top", "run1_2"),
    ("jules", "2017_08_29/top", "run1_2"),
    ("phantom", "2017_08_29/top", "run1_1"),
    ("jules", "2017_08_29/top", "run1_1"),
    ("jules", "2017_09_02/top", "run1"),
    ("phantom", "2019_03_07", "run"),
    ("jules", "2017_09_02/bottom", "run2"),
)

CAM_OVERRIDES = [0, 0, 0, 3, 3, 3, 5, 0, 3, 0]

# the 5 force-plate trials (cheetah, date, trial)
KINETIC_SET: Tuple[Tuple[str, str, str], ...] = (
    ("arabia", "2009_09_07", "06"),
    ("shiraz", "2009_09_07", "04"),
    ("shiraz", "2009_09_08", "04"),
    ("shiraz", "2009_09_11", "01"),
    ("shiraz", "2009_09_11", "02"),
)


def _reference_gt_trajectory(n_frames: int, seed: int,
                             fps: float = 120.0) -> np.ndarray:
    """Ground-truth q of a synthetic trial: the procedural gallop of
    ``n_frames`` at ``fps`` (the reference's shipped solutions, which the
    JAX package reads first where they exist, are not in the
    repository)."""
    return syn.gallop_trajectory(n_frames, fps=fps, seed=seed)


def kinetic_path(cheetah: str, date: str, trial: str) -> str:
    """The trial directory of a force-plate trial, under the root."""
    return os.path.join("kinetic_dataset", date, cheetah, f"trial{trial}")


def materialize_synthetic_testset(root_dir: str, n_cams: int = 6,
                                  seed: int = 0,
                                  noise_px: float = 1.5,
                                  occlusion_rate: float = 2.0,
                                  confusion_rate: float = 1.2) -> List[str]:
    """Write an AcinoSet-style directory tree for every test trial,
    rendered from its ground-truth trajectory through a ring of fisheye
    cameras with the correlated DLC failure model
    (``synthetic.corrupt_dlc``), plus ``synthetic_gt.pickle`` (q and
    markers) for scoring against the truth. Host work in float64."""
    made = []
    for i, (cheetah, date, trial_name) in enumerate(TEST_SET):
        data_path = os.path.join(date, cheetah, trial_name)
        q_gt = _reference_gt_trajectory(40 + 2 * i, i)
        subject = params_mod.get_subject(cheetah)
        fps = 120.0 if "2019" in date else 90.0
        markers = syn.fk_markers_np(q_gt, subject)
        scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=n_cams,
                                 fps=fps, seed=seed + i)
        tr = syn.synthesize(q_gt, subject, scene, noise_px=noise_px,
                            outlier_frac=0.02, seed=seed + i,
                            subject_name=cheetah,
                            occlusion_rate=occlusion_rate,
                            confusion_rate=confusion_rate)
        syn.write_trial_dir(tr, root_dir, data_path, monocular_cam=2,
                            ground_plane_height=contacts_mod.
                            estimate_ground_height(q_gt, subject))
        with open(os.path.join(root_dir, data_path, "synthetic_gt.pickle"),
                  "wb") as f:
            pickle.dump({"q": q_gt, "positions": tr.markers_gt}, f)
        made.append(data_path)
    return made


def materialize_synthetic_kinetic_testset(root_dir: str, n_cams: int = 4,
                                          seed: int = 100) -> List[str]:
    """Write synthetic copies of the 5 force-plate trials: 50-frame
    procedural gallops at 200 fps seen by ``n_cams`` pinhole cameras 6 m
    out (the 2009 kinetic-dataset rig), DLC noise 2 px and 1 % outliers,
    monocular camera 0, plus ``synthetic_gt.pickle``. Host work in
    float64."""
    made = []
    for i, (cheetah, date, trial) in enumerate(KINETIC_SET):
        data_path = kinetic_path(cheetah, date, trial)
        q_gt = _reference_gt_trajectory(50, seed + i, fps=200.0)
        subject = params_mod.get_subject(cheetah)
        markers = syn.fk_markers_np(q_gt, subject)
        scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=n_cams,
                                 fps=200.0, distance=6.0, fisheye=False,
                                 seed=seed + i)
        tr = syn.synthesize(q_gt, subject, scene, noise_px=2.0,
                            outlier_frac=0.01, seed=seed + i,
                            subject_name=cheetah)
        syn.write_trial_dir(tr, root_dir, data_path, monocular_cam=0,
                            ground_plane_height=contacts_mod.
                            estimate_ground_height(q_gt, subject))
        with open(os.path.join(root_dir, data_path, "synthetic_gt.pickle"),
                  "wb") as f:
            pickle.dump({"q": q_gt, "positions": tr.markers_gt}, f)
        made.append(data_path)
    return made


# the physics-based mode's attempts, in order: the LM solve is
# deterministic, so each fallback changes the problem: the GRFs solved for,
# then fixed to the synthesized profiles, then also without the pose prior
PHYSICS_ATTEMPTS = (dict(),
                    dict(synthesised_grf=True),
                    dict(synthesised_grf=True, disable_pose_prior=True))


def run_monocular(root_dir: str, dir_prefix: str,
                  test_set: Tuple = TEST_SET,
                  cam_overrides: Optional[List[int]] = None,
                  modes: Tuple[str, ...] = ("ground-truth", "default",
                                            "data-driven", "physics-based"),
                  data_driven_dataset: Optional[str] = None,
                  verbose: bool = True,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None,
                  report: Optional[dict] = None) -> None:
    """The serial per-trial path: each trial of ``test_set`` under
    ``root_dir`` in turn through ``modes``, each solve alone at the trial's
    own length on ``device`` (the card by default), artifacts under
    ``dir_prefix``:

    * ground-truth: ``estimate_kinematics`` on all cameras;
    * default: ``estimate_kinematics`` on the monocular camera (metadata's,
      or ``cam_overrides``);
    * data-driven: the same with the learned priors trained on
      ``data_driven_dataset``;
    * physics-based: contact detection and GRF synthesis on the saved
      kinematic solution, then ``estimate_kinetics`` in up to three
      attempts (``PHYSICS_ATTEMPTS``), stopping at the first acceptable
      one. An attempt that raises ``ValueError`` or ``FileNotFoundError``
      is reported and the next one tried; any other error propagates.

    With a ``report`` dict, per mode: the trials, and per trial the wall
    seconds, the kernel's launches per (B, N) and the decisions the solve
    reported (the physics mode's stance matrix, each attempt's outcome and
    the 1-based index of the accepted attempt, None when none was)."""
    dev = resolve_device(device)
    rep = {} if report is None else report
    t_start = time.time()

    def timed(mode, path, fn):
        """Run ``fn(trial_report)``, recording its wall and launches."""
        out, tr = _timed(dev, fn)
        m = rep.setdefault(mode, {"trials": [], "per_trial": {}})
        m["trials"].append(path)
        m["per_trial"][path] = tr
        return out

    kw = dict(out_dir_prefix=dir_prefix, solver_output=verbose, dtype=dtype,
              device=dev)
    for idx, (cheetah, date, trial_name) in enumerate(test_set):
        data_path = os.path.join(date, cheetah, trial_name)
        if not os.path.isdir(os.path.join(root_dir, data_path)):
            print(f"skip missing {data_path}")
            continue
        cam = cam_overrides[idx] if cam_overrides is not None else None
        if verbose:
            print(f"== {data_path} (cam={cam}) ==")
        trial = lambda **k: est_mod.init_trajectory(
            root_dir, data_path, cheetah, override_monocular_cam=cam, **k)
        if "ground-truth" in modes:
            timed("ground-truth", data_path,
                  lambda tr: est_mod.estimate_kinematics(
                      trial(kinematic_model=True), report=tr, **kw))
        if "default" in modes:
            timed("default", data_path,
                  lambda tr: est_mod.estimate_kinematics(
                      trial(monocular_enable=True, kinematic_model=True),
                      report=tr, **kw))
        if "data-driven" in modes:
            timed("data-driven", data_path,
                  lambda tr: est_mod.estimate_kinematics(
                      trial(monocular_enable=True, kinematic_model=True),
                      monocular_constraints=True,
                      data_driven_dataset=data_driven_dataset, report=tr,
                      **kw))
        if "physics-based" in modes:
            timed("physics-based", data_path,
                  lambda tr: _physics_attempts(trial, data_path, tr, kw))
    print(f"Run through all videos took {time.time() - t_start:.2f}s")


def _timed(dev: torch.device, fn):
    """Run ``fn(report)`` with a fresh report dict; returns (what ``fn``
    returned, the report with the wall seconds, synced on the card, and
    the kernel's launches per (B, N) made meanwhile added)."""
    before = dict(cuda_banded.launches_by_shape)
    tr: dict = {}
    t0 = time.time()
    out = fn(tr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tr["wall_s"] = time.time() - t0
    tr["launches"] = {k: v - before.get(k, 0) for k, v in
                      cuda_banded.launches_by_shape.items()
                      if v != before.get(k, 0)}
    return out, tr


def _physics_attempts(trial, data_path: str, tr: dict, kw: dict) -> bool:
    """The physics-based mode of one trial: ``PHYSICS_ATTEMPTS`` in order
    until one is acceptable; each attempt's outcome into ``tr``."""
    tr["attempts"], tr["attempt"] = [], None
    for attempt, akw in enumerate(PHYSICS_ATTEMPTS):
        est = trial(monocular_enable=True, kinematic_model=False)
        est_mod.determine_contacts(est, monocular=True,
                                   out_dir_prefix=kw["out_dir_prefix"])
        try:
            ok = est_mod.estimate_kinetics(est, report=tr, **akw, **kw)
        except (ValueError, FileNotFoundError) as e:
            print(f"physics-based attempt {attempt + 1} failed: "
                  f"{type(e).__name__}: {e}")
            tr["attempts"].append(f"{type(e).__name__}: {e}")
            continue
        tr["attempts"].append("ok" if ok else "not acceptable")
        if ok:
            tr["attempt"] = attempt + 1
            return True
        print(f"physics-based attempt {attempt + 1} ({akw}) not "
              "acceptable, trying fallback")
    print(f"physics-based FAILED for {data_path} (no acceptable solution "
          "in any configuration)")
    return False


def run_kinetic(root_dir: str, dir_prefix: str,
                kinetic_set: Tuple = KINETIC_SET, verbose: bool = True,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None,
                report: Optional[dict] = None) -> None:
    """The force-plate pipeline over the trials of ``kinetic_set`` found
    under ``root_dir``, each trial alone at its own length on ``device``
    (the card by default), artifacts under ``dir_prefix``:

    * kinematic: ``estimate_kinematics`` on all cameras (pinhole, 200 fps,
      the kinetic dataset's weights, joint limits and camera multipliers);
    * kinetic: contact detection and GRF synthesis on that solution, then
      ``estimate_kinetics`` with the GRFs fixed to the synthesized
      profiles (the JAX call also passes ``joint_estimation=False`` and
      ``ground_constraint=True``, neither of which changes its solve; the
      port's function takes neither);
    * grf: ``estimate_grf``, the GRFs re-solved with the torques anchored
      to the kinetic solution's.

    A stage whose solution is not finite ends the trial. With a ``report``
    dict, per stage: the trials, and per trial the wall seconds, the
    kernel's launches per (B, N), whether the stage succeeded, and for the
    kinetic and grf stages the pruned stance and the solved torques and
    GRFs."""
    dev = resolve_device(device)
    rep = {} if report is None else report
    t0 = time.time()
    kw = dict(out_dir_prefix=dir_prefix, solver_output=verbose, dtype=dtype,
              device=dev)
    for cheetah, date, trial in kinetic_set:
        data_path = kinetic_path(cheetah, date, trial)
        if not os.path.isdir(os.path.join(root_dir, data_path)):
            print(f"skip missing {data_path}")
            continue
        est_of = lambda kinematic_model: est_mod.init_trajectory(
            root_dir, data_path, cheetah, kinetic_dataset=True,
            kinematic_model=kinematic_model)

        def kinematic(tr):
            est = est_of(True)
            return est_mod.estimate_kinematics(est, **kw), est

        def kinetic(tr):
            est = est_of(False)
            est_mod.determine_contacts(est, out_dir_prefix=dir_prefix)
            return est_mod.estimate_kinetics(est, synthesised_grf=True,
                                             report=tr, **kw), est

        def grf(tr):
            est = est_of(False)
            return est_mod.estimate_grf(est, report=tr, **kw), est

        for stage, fn in (("kinematic", kinematic), ("kinetic", kinetic),
                          ("grf", grf)):
            (ok, est), tr = _timed(dev, fn)
            tr["ok"] = ok
            if est.tau is not None:
                tr.update(tau=est.tau, grf_z=est.grf_z, grf_xy=est.grf_xy)
            r = rep.setdefault(stage, {"trials": [], "per_trial": {}})
            r["trials"].append(data_path)
            r["per_trial"][data_path] = tr
            if not ok:
                break
    print(f"Run through all videos took {time.time() - t0:.2f}s")


def kinetic_analysis(root_dir: str, dir_prefix: str,
                     kinetic_set: Tuple = KINETIC_SET,
                     device: DeviceLike = None,
                     report: Optional[dict] = None) -> Dict:
    """Biomechanics analysis of the force-plate trials whose physics
    solution ``fte_kinetic`` exists under ``dir_prefix``: each trial's
    stance-normalised gait curves (``results.gait_analysis`` at 200 fps,
    on ``grf/autogen-contact.json``, else the trial's metadata), its
    torque plot ``torques.pdf`` and gait plot ``gait.pdf`` beside the
    stage directories, and, where the trial has hand labels
    (``dlc_hand_labeled``), the reprojection error of the physics solution
    against them. Where matplotlib is not installed, a line names each
    plot skipped. Returns {trial: reprojection statistics}; with
    ``report``, per trial the gait analysis and the plots written and
    skipped."""
    from ..dynamics.eom import tau_from_dict
    from . import results as results_mod

    dev = resolve_device(device)
    out = {}
    for cheetah, date, trial in kinetic_set:
        data_path = kinetic_path(cheetah, date, trial)
        base = os.path.join(dir_prefix, data_path)
        fte_p = os.path.join(base, "fte_kinetic", "fte.pickle")
        if not os.path.exists(fte_p):
            continue
        d = dio.load_fte_pickle(fte_p)
        cj_path = os.path.join(base, "grf", "autogen-contact.json")
        meta_path = os.path.join(root_dir, data_path, "metadata.json")
        contact_path = cj_path if os.path.exists(cj_path) else meta_path
        tau = tau_from_dict(d["tau"], d["q"].shape[0])
        ga = results_mod.gait_analysis(d["q"], tau, contact_path, fps=200.0,
                                       device=dev)
        plots = {"written": [], "skipped": []}
        for name, draw in (
                ("torques.pdf", lambda p: results_mod.plot_torques(
                    tau, 200.0, p)),
                ("gait.pdf", lambda p: results_mod.plot_gait_attributes(
                    ga, p))):
            path = os.path.join(base, name)
            plots["written" if draw(path) else "skipped"].append(path)
        if plots["skipped"]:
            print("matplotlib is not installed: skipped "
                  + ", ".join(plots["skipped"]))
        hand_dir = os.path.join(root_dir, data_path, "dlc_hand_labeled")
        if os.path.isdir(hand_dir):
            out[data_path] = results_mod.reprojection_errors(
                os.path.join(base, "fte_kinetic"), hand_dir)
        if report is not None:
            report[data_path] = {"gait": ga, "plots": plots}
    return out


MODE_DIRS = (("default", "fte_kinematic_orig_{cam}"),
             ("data-driven", "fte_kinematic_{cam}"),
             ("physics-based", "fte_kinetic_{cam}"))
METRICS = ("mpe", "mpjpe", "CoM vel rmse", "smoothness error", "time")


def trial_scores(gt: Dict, d: Dict) -> Dict[str, float]:
    """Unrounded scores of the solution ``d`` against the multi-view one
    ``gt`` (fte.pickle dicts): MPE and MPJPE in mm, CoM-velocity RMSE in
    m/s, smoothness error in mm, over their common frames."""
    n = min(len(d["positions"]), len(gt["positions"]))
    X, Y = gt["positions"][:n], d["positions"][:n]
    mpjpe, _, _ = metrics_mod.traj_error(X, Y, centered=True)
    mpe, _, smooth = metrics_mod.traj_error(X, Y)
    return {"mpe": float(mpe.mean()), "mpjpe": float(mpjpe.mean()),
            "CoM vel rmse": metrics_mod.rmse(
                np.asarray(gt["com_vel"])[:n - 1],
                np.asarray(d["com_vel"])[:n - 1]),
            "smoothness error": smooth}


def dataset_post_process(root_dir: str, dir_prefix: str,
                         test_set: Tuple = TEST_SET,
                         cam_overrides: Optional[List[int]] = None
                         ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """Per trial and mode, MPE, MPJPE, CoM-velocity RMSE, smoothness error
    (against the multi-view solve) and solve time, rounded as the JAX
    package rounds them, written to ``dataset_results.csv``: one column per
    (trial, mode) under a two-row header, one row per metric, as pandas
    writes ``concat({trial: DataFrame(modes)}, axis=1)``. Returns
    {trial: {mode: {metric: value}}}."""
    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    for idx, (cheetah, date, trial_name) in enumerate(test_set):
        data_path = os.path.join(date, cheetah, trial_name)
        base = os.path.join(dir_prefix, data_path)
        if not os.path.exists(os.path.join(base, "fte_kinematic",
                                           "fte.pickle")):
            continue
        if cam_overrides is not None:
            cam_idx = cam_overrides[idx]
        else:
            cam_idx = dio.load_metadata(os.path.join(
                root_dir, data_path))["monocular_cam"]
        gt = dio.load_fte_pickle(os.path.join(base, "fte_kinematic",
                                              "fte.pickle"))
        entry: Dict[str, Dict[str, float]] = {}
        for mode, sub in MODE_DIRS:
            p = os.path.join(base, sub.format(cam=cam_idx), "fte.pickle")
            if not os.path.exists(p):
                continue
            d = dio.load_fte_pickle(p)
            sc = trial_scores(gt, d)
            entry[mode] = {
                "mpe": round(sc["mpe"], 1), "mpjpe": round(sc["mpjpe"], 1),
                "CoM vel rmse": round(sc["CoM vel rmse"], 2),
                "smoothness error": round(sc["smoothness error"], 1),
                "time": round(float(d["processing_time_s"] or 0.0), 1)}
        if entry:
            results[data_path] = entry
    if not results:
        return results
    cols = [(t, m) for t, e in results.items() for m in e]
    os.makedirs(dir_prefix, exist_ok=True)
    with open(os.path.join(dir_prefix, "dataset_results.csv"), "w",
              encoding="utf-8", newline="") as f:
        f.write(",".join([""] + [t for t, _ in cols]) + "\n")
        f.write(",".join([""] + [m for _, m in cols]) + "\n")
        for k in METRICS:
            f.write(",".join([k] + [dio.csv_float(results[t][m].get(k))
                                    for t, m in cols]) + "\n")
    for t, m in cols:
        print(f"{t:40s} {m:14s} " + "  ".join(
            f"{k}={results[t][m][k]}" for k in METRICS))
    return results


def main(argv=None, report: Optional[dict] = None) -> Optional[dict]:
    """The CLI. ``report`` (Python callers only) collects each mode's
    decisions, walls and kernel launches (:func:`run_monocular`, or
    ``batched.run_monocular_batched`` with ``--batched``) and the results
    table; with ``--run_kinetic``, each force-plate stage's (``kinetic``,
    :func:`run_kinetic`), the analysis per trial (``kinetic_analysis``) and
    its returned dict (``kinetic_results``). It is also returned."""
    parser = argparse.ArgumentParser(
        description="cheetah reconstruction over a dataset of trials "
                    "(PyTorch port)")
    parser.add_argument("--root_dir", type=str, default="./cheetah_videos")
    parser.add_argument("--out_dir_prefix", type=str, default="./out")
    parser.add_argument("--run_monocular", action="store_true")
    parser.add_argument("--run_kinetic", action="store_true")
    parser.add_argument("--override_default_cam", action="store_true")
    parser.add_argument("--clean", action="store_true",
                        help="regenerate reconstructions before analysis")
    parser.add_argument("--materialize_synthetic", action="store_true",
                        help="render the synthetic test set into root_dir")
    parser.add_argument("--batched", action="store_true",
                        help="solve each mode's whole trial set as one "
                             "batch (float32) on the device")
    parser.add_argument("--trials", type=int, default=None,
                        help="limit to the first N test-set trials")
    parser.add_argument("--no_ground_anchor", action="store_true",
                        help="disable the monocular ground-plane depth "
                             "anchor (ray shift + anchored polish)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of the solves (default: the "
                             "current CUDA device; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    test_set = TEST_SET[: args.trials] if args.trials else TEST_SET
    cam_overrides = CAM_OVERRIDES if args.override_default_cam else None
    if cam_overrides is not None and args.trials:
        cam_overrides = cam_overrides[: args.trials]
    if args.materialize_synthetic:
        made = materialize_synthetic_testset(args.root_dir)
        print(f"materialized {len(made)} synthetic trials in {args.root_dir}")
    if args.run_monocular:
        if args.clean:
            rep = report if report is not None else {}
            rep.setdefault("modes", {})
            if args.batched:
                from . import batched
                batched.run_monocular_batched(
                    args.root_dir, args.out_dir_prefix, test_set,
                    cam_overrides,
                    modes=("ground-truth", "default", "data-driven",
                           "physics-based"),
                    ground_anchor=not args.no_ground_anchor,
                    device=args.device, report=rep["modes"])
            else:
                run_monocular(args.root_dir, args.out_dir_prefix, test_set,
                              cam_overrides, device=args.device,
                              report=rep["modes"])
        res = dataset_post_process(args.root_dir, args.out_dir_prefix,
                                   test_set, cam_overrides)
        if report is not None:
            report["results"] = res
    if args.run_kinetic:
        if args.clean:
            rep = report if report is not None else {}
            run_kinetic(args.root_dir, args.out_dir_prefix,
                        device=args.device,
                        report=rep.setdefault("kinetic", {}))
        analysis = {} if report is None else report.setdefault(
            "kinetic_analysis", {})
        res = kinetic_analysis(args.root_dir, args.out_dir_prefix,
                               device=args.device, report=analysis)
        print(res)
        if report is not None:
            report["kinetic_results"] = res
    return report


if __name__ == "__main__":
    main()
