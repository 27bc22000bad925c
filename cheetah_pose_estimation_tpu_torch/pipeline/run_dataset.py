"""The dataset CLI: its monocular, force-plate, AcinoSet, analysis and
study paths.

Port of ``cheetah_pose_estimation_tpu/pipeline/run_dataset.py``, every
flag: ``--materialize_synthetic``, ``--run_monocular --clean`` (serial or
``--batched``), ``--run_kinetic [--clean]``, ``--run_acinoset [--clean]``,
``--run_analysis [--clean] [--batched]`` and the study flags below::

    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --materialize_synthetic --root_dir R
    CHEETAH_DATA_DRIVEN_DATASET=P \
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_monocular [--batched] --clean --root_dir R --out_dir_prefix O
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_kinetic --clean --root_dir R --out_dir_prefix O
    CHEETAH_DATA_DRIVEN_DATASET=P \
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_acinoset --clean --root_dir R --out_dir_prefix O
    CHEETAH_DATA_DRIVEN_DATASET=P \
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_analysis [--batched] --clean --root_dir R --out_dir_prefix O

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
(:func:`materialize_synthetic_kinetic_testset` does). The fourth solves
every AcinoSet trial directory under R (:func:`run_acinoset`: ground
truth, default, data-driven; pairwise pseudo-measurements on flick trials
that have them) and prints :func:`validate_dataset`; the fifth solves
every camera of every test trial as the monocular one
(:func:`run_monocular_all`), then writes the distance-vs-error table
(:func:`distance_vs_error`) and the per-camera robustness of one trial
(``results.example_robustness``). The study flags run
``pipeline/studies.py``: ``--run_grid_search``,
``--run_data_driven_ablation_study`` and
``--run_physics_based_ablation_study`` (batched with ``--batched``, else
trial by trial) on the test trials of R, scored against the multi-view
solutions that a ``--run_monocular`` run saved under O (the physics
ablation starts from its data-driven solutions), and
``--run_degradation_sweep [--sweep_physics]`` on procedural trials of its
own::

    CHEETAH_DATA_DRIVEN_DATASET=P \
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_grid_search --run_data_driven_ablation_study \
        --run_physics_based_ablation_study [--batched] \
        --root_dir R --out_dir_prefix O
    CHEETAH_DATA_DRIVEN_DATASET=P \
    python -m cheetah_pose_estimation_tpu_torch.pipeline.run_dataset \
        --run_degradation_sweep [--sweep_physics] --out_dir_prefix O

Plots (the results table's bars, the studies' figures) are written where
matplotlib is installed; elsewhere a line names each PDF skipped.
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
from ..ops import camera as cam_ops
from ..ops import cuda_banded
from ..utils.device import DeviceLike, resolve_device
from . import contacts as contacts_mod
from . import estimator as est_mod
from . import metrics as metrics_mod
from .bench_lib import REF_TEST_SET

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


def _reference_gt_trajectory(date: str, cheetah: str, trial_name: str,
                             fallback_frames: int, fallback_seed: int,
                             fallback_fps: float = 120.0) -> np.ndarray:
    """Ground-truth q of a synthetic trial (JAX ``run_dataset.py:71-89``):
    the reference test set's shipped physics-based solution of the trial
    (``REF_TEST_SET/<date>/<cheetah>/<trial>/fte_kinetic_*``), else its
    multi-view one (``fte_kinematic``), else the procedural gallop of
    ``fallback_frames`` at ``fallback_fps`` (the tree is not in the
    repository)."""
    from glob import glob

    trial_dir = os.path.join(REF_TEST_SET, date, cheetah, trial_name)
    cands = sorted(glob(os.path.join(trial_dir, "fte_kinetic_*",
                                     "fte.pickle")))
    cands.append(os.path.join(trial_dir, "fte_kinematic", "fte.pickle"))
    for p in cands:
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)["q"]
    return syn.gallop_trajectory(fallback_frames, fps=fallback_fps,
                                 seed=fallback_seed)


def kinetic_path(cheetah: str, date: str, trial: str) -> str:
    """The trial directory of a force-plate trial, under the root."""
    return os.path.join("kinetic_dataset", date, cheetah, f"trial{trial}")


def materialize_synthetic_testset(root_dir: str, n_cams: int = 6,
                                  seed: int = 0,
                                  noise_px: float = 1.5,
                                  occlusion_rate: float = 2.0,
                                  confusion_rate: float = 1.2) -> List[str]:
    """Write an AcinoSet-style directory tree for every test trial,
    rendered from its ground-truth trajectory (``_reference_gt_trajectory``)
    through a ring of fisheye
    cameras with the correlated DLC failure model
    (``synthetic.corrupt_dlc``), plus ``synthetic_gt.pickle`` (q and
    markers) for scoring against the truth. Host work in float64."""
    made = []
    for i, (cheetah, date, trial_name) in enumerate(TEST_SET):
        data_path = os.path.join(date, cheetah, trial_name)
        q_gt = _reference_gt_trajectory(date, cheetah, trial_name,
                                        40 + 2 * i, i)
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
    """Write synthetic copies of the 5 force-plate trials: their
    ground-truth trajectories (``_reference_gt_trajectory``: without the
    reference test set, 50-frame procedural gallops) at 200 fps seen by
    ``n_cams`` pinhole cameras 6 m
    out (the 2009 kinetic-dataset rig), DLC noise 2 px and 1 % outliers,
    monocular camera 0, plus ``synthetic_gt.pickle``. Host work in
    float64."""
    made = []
    for i, (cheetah, date, trial) in enumerate(KINETIC_SET):
        data_path = kinetic_path(cheetah, date, trial)
        q_gt = _reference_gt_trajectory(
            os.path.join("kinetic_dataset", date), cheetah, f"trial{trial}",
            50, seed + i, fallback_fps=200.0)
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


# Hand-curated AcinoSet frame windows (the active entries of the
# reference's table): a real AcinoSet directory outside the table had bad
# input data and is skipped.
ACINOSET_SELECTED_FRAMES: Dict[str, Tuple[int, int]] = {
    "2019_03_03/phantom/run": (100, 220),
    "2019_03_09/lily/run": (80, 170),
    "2017_08_29/top/phantom/run1_1": (20, 160),
    "2017_12_21/top/lily/run1": (10, 105),
    "2017_12_21/bottom/jules/flick2_2": (5, 150),
    "2017_12_10/top/zorro/flick1": (115, 210),
    "2017_12_10/bottom/zorro/flick2": (5, 140),
    "2017_09_03/bottom/zorro/run2_1": (130, 270),
    "2017_12_09/bottom/phantom/run2": (20, 115),
    "2017_09_03/bottom/zorro/run2_3": (5, 150),
    "2017_08_29/top/jules/run1_1": (10, 110),
    "2017_09_02/top/jules/run1": (10, 110),
    "2019_03_07/menya/run": (60, 160),
    "2017_09_02/top/phantom/run1_2": (20, 160),
    "2019_03_07/phantom/run": (100, 200),
    "2019_02_27/romeo/run": (40, 150),
    "2019_02_27/romeo/flick": (10, 150),
    "2017_08_29/top/jules/run1_2": (30, 130),
    "2017_12_16/top/cetane/run1": (110, 210),
    "2019_02_27/kiara/run": (20, 100),
    "2017_09_02/bottom/jules/run2": (50, 160),
    "2017_09_03/bottom/zorro/run2_2": (32, 141),
    "2019_03_09/jules/flick1": (40, 160),
    "2017_09_03/bottom/zorro/flick2": (10, 100),
    "2017_08_29/bottom/zorro/flick2": (75, 135),
    "2017_12_09/bottom/jules/flick2": (5, 75),
    "2017_12_17/bottom/zorro/flick2": (5, 145),
}

# directories with erroneous input, skipped (the reference's list is empty)
ACINOSET_BAD_VIDEOS: Tuple[str, ...] = ()

# the modes ``run_acinoset`` solves each trial in
ACINOSET_MODES = ("ground-truth", "default", "data-driven")


def run_acinoset(root_dir: str, dir_prefix: str,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 report: Optional[dict] = None) -> List[str]:
    """Every AcinoSet trial directory under ``root_dir`` (one holding
    ``metadata.json`` and ``dlc/``) through ``ACINOSET_MODES`` (multi-view
    ground truth, default and data-driven monocular
    ``estimate_kinematics``), each trial alone at its own length on
    ``device`` (the card by default), artifacts under ``dir_prefix``.

    A directory named as real AcinoSet data (``2016_``, ``2017_``,
    ``2019_``) runs only when it is in ``ACINOSET_SELECTED_FRAMES``, with
    its curated window where the trial's own frame range covers it (else
    its metadata's); other directories (synthetic trials) run windowed by
    their metadata. Directories in ``ACINOSET_BAD_VIDEOS`` are skipped. The
    subject is the first of jules, phantom, shiraz, arabia in the path
    (else acinoset). A "flick" trial with a ``dlc_pw/`` folder gets the
    pairwise pseudo-measurements (W = 3). A trial whose files are
    missing or inconsistent (``FileNotFoundError``, ``AssertionError``) is
    reported and skipped; any other error propagates. Returns the trials
    done. With ``report``, per mode: the trials, and per trial the wall
    seconds, the kernel's launches per (B, N), the solve's decisions and
    the measurements per marker W."""
    from glob import glob

    dev = resolve_device(device)
    rep = {} if report is None else report
    kw = dict(out_dir_prefix=dir_prefix, dtype=dtype, device=dev)
    done = []
    for meta in sorted(glob(os.path.join(root_dir, "**", "metadata.json"),
                            recursive=True)):
        trial_dir = os.path.dirname(meta)
        if not os.path.isdir(os.path.join(trial_dir, "dlc")):
            continue
        data_path = os.path.relpath(trial_dir, root_dir)
        if data_path in ACINOSET_BAD_VIDEOS:
            continue
        frames = ACINOSET_SELECTED_FRAMES.get(data_path)
        if frames is None and any(
                data_path.startswith(y) for y in
                ("2017_", "2019_", "2016_")):
            continue
        start, end = frames if frames is not None else (-1, -1)
        if frames is not None:
            # a synthetic copy of a curated trial is shorter than the real
            # video: the curated window applies only where it fits
            md = dio.load_metadata(trial_dir)
            if not (md["start_frame"] <= start and end <= md["end_frame"]):
                start, end = -1, -1
        cheetah = next((n for n in ("jules", "phantom", "shiraz", "arabia")
                        if n in data_path), "acinoset")
        use_ppm = ("flick" in data_path
                   and os.path.isdir(os.path.join(trial_dir, "dlc_pw")))
        try:
            for mode in ACINOSET_MODES:
                est = est_mod.init_trajectory(
                    root_dir, data_path, cheetah, kinematic_model=True,
                    start_frame=start, end_frame=end,
                    monocular_enable=mode != "ground-truth",
                    enable_ppm=use_ppm)
                _, tr = _timed(dev, lambda tr: est_mod.estimate_kinematics(
                    est, monocular_constraints=mode == "data-driven",
                    report=tr, **kw))
                tr["W"] = int(np.shape(est.data.meas)[-1])
                m = rep.setdefault(mode, {"trials": [], "per_trial": {}})
                m["trials"].append(data_path)
                m["per_trial"][data_path] = tr
            done.append(data_path)
        except (FileNotFoundError, AssertionError) as e:
            print(f"skip {data_path}: {e}")
    return done


def validate_dataset(dir_prefix: str, test_set: Tuple = TEST_SET
                     ) -> Dict[str, bool]:
    """Plausibility of every saved solution (``fte*/fte.pickle``) of the
    trials of ``test_set`` under ``dir_prefix``: CoM speed <= 50 m/s and
    base height in (-0.3, 1) m on every frame. Returns {"<trial>/<dir>":
    ok}."""
    report = {}
    for cheetah, date, trial_name in test_set:
        data_path = os.path.join(date, cheetah, trial_name)
        base = os.path.join(dir_prefix, data_path)
        for sub in os.listdir(base) if os.path.isdir(base) else []:
            if not sub.startswith("fte"):
                continue
            p = os.path.join(base, sub, "fte.pickle")
            if not os.path.exists(p):
                continue
            d = dio.load_fte_pickle(p)
            speed = np.linalg.norm(d["com_vel"], axis=1)
            ok = bool((speed <= 50.0).all()
                      and (d["q"][:, 2] > -0.3).all()
                      and (d["q"][:, 2] < 1.0).all())
            report[f"{data_path}/{sub}"] = ok
    return report


def run_monocular_all(root_dir: str, dir_prefix: str,
                      test_set: Tuple = TEST_SET,
                      modes: Tuple[str, ...] = ("default", "data-driven"),
                      batched: bool = False,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None,
                      report: Optional[dict] = None) -> None:
    """Every camera of every trial of ``test_set`` under ``root_dir`` as
    the monocular camera, through ``modes`` on ``device`` (the card by
    default): the input of the distance-vs-error analysis. With
    ``batched``, the multi-view ground truth of each trial once, then each
    (trial, camera) combination as one lane of
    ``batched.run_monocular_batched`` (60 lanes on the 10-trial test set,
    in its subject groups); without it, :func:`run_monocular` on each
    combination in turn (``modes`` only, as in the JAX package: the
    ground truth is not solved). ``report`` is passed to the runs: per
    mode, the batched form's lanes in its subject groups' order; the
    serial form's per-trial entries keep each trial's last camera."""
    dev = resolve_device(device)
    combos: List[Tuple[str, str, str]] = []
    cams: List[int] = []
    for cheetah, date, trial_name in test_set:
        data_path = os.path.join(date, cheetah, trial_name)
        if not os.path.isdir(os.path.join(root_dir, data_path)):
            continue
        k_arr = dio.find_scene_file(os.path.join(root_dir, data_path))[0]
        for cam in range(len(k_arr)):
            combos.append((cheetah, date, trial_name))
            cams.append(cam)
    kw = dict(verbose=False, dtype=dtype, device=dev, report=report)
    if batched:
        from . import batched as batched_mod
        batched_mod.run_monocular_batched(
            root_dir, dir_prefix, list(dict.fromkeys(combos)),
            modes=("ground-truth",), **kw)
        batched_mod.run_monocular_batched(
            root_dir, dir_prefix, combos, cam_overrides=cams,
            modes=tuple(m for m in modes if m != "ground-truth"), **kw)
        return
    for combo, cam in zip(combos, cams):
        run_monocular(root_dir, dir_prefix, (combo,), cam_overrides=[cam],
                      modes=tuple(modes), **kw)


def distance_from_camera(data_path: str, com_pos: np.ndarray, cam_idx: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Per frame, the distance (m) of the CoM ``com_pos`` (N, 3) from
    camera ``cam_idx`` of the trial at ``data_path`` and the angle (deg)
    between its ray and the optical axis through the image centre, by the
    fisheye model in float64 on the host."""
    k_arr, d_arr, r_arr, t_arr, cam_res, _, _ = dio.find_scene_file(
        data_path)
    d_arr = d_arr.reshape(-1, 4)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    K, D, R = f64(k_arr[cam_idx]), f64(d_arr[cam_idx]), f64(r_arr[cam_idx])
    t = f64(t_arr[cam_idx]).reshape(3)
    center_img = np.array([cam_res[0] / 2.0, cam_res[1] / 2.0])
    img_pts = cam_ops.project_fisheye(f64(com_pos), K, D, R, t)
    r1 = cam_ops.undistort_fisheye(f64(center_img[None]), K, D).numpy()
    r2 = cam_ops.undistort_fisheye(img_pts, K, D).numpy()
    r1 = np.concatenate([r1, [[1.0]]], axis=1)[0]
    r2 = np.concatenate([r2, np.ones((len(r2), 1))], axis=1)
    cosang = r2 @ r1 / (np.linalg.norm(r2, axis=1) * np.linalg.norm(r1))
    angles = np.degrees(np.arccos(np.clip(cosang, -1, 1)))
    cam_pos = -np.linalg.inv(r_arr[cam_idx]) @ np.asarray(
        t_arr[cam_idx]).reshape(3)
    dist = np.linalg.norm(com_pos - cam_pos[None], axis=1)
    return dist, angles


def is_outlier(points: np.ndarray, thresh: float = 3.5) -> np.ndarray:
    """Modified z-score outlier mask: 0.6745 |x - median| / MAD > thresh
    (all False when the MAD is 0)."""
    points = np.asarray(points, float)
    if points.ndim == 1:
        points = points[:, None]
    med = np.median(points, axis=0)
    diff = np.sqrt(np.sum((points - med) ** 2, axis=-1))
    mad = np.median(diff)
    if mad == 0:
        return np.zeros(len(points), bool)
    return 0.6745 * diff / mad > thresh


DIST_COLUMNS = ("trial", "cam", "mode", "mpe_mm", "distance_m", "angle_deg")


def distance_vs_error(root_dir: str, dir_prefix: str,
                      test_set: Tuple = TEST_SET,
                      cam_overrides: Optional[List[int]] = None,
                      save_plot: bool = True) -> List[Dict]:
    """Reconstruction error against the CoM's distance from the camera:
    per trial of ``test_set`` with a multi-view solve under
    ``dir_prefix``, per camera (``cam_overrides``' one; else every camera
    with an ``fte_kinematic_orig_<cam>`` directory, else the metadata's
    monocular camera) and per mode with a saved solution, a row with
    ``DIST_COLUMNS``: the MPE (mm) against the multi-view solve, the mean
    distance (m) and view angle (deg) of the multi-view CoM
    (:func:`distance_from_camera`). With ``save_plot`` and rows,
    ``dist_vs_error.csv`` (the bytes pandas' ``to_csv(index=False)``
    writes) and the scatter ``dist_vs_error.pdf`` (modified z-score
    outliers > 5 left out) in ``dir_prefix``. The JAX package writes the
    CSV inside its plot branch; the port writes it whenever ``save_plot``
    is set, and where matplotlib is not installed prints a line naming
    the PDF it skipped instead. Returns the rows."""
    rows = []
    for idx, (cheetah, date, trial_name) in enumerate(test_set):
        data_path = os.path.join(date, cheetah, trial_name)
        base = os.path.join(dir_prefix, data_path)
        gt_p = os.path.join(base, "fte_kinematic", "fte.pickle")
        if not os.path.exists(gt_p):
            continue
        gt = dio.load_fte_pickle(gt_p)
        if cam_overrides is not None:
            cams = [cam_overrides[idx]]
        else:
            k_arr = dio.find_scene_file(os.path.join(root_dir,
                                                     data_path))[0]
            cams = [c for c in range(len(k_arr)) if os.path.isdir(
                os.path.join(base, f"fte_kinematic_orig_{c}"))]
            if not cams:
                cams = [dio.load_metadata(os.path.join(
                    root_dir, data_path))["monocular_cam"]]
        for cam_idx in cams:
            for mode, sub in MODE_DIRS:
                p = os.path.join(base, sub.format(cam=cam_idx), "fte.pickle")
                if not os.path.exists(p):
                    continue
                d = dio.load_fte_pickle(p)
                n = min(len(d["positions"]), len(gt["positions"]))
                err = np.linalg.norm(
                    d["positions"][:n] - gt["positions"][:n],
                    axis=2).mean() * 1000
                dist, angle = distance_from_camera(
                    os.path.join(root_dir, data_path),
                    np.asarray(gt["com_pos"]), cam_idx)
                rows.append(dict(trial=data_path, cam=cam_idx, mode=mode,
                                 mpe_mm=float(err),
                                 distance_m=float(dist.mean()),
                                 angle_deg=float(np.mean(angle))))
    if save_plot and rows:
        write_rows_csv(os.path.join(dir_prefix, "dist_vs_error.csv"), rows,
                       DIST_COLUMNS)
        _dist_plot(rows, os.path.join(dir_prefix, "dist_vs_error.pdf"))
    return rows


def write_rows_csv(path: str, rows: List[Dict], columns: Tuple[str, ...]
                   ) -> None:
    """``rows`` (dicts of str, int and float) as pandas writes
    ``DataFrame(rows).to_csv(path, index=False)``: a header of
    ``columns``, floats as ``repr``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(",".join(columns) + "\n")
        for r in rows:
            f.write(",".join(dio.csv_float(r[k]) if isinstance(r[k], float)
                             else str(r[k]) for k in columns) + "\n")


def _dist_plot(rows: List[Dict], out_path: str) -> None:
    """The distance-vs-error scatter, one series per mode in the order of
    the sorted mode names, each without its outliers (modified z-score >
    5)."""
    from .results import _pyplot

    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped {out_path}")
        return
    fig = plt.figure(figsize=(12, 8), dpi=60)
    for mode in sorted({r["mode"] for r in rows}):
        grp = [r for r in rows if r["mode"] == mode]
        keep = ~is_outlier([r["mpe_mm"] for r in grp], 5.0)
        plt.scatter([r["distance_m"] for r, k in zip(grp, keep) if k],
                    [r["mpe_mm"] for r, k in zip(grp, keep) if k],
                    label=mode)
    plt.xlabel("CoM distance from camera (m)")
    plt.ylabel("MPE (mm)")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)


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
    writes ``concat({trial: DataFrame(modes)}, axis=1)``, then
    :func:`_post_process_plots`. Returns {trial: {mode: {metric:
    value}}}."""
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
    _post_process_plots(results, dir_prefix)
    return results


def _post_process_plots(results: Dict[str, Dict[str, Dict[str, float]]],
                        dir_prefix: str) -> None:
    """``data_driven_mpjpe_result.pdf``: horizontal bars of each mode's
    MPE and MPJPE averaged over the trials (a line names it where
    matplotlib is not installed)."""
    from .results import _pyplot

    out = os.path.join(dir_prefix, "data_driven_mpjpe_result.pdf")
    plt = _pyplot()
    if plt is None:
        print(f"matplotlib is not installed: skipped {out}")
        return
    modes = sorted({m for e in results.values() for m in e})
    means = {k: [float(np.mean([e[m][k] for e in results.values()
                                if m in e])) for m in modes]
             for k in ("mpe", "mpjpe")}
    y = np.arange(len(modes))
    fig = plt.figure()
    for j, k in enumerate(("mpe", "mpjpe")):
        plt.barh(y + 0.25 * (j - 0.5), means[k], 0.25, label=k)
    plt.yticks(y, modes)
    plt.xlabel("Error (mm)")
    plt.legend()
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)


def _maybe_ablation_figure(dir_prefix: str) -> None:
    """The combined ablation figure (``results.ablation_study``) once both
    ablation CSVs exist in ``dir_prefix``."""
    if all(os.path.exists(os.path.join(dir_prefix, f))
           for f in ("data_driven_ablation_results.csv",
                     "physics_based_ablation_results.csv")):
        from . import results as results_mod
        results_mod.ablation_study(dir_prefix)


def main(argv=None, report: Optional[dict] = None) -> Optional[dict]:
    """The CLI. ``report`` (Python callers only) collects each mode's
    decisions, walls and kernel launches (:func:`run_monocular`, or
    ``batched.run_monocular_batched`` with ``--batched``) and the results
    table; with ``--run_kinetic``, each force-plate stage's (``kinetic``,
    :func:`run_kinetic`), the analysis per trial (``kinetic_analysis``) and
    its returned dict (``kinetic_results``); with ``--run_acinoset``, each
    mode's (``acinoset``, :func:`run_acinoset`) and the validation dict
    (``validate``); with ``--run_analysis``, each mode's of the
    every-camera sweep (``analysis``, :func:`run_monocular_all`), the rows
    of :func:`distance_vs_error` (``dist_vs_error``) and the values of
    ``results.example_robustness`` (``robustness``); with a study flag,
    per study its rows (or dict) and its wall seconds and launches per
    shape (``studies``: ``grid``, ``model_selection``, ``dd_ablation``,
    ``physics_ablation``, ``degradation``). It is also returned."""
    parser = argparse.ArgumentParser(
        description="cheetah reconstruction over a dataset of trials "
                    "(PyTorch port)")
    parser.add_argument("--root_dir", type=str, default="./cheetah_videos")
    parser.add_argument("--out_dir_prefix", type=str, default="./out")
    parser.add_argument("--run_monocular", action="store_true")
    parser.add_argument("--run_acinoset", action="store_true")
    parser.add_argument("--run_kinetic", action="store_true")
    parser.add_argument("--run_analysis", action="store_true")
    parser.add_argument("--run_grid_search", action="store_true")
    parser.add_argument("--run_degradation_sweep", action="store_true")
    parser.add_argument("--sweep_physics", action="store_true",
                        help="add a physics-based column to the degradation "
                             "sweep (warm-started from each rate's "
                             "data-driven solution)")
    parser.add_argument("--run_data_driven_ablation_study",
                        action="store_true")
    parser.add_argument("--run_physics_based_ablation_study",
                        action="store_true")
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
    if args.run_acinoset:
        if args.clean:
            rep = report if report is not None else {}
            done = run_acinoset(args.root_dir, args.out_dir_prefix,
                                device=args.device,
                                report=rep.setdefault("acinoset", {}))
            print(f"processed {len(done)} AcinoSet trials")
        valid = validate_dataset(args.out_dir_prefix)
        print(valid)
        if report is not None:
            report["validate"] = valid
    if args.run_analysis:
        if args.clean:
            rep = report if report is not None else {}
            run_monocular_all(args.root_dir, args.out_dir_prefix, test_set,
                              batched=args.batched, device=args.device,
                              report=rep.setdefault("analysis", {}))
        rows = distance_vs_error(args.root_dir, args.out_dir_prefix,
                                 test_set, cam_overrides)
        for r in rows:
            print("  ".join(f"{k}={r[k]}" for k in DIST_COLUMNS))
        from . import results as results_mod
        rob = results_mod.example_robustness(args.out_dir_prefix)
        if report is not None:
            report["dist_vs_error"] = rows
            report["robustness"] = rob
    if not (args.run_grid_search or args.run_degradation_sweep
            or args.run_data_driven_ablation_study
            or args.run_physics_based_ablation_study):
        return report
    from . import results as results_mod
    from . import studies
    studies_rep = {} if report is None else report.setdefault("studies", {})
    dev = resolve_device(args.device)
    kw = dict(device=dev)

    def study(name, fn):
        """Run ``fn()``; its result, wall and launches into the report."""
        out, tr = _timed(dev, lambda tr: fn())
        studies_rep[name] = dict(tr, result=out)

    if args.run_grid_search:
        if args.batched:
            study("grid", lambda: studies.run_grid_search_batched(
                args.root_dir, args.out_dir_prefix, test_set,
                cam_overrides=cam_overrides, **kw))
        else:
            study("grid", lambda: studies.run_grid_search(
                args.root_dir, args.out_dir_prefix, test_set, **kw))
        study("model_selection", lambda: studies.model_selection_analysis(
            out_dir=args.out_dir_prefix, **kw))
        results_mod.data_driven_analysis(args.out_dir_prefix)
    if args.run_degradation_sweep:
        study("degradation", lambda: studies.run_degradation_sweep(
            out_dir=args.out_dir_prefix, include_physics=args.sweep_physics,
            **kw))
    if args.run_data_driven_ablation_study:
        if args.batched:
            study("dd_ablation", lambda:
                  studies.run_data_driven_ablation_batched(
                      args.root_dir, args.out_dir_prefix, test_set,
                      cam_overrides, **kw))
        else:
            study("dd_ablation", lambda:
                  studies.run_data_driven_ablation_study(
                      args.root_dir, args.out_dir_prefix, test_set, **kw))
        _maybe_ablation_figure(args.out_dir_prefix)
    if args.run_physics_based_ablation_study:
        if args.batched:
            study("physics_ablation", lambda:
                  studies.run_physics_ablation_batched(
                      args.root_dir, args.out_dir_prefix, test_set,
                      cam_overrides, **kw))
        else:
            study("physics_ablation", lambda:
                  studies.run_physics_based_ablation_study(
                      args.root_dir, args.out_dir_prefix, test_set,
                      cam_overrides, **kw))
        _maybe_ablation_figure(args.out_dir_prefix)
    return report


if __name__ == "__main__":
    main()
