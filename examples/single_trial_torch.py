"""Single-trial workflow on the PyTorch port: the counterpart of
``examples/single_trial.py`` (init -> kinematics -> contacts -> kinetics ->
monocular modes -> scores), importing only
``cheetah_pose_estimation_tpu_torch``.

    python examples/single_trial_torch.py [workdir] [--device cpu]

A synthetic trial (the procedural 60-frame gallop seen by 6 fisheye
cameras) is written under ``workdir`` (default ``./example_trial``), then
the staged pipeline runs on the card (``--device cpu`` for the CPU) and
prints the reconstruction metrics: the multi-view kinematic MPE against the
synthetic truth, the detected contacts, the physics solve's peak vertical
GRF and largest torque, and the default and data-driven monocular modes
scored against the multi-view solve. The data-driven mode's priors train
on the procedural pose tables (written under ``workdir/priors``).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from cheetah_pose_estimation_tpu_torch.data import io as dio  # noqa: E402
from cheetah_pose_estimation_tpu_torch.data import synthetic as syn  # noqa
from cheetah_pose_estimation_tpu_torch.models import params as P  # noqa
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib  # noqa
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as est_mod
from cheetah_pose_estimation_tpu_torch.pipeline import metrics  # noqa
from cheetah_pose_estimation_tpu_torch.priors import dataset  # noqa: E402

DATA_PATH = os.path.join("2019_03_07", "phantom", "run")
SUBJECT = "acinoset"
MONOCULAR_CAM = 2


def render(root: str):
    """The example's trial, written under ``root``; returns it."""
    q_gt = syn.gallop_trajectory(60, seed=0)
    subject = P.get_subject(SUBJECT)
    markers = syn.fk_markers_np(q_gt, subject)
    scene = syn.ring_cameras(markers.mean(axis=(0, 1)), n_cams=6, seed=3)
    trial = syn.synthesize(q_gt, subject, scene, noise_px=1.5, seed=3)
    syn.write_trial_dir(trial, root, DATA_PATH, monocular_cam=MONOCULAR_CAM)
    return trial


def run(root: str, device=None, verbose: bool = True) -> dict:
    """The workflow on ``device`` (the card by default), in float32.
    Returns the printed numbers and each stage's wall seconds."""
    say = print if verbose else (lambda *a: None)
    out, walls = {}, {}
    trial = render(root)
    say(f"trial materialized under {root}/{DATA_PATH}")

    # 1) multi-view kinematic FTE
    t0 = time.perf_counter()
    est = est_mod.init_trajectory(root, DATA_PATH, SUBJECT,
                                  kinematic_model=True)
    est_mod.estimate_kinematics(est, solver_output=verbose, device=device)
    walls["multi_view"] = time.perf_counter() - t0
    d = dio.load_fte_pickle(os.path.join(root, DATA_PATH, "fte_kinematic",
                                         "fte.pickle"))
    out["mv_mpe_mm"] = float(np.linalg.norm(
        d["positions"] - trial.markers_gt, axis=2).mean() * 1e3)
    say(f"multi-view kinematic MPE vs synthetic GT: {out['mv_mpe_mm']:.1f} "
        "mm")

    # 2) contact detection + GRF synthesis
    t0 = time.perf_counter()
    est2 = est_mod.init_trajectory(root, DATA_PATH, SUBJECT,
                                   kinematic_model=False)
    contacts, _ = est_mod.determine_contacts(est2)
    out["contacts"] = contacts
    say("contacts:", dict(contacts))

    # 3) physics-based FTE with joint torque/GRF estimation
    est_mod.estimate_kinetics(est2, solver_output=verbose, device=device)
    walls["kinetics"] = time.perf_counter() - t0
    out["peak_grf_bw"] = float(np.max(est2.grf_z))
    out["tau_max"] = float(np.abs(est2.tau).max())
    say(f"peak vertical GRF: {out['peak_grf_bw']:.2f} body weights; "
        f"|tau|max: {out['tau_max']:.1f}")

    # 4) monocular modes + scoring against the multi-view solution
    t0 = time.perf_counter()
    dset = os.path.join(root, "priors", "dataset_full_pose.csv")
    dataset.save_pose_dataset(dset, bench_lib.procedural_pose_table(
        bench_lib.TRAIN_SEEDS))
    dataset.save_pose_dataset(
        os.path.join(root, "priors", "validation_dataset.csv"),
        bench_lib.procedural_pose_table(bench_lib.VAL_SEEDS))
    est3 = est_mod.init_trajectory(root, DATA_PATH, SUBJECT,
                                   kinematic_model=True,
                                   monocular_enable=True)
    est_mod.estimate_kinematics(est3, device=device)
    est4 = est_mod.init_trajectory(root, DATA_PATH, SUBJECT,
                                   kinematic_model=True,
                                   monocular_enable=True)
    est_mod.estimate_kinematics(est4, monocular_constraints=True,
                                data_driven_dataset=dset, device=device)
    walls["monocular"] = time.perf_counter() - t0
    scores = metrics.compare_traj_error(os.path.join(root, DATA_PATH),
                                        cam_idx=MONOCULAR_CAM,
                                        save_plots=False)
    out["monocular"] = {m: {k: float(v) for k, v in s.items()
                            if k != "per_joint"} for m, s in scores.items()}
    for mode, vals in scores.items():
        say(f"{mode}: MPE {vals['mpe_mm']:.1f} mm, "
            f"MPJPE {vals['mpjpe_mm']:.1f} mm")
    out["wall_s"] = walls
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="./example_trial")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    args = ap.parse_args(argv)
    run(args.workdir, device=args.device)


if __name__ == "__main__":
    main()
