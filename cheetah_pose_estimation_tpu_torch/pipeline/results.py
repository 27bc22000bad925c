"""Results and biomechanics analysis: the parts the force-plate analysis
calls.

Port of part of ``cheetah_pose_estimation_tpu/pipeline/results.py``: 2D
reprojection error against hand labels (on the CSV tables, without pandas),
the contact file's per-role stance table, stance-normalised gait curves
(joint angles, torques, power per limb role), the friction-polygon check of
solved GRFs, the torque and gait plots, and the per-camera robustness of
one trial (``--run_analysis``). The plots import matplotlib when called
and write nothing where it is not installed; every metric is also returned
as data. The rest of the JAX module (the studies' figures, the GRF error
against force plates, the LCP and contact checks) is not ported.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import io as dio
from ..dynamics.eom import FOOT_NAMES, TORQUE_MAP
from ..models import skeleton as sk
from ..utils.device import DeviceLike, resolve_device


def _column(table: dio.Table, key: Tuple[str, ...]) -> Optional[np.ndarray]:
    """The values of ``table``'s column ``key``, None when absent."""
    try:
        return table.values[:, table.columns.index(key)]
    except ValueError:
        return None


def reprojection_errors(fte_dir: str, hand_labeled_dir: str
                        ) -> Dict[str, float]:
    """Pixel error statistics of the saved reprojections ``cam*_fte.csv``
    in ``fte_dir`` against the hand labels of the same camera in
    ``hand_labeled_dir`` (``cam<i>.h5``, read through the ``.csv`` beside
    it, or ``cam<i>.csv``), over the frames both tables hold: mean,
    median, std and count of the finite per-marker errors (NaN and a count
    of 0 when there are none)."""
    errs: List[float] = []
    for cam_path in sorted(glob.glob(os.path.join(
            fte_dir, "cam*_fte.csv"))):
        cam_name = os.path.basename(cam_path).split("_")[0]
        gt_path_h5 = os.path.join(hand_labeled_dir, f"{cam_name}.h5")
        gt_path_csv = os.path.join(hand_labeled_dir, f"{cam_name}.csv")
        gt_path = gt_path_h5 if os.path.exists(gt_path_h5) else gt_path_csv
        if not os.path.exists(gt_path):
            continue
        pred = dio.read_table(cam_path, 2)
        gt = dio.load_dlc_table(gt_path)
        # the hand labels' scorer level dropped: (bodypart, coord) columns
        gt = gt._replace(columns=[c[1:] for c in gt.columns])
        rows = {int(i): r for r, i in enumerate(gt.index)}
        common = [(r, rows[int(i)]) for r, i in enumerate(pred.index)
                  if int(i) in rows]
        rp = np.array([a for a, _ in common], dtype=np.int64)
        rg = np.array([b for _, b in common], dtype=np.int64)
        for m in sk.MARKERS:
            px, gx = _column(pred, (m, "x")), _column(gt, (m, "x"))
            if px is None or gx is None:
                continue
            dx = px[rp] - gx[rg]
            dy = _column(pred, (m, "y"))[rp] - _column(gt, (m, "y"))[rg]
            e = np.sqrt(dx * dx + dy * dy)
            errs.extend(e[np.isfinite(e)].tolist())
    err = np.asarray(errs)
    if err.size == 0:
        return {"mean_px": float("nan"), "median_px": float("nan"), "n": 0}
    return {"mean_px": float(err.mean()), "median_px": float(np.median(err)),
            "std_px": float(err.std()), "n": int(err.size)}


# limb -> (hip or shoulder, knee, ankle) torque-map column names
LIMB_JOINTS = {
    "FL": ("front-left-hip-pitch:y", "UFL_LFL_torque:y", "LFL_HFL_torque:y"),
    "FR": ("front-right-hip-pitch:y", "UFR_LFR_torque:y",
           "LFR_HFR_torque:y"),
    "BL": ("back-left-hip-pitch:y", "UBL_LBL_torque:y", "LBL_HBL_torque:y"),
    "BR": ("back-right-hip-pitch:y", "UBR_LBR_torque:y", "LBR_HBR_torque:y"),
}

_TAU_COL = {n: i for i, n in enumerate(TORQUE_MAP.names)}


def contact_json_conversion(json_path: str) -> Dict[str, List]:
    """A contact file -> per limb role (fore/hind, leading/trailing) the
    (side, first frame, end frame) of its first stance, relative to the
    file's start frame and widened by one frame each way; (side, 0, 0)
    for a stance that runs past the file's end frame and for the role of
    a foot without a stance whose partner has one."""
    with open(json_path, "r", encoding="utf-8") as f:
        cj = json.load(f)
    start_frame, end_frame = cj["start_frame"], cj["end_frame"]
    order = cj["contacts"]
    ret = {"forelimb-trailing": ["", 0, 0], "forelimb-leading": ["", 0, 0],
           "hindlimb-leading": ["", 0, 0], "hindlimb-trailing": ["", 0, 0]}
    for name in FOOT_NAMES:
        limb = "forelimb" if name[1] == "F" else "hindlimb"
        side = "right" if name[2] == "R" else "left"
        if name in order and order[name] is not None:
            data = order[name]
            s = data[0][0] - start_frame
            e = data[0][1] - start_frame
            if data[0][1] > end_frame:
                ret[f"{limb}-{data[0][3]}"] = [side, 0, 0]
            else:
                ret[f"{limb}-{data[0][3]}"] = [side, s - 1 if s > 0 else s,
                                               e + 1]
        else:
            other = order.get(
                f"{name[:2]}{'L' if side == 'right' else 'R'}_foot")
            if other is not None:
                role = "leading" if other[0][3] == "trailing" else "trailing"
                ret[f"{limb}-{role}"] = [side, 0, 0]
    return ret


# the leg links, in the order of the relative pose's entries 16-27
LEG_LINKS = ("UFL", "LFL", "HFL", "UFR", "LFR", "HFR", "UBL", "LBL", "UBR",
             "LBR", "HBL", "HBR")


def joint_angles(q: np.ndarray, device: DeviceLike = None
                 ) -> Dict[str, np.ndarray]:
    """The relative pitch of each leg link over the trajectory q (N, 54),
    computed in float64 on ``device`` (the card by default)."""
    x = sk.relative_pose(torch.as_tensor(
        np.asarray(q), dtype=torch.float64,
        device=resolve_device(device))).cpu().numpy()
    return {n: x[:, 16 + i] for i, n in enumerate(LEG_LINKS)}


STANCE_POINTS = 101   # 0, 1, ..., 100 % of stance


def stance_normalized(series: np.ndarray, start: int, end: int
                      ) -> np.ndarray:
    """A per-frame series over frames [start, end) resampled linearly onto
    0-100 % of stance (NaN when fewer than two frames)."""
    seg = np.asarray(series)[start:end]
    if len(seg) < 2:
        return np.full(STANCE_POINTS, np.nan)
    xp = np.linspace(0, 100, len(seg))
    return np.interp(np.linspace(0, 100, STANCE_POINTS), xp, seg)


def gait_analysis(q: np.ndarray, tau: Optional[np.ndarray],
                  contact_json_path: str, fps: float,
                  device: DeviceLike = None) -> Dict:
    """Stance-normalised hip, knee and ankle curves per limb role of the
    contact file: joint angle, and with torques ``tau`` (N, 22) the torque
    and the power (torque times the joint's angular rate, from
    ``np.gradient`` of q at ``fps``), the angles on ``device`` (the card
    by default). Returns {"angle", "torque", "power":
    {"<role>-<joint>": (101,)}, "contacts": the per-role table}."""
    contacts = contact_json_conversion(contact_json_path)
    angles = joint_angles(q, device)
    dq = np.gradient(np.asarray(q), axis=0) * fps
    dangles = joint_angles(dq, device)
    out = {"angle": {}, "torque": {}, "power": {}, "contacts": contacts}
    for role, (side, s, e) in contacts.items():
        if e <= s:
            continue
        fore = role.startswith("forelimb")
        prefix = ("F" if fore else "B") + ("R" if side == "right" else "L")
        for label, joint_col in zip(("hip", "knee", "ankle"),
                                    LIMB_JOINTS[prefix]):
            link = {"hip": "U", "knee": "L", "ankle": "H"}[label] + prefix
            out["angle"][f"{role}-{label}"] = stance_normalized(
                angles[link], s, e)
            if tau is not None:
                tcol = np.asarray(tau)[:, _TAU_COL[joint_col]]
                out["torque"][f"{role}-{label}"] = stance_normalized(
                    tcol, s, e)
                out["power"][f"{role}-{label}"] = stance_normalized(
                    tcol * dangles[link], s, e)
    return out


GRF_ACTIVE = 1e-6     # body weights: a polygon component above it acts


def check_grf(grf_xy: np.ndarray) -> Dict[str, float]:
    """Friction-polygon sanity of solved GRFs (N, 4 feet, 4 directions):
    opposite polygon components (+x/-x, +y/-y: directions 0/2 and 1/3)
    are never both above ``GRF_ACTIVE``. Returns the number of such pairs
    and whether there are none."""
    g = np.asarray(grf_xy)
    both_x = (g[..., 0] > GRF_ACTIVE) & (g[..., 2] > GRF_ACTIVE)
    both_y = (g[..., 1] > GRF_ACTIVE) & (g[..., 3] > GRF_ACTIVE)
    n_bad = int(both_x.sum() + both_y.sum())
    return {"n_invalid": n_bad, "ok": n_bad == 0}


def _pyplot():
    """matplotlib's pyplot on the Agg backend, None where matplotlib is not
    installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_torques(tau: np.ndarray, fps: float, out_path: str) -> bool:
    """Plot the front-left leg's torques (``LIMB_JOINTS["FL"]``) of ``tau``
    (N, 22) against time to ``out_path``. Returns False, writing nothing,
    without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    t = np.arange(len(tau)) / fps
    fig = plt.figure(figsize=(16, 9), dpi=60)
    for c in LIMB_JOINTS["FL"]:
        plt.plot(t, np.asarray(tau)[:, _TAU_COL[c]], label=c)
    plt.xlabel("Time (s)")
    plt.ylabel("Torque (body-weight units)")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_gait_attributes(analysis: Dict, out_path: str) -> bool:
    """Plot a :func:`gait_analysis` result's angle, torque and power curves
    against % stance to ``out_path``. Returns False, writing nothing,
    without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, axs = plt.subplots(3, 1, figsize=(12, 14), dpi=60)
    for ax, key in zip(axs, ("angle", "torque", "power")):
        for label, curve in analysis[key].items():
            ax.plot(np.linspace(0, 100, len(curve)), curve, label=label)
        ax.set_ylabel(key)
        ax.set_xlabel("% stance")
        if analysis[key]:
            ax.legend(fontsize=7)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return True


# the cameras of ``example_robustness``'s chart (those of the test set)
ROBUSTNESS_CAMS = range(6)


def example_robustness(dir_prefix: str,
                       test_run: Tuple[str, str, str] =
                       ("phantom", "2019_03_07", "run")
                       ) -> Dict[str, List[float]]:
    """Per-camera robustness of one trial: the mean root-relative MPJPE
    (mm) of the default, data-driven and physics-based solutions of each
    of the cameras ``ROBUSTNESS_CAMS`` whose three solutions all exist
    under ``dir_prefix``, against the multi-view solve, and their bar chart
    ``example-cam-robustness.pdf`` in ``dir_prefix`` (a line names it when
    matplotlib is not installed). As in the JAX package, every pickle is
    read from ``dir_prefix``."""
    from . import metrics as metrics_mod

    cheetah, date, trial = test_run
    data_path = os.path.join(date, cheetah, trial)
    vals: Dict[str, List[float]] = {
        "single_traj_error": [], "data_driven_traj_error": [],
        "physics_based_traj_error": []}
    cams: List[int] = []
    gt_path = os.path.join(dir_prefix, data_path, "fte_kinematic",
                           "fte.pickle")
    if not os.path.exists(gt_path):
        return vals
    gt = dio.load_fte_pickle(gt_path)["positions"]
    for cam_idx in ROBUSTNESS_CAMS:
        base = os.path.join(dir_prefix, data_path)
        paths = [os.path.join(base, f"{k}_{cam_idx}", "fte.pickle")
                 for k in ("fte_kinematic_orig", "fte_kinematic",
                           "fte_kinetic")]
        if not all(os.path.exists(p) for p in paths):
            continue
        cams.append(cam_idx)
        for key, p in zip(vals, paths):
            pos = dio.load_fte_pickle(p)["positions"]
            _, err, _ = metrics_mod.traj_error(gt, pos, centered=True)
            vals[key].append(float(err.mean()))
    if cams:
        out = os.path.join(dir_prefix, "example-cam-robustness.pdf")
        plt = _pyplot()
        if plt is None:
            print(f"matplotlib is not installed: skipped {out}")
            return vals
        fig = plt.figure(figsize=(16, 12), dpi=60)
        width = 0.25
        x = np.arange(len(cams))
        for k, (key, label, color) in enumerate((
                ("single_traj_error", "Default", "#36454f"),
                ("data_driven_traj_error", "Data-driven", "#2ca02c"),
                ("physics_based_traj_error", "Physics-based", "#ff7f0e"))):
            plt.bar(x + k * width, vals[key], width, label=label,
                    color=color)
        plt.xticks(x + width, [str(c + 1) for c in cams])
        plt.ylabel("MPJPE (mm)")
        plt.xlabel("Camera")
        plt.legend()
        fig.savefig(out, bbox_inches="tight")
        plt.close(fig)
    return vals
