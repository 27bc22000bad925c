"""Results and biomechanics analysis.

Port of ``cheetah_pose_estimation_tpu/pipeline/results.py``, in numpy on the
host (the kinematics and the EOM in torch on the device of the call): 2D
reprojection error against hand labels and the DLC detections' pixel error
(on the CSV tables, without pandas), the contact file's per-role stance
table, stance-normalised gait curves (joint angles, torques, power per limb
role), mechanical power, the trajectory, torque, GRF and contact-detection
errors, the friction-polygon and ground complementarity checks, the error
bands over time, the per-camera robustness of one trial
(``--run_analysis``), the pose prior's likelihood of a solved pose, and the
studies' figures (the ablation bars, the model-selection and grid-search
curves; the studies' CSVs and pickle are read without pandas). The plots
import matplotlib when called; where it is not installed a plot-only
function writes nothing and returns False, and one that also returns data
returns it and prints a line naming the file it skipped.
"""
from __future__ import annotations

import csv
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
    ``hand_labeled_dir`` (``cam<i>.h5``, else ``cam<i>.csv``), over the frames both tables hold: mean,
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


def check_lcp(grf_z: np.ndarray, foot_heights: np.ndarray,
              tol: float = 1e-2) -> Dict[str, float]:
    """Epsilon-relaxed ground complementarity (JAX ``results.py:199-208``):
    GRFz * max(foot height, 0), both (N, 4), should be ~0, the target of
    the physics solve's ``enable_lcp`` penalty. Returns its largest and
    mean magnitude and whether the largest is below ``tol``."""
    comp = np.asarray(grf_z) * np.maximum(np.asarray(foot_heights), 0.0)
    return {"max_violation": float(np.max(np.abs(comp))),
            "mean_violation": float(np.mean(np.abs(comp))),
            "ok": bool(np.max(np.abs(comp)) < tol)}


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


def _read_rows(path: str) -> List[Dict[str, str]]:
    """The rows of a CSV table with a header line, as dicts of strings."""
    with open(path, encoding="utf-8", newline="") as f:
        return list(csv.DictReader(f))


def _num(v: str) -> float:
    """A CSV field as pandas reads it into a float column (empty: NaN)."""
    return float(v) if v != "" else float("nan")


def _skipped(paths: List[str]) -> None:
    print("matplotlib is not installed: skipped " + ", ".join(paths))


# the ablation figure's scenarios and the configuration rows they read
ABLATION_SCENARIOS = ("Default", "Pose", "Motion", "Pose + Motion")
ABLATION_LABELS = ("neither", "no-motion", "no-pose", "both")


def ablation_study(dir_prefix: str) -> Dict[str, Dict[str, List[float]]]:
    """The ablation figure ``ablation-study.pdf`` in ``dir_prefix``:
    grouped bars of MPE, MPJPE and CoM-velocity RMSE over the four prior
    scenarios (``ABLATION_SCENARIOS``: no prior, the pose prior, the motion
    prior, both) for the data-driven and physics-based families, from
    ``data_driven_ablation_results.csv`` and
    ``physics_based_ablation_results.csv`` there (a line names the PDF
    when matplotlib is not installed). Returns {family: {column: the four
    values}} (NaN for a missing configuration)."""
    series = {}
    for fam, name in (("data-driven", "data_driven_ablation_results.csv"),
                      ("physics-based",
                       "physics_based_ablation_results.csv")):
        rows = {r["config"]: r for r in _read_rows(
            os.path.join(dir_prefix, name))}
        cols = [c for c in ("mpe", "mpjpe", "cvr")
                if rows and c in next(iter(rows.values()))]
        series[fam] = {c: [_num(rows[l][c]) if l in rows else float("nan")
                           for l in ABLATION_LABELS] for c in cols}
    out = os.path.join(dir_prefix, "ablation-study.pdf")
    plt = _pyplot()
    if plt is None:
        _skipped([out])
        return series
    import matplotlib.gridspec as gridspec

    width = 0.25
    x = np.arange(len(ABLATION_SCENARIOS))
    fig = plt.figure(figsize=(16, 9), dpi=120)
    gs = gridspec.GridSpec(2, 4)
    for ax, col, ylabel in ((plt.subplot(gs[0, :2]), "mpe", "MPE (mm)"),
                            (plt.subplot(gs[0, 2:]), "mpjpe", "MPJPE (mm)"),
                            (plt.subplot(gs[1, 1:3]), "cvr", "CVR (m/s)")):
        if col not in series["data-driven"]:
            continue
        ax.bar(x - width / 2, series["data-driven"][col], width,
               label="Data-driven")
        if col in series["physics-based"]:
            ax.bar(x + width / 2, series["physics-based"][col], width,
                   label="Physics-based")
        ax.set_xticks(x)
        ax.set_xticklabels(ABLATION_SCENARIOS)
        ax.set_ylabel(ylabel)
    fig.legend(("Data-driven", "Physics-based"), loc="lower right")
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return series


def _mean_std(rows: List[Dict[str, str]], key: str, col: str):
    """Per distinct value of ``key`` (sorted): the mean and the sample
    standard deviation (ddof 1, NaN for one value) of ``col``."""
    groups: Dict[float, List[float]] = {}
    for r in rows:
        groups.setdefault(_num(r[key]), []).append(_num(r[col]))
    xs = sorted(groups)
    return (xs, [float(np.mean(groups[x])) for x in xs],
            [float(np.std(groups[x], ddof=1)) if len(groups[x]) > 1
             else float("nan") for x in xs])


def data_driven_analysis(dir_prefix: str,
                         pose_components: Tuple[int, ...] =
                         (1, 2, 3, 4, 5, 6, 7),
                         window_sizes: Tuple[int, ...] =
                         (1, 2, 3, 4, 5, 6, 7)) -> Dict:
    """The model-selection curves of ``grid_search.pickle`` in
    ``dir_prefix`` (``studies.model_selection_analysis``: GMM train and
    validation likelihood against the component count, AR train and
    validation RMSE and non-zero counts against the window, lasso then
    least squares) as ``gmm_model_selection.pdf`` and
    ``ar_model_selection.pdf``, and, where ``grid_search_results.csv``
    exists, the reconstruction errors' mean and standard deviation over
    the other grid axes against the component count and the window
    (``gmm_components_vs_error.pdf``, ``ar_window_vs_error.pdf``). A line
    names the PDFs when matplotlib is not installed. Returns the pickle's
    dict."""
    from ..utils import data_ops

    data = data_ops.load_pickle(os.path.join(dir_prefix,
                                             "grid_search.pickle"))
    gs_csv = os.path.join(dir_prefix, "grid_search_results.csv")
    names = ["gmm_model_selection.pdf", "ar_model_selection.pdf"] + (
        ["gmm_components_vs_error.pdf", "ar_window_vs_error.pdf"]
        if os.path.exists(gs_csv) else [])
    plt = _pyplot()
    if plt is None:
        _skipped([os.path.join(dir_prefix, n) for n in names])
        return data
    nw = len(window_sizes)
    fig = plt.figure(figsize=(16, 9), dpi=60)
    plt.plot(pose_components, data["gmm_train_likelihood"], marker="o",
             label="Train")
    plt.plot(pose_components, data["gmm_validation_likelihood"], marker="o",
             label="Test")
    plt.xlabel("# Components")
    plt.ylabel("Likelihood")
    plt.legend()
    fig.savefig(os.path.join(dir_prefix, names[0]), bbox_inches="tight")
    plt.close(fig)

    fig = plt.figure(figsize=(16, 9), dpi=60)
    axd = fig.subplot_mosaic([["left", "right"], ["bottom", "bottom"]])
    for ax, sl, title in (("left", slice(None, nw), "L1-norm"),
                          ("right", slice(nw, None), "L2-norm")):
        axd[ax].plot(window_sizes, data["lr_train_rmse"][sl], marker="o",
                     label="Train")
        axd[ax].plot(window_sizes, data["lr_validation_rmse"][sl],
                     marker="o", label="Test")
        axd[ax].set_title(title)
        axd[ax].set_ylabel("Model RMSE")
        axd[ax].set_xlabel("Window Size")
        axd[ax].legend()
    axd["bottom"].plot(window_sizes, data["lr_non_zeros"][:nw], marker="o",
                       label="L1-norm")
    axd["bottom"].plot(window_sizes, data["lr_non_zeros"][nw:], marker="o",
                       label="L2-norm")
    axd["bottom"].set_ylabel("# Non-zero Parameters")
    axd["bottom"].set_xlabel("Window Size")
    axd["bottom"].legend()
    fig.savefig(os.path.join(dir_prefix, names[1]), bbox_inches="tight")
    plt.close(fig)
    if len(names) == 2:
        return data

    rows = _read_rows(gs_csv)

    def band(ax, xs, mean, std, label=None):
        mean, std = np.asarray(mean, float), np.asarray(std, float)
        ax.plot(xs, mean, marker="o", label=label)
        ax.fill_between(xs, mean - std, mean + std, alpha=0.1)

    fig = plt.figure(figsize=(16, 9), dpi=60)
    axd = fig.subplot_mosaic([["left", "right"]])
    for ax, col, ylabel in (("left", "mpe", "Global MPE (mm)"),
                            ("right", "mpjpe", "Root-relative MPJPE (mm)")):
        band(axd[ax], *_mean_std(rows, "n_components", col))
        axd[ax].set_ylabel(ylabel)
        axd[ax].set_xlabel("# Components")
    fig.savefig(os.path.join(dir_prefix, names[2]), bbox_inches="tight")
    plt.close(fig)

    fig = plt.figure(figsize=(16, 9), dpi=60)
    axd = fig.subplot_mosaic([["left", "right"]])
    for lasso, lbl in (("True", "L1-norm"), ("False", "L2-norm")):
        sub = [r for r in rows if r["lasso"] == lasso]
        if not sub:
            continue
        for ax, col in (("left", "mpe"), ("right", "mpjpe")):
            band(axd[ax], *_mean_std(sub, "window", col), lbl)
    axd["left"].set_ylabel("Global MPE (mm)")
    axd["right"].set_ylabel("Root-relative MPJPE (mm)")
    for ax in ("left", "right"):
        axd[ax].set_xlabel("Window Size")
        axd[ax].legend()
    fig.savefig(os.path.join(dir_prefix, names[3]), bbox_inches="tight")
    plt.close(fig)
    return data


def kinematic_error(q: np.ndarray, q_ref: np.ndarray) -> Dict[str, float]:
    """RMSE of the base (q[:, :6]) and of the joint angles (q[:, 6:])
    between two trajectories over their common frames (JAX
    ``results.py:28-35``)."""
    q, q_ref = np.asarray(q), np.asarray(q_ref)
    n = min(len(q), len(q_ref))
    base = float(np.sqrt(np.mean((q[:n, :6] - q_ref[:n, :6])**2)))
    rel = float(np.sqrt(np.mean((q[:n, 6:] - q_ref[:n, 6:])**2)))
    return {"base_rmse": base, "relative_rmse": rel}


def grf_error(grf_z_est: np.ndarray, grf_z_meas: Dict[int, np.ndarray],
              contacts: Dict, start_frame: int) -> Dict[str, float]:
    """RMSE (body weights) of the estimated vertical GRF (N, 4 feet)
    against the force plates' (``grf_z_meas``: plate index -> (n, 3)
    forces) over each foot's stance frames of ``contacts`` (foot name ->
    [[start, end, plate + 1, ...], ...]) (JAX ``results.py:209-231``)."""
    errs = []
    for i, name in enumerate(FOOT_NAMES):
        seqs = contacts.get(name)
        if seqs is None:
            continue
        plate = seqs[0][2] - 1
        if plate not in grf_z_meas:
            continue
        meas = np.asarray(grf_z_meas[plate])[:, 2]
        for s, e, *_ in seqs:
            for f in range(s, e + 1):
                t = f - start_frame
                if 0 <= t < len(grf_z_est) and t < len(meas):
                    errs.append(grf_z_est[t, i] - meas[t])
    errs = np.asarray(errs)
    if errs.size == 0:
        return {"rmse_bw": float("nan"), "n": 0}
    return {"rmse_bw": float(np.sqrt(np.mean(errs**2))), "n": int(errs.size)}


def contact_detection_analysis(pred: Dict, labeled: Dict, n_frames: int,
                               start_frame: int) -> Dict[str, float]:
    """Per-frame precision, recall and F1 of the predicted stances against
    the labelled ones (both foot name -> [[start, end, ...], ...] or None)
    over ``n_frames`` frames from ``start_frame`` (JAX
    ``results.py:236-261``)."""
    def to_mask(contacts):
        m = np.zeros((n_frames, len(FOOT_NAMES)), bool)
        for i, name in enumerate(FOOT_NAMES):
            for s, e, *_ in contacts.get(name) or ():
                m[max(s - start_frame, 0):min(e - start_frame + 1,
                                              n_frames), i] = True
        return m

    p, lab = to_mask(pred), to_mask(labeled)
    tp, fp, fn = np.sum(p & lab), np.sum(p & ~lab), np.sum(~p & lab)
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return {"precision": float(precision), "recall": float(recall),
            "f1": float(f1), "tp": int(tp), "fp": int(fp), "fn": int(fn)}


def determine_dlc_performance(dlc_dir: str, hand_labeled_dir: str,
                              dlc_thresh: float = 0.5) -> Dict[str, float]:
    """Pixel statistics of the DLC detections in ``dlc_dir`` above
    ``dlc_thresh`` against the hand labels in ``hand_labeled_dir`` (both
    CSV tables, ``data/io.load_dlc_points``) over their common frames (JAX
    ``results.py:264-281``)."""
    xy_p, lik_p, _ = dio.load_dlc_points(dlc_dir)
    xy_g, lik_g, _ = dio.load_dlc_points(hand_labeled_dir)
    n = min(len(xy_p), len(xy_g))
    pred = np.where((lik_p[:n] > dlc_thresh)[..., None], xy_p[:n], np.nan)
    gt = np.where((lik_g[:n] > 0)[..., None], xy_g[:n], np.nan)
    resid = (gt - pred).reshape(-1)
    resid = resid[np.isfinite(resid)]
    if resid.size == 0:
        return {"rmse_px": float("nan"), "n": 0}
    return {"rmse_px": float(np.sqrt(np.mean(resid**2))),
            "mad_px": float(np.median(np.abs(resid - np.median(resid)))),
            "mean_px": float(resid.mean()), "std_px": float(resid.std()),
            "n": int(resid.size)}


def plot_cost_functions(out_path: str) -> bool:
    """The redescending, Cauchy (c = 7), Fair (c = 7) and quadratic losses
    over weighted residuals 0-30 to ``out_path`` (JAX
    ``results.py:284-303``). Returns False, writing nothing, without
    matplotlib."""
    from ..ops import losses

    plt = _pyplot()
    if plt is None:
        return False
    e = torch.linspace(0, 30, 600, dtype=torch.float64)
    fig = plt.figure(figsize=(10, 6), dpi=60)
    plt.plot(e, losses.redescending(e).numpy(), label="redescending")
    plt.plot(e, losses.cauchy(e, 7.0).numpy(), label="cauchy c=7")
    plt.plot(e, losses.fair(e, 7.0).numpy(), label="fair c=7")
    plt.plot(e, (0.5 * e * e).numpy(), label="quadratic", ls="--")
    plt.ylim(0, 80)
    plt.xlabel("weighted residual")
    plt.ylabel("cost")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_eom_error(fte_pickle_path: str, subject, out_path: str,
                   device: DeviceLike = None) -> np.ndarray:
    """Per-frame norm (body weights) of the EOM residual of a saved
    solution from frame 2 on with no contact force (``eom.eom_residual`` on
    its q, dq, ddq, in float64 on ``device``, the card by default), and its
    plot to ``out_path`` (JAX ``results.py:306-332``); a line names the
    plot when matplotlib is not installed. Returns the norms."""
    from ..dynamics import eom as dyn

    dev = resolve_device(device)
    d = dio.load_fte_pickle(fte_pickle_path)
    t = lambda k: torch.as_tensor(np.asarray(d[k])[2:], dtype=torch.float64,
                                  device=dev)
    q = t("q")
    r = dyn.eom_residual(q, t("dq"), t("ddq"),
                         q.new_zeros(q.shape[0], 4),
                         q.new_zeros(q.shape[0], 4, 4), subject)
    res = np.linalg.norm(r.cpu().numpy() / (subject.total_mass
                                            * dyn.GRAVITY), axis=1)
    plt = _pyplot()
    if plt is None:
        _skipped([out_path])
        return res
    fig = plt.figure(figsize=(10, 5), dpi=60)
    plt.plot(res)
    plt.xlabel("frame")
    plt.ylabel("|EOM residual| (body-weight units, zero contact)")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return res


def get_power_values(q: np.ndarray, tau: np.ndarray, fps: float,
                     force_scale: float = 1.0) -> Dict[str, np.ndarray]:
    """Mechanical power of each torque component, tau_i times the relative
    joint rate it acts on (``TORQUE_MAP.B[:, i]`` . dq, dq by
    ``np.gradient`` at ``fps``), times ``force_scale``, grouped per motor
    (JAX ``results.py:335-350``): {motor: (N, components)}."""
    q = np.asarray(q, float)
    tau = np.asarray(tau, float)
    rel_vel = (np.gradient(q, axis=0) * fps) @ TORQUE_MAP.B
    p_cols = tau * rel_vel[: len(tau)] * force_scale
    out: Dict[str, List[np.ndarray]] = {}
    for i, name in enumerate(TORQUE_MAP.names):
        out.setdefault(name.rsplit(":", 1)[0], []).append(p_cols[:, i])
    return {k: np.stack(v, axis=1) for k, v in out.items()}


def plot_power_values(q: np.ndarray, tau: np.ndarray, fps: float,
                      out_path: str, force_scale: float = 1.0
                      ) -> Dict[str, float]:
    """The total power of :func:`get_power_values` against time, with its
    mean, to ``out_path`` (JAX ``results.py:353-379``; W/kg when tau is in
    body weights and ``force_scale`` is g); a line names the plot when
    matplotlib is not installed. Returns its peak and mean."""
    power = get_power_values(q, tau, fps, force_scale)
    total = np.sum(np.hstack(list(power.values())), axis=1)
    stats = {"peak": float(np.max(total)), "mean": float(np.mean(total))}
    plt = _pyplot()
    if plt is None:
        _skipped([out_path])
        return stats
    t = np.arange(len(total)) / fps
    fig = plt.figure(figsize=(16, 9), dpi=60)
    plt.plot(t, total, color="#36454f")
    plt.plot(t, np.full_like(total, total.mean()), color="#ff7f0e",
             linestyle="--", label="Mean")
    plt.title(f"Total power output of cheetah.\nPeak power: "
              f"{int(np.max(total))} W/kg, Avg power: "
              f"{int(np.mean(total))} W/kg")
    plt.ylabel("Total power (W/kg)")
    plt.xlabel("Time (s)")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return stats


def torque_error(tau1: np.ndarray, tau2: np.ndarray):
    """Per-column torque RMSE over the common frames of two (N, k)
    torque tables (JAX ``results.py:418-427``): (RMSE (k,), tau1, tau2 cut
    to the common frames)."""
    tau1, tau2 = np.asarray(tau1), np.asarray(tau2)
    n = min(len(tau1), len(tau2))
    tau1, tau2 = tau1[:n], tau2[:n]
    return np.linalg.norm(tau1 - tau2, axis=0) / np.sqrt(n), tau1, tau2


def align_error_trajectories(trajectories: List[np.ndarray]):
    """Error curves of different lengths resampled linearly onto the
    longest one's length, and their band statistics (JAX
    ``results.py:430-445``): (length, the resampled curves, mean, std,
    median, lower and upper quartile, median absolute deviation)."""
    max_length = max(len(t) for t in trajectories)
    target = np.linspace(0.0, 1.0, max_length)
    interp = np.stack([
        np.interp(target, np.linspace(0.0, 1.0, len(t)), np.asarray(t))
        for t in trajectories])
    med = np.median(interp, axis=0)
    return (max_length, interp, np.mean(interp, axis=0),
            np.std(interp, axis=0), med,
            np.quantile(interp, 0.25, axis=0),
            np.quantile(interp, 0.75, axis=0),
            np.median(np.abs(interp - med), axis=0))


def align_error_and_plot(x: List[np.ndarray], y: List[np.ndarray],
                         z: List[np.ndarray], file_name: str) -> bool:
    """The median error over time with its MAD band of the default (``x``),
    data-driven (``y``) and physics-based (``z``) curves, each set aligned
    by :func:`align_error_trajectories`, to ``file_name`` (JAX
    ``results.py:448-469``). Returns False, writing nothing, without
    matplotlib."""
    stats = [align_error_trajectories(t) for t in (x, y, z)]
    assert stats[0][0] == stats[1][0] == stats[2][0]
    plt = _pyplot()
    if plt is None:
        return False
    fig = plt.figure(figsize=(16, 12), dpi=60)
    for (n, _, _, _, med, _, _, mad), label, color in zip(
            stats, ("Default", "Data-driven", "Physics-based"),
            ("#36454f", "#2e8b57", "#ff7f0e")):
        plt.plot(med, color=color, label=label)
        plt.fill_between(range(n), med - mad, med + mad, color=color,
                         alpha=0.15)
    plt.title("MPE over time")
    plt.xlabel("Frames")
    plt.ylabel("Error (mm)")
    plt.legend()
    fig.savefig(file_name, bbox_inches="tight")
    plt.close(fig)
    return True


def save_error_dists(px_errors: Dict[int, np.ndarray],
                     output_dir: str) -> Tuple[float, float]:
    """The pooled per-camera pixel errors' mean and median, saved with them
    as ``reprojection.pickle`` in ``output_dir``, and their histograms
    ``overall_error_hist.pdf`` and ``cams_error_hist.pdf`` there (JAX
    ``results.py:472-510``; a line names the PDFs when matplotlib is not
    installed). Returns (mean, median)."""
    import pickle

    distances = np.concatenate([np.asarray(v, float).ravel()
                                for v in px_errors.values()])
    mean_error = float(np.mean(distances))
    med_error = float(np.median(distances))
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "reprojection.pickle"), "wb") as f:
        pickle.dump({"error": distances, "mean_error": mean_error,
                     "med_error": med_error}, f)
    names = [os.path.join(output_dir, n)
             for n in ("overall_error_hist.pdf", "cams_error_hist.pdf")]
    plt = _pyplot()
    if plt is None:
        _skipped(names)
        return mean_error, med_error
    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.hist(distances, bins=50)
    ax.set_title(f"Error Overview (N={len(distances)}, "
                 f"mean={mean_error:.3f}, med={med_error:.3f})")
    ax.set_xlabel("Error [px]")
    ax.set_ylabel("Frequency")
    fig.savefig(names[0])
    plt.close(fig)
    fig = plt.figure()
    ax = fig.add_subplot(1, 1, 1)
    ax.hist([np.asarray(v, float).ravel() for v in px_errors.values()],
            bins=10, density=True, histtype="bar")
    ax.legend([f"cam{int(k) + 1} (N={len(np.asarray(v).ravel())})"
               for k, v in px_errors.items()])
    ax.set_title("Reprojection Pixel Error")
    ax.set_xlabel("Error [px]")
    ax.set_ylabel("Frequency")
    fig.savefig(names[1])
    plt.close(fig)
    return mean_error, med_error


def plot_3d_pose(fte_pickle_path: str, pose_idx: int, subject,
                 gmm_dataset: str, out_path: str, n_components: int = 5,
                 device: DeviceLike = None) -> Tuple[float, float]:
    """The pose prior's log-likelihood of frame ``pose_idx`` of a saved
    solution and of a distorted copy (front body and neck pitch and roll
    set to +-pi/6), under an ``n_components`` GMM fitted (seed 42) on the
    22 relative joint angles of the CSV table ``gmm_dataset`` on ``device``
    (the card by default); both skeletons, centred, drawn to ``out_path``
    (JAX ``results.py:513-549``; a line names the plot when matplotlib is
    not installed). Returns (ll solved, ll distorted). The JAX function
    indexes the float that ``gmm.score`` returns and raises; here each
    likelihood is ``score`` of its one pose."""
    from ..priors import dataset as prior_ds
    from ..priors import gmm as gmm_mod

    dev = resolve_device(device)
    d = dio.load_fte_pickle(fte_pickle_path)
    q_orig = np.asarray(d["q"][pose_idx], np.float64)
    pos1 = np.asarray(d["positions"][pose_idx])
    q_bad = q_orig.copy()
    q_bad[3:12:3] = np.pi / 6
    q_bad[3:12:2] = -np.pi / 6
    qt = torch.as_tensor(np.stack([q_orig, q_bad]), device=dev)
    pos2 = sk.fk_markers(qt[1:], subject)[0].cpu().numpy()
    x = sk.relative_pose(qt)[:, 6:].cpu().numpy()
    model = gmm_mod.fit(prior_ds.load_pose_dataset(gmm_dataset).data[:, 6:28],
                        n_components=n_components, seed=42, device=dev)
    ll1 = gmm_mod.score(model, x[:1])
    ll2 = gmm_mod.score(model, x[1:])
    plt = _pyplot()
    if plt is None:
        _skipped([out_path])
        return ll1, ll2
    from . import visualize

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(1, 1, 1, projection="3d")
    visualize._draw_pose(ax, pos1 - pos1.mean(axis=0, keepdims=True),
                         "#36454f", f"solved (ll={ll1:.1f})")
    visualize._draw_pose(ax, pos2 - pos2.mean(axis=0, keepdims=True),
                         "#d62728", f"distorted (ll={ll2:.1f})")
    ax.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return ll1, ll2


def std_dev(predictions: np.ndarray, targets: np.ndarray) -> float:
    """NaN-aware standard deviation of the residuals (JAX
    ``results.py:552-556``)."""
    return float(np.nanstd((np.asarray(predictions, float)
                            - np.asarray(targets, float)).flatten()))


def check_joint_estimation(root_dir: str, dir_prefix: str,
                           cheetah: str = "shiraz", date: str = "2009_09_08",
                           trial: str = "04") -> Dict[str, float]:
    """A kinetic solution under ``root_dir`` against the one for the same
    force-plate trial under ``dir_prefix`` (both
    ``kinetic_dataset/<date>/<cheetah>/trial<trial>/fte_kinetic/
    fte.pickle``): root-relative MPJPE (mm) and the torque RMSE over the
    motors both hold, each aligned on its common frames and components
    (JAX ``results.py:559-594``)."""
    from . import metrics as metrics_mod

    data_path = os.path.join("kinetic_dataset", date, cheetah,
                             f"trial{trial}")
    fte_gt = dio.load_fte_pickle(os.path.join(
        dir_prefix, data_path, "fte_kinetic", "fte.pickle"))
    fte = dio.load_fte_pickle(os.path.join(
        root_dir, data_path, "fte_kinetic", "fte.pickle"))
    per_joint, _, _ = metrics_mod.traj_error(fte_gt["positions"],
                                             fte["positions"], centered=True)
    diffs = []
    for name in sorted(set(fte_gt["tau"]) & set(fte["tau"])):
        a = np.asarray(fte_gt["tau"][name], float)
        b = np.asarray(fte["tau"][name], float)
        a = a.reshape(a.shape[0], -1)
        b = b.reshape(b.shape[0], -1)
        n, k = min(a.shape[0], b.shape[0]), min(a.shape[1], b.shape[1])
        diffs.append((a[:n, :k] - b[:n, :k]).ravel())
    tau_rmse = float(np.sqrt(np.nanmean(np.concatenate(diffs) ** 2))) \
        if diffs else float("nan")
    return {"mpjpe_mm": float(per_joint.mean()), "torque_rmse": tau_rmse}


def animate_torque_plot(tau: Dict[str, np.ndarray], fps: float,
                        out_path: str, force_scale: float = 1.0) -> bool:
    """Each motor's summed torque (times ``force_scale``) as an animated
    bar chart over the frames, written as a GIF to ``out_path`` (JAX
    ``results.py:816-853``). Returns False, writing nothing, without
    matplotlib."""
    plt = _pyplot()
    if plt is None:
        return False
    from matplotlib import animation

    names = list(tau.keys())
    arrs = [np.atleast_2d(np.asarray(tau[k], float).T).T * force_scale
            for k in names]
    n_frames = min(a.shape[0] for a in arrs)
    totals = [a.sum(axis=1) for a in arrs]
    vmax = max(float(np.nanmax(np.abs(t))) for t in totals)
    if not np.isfinite(vmax) or vmax == 0.0:
        vmax = 1.0
    fig, ax = plt.subplots(figsize=(16, 9), dpi=50)
    bars = ax.bar(range(len(names)), [t[0] for t in totals],
                  color="#36454f")
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=7)
    ax.set_ylim(-1.1 * vmax, 1.1 * vmax)
    ax.set_ylabel("Torque")

    def update(i):
        for b, t in zip(bars, totals):
            b.set_height(t[i])
        ax.set_title(f"t = {i / fps:.3f} s")
        return bars

    anim = animation.FuncAnimation(fig, update, frames=n_frames, blit=False)
    anim.save(out_path, writer=animation.PillowWriter(
        fps=max(1, min(int(round(fps)), 30))))
    plt.close(fig)
    return True
