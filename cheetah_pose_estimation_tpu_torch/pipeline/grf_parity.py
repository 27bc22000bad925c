"""Force-accuracy validation against the reference's solved kinetic
trajectories.

Port of ``cheetah_pose_estimation_tpu/pipeline/grf_parity.py``. The
reference ships solved physics trajectories of its five force-plate trials:
joint torques in ``fte_kinetic/fte.pickle`` (per motor, body-weight units)
and per-foot ground-reaction forces in ``fte_kinetic/cheetah.pickle`` (foot
nodes carry ``GRFz (N,1)`` and ``GRFxy (N,1,4)`` in body-weight units). The
reference validated those forces against its plates, so they are external
force truth for the port's force path: the per-frame torque/GRF elimination
(``solver.kinetic.KineticFTE.forces``) is evaluated at the reference's own
trajectory, with stance from its GRFz support, and the solved forces are
compared. The trajectory is the same, so any difference isolates the
dynamics model and the force solver from the reconstruction.

The torque split across the 22 motors at a fixed trajectory depends on
each solver's regularisation (the reference's torque penalty, the port's
ridge-regularised elimination) while a foot is in stance, so the GRF
columns, pinned by the six base rows of the equations of motion, are the
headline; the torque columns are split into flight frames (identifiable)
and stance frames.

The tree (``KINETIC_ROOT``: ``kinetic_dataset`` under the reference test
set, ``bench_lib.REF_TEST_SET``) is not in the repository: without it
there are no trials and no rows.
"""
from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dynamics import eom as dyn
from ..models import params as P
from ..utils.device import DeviceLike, resolve_device
from . import bench_lib

KINETIC_ROOT = os.path.join(bench_lib.REF_TEST_SET, "kinetic_dataset")
STANCE_THRESHOLD_BW = 1e-3   # reference GRFz support -> stance indicator
COLUMNS = ("trial", "n_frames", "gz_rmse_bw", "stance_gz_rmse_bw",
           "tot_grf_corr", "peak_gz_ours_bw", "peak_gz_ref_bw",
           "tau_rmse_bw", "tau_ref_rms_bw", "tau_flight_rmse_bw",
           "tau_flight_ref_rms_bw", "tau_stance_rmse_bw",
           "sagittal_curve_corr", "n_stance_curves")


def kinetic_trial_dirs(root: str = KINETIC_ROOT) -> List[str]:
    """The trial directories ``root/<date>/<cheetah>/<trial>`` that hold
    ``fte_kinetic/fte.pickle``, sorted ([] without the tree)."""
    return [d for d in sorted(glob.glob(os.path.join(root, "*", "*", "*")))
            if os.path.exists(os.path.join(d, "fte_kinetic", "fte.pickle"))]


def load_reference_kinetic_solution(trial_dir: str) -> Dict:
    """q (N,54), tau (N,22) in ``TORQUE_MAP`` column order, grf_z (N,4) and
    grf_xy (N,4,4) in ``FOOT_NAMES`` order, all body-weight units, and
    start_frame."""
    with open(os.path.join(trial_dir, "fte_kinetic", "fte.pickle"),
              "rb") as f:
        ref = pickle.load(f)
    with open(os.path.join(trial_dir, "fte_kinetic", "cheetah.pickle"),
              "rb") as f:
        chz = pickle.load(f)
    grf: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    for link in chz["links"]:
        for node in link["nodes"]:
            if isinstance(node, dict) and "GRFz" in node:
                grf[node["name"]] = (np.asarray(node["GRFz"])[:, 0],
                                     np.asarray(node["GRFxy"])[:, 0, :])
    gz = np.stack([grf[n][0] for n in dyn.FOOT_NAMES], axis=1)
    gxy = np.stack([grf[n][1] for n in dyn.FOOT_NAMES], axis=1)
    # the reference's tau dict -> TORQUE_MAP columns: a motor's components
    # in the order of its axes in the map
    cols = []
    for nm in dyn.TORQUE_MAP.names:
        motor, ax = nm.rsplit(":", 1)
        axes = [x.rsplit(":", 1)[1] for x in dyn.TORQUE_MAP.names
                if x.startswith(motor + ":")]
        cols.append(np.asarray(ref["tau"][motor])[:, axes.index(ax)])
    return dict(q=np.asarray(ref["q"], np.float64),
                tau=np.stack(cols, axis=1), grf_z=gz, grf_xy=gxy,
                start_frame=int(ref.get("start_frame", 0)))


def solve_forces_at(q: np.ndarray, stance: np.ndarray, subject_name: str,
                    fps: float = 200.0, device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tau (N,22), grf_z (N,4), grf_xy (N,4,4)) of the port's per-frame
    elimination at the trajectory ``q`` with the stance matrix ``stance``
    (N,4), body-weight units: ``KineticFTE.forces`` of the force-plate
    configuration in float64 on ``device`` (the card by default)."""
    from ..parallel import batch as pbatch
    from ..solver import kinematic as kin
    from ..solver import kinetic as kn

    dev = resolve_device(device)
    subject = P.get_subject(subject_name)
    q = np.asarray(q, np.float64)
    N = q.shape[0]
    gmmp = kin.GMMPrior(np.zeros((1, 22)), np.eye(22)[None], np.zeros(1))
    ar = kin.ARAnchor(np.zeros((N, 28)), np.zeros(28), np.zeros(N))
    cam = kin.CameraSet(np.eye(3)[None], np.zeros((1, 4)), np.eye(3)[None],
                        np.zeros((1, 3)))
    base = kin.KinematicData(
        meas=np.zeros((N, 1, 24, 2, 1)), weight=np.zeros((N, 1, 24, 2, 1)),
        cam=cam, h=np.asarray(1.0 / fps), acc_weight=np.ones(54),
        frame_valid=np.ones(N), gmm=gmmp, ar=ar)
    kd = kn.KineticData(
        base=base, stance=np.asarray(stance, np.float64),
        grf_fixed=np.zeros((N, 4)), grf_xy_fixed=np.zeros((N, 4, 4)),
        use_fixed_grf=np.asarray(0.0), q_warm=q, ground_z=np.asarray(0.0))
    kbat, qb = pbatch.pad_and_stack_kinetic([kd], [q], dtype=torch.float64,
                                            device=dev)
    fte = kn.KineticFTE(kn.KineticConfig(kinetic_dataset=True), subject)
    tau, gz, gxy = fte.forces(qb, kbat)
    return tuple(x[0].detach().cpu().numpy() for x in (tau, gz, gxy))


# The 12 leg pitch (sagittal, about-y) motor columns, hip/knee/hock per
# leg: the reference's gait-analysis torque curves.
_LEG_PITCH = tuple(i for i, nm in enumerate(dyn.TORQUE_MAP.names)
                   if ("hip-pitch" in nm
                       or ("_torque:y" in nm and nm[0] in "UL"
                           and nm[1] in "FB")))


def _stance_curve(x: np.ndarray, stance_col: np.ndarray,
                  n_pts: int = 50) -> Optional[np.ndarray]:
    """A foot's longest contiguous stance window from frame 2 on (frames
    0-1 are the backward differences' boundary), resampled to n_pts; None
    when it has fewer than 4 frames."""
    on = np.flatnonzero(stance_col > 0)
    on = on[on >= 2]
    if on.size < 4:
        return None
    w = max(np.split(on, np.flatnonzero(np.diff(on) > 1) + 1), key=len)
    if len(w) < 4:
        return None
    t = np.linspace(0, len(w) - 1, n_pts)
    return np.interp(t, np.arange(len(w)), x[w])


def _rms(x: np.ndarray) -> float:
    return float(np.sqrt(np.mean(x ** 2)))


def grf_parity(out_csv: Optional[str] = None, root: str = KINETIC_ROOT,
               verbose: bool = True, device: DeviceLike = None
               ) -> List[Dict]:
    """Per-trial force parity against the reference's solved physics, one
    dict per trial of ``root`` with the keys of ``COLUMNS`` (JAX's column
    order), the first two frames left out of the errors:

    GRF: ``gz_rmse_bw`` (all frames and feet), ``stance_gz_rmse_bw`` (stance
    frames), ``tot_grf_corr`` (total vertical force over frames),
    ``peak_gz_[ours|ref]_bw``. Torque: ``tau_rmse_bw`` and
    ``tau_ref_rms_bw``; ``tau_flight_rmse_bw`` and
    ``tau_flight_ref_rms_bw`` over frames with no foot in stance (where the
    torques are identifiable from the trajectory), ``tau_stance_rmse_bw``
    over the rest; ``sagittal_curve_corr``, the mean correlation of the
    stance-normalised hip/knee/hock pitch-torque curves of each foot's
    longest stance window, over ``n_stance_curves`` curves. NaN where a
    set is empty.

    With ``out_csv``, the rows are written there as pandas writes them
    (``run_dataset.write_rows_csv``); nothing is written by default."""
    from .run_dataset import write_rows_csv

    dev = resolve_device(device)
    rows = []
    nan = float("nan")
    for tdir in kinetic_trial_dirs(root):
        name = "arabia" if "arabia" in tdir else "shiraz"
        ref = load_reference_kinetic_solution(tdir)
        stance = (ref["grf_z"] > STANCE_THRESHOLD_BW).astype(float)
        tau, gz, _ = solve_forces_at(ref["q"], stance, name, device=dev)
        sl = slice(2, None)
        m = stance[sl] > 0
        d_gz = gz[sl] - ref["grf_z"][sl]
        tot, tot_ref = gz[sl].sum(1), ref["grf_z"][sl].sum(1)
        d_tau = tau[sl] - ref["tau"][sl]
        flight = stance[sl].sum(axis=1) == 0
        leg = np.asarray(_LEG_PITCH)
        corrs = []
        for f in range(4):
            for j in range(3):
                col = leg[3 * f + j]
                a = _stance_curve(tau[:, col], stance[:, f])
                b = _stance_curve(ref["tau"][:, col], stance[:, f])
                if a is None or b is None or np.std(a) < 1e-9 \
                        or np.std(b) < 1e-9:
                    continue
                corrs.append(float(np.corrcoef(a, b)[0, 1]))
        rows.append(dict(
            trial=os.path.relpath(tdir, root), n_frames=len(ref["q"]),
            gz_rmse_bw=_rms(d_gz),
            stance_gz_rmse_bw=_rms(d_gz[m]) if m.any() else nan,
            tot_grf_corr=float(np.corrcoef(tot, tot_ref)[0, 1]),
            peak_gz_ours_bw=float(gz.max()),
            peak_gz_ref_bw=float(ref["grf_z"].max()),
            tau_rmse_bw=_rms(d_tau),
            tau_ref_rms_bw=_rms(ref["tau"][sl]),
            tau_flight_rmse_bw=_rms(d_tau[flight]) if flight.any() else nan,
            tau_flight_ref_rms_bw=_rms(ref["tau"][sl][flight])
            if flight.any() else nan,
            tau_stance_rmse_bw=_rms(d_tau[~flight])
            if (~flight).any() else nan,
            sagittal_curve_corr=float(np.mean(corrs)) if corrs else nan,
            n_stance_curves=len(corrs)))
        if verbose:
            r = rows[-1]
            print(f"[grf_parity] {r['trial']}: gz_rmse={r['gz_rmse_bw']:.3f} "
                  f"corr={r['tot_grf_corr']:.3f} "
                  f"tau_flight={r['tau_flight_rmse_bw']:.3f} "
                  f"curve_corr={r['sagittal_curve_corr']:.3f}")
    if out_csv:
        write_rows_csv(out_csv, rows, COLUMNS)
    return rows
