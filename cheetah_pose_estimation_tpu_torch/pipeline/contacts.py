"""Heuristic contact detection.

Port of the numpy part of ``cheetah_pose_estimation_tpu/pipeline/contacts.py``
(``contacts.py:25-181``): a stance-time linear model from Hudson's cheetah
data, a foot-height threshold plus vertical-velocity zero-crossing test,
argmin-window stance placement, leading/trailing limb assignment, and the
``grf/autogen-contact.json`` files, and the force profiles: half-sine Fz
and a quadratic-spline Fx per detected stance (``synth_grf_data``), and the
per-frame profiles the physics-based mode fixes (``get_grf_profile``).
Foot kinematics are a forward-mode derivative of the feet's positions in
float64 on the host. The force-plate tables (``grf_io``) are read in
either form (``.h5`` first, as JAX reads them) and written as CSV only: the
JAX package writes a ``.h5`` beside each, but the JAX references of the
port's trees were solved on CSV-only trees.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..dynamics.eom import FOOT_NAMES, POLYGON_D, foot_points
from ..models.params import SubjectParams
from ..utils.device import FORWARD_AD
from . import grf_io


class SimpleLinearModel:
    """y = m x + c least-squares line."""

    def __init__(self, pts):
        x, y = zip(*pts)
        A = np.vstack([x, np.ones(len(x))]).T
        self.m, self.c = np.linalg.lstsq(A, y, rcond=None)[0]

    def predict(self, x: float) -> float:
        return self.m * x + self.c


STANCE_TIME_MODEL = SimpleLinearModel([[9.0, 0.09], [14.0, 0.06]])
# peak vertical force (body weights) against speed, per limb role
MODEL_LFL = SimpleLinearModel([[9.0, 2.0], [15.0, 1.8]])     # leading fore
MODEL_LHL = SimpleLinearModel([[9.0, 2.1], [15.0, 2.6]])     # leading hind
MODEL_NLFL = SimpleLinearModel([[9.5, 2.1], [15.0, 2.0]])    # trailing fore
MODEL_NLHL = SimpleLinearModel([[9.0, 1.7], [15.0, 2.5]])    # trailing hind

HEIGHT_THRESHOLD = 0.05


def positive_zero_crossings(x: np.ndarray) -> Tuple[int, List[int]]:
    """Count of -/+ crossings of the nonzero entries of x, and the indices
    around each."""
    count = 0
    args: List[int] = []
    x = x[np.nonzero(x)]
    for i in range(1, len(x)):
        if x[i - 1] < 0 and x[i] > 0:
            count += 1
            args.extend([i + 2, i + 1, i, i - 1, i - 2])
    return count, args


def group_by_consecutive_values(x) -> List[np.ndarray]:
    spl = [0] + [i for i in range(1, len(x)) if x[i] - x[i - 1] > 1] + [None]
    return [x[b:e] for b, e in [(spl[i - 1], spl[i])
                                 for i in range(1, len(spl))]]


def foot_kinematics(q: np.ndarray, dq: np.ndarray,
                    subject: SubjectParams) -> Tuple[np.ndarray, np.ndarray]:
    """(heights (N, 4), velocities (N, 4, 3)) of the feet along a trajectory
    (float64, on the host)."""
    qt = torch.as_tensor(np.asarray(q), dtype=torch.float64)
    dqt = torch.as_tensor(np.asarray(dq), dtype=torch.float64)
    with FORWARD_AD:
        pts, vel = torch.func.jvp(lambda qq: foot_points(qq, subject),
                                  (qt,), (dqt,))
    return pts[..., 2].numpy(), vel.numpy()


def estimate_ground_height(q: np.ndarray, subject: SubjectParams) -> float:
    """Ground elevation estimate for a trajectory: its lowest foot height
    (the stand-in for a trial's measured ground plane height)."""
    z, _ = foot_kinematics(q, np.zeros_like(q), subject)
    return float(np.min(z))


def contact_detection(q: np.ndarray, dq: np.ndarray, subject: SubjectParams,
                      start_frame: int, speed: float, fps: float,
                      data_dir: Optional[str] = None,
                      ground_plane_height: float = 0.0,
                      foot_kin: Optional[Tuple[np.ndarray, np.ndarray]]
                      = None,
                      per_foot_relative: bool = False) -> Tuple[Dict, Dict]:
    """Heuristic stance detection against the ground plane. Returns
    (contacts, contacts_tmp) and, with ``data_dir``, writes them as
    ``grf/autogen-contact.json`` and ``grf/autogen-contact-02.json`` there
    (the physics-based mode reads the first back). ``foot_kin`` supplies
    precomputed (heights, velocities) so that a batch caller evaluates the
    feet of every trial in one call. ``per_foot_relative`` gates the height
    test against each foot's own lowest height instead of the plane, so a
    global depth error of a monocular solve (which moves every foot off the
    plane) does not hide its stances: the depth correction needs that."""
    stance_time_fe = round(STANCE_TIME_MODEL.predict(speed) * fps)
    mid_way = stance_time_fe // 2
    is_even = (stance_time_fe % 2) == 0
    heights, vels = foot_kin if foot_kin is not None \
        else foot_kinematics(q, dq, subject)
    N = q.shape[0]
    contacts: Dict[str, Optional[List]] = {}
    contacts_tmp: Dict[str, Optional[List]] = {}
    for i, name in enumerate(FOOT_NAMES):
        fh = heights[:, i]
        gate = (float(fh.min()) if per_foot_relative
                else ground_plane_height) + HEIGHT_THRESHOLD
        arg_h = np.where(fh < gate)[0]
        groups = group_by_consecutive_values(arg_h)
        _, vel_crossings = positive_zero_crossings(vels[:, i, 2])
        contacts[name] = []
        contacts_tmp[name] = []
        arg_min_height = -1
        for j, grp in enumerate(groups):
            if len(grp) == 0:
                continue
            start_search = int(arg_min_height + 1)
            end_search = groups[j + 1][0] if j + 1 < len(groups) else -1
            seg = fh[start_search:end_search]
            if len(seg) == 0:
                continue
            arg_min_height = start_search + int(np.argmin(seg))
            possible = np.intersect1d(grp, vel_crossings)
            is_contact = [arg_min_height + k not in possible
                          for k in (-2, -1, 0, 1, 2)]
            if np.all(is_contact):
                arg_min_height = grp[-1]
                continue
            start_idx = int(arg_min_height - mid_way)
            end_idx = int(arg_min_height + mid_way)
            arg_min_height = grp[-1]
            if is_even:
                start_idx += 1
            if start_idx < 0:
                end_idx -= start_idx
                start_idx = 0
            if end_idx >= N:
                start_idx -= end_idx - N - 1
                end_idx = N - 1
            contacts[name].append([start_frame + start_idx,
                                   start_frame + end_idx, i, "TBD"])
            contacts_tmp[name].append([int(start_frame + grp[0]),
                                       int(start_frame + grp[-1]), i, "TBD"])
        if not contacts[name]:
            contacts[name] = None
            contacts_tmp[name] = None

    def assign(a: str, b: str):
        if contacts[a] is not None and contacts[b] is not None:
            if contacts[a][0][0] > contacts[b][0][0]:
                contacts[a][0][3], contacts[b][0][3] = "leading", "trailing"
            else:
                contacts[a][0][3], contacts[b][0][3] = "trailing", "leading"

    assign("HFL_foot", "HFR_foot")
    assign("HBL_foot", "HBR_foot")

    if data_dir is not None:
        grf_dir = os.path.join(data_dir, "grf")
        os.makedirs(grf_dir, exist_ok=True)
        for fname, c in (("autogen-contact.json", contacts),
                         ("autogen-contact-02.json", contacts_tmp)):
            with open(os.path.join(grf_dir, fname), "w",
                      encoding="utf-8") as f:
                json.dump({"start_frame": int(start_frame),
                           "end_frame": int(start_frame + N),
                           "contacts": c}, f)
    return contacts, contacts_tmp


def synth_grf_data(speed: float, direction: float, data_dir: str,
                   contact_fname: str = "autogen-contact.json",
                   out_fname: str = "data_synth") -> None:
    """Synthesize per-limb force profiles over the first detected stance
    of each foot in ``data_dir/contact_fname`` and write them to
    ``data_dir/<out_fname>.csv``: a half-sine Fz whose peak follows the
    speed and the limb's role, and an Fx that is a quadratic spline through
    a deceleration lobe (``direction`` x half the peak) and an acceleration
    lobe, zero at touch-down, mid-stance and lift-off."""
    from scipy import interpolate

    with open(os.path.join(data_dir, contact_fname), "r",
              encoding="utf-8") as f:
        cj = json.load(f)
    start_frame, end_frame = cj["start_frame"], cj["end_frame"]
    order = cj["contacts"]
    models = {("F", "leading"): MODEL_LFL, ("F", "trailing"): MODEL_NLFL,
              ("B", "leading"): MODEL_LHL, ("B", "trailing"): MODEL_NLHL}
    frames = {}
    for name in FOOT_NAMES:
        if (name not in order or order[name] is None
                or order[name][0][1] >= end_frame):
            continue
        start_idx = max(order[name][0][0] - 1, start_frame)
        end_idx = min(order[name][0][1] + 1, end_frame)
        stance_end = end_idx - start_idx
        if stance_end <= 0:
            continue
        model = models.get((name[1], order[name][0][3]))
        if model is None:
            continue
        peak_idx = stance_end // 2
        t = np.linspace(0, stance_end, stance_end)
        Fz_peak = model.predict(speed)
        Fx_dec = direction * 0.5 * Fz_peak
        Fx_acc = 0.5 * -Fx_dec
        ctrl = np.array([[0.0, 0.0], [peak_idx // 2, Fx_dec],
                         [peak_idx, 0.0],
                         [peak_idx + (stance_end - peak_idx) // 2, Fx_acc],
                         [stance_end, 0.0]])
        spline = interpolate.InterpolatedUnivariateSpline(
            ctrl[:, 0], ctrl[:, 1], k=2)
        Fxyz = np.zeros((end_frame - start_frame, 3))
        sl = slice(start_idx - start_frame, end_idx - start_frame)
        Fxyz[sl, 0] = spline(t)
        Fxyz[sl, 2] = Fz_peak * np.sin(np.pi * (t / stance_end))
        frames[order[name][0][2] - 1] = Fxyz
    grf_io.save_force_plate_df(os.path.join(data_dir, f"{out_fname}.csv"),
                               frames)


def get_grf_profile(params_total_length: int, data_dir: str,
                    metadata_dir: str, direction: float,
                    scale_forces_by: float, kinetic_dataset: bool = False,
                    synthetic_data: bool = True) -> Tuple[Dict, Dict]:
    """Per-frame (GRFz, GRFxy-polygon) profiles of each foot in body-weight
    units, from the force-plate table of ``data_dir/grf``: the synthesized
    one (``data_synth.h5``, frames as written) or the measured one
    (``data.h5`` of a force-plate trial, each read from its ``.csv`` where
    the ``.h5`` does not exist: 3500 Hz resampled to 200 Hz by a
    2/35 polyphase filter, the mean of the first 500 samples removed,
    scaled by ``scale_forces_by``, Fx and Fy signed by ``direction``). A
    foot's force counts on the frames of its first stance; its horizontal
    part goes to the friction-polygon direction it projects on most, when
    that projection is positive."""
    from scipy import signal

    grf = grf_io.load_force_plate_df(os.path.join(
        data_dir, "grf", "data_synth.h5" if synthetic_data else "data.h5"))
    meta_path = (os.path.join(data_dir, "grf", "autogen-contact.json")
                 if synthetic_data
                 else os.path.join(metadata_dir, "metadata.json"))
    with open(meta_path, "r", encoding="utf-8") as f:
        cj = json.load(f)
    start_frame = cj["start_frame"]
    order = cj["contacts"]
    nfe = params_total_length
    measured = not synthetic_data and kinetic_dataset
    gz = {n: [0.0] * nfe for n in FOOT_NAMES}
    gxy = {n: [[0.0] * 4 for _ in range(nfe)] for n in FOOT_NAMES}
    for name in FOOT_NAMES:
        if name not in order or order[name] is None:
            continue
        plate = order[name][0][2] - 1
        if plate not in grf:
            continue
        F = grf[plate]
        if measured:
            def prep(col, sgn=1.0):
                x = col - col[:500].mean()
                return sgn * signal.resample_poly(x, up=2, down=35) \
                    * scale_forces_by
            Fz = prep(F[:, 2])
            Fx = prep(F[:, 0], direction)
            Fy = prep(F[:, 1], direction)
        else:
            Fx, Fy, Fz = F[:, 0], F[:, 1], F[:, 2]
        on_ground = set(range(order[name][0][0], order[name][0][1] + 1))
        for fe in range(1, nfe):
            if (start_frame + fe - 1) not in on_ground:
                continue
            k = start_frame + fe - 1 if measured else fe - 1
            if k >= len(Fz):
                continue
            gz[name][fe - 1] = float(Fz[k])
            comps = POLYGON_D @ np.array([Fx[k], Fy[k], 0.0])
            mi = int(np.argmax(comps))
            if comps[mi] > 0:
                gxy[name][fe - 1][mi] = float(comps[mi])
    return gz, gxy
