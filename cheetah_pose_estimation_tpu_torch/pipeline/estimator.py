"""Trial directories in, AcinoSet artifacts out.

Port of the parts of ``cheetah_pose_estimation_tpu/pipeline/estimator.py``
that the batched dataset CLI runs: the per-trial configuration and
estimator (``TrajectoryParams``, ``Scene``, ``CheetahEstimator`` with
``save`` and ``load``), ``init_trajectory`` (read a trial directory: DLC
tables, scene calibration, metadata), the data-driven mode's settings and
prior gate, the training-table lookup, and the physics mode's warm start
and contact files. The serial per-trial entry points
(``estimate_kinematics``, ``estimate_kinetics``) and the pairwise
pseudo-measurements (``enable_ppm``) are not ported yet. Host work is numpy
and float64 torch on the CPU.

Directory layout consumed (the reference's):

  <root_dir>/<data_path>/
      metadata.json                        start/end frame, cam_sync, ...
      dlc/cam*.csv                         DLC predictions
      (walk up) extrinsic_calib/N_cam_scene_sba.json

Outputs land in ``fte_kinematic`` (multi-view), ``fte_kinematic_orig_<cam>``
(monocular default), ``fte_kinematic_<cam>`` (data-driven) and
``fte_kinetic_<cam>`` (physics-based) under ``<out_dir_prefix>/<data_path>``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data import io as dio
from ..models import noise as noise_tables
from ..models import params as params_mod
from ..models import skeleton as sk
from ..ops import camera as cam_ops
from ..solver import kinematic as kin

# base-pose anchor of the prior-constrained solves (solver.kinematic
# base_ref / base_anchor_*): a stiff translation pin (sigma ~2.5 cm) and a
# soft rotation pin, so the pose prior cannot trade global depth for
# manifold poses
DD_BASE_ANCHOR = dict(base_anchor_trans=1.6e3, base_anchor_rot=1e2)

# prior gate threshold on the chain's prior-free cost against the
# prior-free solve's
PRIOR_GUARD_RATIO = 1.30


def _default_data_driven_dataset() -> str:
    """Training table of the learned priors: ``CHEETAH_DATA_DRIVEN_DATASET``,
    else ``./models/data-driven/dataset_full_pose.h5`` or ``.csv`` (the
    reference's location). Without any of them the ``.h5`` path, which
    raises when read (only the CSV form is read)."""
    cands = [os.environ.get("CHEETAH_DATA_DRIVEN_DATASET"),
             os.path.join(".", "models", "data-driven",
                          "dataset_full_pose.h5"),
             os.path.join(".", "models", "data-driven",
                          "dataset_full_pose.csv")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return cands[1]


def prior_gate_accept(c_chain, c_free):
    """Per-trial prior gate: the GMM chain is accepted when its prior-free
    cost does not exceed the prior-free solve's by more than
    (PRIOR_GUARD_RATIO - 1) x max(|cost|, 1).

    Not a plain ratio test: the smoothed redescending loss is slightly
    negative at well-fit residuals, so totals can be negative and
    ``c_chain <= r * c_free`` would invert there. Elementwise on arrays."""
    c_chain = np.asarray(c_chain, np.float64)
    c_free = np.asarray(c_free, np.float64)
    margin = (PRIOR_GUARD_RATIO - 1.0) * np.maximum(np.abs(c_free), 1.0)
    return c_chain <= c_free + margin


@dataclasses.dataclass
class TrajectoryParams:
    """Per-trial configuration."""
    data_dir: str
    start_frame: int
    end_frame: int
    total_length: int
    dlc_thresh: float
    sync_offset: Optional[List[Dict]]
    hand_labeled_data: bool
    kinetic_dataset: bool
    enable_shutter_delay_estimation: bool
    enable_ppms: bool
    # metadata.json ground_plane_height: the trial world frame's ground
    # elevation (not 0 for AcinoSet)
    ground_plane_height: float = 0.0


@dataclasses.dataclass
class Scene:
    """Calibrated camera rig."""
    scene_fpath: str
    k_arr: np.ndarray
    d_arr: np.ndarray
    r_arr: np.ndarray
    t_arr: np.ndarray
    cam_res: tuple
    fps: float
    n_cams: int
    cam_idx: Optional[int] = None


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@dataclasses.dataclass
class CheetahEstimator:
    name: str
    data_path: str
    subject: params_mod.SubjectParams
    params: TrajectoryParams
    scene: Scene
    kinematic_model: bool = True
    # filled by the solves
    q: Optional[np.ndarray] = None
    q0: Optional[np.ndarray] = None
    data: Optional[kin.KinematicData] = None   # numpy leaves, no trial axis
    com_pos: Optional[np.ndarray] = None
    com_vel: Optional[np.ndarray] = None
    opt_time_s: Optional[float] = None
    obj_cost: Optional[float] = None
    xy: Optional[np.ndarray] = None       # (F, C, L, 2) raw detections
    likelihood: Optional[np.ndarray] = None
    tau: Optional[np.ndarray] = None      # (N, 22) solved joint torques
    grf_z: Optional[np.ndarray] = None    # (N, 4)
    grf_xy: Optional[np.ndarray] = None   # (N, 4, 4)
    shutter_delay: Optional[np.ndarray] = None  # (C,) seconds

    def _base(self, out_dir_prefix: Optional[str]) -> str:
        return (os.path.join(out_dir_prefix, self.data_path)
                if out_dir_prefix else self.params.data_dir)

    def load(self, fte_name: str, out_dir_prefix: Optional[str] = None):
        """Load a saved solution's state (the q trajectory in fte.pickle is
        the full state)."""
        d = dio.load_fte_pickle(os.path.join(self._base(out_dir_prefix),
                                             fte_name, "fte.pickle"))
        self.q = np.asarray(d["q"])
        self.com_pos = d.get("com_pos")
        self.com_vel = d.get("com_vel")
        self.obj_cost = d.get("obj_cost")
        return d

    def derivatives(self):
        """The implicit-Euler collocation variables dq, ddq that the solver
        eliminates, from q."""
        q = self.q
        h = 1.0 / self.scene.fps
        N = q.shape[0]
        dq = np.zeros_like(q)
        ddq = np.zeros_like(q)
        dq[1:] = (q[1:] - q[:-1]) / h
        ddq[2:] = (dq[2:] - dq[1:-1]) / h
        if N > 2:
            ddq[1] = ddq[2]
            ddq[0] = ddq[1]
            dq[0] = dq[1] - h * ddq[1]
        return dq, ddq

    def is_solution_acceptable(self) -> bool:
        """Finite objective and state (non-finite values are the LM
        solver's failure signal)."""
        return (self.q is not None and bool(np.all(np.isfinite(self.q)))
                and self.obj_cost is not None
                and bool(np.isfinite(self.obj_cost)))

    def _project_fn(self):
        return (cam_ops.project_pinhole if self.params.kinetic_dataset
                else cam_ops.project_fisheye)

    def save(self, out_dir_name: str, fname: str = "fte",
             out_dir_prefix: Optional[str] = None) -> str:
        """Write fte.pickle and the per-camera reprojections
        ``cam<i>_<fname>.csv`` to ``<base>/<out_dir_name>``."""
        out_dir = os.path.join(self._base(out_dir_prefix), out_dir_name)
        q = np.asarray(self.q, dtype=np.float64)
        dq, ddq = self.derivatives()
        positions = sk.fk_markers(_t(q), self.subject).numpy()
        rel = lambda a: sk.relative_pose(_t(a)).numpy()
        com = sk.com_position(_t(q), self.subject).numpy()
        com_vel = (com[1:] - com[:-1]) * self.scene.fps
        self.com_pos, self.com_vel = com, com_vel
        meas_err = self._measurement_slacks(positions)
        sync = [0] * self.scene.n_cams
        if self.params.sync_offset:
            for off in self.params.sync_offset:
                sync[off["cam"]] = off["frame"]
        from ..dynamics.eom import tau_as_dict
        tau_dict = tau_as_dict(self.tau) if self.tau is not None else {}
        dio.save_fte_pickle(
            os.path.join(out_dir, f"{fname}.pickle"), positions,
            x=rel(q), dx=rel(dq), ddx=rel(ddq), q=q, dq=dq, ddq=ddq,
            com_pos=com, com_vel=com_vel, tau=tau_dict, meas_err=meas_err,
            obj_cost=self.obj_cost, processing_time_s=self.opt_time_s,
            start_frame=self.params.start_frame)
        positions_arr = []
        for c in range(self.scene.n_cams):
            if self.shutter_delay is not None:
                tau_c = float(self.shutter_delay[c])
                shift = dq[:, :3] * tau_c + ddq[:, :3] * tau_c**2
                positions_arr.append(positions + shift[:, None, :])
            else:
                positions_arr.append(positions)
        proj = self._project_fn()
        dio.save_3d_cheetah_as_2d(
            positions_arr, out_dir, self.scene.k_arr, self.scene.d_arr,
            self.scene.r_arr, self.scene.t_arr, self.scene.cam_res,
            lambda X, k, d, r, t: proj(_t(X), _t(k), _t(d), _t(r),
                                       _t(t).reshape(3)).numpy(),
            self.params.start_frame, sync, out_fname=fname)
        return out_dir

    def _measurement_slacks(self, positions: np.ndarray) -> np.ndarray:
        """Reprojection minus measurement for every (frame, camera, marker,
        coordinate, detection)."""
        data = self.data
        meas = np.asarray(data.meas)
        proj = self._project_fn()
        out = np.zeros_like(meas)
        cam = data.cam
        pts = _t(positions.reshape(-1, 3))
        for c in range(meas.shape[1]):
            uv = proj(pts, _t(cam.K[c]), _t(cam.D[c]), _t(cam.R[c]),
                      _t(cam.t[c])).numpy().reshape(meas.shape[0],
                                                    meas.shape[2], 2)
            out[:, c] = uv[..., None] - meas[:, c]
        return out


def _fps_for_path(data_path: str, kinetic_dataset: bool) -> float:
    if not kinetic_dataset and "2019" in data_path:
        return 120.0
    if not kinetic_dataset and "2017" in data_path:
        return 90.0
    return 200.0


def init_trajectory(root_dir: str, data_path: str, cheetah_name: str,
                    kinetic_dataset: bool = False,
                    start_frame: int = -1, end_frame: int = -1,
                    dlc_thresh: float = 0.5,
                    kinematic_model: bool = True,
                    monocular_enable: bool = False,
                    override_monocular_cam: Optional[int] = None,
                    enable_ppm: bool = False,
                    hand_labeled_data: bool = False,
                    shutter_delay_estimation: bool = False
                    ) -> CheetahEstimator:
    """Load a trial directory and assemble its problem: the metadata's
    window, sync offsets, ground height and monocular camera (explicit
    start/end frames override only the window), the scene calibration, the
    frame rate from the path, and the measurements (all cameras, or the
    monocular one)."""
    if enable_ppm:
        raise NotImplementedError("pairwise pseudo-measurements (enable_ppm)"
                                  " are not ported")
    subject = params_mod.get_subject(cheetah_name)
    data_dir = os.path.join(root_dir, data_path)
    assert os.path.exists(data_dir), data_dir

    ground_plane_height = 0.0
    cam_idx = None
    sync_offset = None
    if start_frame < 0 or end_frame < 0 or os.path.exists(
            os.path.join(data_dir, "metadata.json")):
        meta = dio.load_metadata(data_dir)
        if start_frame < 0 or end_frame < 0:
            start_frame = meta["start_frame"]
            end_frame = meta["end_frame"]
        sync_offset = meta.get("cam_sync")
        ground_plane_height = meta.get("ground_plane_height", 0.0)
        if monocular_enable:
            cam_idx = meta.get("monocular_cam")
    if override_monocular_cam is not None and monocular_enable:
        cam_idx = override_monocular_cam
    total_length = end_frame - start_frame

    k_arr, d_arr, r_arr, t_arr, cam_res, n_cams, scene_fpath = \
        dio.find_scene_file(data_dir)
    d_arr = d_arr.reshape((-1, 4))
    fps = _fps_for_path(data_path, kinetic_dataset)
    params = TrajectoryParams(data_dir, start_frame, end_frame, total_length,
                              dlc_thresh, sync_offset, hand_labeled_data,
                              kinetic_dataset, shutter_delay_estimation,
                              enable_ppm, ground_plane_height)
    scene = Scene(scene_fpath, k_arr, d_arr, r_arr, t_arr, cam_res, fps,
                  n_cams, cam_idx)
    est = CheetahEstimator(cheetah_name, data_path, subject, params, scene,
                           kinematic_model)
    _load_measurements(est)
    return est


def _load_measurements(est: CheetahEstimator):
    """Read the DLC tables, apply the sync offsets and the frame window, and
    build the measurement and likelihood-gated weight arrays."""
    p = est.params
    dlc_dir = os.path.join(
        p.data_dir, "dlc" if not p.hand_labeled_data else "dlc_hand_labeled")
    xy, lik, _ = dio.load_dlc_points(dlc_dir, est.scene.n_cams)
    sync = [0] * est.scene.n_cams
    if p.sync_offset:
        for off in p.sync_offset:
            sync[off["cam"]] = off["frame"]
    N = p.end_frame - p.start_frame
    C = est.scene.n_cams
    L = len(sk.MARKERS)
    meas = np.zeros((N, C, L, 2))
    likelihood = np.zeros((N, C, L))
    for c in range(C):
        lo = p.start_frame - sync[c]
        hi = lo + N
        lo_c = max(lo, 0)
        hi_c = min(hi, xy.shape[0])
        if hi_c > lo_c:
            meas[lo_c - lo:hi_c - lo, c] = np.nan_to_num(xy[lo_c:hi_c, c])
            likelihood[lo_c - lo:hi_c - lo, c] = lik[lo_c:hi_c, c]
    est.xy = meas
    est.likelihood = likelihood

    w_rows = noise_tables.measurement_weights(1, p.kinetic_dataset)
    gate = (likelihood > p.dlc_thresh).astype(float)
    weight_full = np.einsum("wl,ncl->nclw", w_rows, gate)
    meas_full = meas[..., None]
    sl = slice(None) if est.scene.cam_idx is None else \
        slice(est.scene.cam_idx, est.scene.cam_idx + 1)
    # the scene file stores t as (C, 3, 1); the solver takes (C, 3)
    cam = kin.CameraSet(est.scene.k_arr[sl], est.scene.d_arr[sl],
                        est.scene.r_arr[sl],
                        est.scene.t_arr[sl].reshape(-1, 3))
    gmmp = kin.GMMPrior(np.zeros((1, 22)), np.eye(22)[None], np.zeros((1,)))
    ar = kin.ARAnchor(np.zeros((N, 28)), np.zeros(28), np.zeros(N))
    est.data = kin.KinematicData(
        meas=meas_full[:, sl], weight=weight_full[:, sl], cam=cam,
        h=np.asarray(1.0 / est.scene.fps),
        acc_weight=noise_tables.acc_model_weights(),
        frame_valid=np.ones(N), gmm=gmmp, ar=ar)


def _load_warm_start(est: CheetahEstimator, monocular: bool,
                     out_dir_prefix: Optional[str]):
    """The saved kinematic solution a physics solve starts from: the
    data-driven one (``fte_kinematic_<cam>``) of a monocular trial, else the
    default one, or the multi-view ``fte_kinematic``."""
    base = est._base(out_dir_prefix)
    name = ("fte_kinematic" if not monocular or est.scene.cam_idx is None
            else f"fte_kinematic_{est.scene.cam_idx}")
    path = os.path.join(base, name, "fte.pickle")
    if not os.path.exists(path) and monocular:
        path = os.path.join(base, f"fte_kinematic_orig_{est.scene.cam_idx}",
                            "fte.pickle")
    return dio.load_fte_pickle(path)


def determine_contacts(est: CheetahEstimator, monocular: bool = False,
                       out_dir_prefix: Optional[str] = None,
                       verbose: bool = False):
    """Contact detection on the saved kinematic solution, written to
    ``grf/autogen-contact.json`` and ``grf/autogen-contact-02.json``.
    The JAX function also synthesizes force profiles into ``data_synth.h5``
    (``contacts.synth_grf_data``); the batched physics mode never reads
    them, and that step is not ported yet."""
    from . import contacts as contacts_mod

    d = _load_warm_start(est, monocular, out_dir_prefix)
    est.com_vel = d["com_vel"]
    est.com_pos = d["com_pos"]
    speed = float(np.mean(np.linalg.norm(d["com_vel"], axis=1)))
    contacts, contacts_tmp = contacts_mod.contact_detection(
        d["q"], d["dq"], est.subject, est.params.start_frame, speed,
        est.scene.fps, data_dir=est._base(out_dir_prefix),
        ground_plane_height=est.params.ground_plane_height)
    if verbose:
        print(contacts)
    return contacts, contacts_tmp
