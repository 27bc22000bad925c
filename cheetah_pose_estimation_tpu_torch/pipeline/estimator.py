"""Trial directories in, AcinoSet artifacts out.

Port of ``cheetah_pose_estimation_tpu/pipeline/estimator.py`` for the
dataset CLI: the per-trial configuration and estimator
(``TrajectoryParams``, ``Scene``, ``CheetahEstimator`` with ``save`` and
``load``), ``init_trajectory`` (read a trial directory: DLC tables, scene
calibration, metadata), the data-driven mode's settings and prior gate, the
training-table lookup, the physics mode's warm start, contact files and
synthesized force profiles, and the serial per-trial solves
(``estimate_kinematics``, ``estimate_kinetics``), each trial solved alone
at its own length on the device of the run (the card by default), and the
force-plate pipeline's GRF solves on a saved solution (``estimate_grf``,
the torque-anchored re-estimation; ``estimate_static_grf``, per frame).
The multi-view solve can take the per-camera shutter delays as unknowns
(``enable_shutter_delay_estimation``), and the data-driven mode can roll
its AR anchors (``motion_prior_rolling``). Host work is numpy and float64
torch on the CPU.

Directory layout consumed (the reference's):

  <root_dir>/<data_path>/
      metadata.json                        start/end frame, cam_sync, ...
      dlc/cam*.csv                         DLC predictions
      (walk up) extrinsic_calib/N_cam_scene_sba.json

Outputs land in ``fte_kinematic`` (multi-view), ``fte_kinematic_orig_<cam>``
(monocular default), ``fte_kinematic_<cam>`` (data-driven) and
``fte_kinetic_<cam>`` (physics-based; ``fte_kinetic`` multi-view) and
``fte_grf`` (the GRF re-estimation) under ``<out_dir_prefix>/<data_path>``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import convert
from ..data import io as dio
from ..models import noise as noise_tables
from ..models import params as params_mod
from ..models import skeleton as sk
from ..ops import camera as cam_ops
from ..parallel import batch as pbatch
from ..priors import armodel
from ..priors import dataset as prior_ds
from ..priors import gmm as gmm_mod
from ..solver import kinematic as kin
from ..utils import data_ops
from ..utils.device import DeviceLike, resolve_device

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
    raises when read."""
    cands = [os.environ.get("CHEETAH_DATA_DRIVEN_DATASET"),
             os.path.join(".", "models", "data-driven",
                          "dataset_full_pose.h5"),
             os.path.join(".", "models", "data-driven",
                          "dataset_full_pose.csv")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return cands[1]


def prior_gate_accept(c_chain, c_free, guard_ratio: Optional[float] = None):
    """Per-trial prior gate: the GMM chain is accepted when its prior-free
    cost does not exceed the prior-free solve's by more than
    (guard_ratio - 1) x max(|cost|, 1), ``guard_ratio`` defaulting to
    ``PRIOR_GUARD_RATIO``.

    Not a plain ratio test: the smoothed redescending loss is slightly
    negative at well-fit residuals, so totals can be negative and
    ``c_chain <= r * c_free`` would invert there. Elementwise on arrays."""
    if guard_ratio is None:
        guard_ratio = PRIOR_GUARD_RATIO
    c_chain = np.asarray(c_chain, np.float64)
    c_free = np.asarray(c_free, np.float64)
    margin = (guard_ratio - 1.0) * np.maximum(np.abs(c_free), 1.0)
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
    # the last solve's cost functions and its problem (tensors, a batch of
    # one): what solution_details evaluates
    fte: Optional[object] = None
    problem: Optional[object] = None

    @property
    def scale_forces_by(self) -> float:
        """Body weight in newtons: the GRF profiles' unit."""
        return self.subject.total_mass * 9.81

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

    def solution_details(self) -> Dict[str, float]:
        """Print and return the total objective, the per-term costs of a
        kinematic solve at annealing scale 1 (their sum is the total) and
        the estimated shutter delays (JAX ``estimator.py:200-225``). After
        a physics solve, whose cost functions have no per-term breakdown,
        the total is the saved objective."""
        out: Dict[str, float] = {}
        if self.q is not None and self.problem is not None and hasattr(
                self.fte, "cost_terms"):
            q = torch.as_tensor(self.q, dtype=self.problem.h.dtype,
                                device=self.problem.h.device)[None]
            terms = self.fte.cost_terms(q, self.problem)
            out.update({k: float(v[0]) for k, v in terms.items()})
            out["cost"] = float(sum(out.values()))
        elif self.obj_cost is not None:
            out["cost"] = float(self.obj_cost)
        print("Total cost:", out.get("cost"))
        for k, v in out.items():
            if k != "cost":
                print(f"-- {k}: {v}")
        if self.shutter_delay is not None:
            print("Shutter delay estimation:",
                  list(np.asarray(self.shutter_delay)))
        return out

    def is_solution_acceptable(self) -> bool:
        """Finite objective and state (non-finite values are the LM
        solver's failure signal)."""
        return (self.q is not None and bool(np.all(np.isfinite(self.q)))
                and self.obj_cost is not None
                and bool(np.isfinite(self.obj_cost)))

    def _project_fn(self):
        return (cam_ops.project_pinhole if self.params.kinetic_dataset
                else cam_ops.project_fisheye)

    def get_objective_cost(self) -> float:
        """The saved objective, NaN before a solve."""
        return float(self.obj_cost) if self.obj_cost is not None \
            else float("nan")

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
    monocular one). With ``enable_ppm``, each DLC prediction is joined by
    its two pairwise pseudo-measurements from ``dlc_pw/*.pickle`` (one
    pickle per camera): W = 3 measurements per marker. Host work only:
    the solves take the device."""
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

    if p.enable_ppms:
        # W = 3: the pairwise pseudo-measurements beside each prediction,
        # from the unsynchronised DLC arrays as the JAX package reads them
        from glob import glob

        from ..data import ppm as ppm_mod
        pw_paths = sorted(glob(os.path.join(dlc_dir + "_pw", "*.pickle")))
        assert len(pw_paths) == C, (pw_paths, C)
        meas_full, weight_full = ppm_mod.assemble_ppm_measurements(
            xy, lik, [ppm_mod.load_ppm_pickle(f) for f in pw_paths],
            p.start_frame, N, p.dlc_thresh, p.kinetic_dataset)
    else:
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


def _pruned_stance(est: CheetahEstimator, base: str, q: np.ndarray,
                   n_frames: int) -> np.ndarray:
    """The (n_frames, 4) stance matrix of ``<base>/grf/autogen-contact.json``
    pruned on the trajectory ``q``."""
    from ..solver import kinetic as kn

    with open(os.path.join(base, "grf", "autogen-contact.json"),
              encoding="utf-8") as f:
        cj = json.load(f)
    stance = kn.stance_matrix(cj["contacts"], cj["start_frame"], n_frames)
    return kn.prune_stance(stance, q, est.subject, 1.0 / est.scene.fps)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().double().cpu().numpy()


def estimate_kinematics(est: CheetahEstimator,
                        monocular_constraints: bool = False,
                        disable_pose_prior: bool = False,
                        disable_motion_prior: bool = False,
                        pose_model_num_components: int = 5,
                        motion_model_window_size: int = 4,
                        motion_model_sparse_solution: bool = True,
                        motion_prior_rolling: int = 0,
                        data_driven_dataset: Optional[str] = None,
                        prior_guard_ratio: Optional[float] = None,
                        ground_anchor: bool = True,
                        depth_scan: bool = True,
                        out_dir_prefix: Optional[str] = None,
                        solver_output: bool = False,
                        save: bool = True,
                        dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None,
                        report: Optional[dict] = None) -> bool:
    """Kinematic reconstruction of one trial, solved alone at its own
    length on ``device`` (the card by default) in ``dtype``.

    From the initial trajectory (multi-view, or the monocular camera's):

    * with ``monocular_constraints`` on a monocular trial (the data-driven
      mode), the bootstrap: the prior-free heading multistart; the GMM
      chain (pose prior, base pinned to the prior-free solve by
      ``DD_BASE_ANCHOR``) and its prior gate (``prior_gate_accept`` with
      ``prior_guard_ratio``; a rejected trial keeps the prior-free solve
      and solves without the pose prior); the AR anchors with adaptive
      weights from the bootstrap; the priors trained on
      ``data_driven_dataset`` and cached beside it;
    * the solve: a cold monocular solve is the heading multistart, else one
      annealed solve from the (bootstrapped) start;
    * on a monocular trial with ``ground_anchor``, the ground-plane ray
      shift and a short polish with the ground, penetration and no-slip
      terms, kept when the plain objective gets no more than 5 % worse
      (no shift: no polish);
    * on a multi-view trial with ``enable_shutter_delay_estimation``, the
      solve with the live shutter coupling, then the joint (q, tau) solve
      of the per-camera delays from zero (``make_joint_shutter_solver``);
      camera 0's delay is set to exactly 0 and the delays go into
      ``est.shutter_delay`` and the problem's ``sd_tau``;
    * with the AR prior and ``motion_prior_rolling`` > 0, that many
      refinements: the AR anchors and their adaptive weights recomputed
      from the current solution, then the solve again from it;
    * in the data-driven mode with ``depth_scan`` and an accepted prior, the
      depth line-scan, and at a nonzero shift the re-polish by the full
      solver from the shifted trajectory, its base pin and AR anchors
      moved with it.

    ``obj_cost`` is the objective of the saved q under the data of the
    solve before the line-scan: after a re-polish it is not the re-polished
    problem's objective (its base pin and AR anchors moved with the shift),
    as in the JAX package, which the port keeps. With
    ``save``, a finite solution is written to ``fte_kinematic``,
    ``fte_kinematic_orig_<cam>`` (default) or ``fte_kinematic_<cam>``
    (data-driven). With ``report``, the decisions taken go into it:
    ``prior_ok``, ``scan_shift``, ``polish_ray_shift``,
    ``polish_stance_frames``, ``polish_changed``. Returns whether the
    solution is finite."""
    from . import depth_anchor as danchor
    from . import initialization as init_mod

    p, scene = est.params, est.scene
    dev = resolve_device(device)
    rep = {} if report is None else report
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    t0 = time.time()
    full_weight = np.einsum(
        "wl,ncl->nclw",
        noise_tables.measurement_weights(1, p.kinetic_dataset),
        (est.likelihood > p.dlc_thresh).astype(float))
    est.q0 = init_mod.initialize_trajectory(
        est.xy[..., None], full_weight, scene.k_arr, scene.d_arr, scene.r_arr,
        scene.t_arr, est.subject, fisheye=not p.kinetic_dataset,
        cam_idx=scene.cam_idx, kinetic_dataset=p.kinetic_dataset)
    # the trial as a batch of one, at its own length
    data, q0 = pbatch.pad_and_stack([est.data], [est.q0], dtype=dtype,
                                    device=dev)

    use_priors = monocular_constraints and scene.cam_idx is not None
    use_gmm = use_priors and not disable_pose_prior
    use_ar = use_priors and not disable_motion_prior
    boot_ran = use_gmm or use_ar
    prior_ok = True
    base_cfg = kin.KinematicConfig(
        fisheye=not p.kinetic_dataset, robust=not p.hand_labeled_data,
        kinetic_dataset=p.kinetic_dataset,
        cam_multipliers=(1.0, 1.0, 0.6, 0.6) if p.kinetic_dataset else ())
    if boot_ran:
        dset = data_driven_dataset or _default_data_driven_dataset()
        cache = data_ops.prior_cache_dir(dset)
        if use_gmm:
            tab = prior_ds.load_pose_dataset(dset)
            gp = gmm_mod.to_solver_prior(gmm_mod.fit(
                tab.data[:, 6:28], n_components=pose_model_num_components,
                seed=42, device=dev, cache_dir=cache))
            data = data._replace(gmm=convert.gmm_prior(gp, 1, device=dev,
                                                       dtype=dtype))
        # the bootstrap: the prior-free heading multistart, then the GMM
        # chain and its gate
        boot = kin.KinematicFTE(base_cfg, est.subject)
        st_free = pbatch.multistart_single(boot.make_solver(), q0[0], data)
        q_boot = st_free.q
        if use_gmm:
            data = data._replace(base_ref=st_free.q[:, :, :6])
            chain = kin.KinematicFTE(dataclasses.replace(
                base_cfg, use_gmm=True, **DD_BASE_ANCHOR), est.subject)
            st_chain = chain.make_solver()(st_free.q, data)
            c_free = float(boot._cost(st_free.q, data, 1.0)[0])
            c_chain = float(boot._cost(st_chain.q, data, 1.0)[0])
            if bool(prior_gate_accept(c_chain, c_free, prior_guard_ratio)):
                q_boot = st_chain.q
            else:
                prior_ok = False
            rep["prior_ok"] = prior_ok
        if use_ar:
            # AR anchors on the bootstrap, per-dimension weights shrunk by
            # the observed prediction error
            mm = armodel.train_motion_model(
                dset, window_size=motion_model_window_size,
                lasso=motion_model_sparse_solution, device=dev,
                cache_dir=cache)
            x_boot = sk.relative_pose(torch.as_tensor(_np(q_boot[0]))).numpy()
            y_pred, valid = armodel.anchor_predictions(mm, x_boot)
            w_ad = armodel.adaptive_motion_weights(mm, y_pred, x_boot, valid)
            data = data._replace(ar=kin.ARAnchor(
                tens(y_pred)[None], tens(w_ad)[None], tens(valid)[None]))
        q0 = q_boot
    use_gmm = use_gmm and prior_ok

    use_shutter = p.enable_shutter_delay_estimation and scene.cam_idx is None
    cfg = dataclasses.replace(
        base_cfg, use_gmm=use_gmm, use_ar=use_ar, live_shutter=use_shutter,
        **(DD_BASE_ANCHOR if (use_gmm or use_ar) else {}))
    fte = kin.KinematicFTE(cfg, est.subject)
    est.fte = fte
    run = fte.make_solver()
    if scene.cam_idx is not None and not boot_ran:
        # a cold monocular solve escapes bad heading basins by the
        # multistart; the prior modes start from the multistarted bootstrap
        state = pbatch.multistart_single(run, q0[0], data)
    else:
        state = run(q0, data)
    if use_shutter:
        # the per-camera delays as unknowns beside the trajectory (JAX
        # estimator.py:561-593): the bordered banded system, from zero
        bst = fte.make_joint_shutter_solver()(
            state.q, state.q.new_zeros((1, data.meas.shape[2])), data)
        tau = _np(bst.tau[0])
        tau[0] = 0.0        # camera 0 is the anchor (pinned to ~1e-9)
        data = data._replace(sd_tau=tens(tau)[None])
        state = state._replace(q=bst.q, cost=bst.cost, it=state.it + bst.it)
        est.shutter_delay = tau
        est.data = est.data._replace(sd_tau=tau)
    if use_ar and motion_prior_rolling > 0:
        # rolling AR refinement (JAX estimator.py:595-605): the anchors
        # from the current solution, then the solve again from it
        for _ in range(motion_prior_rolling):
            x_cur = sk.relative_pose(torch.as_tensor(_np(state.q[0]))).numpy()
            y_pred, valid = armodel.anchor_predictions(mm, x_cur)
            w_ad = armodel.adaptive_motion_weights(mm, y_pred, x_cur, valid)
            data = data._replace(ar=kin.ARAnchor(
                tens(y_pred)[None], tens(w_ad)[None], tens(valid)[None]))
            state = run(state.q, data)
    est.q = _np(state.q[0])
    monocular = scene.cam_idx is not None and not p.kinetic_dataset
    if ground_anchor and monocular:
        ci = scene.cam_idx
        qc, stw, shift = danchor.ray_depth_correction(
            est.q, est.subject, scene.fps, p.ground_plane_height,
            scene.r_arr[ci], scene.t_arr[ci])
        changed = False
        # no shift: no depth evidence, and no polish (its stance pull acts
        # on hovering stance frames too)
        if stw.sum() > 0 and float(np.max(np.abs(shift))) != 0.0:
            afte = kin.KinematicFTE(dataclasses.replace(
                cfg, use_gmm=False, use_ar=False, **danchor.POLISH_CFG),
                est.subject)
            ast = afte.make_solver(stages=danchor.POLISH_STAGES)(
                tens(qc)[None], data._replace(
                    ground_z=tens([p.ground_plane_height]),
                    stance_w=tens(stw)[None]))
            # the shift is reprojection-neutral: a polish that worsens the
            # plain objective by more than 5 % diverged against bad stance
            # evidence
            gfte = kin.KinematicFTE(dataclasses.replace(
                cfg, use_gmm=False, use_ar=False), est.subject)
            c0 = float(gfte.objective(state.q, data)[0])
            c1 = float(gfte.objective(ast.q, data)[0])
            if np.isfinite(c1) and c1 <= 1.05 * c0:
                est.q = _np(ast.q[0])
                state = state._replace(q=ast.q)
                changed = True
        rep.update(polish_ray_shift=float(shift[0]),
                   polish_stance_frames=int(stw.sum()),
                   polish_changed=changed)
    if depth_scan and use_priors and prior_ok and monocular:
        ci = scene.cam_idx
        rays = danchor.camera_ray(est.q, scene.r_arr[ci],
                                  scene.t_arr[ci])[None]
        veto = np.asarray([danchor.scale_median(
            est.q, est.subject, _np(data.meas[0, :, 0]),
            _np(data.weight[0, :, 0]), scene.k_arr[ci], scene.d_arr[ci],
            scene.r_arr[ci], scene.t_arr[ci].reshape(3))])
        scan = danchor.make_depth_linescan(est.subject)
        _, shifts = scan(tens(est.q)[None], data, rays, veto)
        rep["scan_shift"] = float(shifts[0])
        if float(shifts[0]) != 0.0:
            # the scan judges depth only: move the solved trajectory by the
            # accepted shift and re-polish with the full solver, its base
            # pin and AR anchors moved with it
            q_shift = est.q.copy()
            q_shift[:, :3] += float(shifts[0]) * rays[0]
            data2 = data._replace(base_ref=tens(q_shift[:, :6])[None])
            if use_ar:
                yp2, vl2 = armodel.anchor_predictions(
                    mm, sk.relative_pose(torch.as_tensor(q_shift)).numpy())
                data2 = data2._replace(ar=data2.ar._replace(
                    y_pred=tens(yp2)[None], valid=tens(vl2)[None]))
            st2 = run(tens(q_shift)[None], data2)
            est.q = _np(st2.q[0])
            state = state._replace(q=st2.q)
            if solver_output:
                print(f"depth line-scan shift: {float(shifts[0]):+.2f} m")
    est.opt_time_s = time.time() - t0
    est.obj_cost = float(fte.objective(state.q, data)[0])
    est.problem = data
    ok = bool(np.isfinite(est.obj_cost)) and bool(np.all(np.isfinite(est.q)))
    if solver_output:
        print(f"solved in {est.opt_time_s:.1f}s, it={int(state.it[0])}, "
              f"cost={float(state.cost[0]):.2f}")
    if ok and save:
        fname = "fte_kinematic" + ("_gt" if p.hand_labeled_data else "")
        if scene.cam_idx is not None:
            fname = (f"fte_kinematic_{scene.cam_idx}" if monocular_constraints
                     else f"fte_kinematic_orig_{scene.cam_idx}")
        est.save(fname, out_dir_prefix=out_dir_prefix)
    return ok


def determine_contacts(est: CheetahEstimator, monocular: bool = False,
                       out_dir_prefix: Optional[str] = None,
                       verbose: bool = False):
    """Contact detection on the saved kinematic solution, written to
    ``grf/autogen-contact.json`` and ``grf/autogen-contact-02.json``, and
    the force profiles synthesized over each file's stances
    (``contacts.synth_grf_data``: ``grf/data_synth.csv`` and
    ``grf/data_synth_02.csv``, which ``estimate_kinetics(synthesised_grf=
    True)`` reads back)."""
    from . import contacts as contacts_mod

    d = _load_warm_start(est, monocular, out_dir_prefix)
    est.com_vel = d["com_vel"]
    est.com_pos = d["com_pos"]
    speed = float(np.mean(np.linalg.norm(d["com_vel"], axis=1)))
    avg_vel = np.mean(d["com_vel"], axis=0)
    base = est._base(out_dir_prefix)
    contacts, contacts_tmp = contacts_mod.contact_detection(
        d["q"], d["dq"], est.subject, est.params.start_frame, speed,
        est.scene.fps, data_dir=base,
        ground_plane_height=est.params.ground_plane_height)
    direction = 1.0 if avg_vel[0] < 0 else -1.0
    grf_dir = os.path.join(base, "grf")
    contacts_mod.synth_grf_data(speed, direction, grf_dir)
    contacts_mod.synth_grf_data(speed, direction, grf_dir,
                                "autogen-contact-02.json", "data_synth_02")
    if verbose:
        print(contacts)
    return contacts, contacts_tmp


def reset_trajectory(est: CheetahEstimator, extend_by: int = 0):
    """Re-window the trial, optionally extending its frame range by
    ``extend_by`` frames, and rebuild the problem from the DLC tables."""
    if extend_by:
        est.params.end_frame += extend_by
        est.params.total_length = est.params.end_frame \
            - est.params.start_frame
    _load_measurements(est)
    return est


def estimate_kinetics(est: CheetahEstimator,
                      synthesised_grf: bool = False,
                      disable_pose_prior: bool = False,
                      disable_motion_prior: bool = False,
                      use_2d_reprojections: bool = True,
                      enable_lcp: bool = False,
                      out_fname: str = "fte",
                      out_dir_prefix: Optional[str] = None,
                      solver_output: bool = False,
                      save: bool = True,
                      dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None,
                      report: Optional[dict] = None) -> bool:
    """Physics-based reconstruction of one trial, alone at its own length
    on ``device`` (the card by default) in ``dtype``: warm-started from the
    saved kinematic solution (``_load_warm_start``), the stances read from
    ``grf/autogen-contact.json`` and pruned on the warm start; joint torques
    and GRFs are eliminated per frame inside the solver. With
    ``synthesised_grf`` the GRFs are fixed to the profiles of
    ``grf/data_synth.csv`` (``contacts.get_grf_profile``) instead of solved
    for. The monocular solve carries the GMM pose prior (trained on the
    default training table, cached beside it) unless
    ``disable_pose_prior``; ``disable_motion_prior`` drops the torque and
    marker-smoothing energy (a tiny torque ridge keeps the elimination
    nonsingular). ``enable_lcp`` adds the complementarity penalty on the
    loaded feet's heights; ``use_2d_reprojections=False`` solves without
    the reprojections (their weights zeroed), tracking the warm start's
    relative angles in 3D instead of the marker-smoothing energy (JAX
    ``estimator.py:802-823``).

    The solved q, objective, torques and GRFs go into ``est``; with
    ``save`` a finite solution is written to ``fte_kinetic``
    (``fte_kinetic_<cam>`` for a monocular trial). With ``report``, the pruned stance matrix goes
    into it. Returns whether q is finite."""
    from ..dynamics.eom import FOOT_NAMES
    from ..solver import kinetic as kn
    from . import contacts as contacts_mod

    p = est.params
    monocular = est.scene.cam_idx is not None
    use_gmm = (not disable_pose_prior) and monocular
    fte = kn.KineticFTE(kn.KineticConfig(
        fisheye=not p.kinetic_dataset, robust=not p.hand_labeled_data,
        use_gmm=use_gmm, kinetic_dataset=p.kinetic_dataset,
        use_2d_reprojections=use_2d_reprojections, enable_lcp=enable_lcp,
        torque_weight=1e-6 if disable_motion_prior else 1.0,
        smooth_weight_scale=0.0 if disable_motion_prior else 0.1,
        foot_height_bound=0.03 if p.kinetic_dataset else 0.1,
        cam_multipliers=(1.0, 1.0, 0.6, 0.6) if p.kinetic_dataset else ()),
        est.subject)
    dev = resolve_device(device)
    t0 = time.time()
    d = _load_warm_start(est, monocular, out_dir_prefix)
    q_warm = np.asarray(d["q"], np.float64)
    est.com_vel = d["com_vel"]
    est.com_pos = d["com_pos"]
    base = est._base(out_dir_prefix)
    N = p.end_frame - p.start_frame
    stance = _pruned_stance(est, base, q_warm, N)
    if report is not None:
        report["stance"] = stance.astype(int).tolist()
    if synthesised_grf:
        gz, gxy = contacts_mod.get_grf_profile(
            N, base, p.data_dir, 1.0, 1.0 / est.scale_forces_by,
            kinetic_dataset=p.kinetic_dataset, synthetic_data=True)
        grf_fixed = np.stack([gz[n] for n in FOOT_NAMES], axis=1)
        grf_xy_fixed = np.stack([gxy[n] for n in FOOT_NAMES], axis=1)
    else:
        grf_fixed, grf_xy_fixed = np.zeros((N, 4)), np.zeros((N, 4, 4))
    data = est.data
    if not use_2d_reprojections:
        data = data._replace(weight=np.zeros_like(np.asarray(data.weight)))
    if use_gmm:
        dset = _default_data_driven_dataset()
        tab = prior_ds.load_pose_dataset(dset)
        data = data._replace(gmm=gmm_mod.to_solver_prior(gmm_mod.fit(
            tab.data[:, 6:28], n_components=5, seed=42, device=dev,
            cache_dir=data_ops.prior_cache_dir(dset))))
    kd = kn.KineticData(
        base=data, stance=stance, grf_fixed=grf_fixed,
        grf_xy_fixed=grf_xy_fixed,
        use_fixed_grf=np.asarray(float(synthesised_grf)), q_warm=q_warm,
        ground_z=np.asarray(p.ground_plane_height))
    kbat, qw = pbatch.pad_and_stack_kinetic([kd], [q_warm], dtype=dtype,
                                            device=dev)
    state = fte.make_solver()(qw, kbat)
    est.fte, est.problem = fte, kbat
    est.q = _np(state.q[0])
    est.opt_time_s = time.time() - t0
    est.obj_cost = float(fte.objective(state.q, kbat)[0])
    tau, gz_sol, gxy_sol = fte.forces(state.q, kbat)
    est.tau, est.grf_z, est.grf_xy = _np(tau[0]), _np(gz_sol[0]), \
        _np(gxy_sol[0])
    ok = bool(np.all(np.isfinite(est.q)))
    if solver_output:
        print(f"kinetics solved in {est.opt_time_s:.1f}s, "
              f"it={int(state.it[0])}, cost={float(state.cost[0]):.2f}")
    if ok and save:
        dir_name = "fte_kinetic" + ("_gt" if p.hand_labeled_data else "")
        if monocular:
            dir_name = f"{dir_name}_{est.scene.cam_idx}"
        est.save(dir_name, fname=out_fname, out_dir_prefix=out_dir_prefix)
    return ok


def estimate_static_grf(est: CheetahEstimator,
                        out_dir_prefix: Optional[str] = None,
                        dtype: torch.dtype = torch.float32,
                        device: DeviceLike = None):
    """Per-frame static GRFs of the saved kinematic solution
    (``_load_warm_start``): with its q, dq and ddq fixed, the contact forces
    that best close the base's equation of motion within the bounds, the
    friction polyhedron and the stance of ``grf/autogen-contact.json``
    pruned on q (``solver.static_grf``), all frames at once on ``device``
    (the card by default) in ``dtype``. Returns (grf_z (N, 4), grf_xy
    (N, 4, 4)) in body weights, as numpy float64."""
    from ..solver.static_grf import estimate_static_grf as solve

    dev = resolve_device(device)
    d = _load_warm_start(est, False, out_dir_prefix)
    q = np.asarray(d["q"], np.float64)
    stance = _pruned_stance(est, est._base(out_dir_prefix), q, q.shape[0])
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    gz, gxy = solve(tens(q), tens(d["dq"]), tens(d["ddq"]), tens(stance),
                    est.subject)
    return _np(gz), _np(gxy)


def grf_problem(est: CheetahEstimator, out_dir_prefix: Optional[str] = None):
    """The GRF re-estimation's problem of a trial: its warm start, the
    saved physics solution ``fte_kinetic``, whose torques become a
    quadratic anchor of weight (0.1 max(mean |tau|, 1e-2))^-2, the GRFs
    solved for (none fixed) on the stance of ``grf/autogen-contact.json``
    pruned on the warm start, and the 0.03 m foot-height box. Returns
    (the ``KineticFTE``, the ``KineticData`` with numpy leaves, the warm
    start (N, 54), the pruned stance (N, 4))."""
    from ..dynamics.eom import tau_from_dict
    from ..solver import kinetic as kn

    p = est.params
    base = est._base(out_dir_prefix)
    prev = dio.load_fte_pickle(os.path.join(base, "fte_kinetic",
                                            "fte.pickle"))
    q_warm = np.asarray(prev["q"], np.float64)
    N = q_warm.shape[0]
    tau_prev = tau_from_dict(prev["tau"], N)
    stance = _pruned_stance(est, base, q_warm, N)
    scale = max(float(np.abs(tau_prev).mean()), 1e-2)
    kd = kn.KineticData(
        base=est.data, stance=stance, grf_fixed=np.zeros((N, 4)),
        grf_xy_fixed=np.zeros((N, 4, 4)), use_fixed_grf=np.asarray(0.0),
        q_warm=q_warm, tau_anchor=tau_prev,
        tau_anchor_weight=np.asarray(1.0 / (0.1 * scale)**2),
        ground_z=np.asarray(p.ground_plane_height))
    fte = kn.KineticFTE(kn.KineticConfig(
        fisheye=not p.kinetic_dataset, robust=not p.hand_labeled_data,
        kinetic_dataset=p.kinetic_dataset, foot_height_bound=0.03,
        cam_multipliers=(1.0, 1.0, 0.6, 0.6) if p.kinetic_dataset else ()),
        est.subject)
    return fte, kd, q_warm, stance


def estimate_grf(est: CheetahEstimator, out_dir_prefix: Optional[str] = None,
                 solver_output: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 report: Optional[dict] = None) -> bool:
    """GRF re-estimation of a force-plate trial (:func:`grf_problem`: the
    GRFs solved for with the torques anchored to the saved physics
    solution's), alone at its own length on ``device`` (the card by
    default) in ``dtype``. The solved q, objective, torques and GRFs go
    into ``est``, and a finite solution is written to ``fte_grf``. With
    ``report``, the pruned stance matrix goes into it.
    Returns whether q is finite."""
    dev = resolve_device(device)
    t0 = time.time()
    fte, kd, q_warm, stance = grf_problem(est, out_dir_prefix)
    if report is not None:
        report["stance"] = stance.astype(int).tolist()
    kbat, qw = pbatch.pad_and_stack_kinetic([kd], [q_warm], dtype=dtype,
                                            device=dev)
    state = fte.make_solver()(qw, kbat)
    est.q = _np(state.q[0])
    est.opt_time_s = time.time() - t0
    est.obj_cost = float(fte.objective(state.q, kbat)[0])
    tau, gz, gxy = fte.forces(state.q, kbat)
    est.tau, est.grf_z, est.grf_xy = _np(tau[0]), _np(gz[0]), _np(gxy[0])
    ok = bool(np.all(np.isfinite(est.q)))
    if solver_output:
        print(f"grf re-estimation in {est.opt_time_s:.1f}s, "
              f"cost={float(state.cost[0]):.2f}")
    if ok:
        est.save("fte_grf", fname="fte", out_dir_prefix=out_dir_prefix)
    return ok
