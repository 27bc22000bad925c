"""The studies of the dataset CLI (the hyper-parameter grid search, the
prior ablations and the degradation sweep) and the three response studies
that no CLI flag reaches.

Port of ``cheetah_pose_estimation_tpu/pipeline/studies.py``:

* :func:`run_grid_search_batched` solves every (GMM components, AR window,
  lasso) configuration of the data-driven mode on every trial as one
  batch (configurations x trials lanes, each lane with its own GMM padded
  to the largest component count) from a shared production bootstrap;
  :func:`run_grid_search` solves them one trial at a time through
  ``estimator.estimate_kinematics``. Both write ``grid_search_results.csv``.
* :func:`model_selection_analysis`: the GMM likelihoods and AR errors per
  component count and window size (``grid_search.pickle``).
* :func:`run_data_driven_ablation_batched` and
  :func:`run_physics_ablation_batched` switch the pose and motion priors
  on and off, one batch per configuration and subject group (the kinetic
  solve of each group as one batch, not in the JAX package's waves of 5);
  :func:`run_data_driven_ablation_study` and
  :func:`run_physics_based_ablation_study` are the per-trial forms. They
  write ``data_driven_ablation_results.csv`` and
  ``physics_based_ablation_results.csv``.
* :func:`run_degradation_sweep`: default against data-driven (and
  physics-based) monocular solves of the procedural bench trials across
  correlated DLC corruption levels, scored against the synthetic truth
  (``degradation_sweep.csv``).
* :func:`run_forced_vs_gated_bench`: the data-driven mode's prior gate
  against the prior forced on every trial, before and after the depth
  anchor, on the procedural bench trials;
  :func:`run_deadband_sweep` and :func:`run_physics_lever_sweep`: how far
  the kinetic solve's deadbands, GRF cap, weights and schedule move the
  physics stage off a shared kinematic warm start. Each kinetic
  configuration is one batch over all trials (the JAX package's waves of 5
  are a TPU memory workaround). Their JAX defaults write under
  ``docs/artifacts/``; here ``out_csv=None`` writes nothing.

The reconstruction studies score each solution against the multi-view
solve saved under the output directory (``fte_kinematic/fte.pickle``); the
physics ablation starts from the saved data-driven solutions. Every CSV
holds the bytes pandas' ``to_csv(index=False)`` writes for the JAX
package's rows. The entry points run on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import io as dio
from ..models import params as params_mod
from ..models import skeleton as sk
from ..parallel import batch as pbatch
from ..priors import armodel
from ..priors import dataset as prior_ds
from ..priors import gmm as gmm_mod
from ..solver import kinematic as kin
from ..solver import kinetic as kn
from ..utils import data_ops
from ..utils.device import DeviceLike, resolve_device
from . import batched as batched_mod
from . import estimator as est_mod
from . import metrics as metrics_mod
from .estimator import _np, prior_gate_accept

# (label, pose prior, motion prior) of the batched ablations, in row order
ABLATION_CONFIGS = (("both", True, True), ("no-pose", False, True),
                    ("no-motion", True, False), ("neither", False, False))


def _write_csv(dir_prefix: str, name: str, rows: List[Dict]) -> None:
    """``rows`` as pandas writes ``DataFrame(rows).to_csv(index=False)``:
    the columns in first-seen order."""
    from .run_dataset import write_rows_csv

    cols = tuple(dict.fromkeys(k for r in rows for k in r))
    write_rows_csv(os.path.join(dir_prefix, name), rows, cols)


def _errors(gt: np.ndarray, pos: np.ndarray) -> Tuple[float, float]:
    """(MPE, MPJPE) in mm of marker trajectories ``pos`` against ``gt``."""
    return (float(metrics_mod.traj_error(gt, pos)[0].mean()),
            float(metrics_mod.traj_error(gt, pos, centered=True)[0].mean()))


def _score_against_multiview(dir_prefix: str, data_path: str, sub: str
                             ) -> Optional[Tuple[float, float, float]]:
    """(MPE mm, MPJPE mm, CoM-vel RMSE m/s) of the saved solution ``sub``
    of a trial against its saved multi-view solve; None when either is
    missing."""
    base = os.path.join(dir_prefix, data_path)
    gt_p = os.path.join(base, "fte_kinematic", "fte.pickle")
    p = os.path.join(base, sub, "fte.pickle")
    if not (os.path.exists(gt_p) and os.path.exists(p)):
        return None
    gtd, d = dio.load_fte_pickle(gt_p), dio.load_fte_pickle(p)
    n = min(len(gtd["positions"]), len(d["positions"]))
    mpe, mpjpe = _errors(gtd["positions"][:n], d["positions"][:n])
    cvr = metrics_mod.rmse(np.asarray(gtd["com_vel"])[:n - 1],
                           np.asarray(d["com_vel"])[:n - 1])
    return mpe, mpjpe, float(cvr)


def _score_q_against_multiview(q: np.ndarray, est, data_path: str,
                               dir_prefix: str, subject
                               ) -> Optional[Tuple[float, float, float]]:
    """The solved trajectory ``q`` (n, 54) scored as
    :func:`_score_against_multiview` scores a saved one (markers and CoM by
    float64 forward kinematics on the host); None without a saved
    multi-view solve."""
    gt_p = os.path.join(dir_prefix, data_path, "fte_kinematic", "fte.pickle")
    if not os.path.exists(gt_p):
        return None
    gtd = dio.load_fte_pickle(gt_p)
    qt = torch.as_tensor(np.asarray(q, np.float64))
    pos = sk.fk_markers(qt, subject).numpy()
    com = sk.com_position(qt, subject).numpy()
    gt = np.asarray(gtd["positions"])
    n = min(len(gt), len(pos))
    mpe, mpjpe = _errors(gt[:n], pos[:n])
    com_vel = (com[1:n] - com[:n - 1]) * est.scene.fps
    cvr = metrics_mod.rmse(np.asarray(gtd["com_vel"])[:n - 1], com_vel)
    return mpe, mpjpe, float(cvr)


def _pad_gmm(gp: kin.GMMPrior, k_max: int) -> kin.GMMPrior:
    """A solver prior (numpy leaves, no trial axis) padded to ``k_max``
    components by inert ones: zero means, identity precisions and
    log-normaliser -1e30, whose terms vanish from the mixture's density,
    gradient and curvature, so lanes of different component counts share
    one batch."""
    K = gp.means.shape[0]
    if K == k_max:
        return gp
    pad = k_max - K
    return kin.GMMPrior(
        means=np.concatenate([np.asarray(gp.means),
                              np.zeros((pad, gp.means.shape[1]))]),
        prec=np.concatenate([np.asarray(gp.prec),
                             np.tile(np.eye(gp.prec.shape[1]), (pad, 1, 1))]),
        log_norm=np.concatenate([np.asarray(gp.log_norm),
                                 np.full((pad,), -1e30)]))


def _groups(root_dir, test_set, cam_overrides, max_trials):
    """The monocular trials of ``test_set`` (its first ``max_trials``)
    under ``root_dir``, prepared and grouped by subject."""
    trials = test_set[:max_trials] if max_trials else test_set
    return batched_mod._groups(root_dir, trials, cam_overrides,
                               monocular=True)


def _train_gmm(dset: str, n_components: int, dev: torch.device):
    """The GMM of ``n_components`` over the training table's 22 relative
    joint angles (seed 42), cached beside the table."""
    tab = prior_ds.load_pose_dataset(dset)
    return gmm_mod.fit(tab.data[:, 6:28], n_components=n_components,
                       seed=42, device=dev,
                       cache_dir=data_ops.prior_cache_dir(dset))


def _bootstrap(subject, ests, gp: kin.GMMPrior, dtype, dev):
    """The production monocular bootstrap of one subject group: the
    prior-free heading multistart, then the GMM chain warm-started from it
    (pose prior ``gp``), gated per trial on the prior-free cost. Returns
    (the stacked problem, q_free, q_boot, prior-free costs of both)."""
    datas = [est.data._replace(gmm=gp) for est in ests]
    bbat, bq0 = pbatch.pad_and_stack(
        datas, [est.q0 for est in ests], n_frames=batched_mod._n_frames(
            datas), dtype=dtype, device=dev)
    free = kin.KinematicFTE(kin.KinematicConfig(fisheye=True, robust=True),
                            subject)
    q_free = pbatch.make_kinematic_multistart(free)(bq0, bbat).q
    chain = kin.KinematicFTE(kin.KinematicConfig(fisheye=True, robust=True,
                                                 use_gmm=True), subject)
    q_chain = chain.make_solver()(q_free, bbat).q
    c_free = _np(free._cost(q_free, bbat, 1.0))
    c_chain = _np(free._cost(q_chain, bbat, 1.0))
    ok = torch.as_tensor(prior_gate_accept(c_chain, c_free),
                         device=dev)[:, None, None]
    return bbat, q_free, torch.where(ok, q_chain, q_free), c_free, c_chain


def _model_stats(gparams, mm, X: np.ndarray, dset: str) -> Dict[str, float]:
    """The statistics a grid row carries: the AR model's non-zero count
    and train/validation RMSE, the GMM's train and validation mean
    log-likelihood per sample (NaN without ``validation_dataset.h5`` or
    its ``.csv`` beside the training table)."""
    try:
        Xv = prior_ds.load_pose_dataset(os.path.join(
            os.path.dirname(dset), "validation_dataset.h5")).data[:, 6:28]
        gval = gmm_mod.score(gparams, Xv)
    except (OSError, ValueError):
        gval = float("nan")
    return dict(lr_non_zeros=mm.model_non_zeros,
                lr_train_rmse=mm.train_rmse,
                lr_validation_rmse=mm.validation_rmse,
                gmm_train_likelihood=gmm_mod.score(gparams, X),
                gmm_validation_likelihood=gval)


def run_grid_search_batched(root_dir: str, dir_prefix: str, test_set: Tuple,
                            pose_components: Tuple[int, ...] = (3, 5, 8),
                            windows: Tuple[int, ...] = (2, 4, 6, 10),
                            lasso_options: Tuple[bool, ...] = (True, False),
                            cam_overrides: Optional[List[int]] = None,
                            max_trials: Optional[int] = None,
                            data_driven_dataset: Optional[str] = None,
                            dtype: torch.dtype = torch.float32,
                            verbose: bool = True,
                            device: DeviceLike = None) -> List[Dict]:
    """The GMM-components x AR-window x lasso sweep of the data-driven mode
    with every (configuration, trial) a lane of one batch per subject
    group, on ``device`` (the card by default).

    Per group: the production bootstrap (:func:`_bootstrap`, 5-component
    GMM) anchors every configuration; per configuration the GMM (padded to
    the largest component count, :func:`_pad_gmm`) and the AR model
    (anchors and adaptive weights from the bootstrap) trained on
    ``data_driven_dataset`` and cached beside it; then one data-driven
    solve of all lanes from the bootstrap. Each lane is scored against the
    trial's saved multi-view solve. Writes ``grid_search_results.csv``
    (one row per configuration: mean MPE and MPJPE, the trials scored and
    the model statistics, :func:`_model_stats`) and returns its rows."""
    dev = resolve_device(device)
    t0 = time.time()
    dset = data_driven_dataset or est_mod._default_data_driven_dataset()
    configs = [(n, w, l) for n in pose_components for w in windows
               for l in lasso_options]
    k_max = max(pose_components)
    groups = _groups(root_dir, test_set, cam_overrides, max_trials)
    acc: Dict[Tuple, Dict[str, List[float]]] = {
        c: dict(mpe=[], mpjpe=[]) for c in configs}
    model_stats = {}
    if groups:       # as in JAX, a row has model statistics when a trial ran
        X = prior_ds.load_pose_dataset(dset).data[:, 6:28]
        cache = data_ops.prior_cache_dir(dset)
        gmms = {n: _train_gmm(dset, n, dev) for n in pose_components}
        mms = {(w, l): armodel.train_motion_model(
            dset, window_size=w, lasso=l, device=dev, cache_dir=cache)
            for w in windows for l in lasso_options}
        model_stats = {(n, w, l): _model_stats(gmms[n], mms[(w, l)], X, dset)
                       for n, w, l in configs}
        gp_boot = gmm_mod.to_solver_prior(_train_gmm(dset, 5, dev))
    for subject_name, ests in groups.items():
        subject = params_mod.get_subject(subject_name)
        _, _, q_boot, _, _ = _bootstrap(subject, ests, gp_boot, dtype, dev)
        qb_np = _np(q_boot)
        x_boots = sk.relative_pose(torch.as_tensor(qb_np)).numpy()
        datas, q0s, lanes = [], [], []
        for n_comp, w, lasso in configs:
            gp = _pad_gmm(gmm_mod.to_solver_prior(gmms[n_comp]), k_max)
            mm = mms[(w, lasso)]
            for i, est in enumerate(ests):
                n = est.data.meas.shape[0]
                y_pred, valid = armodel.anchor_predictions(mm,
                                                           x_boots[i][:n])
                w_ad = armodel.adaptive_motion_weights(mm, y_pred,
                                                       x_boots[i][:n], valid)
                datas.append(est.data._replace(
                    gmm=gp, ar=kin.ARAnchor(y_pred, w_ad, valid)))
                q0s.append(qb_np[i, :n])
                lanes.append(((n_comp, w, lasso), est))
        bat, q0b = pbatch.pad_and_stack(
            datas, q0s, n_frames=batched_mod._n_frames(datas), dtype=dtype,
            device=dev)
        fte = kin.KinematicFTE(kin.KinematicConfig(
            fisheye=True, robust=True, use_gmm=True, use_ar=True), subject)
        qs = _np(fte.make_solver()(q0b, bat).q)
        for i, (cfg_key, est) in enumerate(lanes):
            gt_p = os.path.join(dir_prefix, est.data_path, "fte_kinematic",
                                "fte.pickle")
            if not os.path.exists(gt_p):
                continue
            gt = np.asarray(dio.load_fte_pickle(gt_p)["positions"])
            n = min(est.data.meas.shape[0], len(gt))
            pos = sk.fk_markers(torch.as_tensor(qs[i, :n]), subject).numpy()
            mpe, mpjpe = _errors(gt[:n], pos)
            acc[cfg_key]["mpe"].append(mpe)
            acc[cfg_key]["mpjpe"].append(mpjpe)
    rows = [dict(_mean_row(dict(n_components=n, window=w, lasso=l), v),
                 **model_stats.get((n, w, l), {}))
            for (n, w, l), v in acc.items()]
    _write_csv(dir_prefix, "grid_search_results.csv", rows)
    if verbose:
        print(f"[batched] grid search: {len(configs)} configs x "
              f"{sum(len(v) for v in groups.values())} trials in "
              f"{time.time() - t0:.1f}s")
    return rows


def _mean_row(label_key: Dict, acc: Dict[str, List[float]]) -> Dict:
    """A study row: ``label_key``, then the means of the per-trial scores
    (NaN where none) and their count."""
    mean = lambda v: float(np.mean(v)) if v else float("nan")
    return dict(label_key, **{k: mean(v) for k, v in acc.items()},
                n=len(acc["mpe"]))


def run_grid_search(root_dir: str, dir_prefix: str, test_set: Tuple,
                    pose_components: Tuple[int, ...] = (3, 5, 8),
                    windows: Tuple[int, ...] = (2, 4, 6, 10),
                    lasso_options: Tuple[bool, ...] = (True, False),
                    cam_overrides: Optional[List[int]] = None,
                    max_trials: Optional[int] = None,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> List[Dict]:
    """The grid of :func:`run_grid_search_batched` one solve at a time:
    per configuration and trial ``estimate_kinematics`` in the data-driven
    mode with that component count, window and lasso option (which saves
    ``fte_kinematic_<cam>``), scored against the multi-view solve. Writes
    ``grid_search_results.csv`` without the model statistics and returns
    its rows."""
    dev = resolve_device(device)
    trials = test_set[:max_trials] if max_trials else test_set
    rows = []
    for n_comp in pose_components:
        for w in windows:
            for lasso in lasso_options:
                acc = dict(mpe=[], mpjpe=[])
                for est in _serial_trials(root_dir, trials, cam_overrides,
                                          kinematic_model=True):
                    if not est_mod.estimate_kinematics(
                            est, monocular_constraints=True,
                            pose_model_num_components=n_comp,
                            motion_model_window_size=w,
                            motion_model_sparse_solution=lasso,
                            out_dir_prefix=dir_prefix, dtype=dtype,
                            device=dev):
                        continue
                    _add(acc, _score_against_multiview(
                        dir_prefix, est.data_path,
                        f"fte_kinematic_{est.scene.cam_idx}"))
                rows.append(_mean_row(dict(n_components=n_comp, window=w,
                                           lasso=lasso), acc))
    _write_csv(dir_prefix, "grid_search_results.csv", rows)
    return rows


def _serial_trials(root_dir, trials, cam_overrides, kinematic_model):
    """Each trial of ``trials`` found under ``root_dir``, initialised from
    its monocular camera (``cam_overrides``' one, else the metadata's)."""
    for idx, (cheetah, date, name) in enumerate(trials):
        data_path = os.path.join(date, cheetah, name)
        if not os.path.isdir(os.path.join(root_dir, data_path)):
            continue
        cam = cam_overrides[idx] if cam_overrides else None
        yield est_mod.init_trajectory(
            root_dir, data_path, cheetah, monocular_enable=True,
            override_monocular_cam=cam, kinematic_model=kinematic_model)


# (label, disable_pose_prior, disable_motion_prior) of the serial ablations
SERIAL_ABLATIONS = (("both", False, False), ("no-pose", True, False),
                    ("no-motion", False, True), ("neither", True, True))


def run_data_driven_ablation_study(root_dir: str, dir_prefix: str,
                                   test_set: Tuple,
                                   cam_overrides: Optional[List[int]] = None,
                                   max_trials: Optional[int] = None,
                                   dtype: torch.dtype = torch.float32,
                                   device: DeviceLike = None) -> List[Dict]:
    """The pose/motion prior on-off ablation of the data-driven mode, one
    trial at a time: per configuration and trial ``estimate_kinematics``
    with the priors disabled as the configuration says (which saves
    ``fte_kinematic_<cam>``), scored against the multi-view solve. Writes
    ``data_driven_ablation_results.csv`` and returns its rows."""
    dev = resolve_device(device)
    trials = test_set[:max_trials] if max_trials else test_set
    rows = []
    for label, no_pose, no_motion in SERIAL_ABLATIONS:
        acc = dict(mpe=[], mpjpe=[], cvr=[])
        for est in _serial_trials(root_dir, trials, cam_overrides,
                                  kinematic_model=True):
            if not est_mod.estimate_kinematics(
                    est, monocular_constraints=True,
                    disable_pose_prior=no_pose,
                    disable_motion_prior=no_motion,
                    out_dir_prefix=dir_prefix, dtype=dtype, device=dev):
                continue
            _add(acc, _score_against_multiview(
                dir_prefix, est.data_path,
                f"fte_kinematic_{est.scene.cam_idx}"))
        rows.append(_mean_row(dict(config=label), acc))
    _write_csv(dir_prefix, "data_driven_ablation_results.csv", rows)
    return rows


def _add(acc: Dict[str, List[float]], s) -> None:
    """Append the scores ``s`` (MPE, MPJPE, CoM-vel RMSE; None: nothing) to
    the lists of ``acc``, in its keys' order."""
    if s:
        for k, v in zip(acc, s):
            acc[k].append(v)


def run_physics_based_ablation_study(root_dir: str, dir_prefix: str,
                                     test_set: Tuple,
                                     cam_overrides: Optional[List[int]]
                                     = None,
                                     max_trials: Optional[int] = None,
                                     dtype: torch.dtype = torch.float32,
                                     device: DeviceLike = None
                                     ) -> List[Dict]:
    """The prior ablation of the physics-based mode, one trial at a time:
    per configuration and trial, contact detection on the saved
    data-driven solution, then ``estimate_kinetics`` from it with the pose
    prior and the motion prior (the torque and marker-smoothing energy)
    disabled as the configuration says (which saves
    ``fte_kinetic_<cam>``), scored against the multi-view solve. The JAX
    call also passes ``joint_estimation=True``, which changes nothing in
    its solve; the port's function does not take it. Writes
    ``physics_based_ablation_results.csv`` and returns its rows."""
    dev = resolve_device(device)
    trials = test_set[:max_trials] if max_trials else test_set
    rows = []
    for label, no_pose, no_motion in SERIAL_ABLATIONS:
        acc = dict(mpe=[], mpjpe=[], cvr=[])
        for est in _serial_trials(root_dir, trials, cam_overrides,
                                  kinematic_model=False):
            est_mod.determine_contacts(est, monocular=True,
                                       out_dir_prefix=dir_prefix)
            if not est_mod.estimate_kinetics(
                    est, disable_pose_prior=no_pose,
                    disable_motion_prior=no_motion,
                    out_dir_prefix=dir_prefix, dtype=dtype, device=dev):
                continue
            _add(acc, _score_against_multiview(
                dir_prefix, est.data_path,
                f"fte_kinetic_{est.scene.cam_idx}"))
        rows.append(_mean_row(dict(config=label), acc))
    _write_csv(dir_prefix, "physics_based_ablation_results.csv", rows)
    return rows


SWEEP_COLUMNS = ("rate", "default_mpjpe", "dd_mpjpe", "improvement_pct",
                 "physics_mpjpe", "physics_vs_dd_pct")


def _sweep_mpjpe(qs: np.ndarray, gts, subject) -> Tuple[float, List[float]]:
    """Mean and per-trial MPJPE (mm) of the solved trajectories ``qs`` (B,
    N, 54) against the true markers ``gts``, both taken relative to the
    first marker of each frame."""
    out = []
    for i, g in enumerate(gts):
        rec = sk.fk_markers(torch.as_tensor(qs[i, :g.shape[0]]),
                            subject).numpy()
        out.append(1e3 * float(np.mean(np.linalg.norm(
            (rec - rec[:, :1]) - (g - g[:, :1]), axis=-1))))
    return float(np.mean(out)), out


def run_degradation_sweep(rates: Tuple[float, ...] = (0.0, 1.0, 2.0, 4.0,
                                                      8.0),
                          n_frames: int = 64,
                          data_driven_dataset: Optional[str] = None,
                          out_dir: Optional[str] = None,
                          include_physics: bool = False,
                          max_trials: int = 10,
                          verbose: bool = True,
                          dtype: torch.dtype = torch.float32,
                          device: DeviceLike = None,
                          report: Optional[dict] = None) -> List[Dict]:
    """Monocular default against data-driven reconstruction across
    correlated DLC corruption levels, on ``device`` (the card by default):
    per rate, the first ``max_trials`` procedural bench trials rendered
    with occlusion bursts at ``rate`` and limb confusions at ``0.6 rate``
    events per camera and 100 frames (camera 2, padded to ``n_frames``),
    solved as one batch by the prior-free heading multistart (default),
    then the GMM chain, the prior gate, AR anchors with adaptive weights
    and the data-driven solve (gate-rejected trials keep the prior-free
    solution), each scored by MPJPE against the synthetic truth. With
    ``include_physics``, the physics-based solve from the data-driven
    solutions as one batch (``bench_lib.build_physics_batch``: contacts
    detected on the warm start, ground heights from the truth, the GMM of
    the default training table, none where there is no such table).

    Rows: ``rate``, ``default_mpjpe``, ``dd_mpjpe``, ``improvement_pct``
    (and ``physics_mpjpe``, ``physics_vs_dd_pct``), rounded to 0.1 as the
    JAX package rounds them; written to ``out_dir/degradation_sweep.csv``
    when ``out_dir`` is given. With ``report``, per rate the unrounded
    values (``rows``), the per-trial MPJPEs and the prior gate."""
    from . import bench_lib
    from . import contacts as contacts_mod

    dev = resolve_device(device)
    subject = params_mod.get_subject("acinoset")
    dset = data_driven_dataset or est_mod._default_data_driven_dataset()
    gp = gmm_mod.to_solver_prior(_train_gmm(dset, 5, dev))
    mm = armodel.train_motion_model(dset, window_size=4, lasso=True,
                                    device=dev,
                                    cache_dir=data_ops.prior_cache_dir(dset))
    trajs = bench_lib.load_reference_trajectories(max_trials)
    cfg = dict(fisheye=True, robust=True)
    fte_def = kin.KinematicFTE(kin.KinematicConfig(**cfg), subject)
    vdef = pbatch.make_kinematic_multistart(fte_def)
    vgmm = kin.KinematicFTE(kin.KinematicConfig(use_gmm=True, **cfg),
                            subject).make_solver()
    vdd = kin.KinematicFTE(kin.KinematicConfig(use_gmm=True, use_ar=True,
                                               **cfg), subject).make_solver()
    gp_phys = None
    if include_physics:
        kvrun = kn.KineticFTE(kn.KineticConfig(use_gmm=True),
                              subject).make_solver()
        dphys = est_mod._default_data_driven_dataset()
        if os.path.exists(dphys):
            gp_phys = gmm_mod.to_solver_prior(_train_gmm(dphys, 5, dev))
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    rep = {} if report is None else report
    rows = []
    for rate in rates:
        datas, q0s, gts, q_gts, fpss = [], [], [], [], []
        for i, (q_gt, _, fps) in enumerate(trajs):
            d, q0, tr = bench_lib.build_monocular_problem(
                q_gt, "acinoset", fps, seed=i, cam_idx=2,
                occlusion_rate=rate, confusion_rate=0.6 * rate)
            datas.append(d)
            q0s.append(q0)
            gts.append(tr.markers_gt)
            q_gts.append(tr.q_gt)
            fpss.append(fps)
        bat, q0b = pbatch.pad_and_stack([d._replace(gmm=gp) for d in datas],
                                        q0s, n_frames=n_frames, dtype=dtype,
                                        device=dev)
        q_def = vdef(q0b, bat).q
        q_chain = vgmm(q_def, bat).q
        prior_ok = prior_gate_accept(_np(fte_def._cost(q_chain, bat, 1.0)),
                                     _np(fte_def._cost(q_def, bat, 1.0)))
        ok = torch.as_tensor(prior_ok, device=dev)[:, None, None]
        q_boot = torch.where(ok, q_chain, q_def)
        yp, vl, xs = batched_mod._anchors(mm, _np(q_boot),
                                          _np(bat.frame_valid))
        ws = np.stack([armodel.adaptive_motion_weights(mm, yp[i], xs[i],
                                                       vl[i])
                       for i in range(len(datas))])
        bat_dd = bat._replace(ar=kin.ARAnchor(tens(yp), tens(ws), tens(vl)))
        q_dd = torch.where(ok, vdd(q_boot, bat_dd).q, q_def)
        raw = {"rate": rate}
        per_trial = {}
        raw["default_mpjpe"], per_trial["default"] = _sweep_mpjpe(
            _np(q_def), gts, subject)
        raw["dd_mpjpe"], per_trial["dd"] = _sweep_mpjpe(_np(q_dd), gts,
                                                        subject)
        if include_physics:
            qdd64 = _np(q_dd)
            gphs = [contacts_mod.estimate_ground_height(qg, subject)
                    for qg in q_gts]
            kbat, q_warm_b = bench_lib.build_physics_batch(
                datas, [qdd64[i, :g.shape[0]] for i, g in enumerate(gts)],
                fpss, subject, gmm_prior=gp_phys, n_frames=n_frames,
                dtype=dtype, ground_heights=gphs, device=dev)
            raw["physics_mpjpe"], per_trial["physics"] = _sweep_mpjpe(
                _np(kvrun(q_warm_b, kbat).q), gts, subject)
        row = dict(rate=rate, default_mpjpe=round(raw["default_mpjpe"], 1),
                   dd_mpjpe=round(raw["dd_mpjpe"], 1))
        row["improvement_pct"] = round(
            100.0 * (1 - row["dd_mpjpe"] / max(row["default_mpjpe"], 1e-9)),
            1)
        if include_physics:
            row["physics_mpjpe"] = round(raw["physics_mpjpe"], 1)
            row["physics_vs_dd_pct"] = round(
                100.0 * (1 - row["physics_mpjpe"]
                         / max(row["dd_mpjpe"], 1e-9)), 1)
        rows.append(row)
        rep.setdefault("rows", []).append(raw)
        rep.setdefault("per_trial", []).append(per_trial)
        rep.setdefault("prior_ok", []).append(prior_ok.tolist())
        if verbose:
            msg = (f"[sweep] rate={rate}: default {row['default_mpjpe']} "
                   f"dd {row['dd_mpjpe']} ({row['improvement_pct']}%)")
            if include_physics:
                msg += (f" physics {row['physics_mpjpe']} "
                        f"({row['physics_vs_dd_pct']}% vs dd)")
            print(msg, flush=True)
    if out_dir:
        from .run_dataset import write_rows_csv
        write_rows_csv(os.path.join(out_dir, "degradation_sweep.csv"), rows,
                       SWEEP_COLUMNS[:6 if include_physics else 4])
    return rows


def _ablation_bootstrap(groups, dset: str, dtype, verbose: bool = True,
                        device: DeviceLike = None):
    """The shared monocular bootstrap of the batched ablations per subject
    group (:func:`_bootstrap` with the 5-component GMM). A chain cost that
    is not finite where the prior-free one is raises. Returns per group
    (subject, ests, the stacked problem, q_free, q_boot, the GMM)."""
    dev = resolve_device(device)
    gp = gmm_mod.to_solver_prior(_train_gmm(dset, 5, dev))
    out = []
    for subject_name, ests in groups.items():
        subject = params_mod.get_subject(subject_name)
        bbat, q_free, q_boot, c_free, c_chain = _bootstrap(
            subject, ests, gp, dtype, dev)
        broken = ~np.isfinite(c_chain) & np.isfinite(c_free)
        if broken.any():
            raise RuntimeError(
                f"ablation bootstrap chain non-finite on trials "
                f"{np.flatnonzero(broken).tolist()}")
        out.append((subject, ests, bbat, q_free, q_boot, gp))
        if verbose:
            print(f"[ablation] bootstrap {subject_name}: "
                  f"{len(ests)} trials", flush=True)
    return out


def _score_rows(acc: Dict[str, Dict[str, List[float]]], out_csv: str,
                dir_prefix: str) -> List[Dict]:
    """One row per ablation configuration, in ``ABLATION_CONFIGS``' order,
    written to ``dir_prefix/out_csv``."""
    rows = [_mean_row(dict(config=label), acc[label])
            for label, _, _ in ABLATION_CONFIGS]
    _write_csv(dir_prefix, out_csv, rows)
    return rows


def run_data_driven_ablation_batched(root_dir: str, dir_prefix: str,
                                     test_set: Tuple,
                                     cam_overrides: Optional[List[int]]
                                     = None,
                                     max_trials: Optional[int] = None,
                                     data_driven_dataset: Optional[str]
                                     = None,
                                     dtype: torch.dtype = torch.float32,
                                     verbose: bool = True,
                                     device: DeviceLike = None
                                     ) -> List[Dict]:
    """The pose/motion prior on-off ablation of the data-driven mode with
    each configuration one batch per subject group, on ``device`` (the card
    by default), from the shared bootstrap (:func:`_ablation_bootstrap`):
    arms with the pose prior start from the gated GMM chain, the others
    from the prior-free solve, with AR anchors and adaptive weights from
    their own start (window 4, lasso); the arm with neither prior is the
    prior-free solve. Scored against the multi-view solve; writes
    ``data_driven_ablation_results.csv`` and returns its rows."""
    dev = resolve_device(device)
    dset = data_driven_dataset or est_mod._default_data_driven_dataset()
    groups = _groups(root_dir, test_set, cam_overrides, max_trials)
    acc = {label: dict(mpe=[], mpjpe=[], cvr=[])
           for label, _, _ in ABLATION_CONFIGS}
    mm = armodel.train_motion_model(dset, window_size=4, lasso=True,
                                    device=dev,
                                    cache_dir=data_ops.prior_cache_dir(dset))
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    for subject, ests, bbat, q_free, q_boot, _ in _ablation_bootstrap(
            groups, dset, dtype, verbose, dev):
        fv = _np(bbat.frame_valid)

        def ar_batch(q_src):
            """The problem with AR anchors and adaptive weights from
            ``q_src``."""
            yp, vl, xs = batched_mod._anchors(mm, _np(q_src), fv)
            ws = np.stack([armodel.adaptive_motion_weights(
                mm, yp[i], xs[i], vl[i]) for i in range(len(ests))])
            return bbat._replace(ar=kin.ARAnchor(tens(yp), tens(ws),
                                                 tens(vl)))

        bat_ar = {True: ar_batch(q_boot), False: ar_batch(q_free)}
        for label, use_gmm, use_ar in ABLATION_CONFIGS:
            if not (use_gmm or use_ar):
                qs = _np(q_free)
            else:
                fte = kin.KinematicFTE(kin.KinematicConfig(
                    fisheye=True, robust=True, use_gmm=use_gmm,
                    use_ar=use_ar), subject)
                qs = _np(fte.make_solver()(q_boot if use_gmm else q_free,
                                           bat_ar[use_gmm]).q)
            for i, est in enumerate(ests):
                _add(acc[label], _score_q_against_multiview(
                    qs[i, :est.data.meas.shape[0]], est, est.data_path,
                    dir_prefix, subject))
            if verbose:
                print(f"[ablation] dd {label}: "
                      f"mpe {np.mean(acc[label]['mpe']):.1f}", flush=True)
    return _score_rows(acc, "data_driven_ablation_results.csv", dir_prefix)


def run_physics_ablation_batched(root_dir: str, dir_prefix: str,
                                 test_set: Tuple,
                                 cam_overrides: Optional[List[int]] = None,
                                 max_trials: Optional[int] = None,
                                 data_driven_dataset: Optional[str] = None,
                                 dtype: torch.dtype = torch.float32,
                                 verbose: bool = True,
                                 device: DeviceLike = None
                                 ) -> List[Dict]:
    """The prior ablation of the physics-based mode with each configuration
    one kinetic solve per subject group, on ``device`` (the card by
    default): per trial the saved data-driven solution is the warm start,
    contact detection on it (``estimator.determine_contacts``) and the
    stances pruned on it; the pose prior is the 5-component GMM, the motion
    prior the torque and marker-smoothing energy (off: torque weight 1e-6,
    smoothing 0). Scored against the multi-view solve; writes
    ``physics_based_ablation_results.csv`` and returns its rows."""
    dev = resolve_device(device)
    dset = data_driven_dataset or est_mod._default_data_driven_dataset()
    groups = _groups(root_dir, test_set, cam_overrides, max_trials)
    acc = {label: dict(mpe=[], mpjpe=[], cvr=[])
           for label, _, _ in ABLATION_CONFIGS}
    gp = gmm_mod.to_solver_prior(_train_gmm(dset, 5, dev))
    for subject_name, ests in groups.items():
        subject = params_mod.get_subject(subject_name)
        kds, qws = [], []
        for est in ests:
            d = est_mod._load_warm_start(est, True, dir_prefix)
            est.com_vel, est.com_pos = d["com_vel"], d["com_pos"]
            est_mod.determine_contacts(est, monocular=True,
                                       out_dir_prefix=dir_prefix)
            N = est.params.end_frame - est.params.start_frame
            q_warm = np.asarray(d["q"], np.float64)
            stance = est_mod._pruned_stance(est, est._base(dir_prefix),
                                            q_warm, N)
            kds.append(kn.KineticData(
                base=est.data._replace(gmm=gp), stance=stance,
                grf_fixed=np.zeros((N, 4)), grf_xy_fixed=np.zeros((N, 4, 4)),
                use_fixed_grf=np.asarray(0.0), q_warm=q_warm,
                ground_z=np.asarray(est.params.ground_plane_height)))
            qws.append(q_warm)
        kbat, q_warm_b = pbatch.pad_and_stack_kinetic(
            kds, qws, n_frames=batched_mod._n_frames([kd.base for kd in kds]),
            dtype=dtype, device=dev)
        for label, use_gmm, use_motion in ABLATION_CONFIGS:
            kfte = kn.KineticFTE(kn.KineticConfig(
                fisheye=True, robust=True, use_gmm=use_gmm,
                torque_weight=1.0 if use_motion else 1e-6,
                smooth_weight_scale=0.1 if use_motion else 0.0), subject)
            qs = _np(kfte.make_solver()(q_warm_b, kbat).q)
            for i, est in enumerate(ests):
                _add(acc[label], _score_q_against_multiview(
                    qs[i, :est.data.meas.shape[0]], est, est.data_path,
                    dir_prefix, subject))
            if verbose:
                print(f"[ablation] physics {label}: "
                      f"mpe {np.mean(acc[label]['mpe']):.1f}", flush=True)
    return _score_rows(acc, "physics_based_ablation_results.csv", dir_prefix)


def model_selection_analysis(data_driven_dataset: Optional[str] = None,
                             pose_components: Tuple[int, ...] =
                             (1, 2, 3, 4, 5, 6, 7),
                             window_sizes: Tuple[int, ...] =
                             (1, 2, 3, 4, 5, 6, 7),
                             out_dir: Optional[str] = None,
                             device: DeviceLike = None) -> Dict:
    """Model-level hyper-parameter curves on the training table
    ``data_driven_dataset`` and ``validation_dataset.h5`` (or its ``.csv``)
    beside it: the
    GMM's train and validation mean log-likelihood per sample for each
    component count (fitted without the cache), then the AR model's train
    and validation RMSE and non-zero coefficient count for each window
    size, lasso first, then least squares (cached beside the table). With
    ``out_dir``, saved as ``grid_search.pickle`` with the JAX package's
    keys. Returns the dict of lists."""
    dev = resolve_device(device)
    dset = data_driven_dataset or est_mod._default_data_driven_dataset()
    X = prior_ds.load_pose_dataset(dset).data[:, 6:28]
    Xv = prior_ds.load_pose_dataset(os.path.join(
        os.path.dirname(dset), "validation_dataset.h5")).data[:, 6:28]
    out: Dict[str, List[float]] = {
        "gmm_train_likelihood": [], "gmm_validation_likelihood": [],
        "lr_train_rmse": [], "lr_validation_rmse": [], "lr_non_zeros": []}
    for k in pose_components:
        params = gmm_mod.fit(X, n_components=k, seed=42, device=dev)
        out["gmm_train_likelihood"].append(gmm_mod.score(params, X))
        out["gmm_validation_likelihood"].append(gmm_mod.score(params, Xv))
    for lasso in (True, False):
        for w in window_sizes:
            mm = armodel.train_motion_model(
                dset, window_size=w, lasso=lasso, device=dev,
                cache_dir=data_ops.prior_cache_dir(dset))
            out["lr_train_rmse"].append(mm.train_rmse)
            out["lr_validation_rmse"].append(mm.validation_rmse)
            out["lr_non_zeros"].append(mm.model_non_zeros)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        data_ops.save_pickle(os.path.join(out_dir, "grid_search.pickle"),
                             out)
    return out


def _bench_trials(trajs):
    """The monocular problems (numpy leaves) of the bench trajectories
    ``trajs`` on camera 2, each rendered with its index as seed: (datas,
    q0s, trials, fpss)."""
    from . import bench_lib

    datas, q0s, trials, fpss = [], [], [], []
    for i, (q_gt, _, fps) in enumerate(trajs):
        d, q0, tr = bench_lib.build_monocular_problem(q_gt, "acinoset", fps,
                                                      seed=i)
        datas.append(d)
        q0s.append(q0)
        trials.append(tr)
        fpss.append(fps)
    return datas, q0s, trials, fpss


def _physics_warm_start(max_trials: int, n_frames: int, dtype, dev):
    """The shared warm start of the two physics response sweeps: the
    default-configuration kinematic multistart on the first ``max_trials``
    bench trials, scored against the synthetic truth, and the physics
    batch built from it with the ground heights estimated from the truth.
    Returns (subject, trials, fpss, warm scores per trial, kinetic batch,
    q_warm (B, N, 54))."""
    from . import bench_lib
    from . import contacts as contacts_mod

    subject = params_mod.get_subject("acinoset")
    datas, q0s, trials, fpss = _bench_trials(
        bench_lib.load_reference_trajectories(max_trials))
    bat, q0b = pbatch.pad_and_stack(datas, q0s, n_frames=n_frames,
                                    dtype=dtype, device=dev)
    fte = kin.KinematicFTE(kin.KinematicConfig(), subject)
    qs64 = _np(pbatch.make_kinematic_multistart(fte)(q0b, bat).q)
    warm = bench_lib.score_per_trial(qs64, trials, fpss, subject)
    gphs = [contacts_mod.estimate_ground_height(tr.q_gt, subject)
            for tr in trials]
    kbat, q_warm_b = bench_lib.build_physics_batch(
        datas, [qs64[i, :tr.q_gt.shape[0]] for i, tr in enumerate(trials)],
        fpss, subject, n_frames=n_frames, dtype=dtype, ground_heights=gphs,
        device=dev)
    return subject, trials, fpss, warm, kbat, q_warm_b


def _means(scores) -> Tuple[float, float, float]:
    """Mean (MPE, MPJPE, CoM-vel RMSE) over per-trial scores."""
    return tuple(float(np.mean([r[i] for r in scores])) for i in range(3))


def run_deadband_sweep(base_deadbands: Tuple = (None, 0.1, 0.05, 0.02,
                                                0.01, 0.0),
                       grf_maxes: Tuple[float, ...] = (5.0, 3.0),
                       n_frames: int = 64, max_trials: int = 10,
                       out_dir: Optional[str] = None,
                       verbose: bool = True,
                       dtype: torch.dtype = torch.float32,
                       device: DeviceLike = None,
                       report: Optional[dict] = None) -> List[Dict]:
    """The physics stage's CoM-velocity response to the base-translation
    EOM deadband and the GRF cap (JAX ``studies.py:884-1002``), on
    ``device`` (the card by default): one default-configuration kinematic
    multistart on the first ``max_trials`` bench trials is the shared warm
    start; then per (``grf_max``, ``base_deadband``) one kinetic solve of
    every trial as one batch (the JAX package's waves of 5 are a TPU memory
    workaround; the lanes are independent), scored against the synthetic
    truth by CoM-velocity RMSE and MPE. ``base_deadband=None`` keeps the
    relative EOM floor on the base rows (written ``"floor"``).

    The scores are float64 host numpy (``bench_lib.score_per_trial``);
    the JAX package scores in ``jnp`` on the host, float32 unless x64 is
    on, ~1e-6 relative apart. Rows rounded as the JAX package rounds them
    (CoM-vel to 1e-4 m/s, MPE to 0.1 mm), written to
    ``out_dir/deadband_sweep.csv`` when ``out_dir`` is given. With
    ``report``: the unrounded rows (``rows``), the warm start's per-trial
    scores (``warm``) and each row's (``per_trial``)."""
    from . import bench_lib

    dev = resolve_device(device)
    subject, trials, fpss, warm, kbat, q_warm_b = _physics_warm_start(
        max_trials, n_frames, dtype, dev)
    mpe_warm, _, cv_warm = _means(warm)
    if verbose:
        print(f"[deadband] warm start: CoMvel={cv_warm:.3f} "
              f"MPE={mpe_warm:.0f}mm", flush=True)
    rep = {} if report is None else report
    rep["warm"] = warm
    rows = []
    for gm in grf_maxes:
        for bd in base_deadbands:
            kfte = kn.KineticFTE(kn.KineticConfig(
                use_gmm=True, base_deadband=bd, grf_max=gm), subject)
            sc = bench_lib.score_per_trial(
                _np(kfte.make_solver()(q_warm_b, kbat).q), trials, fpss,
                subject)
            mpe_v, _, cv = _means(sc)
            raw = dict(base_deadband=("floor" if bd is None else bd),
                       grf_max=gm, comvel_rmse=cv, comvel_warm=cv_warm,
                       comvel_improvement_pct=100.0 * (
                           1.0 - cv / max(cv_warm, 1e-9)),
                       mpe_mm=mpe_v, mpe_warm_mm=mpe_warm)
            row = dict(raw, comvel_rmse=round(cv, 4),
                       comvel_warm=round(cv_warm, 4),
                       comvel_improvement_pct=round(
                           raw["comvel_improvement_pct"], 1),
                       mpe_mm=round(mpe_v, 1),
                       mpe_warm_mm=round(mpe_warm, 1))
            rows.append(row)
            rep.setdefault("rows", []).append(raw)
            rep.setdefault("per_trial", []).append(sc)
            if verbose:
                print(f"[deadband] bd={row['base_deadband']} grf_max={gm}: "
                      f"CoMvel={cv:.3f} ({row['comvel_improvement_pct']}%) "
                      f"MPE={row['mpe_mm']}mm", flush=True)
    if out_dir:
        _write_csv(out_dir, "deadband_sweep.csv", rows)
    return rows


LEVER_VARIANTS = {
    "production": dict(),
    "eom_weight_x10": dict(eom_weight=1e5),
    "deadband_1.0": dict(eom_deadband=1.0),
    "deadband_0.5": dict(eom_deadband=0.5),
    "smooth_x3": dict(smooth_weight_scale=0.3),
    "smooth_0": dict(smooth_weight_scale=0.0),
    "guard_off": dict(meas_guard=0.0),
    "long_stages": dict(_stages=((3.0, 60), (1.7, 60), (1.0, 200))),
    "lam0_0.5": dict(_lam0=0.5),
    "perturbed_warm": dict(_perturb=0.02),
}
LEVER_STAGES = ((3.0, 40), (1.7, 40), (1.0, 100))


def run_physics_lever_sweep(n_frames: int = 64, max_trials: int = 10,
                            out_csv: Optional[str] = None,
                            variants: Optional[Dict[str, Dict]] = None,
                            verbose: bool = True,
                            dtype: torch.dtype = torch.float32,
                            device: DeviceLike = None,
                            report: Optional[dict] = None) -> List[Dict]:
    """Which kinetic-solver levers move the physics stage off its warm
    start (JAX ``studies.py:1206-1325``), on ``device`` (the card by
    default). Per variant of ``variants`` (``LEVER_VARIANTS`` by default:
    ``KineticConfig`` overrides, and the private ``_stages`` (the LM
    schedule, ``LEVER_STAGES`` otherwise), ``_lam0`` (initial damping, 10)
    and ``_perturb`` (the warm start moved by ``_perturb`` x
    ``default_rng(0).standard_normal`` over the whole padded batch, cast to
    the batch's dtype)) one kinetic solve of every trial as one batch from
    the shared warm start of :func:`run_deadband_sweep`, scored against the
    synthetic truth: MPE, MPJPE, CoM-vel RMSE, their change from the warm
    start, and the mean accepted LM steps per lane (``LMState.n_accepted``).

    Rows rounded as the JAX package rounds them. The JAX package writes
    ``docs/artifacts/physics_lever_sweep.csv`` by default; here
    ``out_csv=None`` (the default) writes nothing. With ``report``: the
    unrounded rows (``rows``), the warm start's per-trial scores
    (``warm``), each row's (``per_trial``) and its accepted steps per lane
    (``accepted``)."""
    from . import bench_lib

    dev = resolve_device(device)
    subject, trials, fpss, warm, kbat, q_warm_b = _physics_warm_start(
        max_trials, n_frames, dtype, dev)
    w_mpe, w_mpjpe, w_cv = _means(warm)
    if verbose:
        print(f"[levers] kinematic warm start: MPE={w_mpe:.1f} "
              f"MPJPE={w_mpjpe:.1f} CoMvel={w_cv:.3f}", flush=True)
    rep = {} if report is None else report
    rep["warm"] = warm
    rows = []
    for label, ov in (LEVER_VARIANTS if variants is None
                      else variants).items():
        ov = dict(ov)
        stages = ov.pop("_stages", LEVER_STAGES)
        lam0 = ov.pop("_lam0", 10.0)
        perturb = ov.pop("_perturb", 0.0)
        kfte = kn.KineticFTE(kn.KineticConfig(use_gmm=True, **ov), subject)
        qw = q_warm_b
        if perturb > 0.0:
            noise = perturb * np.random.default_rng(0).standard_normal(
                tuple(q_warm_b.shape))
            qw = q_warm_b + torch.as_tensor(noise, dtype=q_warm_b.dtype,
                                            device=dev)
        st = kfte.make_solver(stages=stages, lam0=lam0)(qw, kbat)
        its = _np(st.n_accepted)
        sc = bench_lib.score_per_trial(_np(st.q), trials, fpss, subject)
        mpe_v, mpjpe_v, cv_v = _means(sc)
        raw = dict(variant=label, mpe_mm=mpe_v, mpjpe_mm=mpjpe_v,
                   comvel_rmse=cv_v, dmpe_mm=mpe_v - w_mpe,
                   dmpjpe_mm=mpjpe_v - w_mpjpe,
                   comvel_improvement_pct=100.0 * (
                       1.0 - cv_v / max(w_cv, 1e-9)),
                   mean_accepted_iters=float(np.mean(its)))
        row = dict(variant=label, mpe_mm=round(mpe_v, 2),
                   mpjpe_mm=round(mpjpe_v, 2), comvel_rmse=round(cv_v, 4),
                   dmpe_mm=round(raw["dmpe_mm"], 2),
                   dmpjpe_mm=round(raw["dmpjpe_mm"], 2),
                   comvel_improvement_pct=round(
                       raw["comvel_improvement_pct"], 1),
                   mean_accepted_iters=round(raw["mean_accepted_iters"], 1))
        rows.append(row)
        rep.setdefault("rows", []).append(raw)
        rep.setdefault("per_trial", []).append(sc)
        rep.setdefault("accepted", []).append(its.tolist())
        if verbose:
            print(f"[levers] {label}: MPE={row['mpe_mm']} "
                  f"dMPJPE={row['dmpjpe_mm']} CoMvel={row['comvel_rmse']} "
                  f"({row['comvel_improvement_pct']}%) "
                  f"it={row['mean_accepted_iters']}", flush=True)
    if out_csv:
        _write_csv(os.path.dirname(out_csv), os.path.basename(out_csv),
                   rows)
    return rows


FVG_VARIANTS = ("default", "chain", "dd_gated", "dd_forced")


def run_forced_vs_gated_bench(out_csv: Optional[str] = None,
                              n_frames: int = 64,
                              prior_guard_ratio: float = 1.10,
                              dtype: torch.dtype = torch.float32,
                              chain_cfg_overrides: Optional[Dict] = None,
                              verbose: bool = True,
                              device: DeviceLike = None,
                              report: Optional[dict] = None) -> List[Dict]:
    """Per-trial evidence for the data-driven mode's prior gate (JAX
    ``studies.py:1049-1203``), on ``device`` (the card by default): for
    each of the 10 bench trials (``bench_lib.reference_trial_paths(10)``),
    scored against the synthetic truth,

      default    the prior-free heading multistart;
      chain      the GMM chain from it, ungated;
      dd_gated   the data-driven solve (AR anchors and adaptive weights from
                 the gated bootstrap, GMM + AR) where the gate at
                 ``prior_guard_ratio`` accepts the chain, the prior-free
                 solution where it rejects it;
      dd_forced  the same with the gate open on every trial;

    each before and after ``bench_lib.make_anchor_polish`` (``_anch``), with
    the chain's prior-free cost over the free solve's (``ratio``) and the
    gate. The priors are the 5-component GMM and the window-4 lasso AR
    model of the default training table
    (``estimator._default_data_driven_dataset``). With a base anchor in
    ``chain_cfg_overrides`` the prior-constrained solves' base pose is
    pinned to the free solve (``KinematicData.base_ref``).

    Rows with the JAX package's columns; the JAX package writes
    ``docs/artifacts/forced_vs_gated.csv`` by default, here ``out_csv=None``
    (the default) writes nothing. With ``report``: both costs
    (``c_free``, ``c_chain``) and per variant the anchor's per-trial shift
    and acceptance (``anchor``)."""
    from . import bench_lib
    from . import contacts as cmod

    dev = resolve_device(device)
    subject = params_mod.get_subject("acinoset")
    names = bench_lib.reference_trial_paths(10)
    datas, q0s, trials, fpss = _bench_trials(
        bench_lib.load_reference_trajectories(10))
    dset = est_mod._default_data_driven_dataset()
    gp = gmm_mod.to_solver_prior(_train_gmm(dset, 5, dev))
    mm = armodel.train_motion_model(dset, window_size=4, lasso=True,
                                    device=dev,
                                    cache_dir=data_ops.prior_cache_dir(dset))
    bat_dd, q0b = pbatch.pad_and_stack([d._replace(gmm=gp) for d in datas],
                                       q0s, n_frames=n_frames, dtype=dtype,
                                       device=dev)
    B = q0b.shape[0]
    gphs = [cmod.estimate_ground_height(tr.q_gt, subject) for tr in trials]
    tens = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    free = kin.KinematicFTE(kin.KinematicConfig(fisheye=True, robust=True),
                            subject)
    q_free = pbatch.make_kinematic_multistart(free)(q0b, bat_dd).q
    overrides = dict(chain_cfg_overrides or {})
    if overrides.get("base_anchor_trans", 0.0) > 0.0 \
            or overrides.get("base_anchor_rot", 0.0) > 0.0:
        bat_dd = bat_dd._replace(base_ref=q_free[:, :, :6])
    chain = kin.KinematicFTE(kin.KinematicConfig(
        fisheye=True, robust=True, use_gmm=True, **overrides), subject)
    q_chain = chain.make_solver()(q_free, bat_dd).q
    c_free = _np(free._cost(q_free, bat_dd, 1.0))
    c_chain = _np(free._cost(q_chain, bat_dd, 1.0))
    ratio = c_chain / c_free
    gate = prior_gate_accept(c_chain, c_free, prior_guard_ratio)
    if verbose:
        print(f"[fvg] gate accepts {int(gate.sum())}/{B}", flush=True)
    vdd = kin.KinematicFTE(kin.KinematicConfig(
        fisheye=True, robust=True, use_gmm=True, use_ar=True, **overrides),
        subject).make_solver()
    fv = _np(bat_dd.frame_valid)

    def dd_solve(accept_mask):
        """The data-driven machinery with the given per-trial gate outcome:
        the bootstrap picked per trial, AR anchors and adaptive weights
        from it, the GMM + AR solve, rejected trials back to the prior-free
        solution."""
        ok = torch.as_tensor(accept_mask, device=dev)[:, None, None]
        qb = torch.where(ok, q_chain, q_free)
        yp, vl, xs = batched_mod._anchors(mm, _np(qb), fv)
        ws = np.stack([armodel.adaptive_motion_weights(mm, yp[i], xs[i],
                                                       vl[i])
                       for i in range(B)])
        bat = bat_dd._replace(ar=kin.ARAnchor(tens(yp), tens(ws), tens(vl)))
        return torch.where(ok, vdd(qb, bat).q, q_free), bat

    q_gated, bat_g = dd_solve(gate)
    q_forced, bat_f = dd_solve(np.ones(B, bool))
    anchor = bench_lib.make_anchor_polish(subject, dtype, dev)
    variants = {"default": (q_free, bat_dd), "chain": (q_chain, bat_dd),
                "dd_gated": (q_gated, bat_g), "dd_forced": (q_forced, bat_f)}
    rep = {} if report is None else report
    rep.update(c_free=c_free.tolist(), c_chain=c_chain.tolist(), anchor={})
    rows = [dict(trial=names[i], ratio=float(ratio[i]), gate=bool(gate[i]))
            for i in range(B)]
    for label, (q, bat) in variants.items():
        pre = bench_lib.score_per_trial(_np(q), trials, fpss, subject)
        rep["anchor"][label] = {}
        q_a = anchor(q, bat, trials, fpss, gphs, report=rep["anchor"][label])
        post = bench_lib.score_per_trial(_np(q_a), trials, fpss, subject)
        for i in range(B):
            for j, m in enumerate(("mpe", "mpjpe", "cvr")):
                rows[i][f"{m}_{label}"] = pre[i][j]
            for j, m in enumerate(("mpe", "mpjpe", "cvr")):
                rows[i][f"{m}_{label}_anch"] = post[i][j]
        if verbose:
            print(f"[fvg] {label}: MPE {np.mean([r[0] for r in pre]):.1f} "
                  f"-> anch {np.mean([r[0] for r in post]):.1f}  "
                  f"CoMvel {np.mean([r[2] for r in pre]):.3f} "
                  f"-> {np.mean([r[2] for r in post]):.3f}", flush=True)
    if out_csv:
        _write_csv(os.path.dirname(out_csv), os.path.basename(out_csv),
                   rows)
    return rows
