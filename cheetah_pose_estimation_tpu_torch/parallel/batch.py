"""Batching ragged trials and the monocular heading multistart.

Port of ``cheetah_pose_estimation_tpu/parallel/batch.py``: trials are padded
to a common frame and camera count and stacked into one ``KinematicData``
(or, with the physics arrays, ``KineticData``) of tensors with a leading
trial axis. The monocular heading multistart solves every trial from three
heading offsets: in full (``make_multistart``, ``multistart_single`` for the
serial path's one trial), or as a short probe of every offset that
finishes only the winner (``make_kinematic_multistart``, the batched
production solver). The TPU backend crossover (``backend_for``,
``CR_MAX_BATCH``) is not ported: the linear solver follows the tensors'
device.

Several devices: a trial mesh (:func:`trial_mesh`) is a tuple of
``torch.device``. :func:`shard_batch` splits a batch's leading (trial) axis
into contiguous equal chunks, one per device, as JAX's
``NamedSharding(mesh, P(TRIAL_AXIS))`` lays it out; :func:`on_mesh` runs a
batched solver on every chunk on its own device, one host thread per
device, and gathers the lanes back in order. Each trial's system stays on
its device, so no collective is needed: reductions over the trials are
taken on the host after the gather (:func:`dryrun_multichip`).
"""
from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..solver.kinematic import (ARAnchor, CameraSet, KinematicData,
                                map_data)
from ..utils.device import DeviceLike, resolve_device

TRIAL_AXIS = "trials"
HEADING_RESTARTS: Tuple[float, ...] = (0.0, 0.3, -0.3)
MULTISTART_MARGIN = 0.01
PROBE_STAGES: Tuple[Tuple[float, int], ...] = ((10.0, 30),)
FULL_STAGES: Tuple[Tuple[float, int], ...] = ((3.0, 30), (1.0, 150))


def _pad_to(x: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    pad = n - x.shape[axis]
    if pad < 0:
        raise ValueError(
            f"trial dimension {x.shape[axis]} exceeds the requested padded "
            f"size {n} (axis {axis}); pass n_frames/n_cams >= the longest "
            "trial (padding never truncates)")
    if pad == 0:
        return x
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width)


def pad_and_stack(datas: Sequence[KinematicData],
                  q0s: Sequence[np.ndarray],
                  n_frames: Optional[int] = None,
                  n_cams: Optional[int] = None,
                  dtype: torch.dtype = torch.float32,
                  device: DeviceLike = None
                  ) -> Tuple[KinematicData, torch.Tensor]:
    """Stack per-trial problems (numpy leaves) into one batch of tensors.

    Padded frames get ``frame_valid = 0`` (weights zeroed, stencil residuals
    masked, identity diagonal anchor in the normal matrix); padded cameras
    get zero weights and a harmless identity pose. q0 padding repeats the
    last valid frame."""
    dev = resolve_device(device)
    N = n_frames or max(d.meas.shape[0] for d in datas)
    C = n_cams or max(d.meas.shape[1] for d in datas)

    def prep(d: KinematicData, q0: np.ndarray):
        n, c = d.meas.shape[0], d.meas.shape[1]
        eye_pad = lambda k: np.concatenate(
            [np.zeros((c, k, k)), np.broadcast_to(np.eye(k), (C - c, k, k))])
        cam = CameraSet(
            _pad_to(np.asarray(d.cam.K), C, 0) + (eye_pad(3) if c < C
                                                  else 0.0),
            _pad_to(np.asarray(d.cam.D), C, 0),
            _pad_to(np.asarray(d.cam.R), C, 0) + (eye_pad(3) if c < C
                                                  else 0.0),
            _pad_to(np.asarray(d.cam.t), C, 0) + (np.concatenate(
                [np.zeros((c, 3)),
                 np.tile(np.array([0.0, 0.0, 10.0]), (C - c, 1))]) if c < C
                else 0.0))
        ar = ARAnchor(_pad_to(np.asarray(d.ar.y_pred), N, 0),
                      np.asarray(d.ar.weight),
                      _pad_to(np.asarray(d.ar.valid), N, 0))
        sw = _pad_to(np.broadcast_to(np.asarray(d.stance_w), (n, 4)), N, 0)
        q0p = np.asarray(q0)
        if q0p.shape[0] > N:
            raise ValueError(
                f"q0 length {q0p.shape[0]} exceeds the requested padded "
                f"size {N}; pass n_frames >= the longest trial")
        if q0p.shape[0] < N:
            q0p = np.concatenate(
                [q0p, np.tile(q0p[-1:], (N - q0p.shape[0], 1))])
        return KinematicData(
            meas=_pad_to(_pad_to(np.asarray(d.meas), N, 0), C, 1),
            weight=_pad_to(_pad_to(np.asarray(d.weight), N, 0), C, 1),
            cam=cam, h=np.asarray(d.h),
            acc_weight=np.asarray(d.acc_weight),
            frame_valid=_pad_to(np.asarray(d.frame_valid), N, 0),
            gmm=d.gmm, ar=ar, ground_z=np.asarray(d.ground_z, float),
            stance_w=sw), q0p

    prepped = [prep(d, q) for d, q in zip(datas, q0s)]

    def stack(*xs):
        return torch.as_tensor(np.stack([np.asarray(x) for x in xs]),
                               dtype=dtype, device=dev)

    leaves = [list(_leaves(p[0])) for p in prepped]
    stacked = [stack(*col) for col in zip(*leaves)]
    batched = _unflatten(prepped[0][0], iter(stacked))
    q0b = torch.as_tensor(np.stack([p[1] for p in prepped]), dtype=dtype,
                          device=dev)
    return batched, q0b


def _leaves(data):
    if isinstance(data, tuple) and hasattr(data, "_fields"):
        for x in data:
            yield from _leaves(x)
    else:
        yield data


def _unflatten(like, it):
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[_unflatten(x, it) for x in like])
    return next(it)


def _pick_restart(st, margin: float, R: int):
    """Per-trial restart selection from a state batched (R*B, ...) in
    restart-major order: restart 0 (unperturbed) unless an alternative beats
    it by more than ``margin``. Non-finite costs are demoted to +inf first,
    so a NaN unperturbed lane cannot win every comparison."""
    cost = st.cost.reshape(R, -1)
    cost = torch.where(torch.isfinite(cost), cost,
                       torch.full_like(cost, float("inf")))
    c0 = cost[0]
    alt = torch.argmin(cost[1:], dim=0) + 1
    c_alt = torch.gather(cost, 0, alt[None])[0]
    best = torch.where(c_alt < (1.0 - margin) * c0, alt, torch.zeros_like(alt))
    best = torch.where(torch.isinf(c0) & torch.isfinite(c_alt), alt, best)
    B = best.shape[0]
    lane = best * B + torch.arange(B, device=best.device)
    return type(st)(*[x[lane] for x in st])


def _perturbed(q0b: torch.Tensor, offs: Tuple[float, ...]) -> torch.Tensor:
    """The R heading-perturbed copies of q0b (B, N, 54), restart-major."""
    q0r = []
    for o in offs:
        q = q0b.clone()
        q[:, :, 5] += o
        q0r.append(q)
    return torch.cat(q0r)


def _repeat(batched: KinematicData, R: int) -> KinematicData:
    return map_data(lambda x: x.repeat((R,) + (1,) * (x.ndim - 1)), batched)


def make_multistart(run, offsets: Tuple[float, ...] = HEADING_RESTARTS,
                    margin: float = MULTISTART_MARGIN):
    """A multistart solver ``ms(q0b, batched)``: every trial of the batch
    solved in full by ``run`` (a batched solver, as returned by
    ``KinematicFTE.make_solver``) from each of the ``offsets`` heading
    perturbations, all R x B lanes as one batch, and the best restart kept
    per trial by the margin rule. ``offsets[0]`` must be the unperturbed
    0. Monocular problems only: multi-view solves are single-start."""
    offs = tuple(float(o) for o in offsets)
    R = len(offs)

    def solve_all(q0b: torch.Tensor, batched: KinematicData):
        return _pick_restart(run(_perturbed(q0b, offs), _repeat(batched, R)),
                             margin, R)

    return solve_all


def multistart(run, q0b: torch.Tensor, batched: KinematicData,
               offsets: Tuple[float, ...] = HEADING_RESTARTS,
               margin: float = MULTISTART_MARGIN):
    """One-shot :func:`make_multistart`."""
    return make_multistart(run, offsets, margin)(q0b, batched)


def multistart_single(run, q0: torch.Tensor, data: KinematicData,
                      offsets: Tuple[float, ...] = HEADING_RESTARTS,
                      margin: float = MULTISTART_MARGIN):
    """Single-trial multistart (the serial path): ``q0`` (N, 54) and
    ``data``, the trial's problem as a batch of one; the R restarts are one
    R-lane batch of the trial's own length. Returns the picked restart's
    state, with its batch axis of one."""
    return multistart(run, q0[None], data, offsets, margin)


def make_multistart_probe(probe_run, full_run,
                          offsets: Tuple[float, ...] = HEADING_RESTARTS,
                          margin: float = MULTISTART_MARGIN):
    """Demand-driven multistart: ``probe_run`` (a short fixed-length solve)
    runs every trial from every heading offset as one batch of R*B lanes,
    the winning restart per trial is picked by the margin rule, and
    ``full_run`` continues only the B winners from their probe states."""
    offs = tuple(float(o) for o in offsets)
    R = len(offs)

    def solve_all(q0b: torch.Tensor, batched: KinematicData):
        sel = _pick_restart(probe_run(_perturbed(q0b, offs),
                                      _repeat(batched, R)), margin, R)
        return full_run(sel.q, batched)

    return solve_all


def make_kinematic_multistart(fte, margin: float = MULTISTART_MARGIN,
                              linear_solver: Optional[str] = None):
    """The production monocular solver: probe-multistart over the default
    annealing schedule of ``KinematicFTE.make_solver`` (probe = its first
    stage as a fixed-length solve, full = the remaining stages)."""
    probe = fte.make_solver(stages=PROBE_STAGES, driver="scan",
                            linear_solver=linear_solver)
    full = fte.make_solver(stages=FULL_STAGES, linear_solver=linear_solver)
    return make_multistart_probe(probe, full, margin=margin)


def pad_and_stack_kinetic(kds, q_warms: Sequence[np.ndarray],
                          n_frames: Optional[int] = None,
                          n_cams: Optional[int] = None,
                          dtype: torch.dtype = torch.float32,
                          device: DeviceLike = None):
    """Stack per-trial physics problems (``solver.kinetic.KineticData``
    with numpy leaves) into one batch of tensors: the kinematic bases go
    through :func:`pad_and_stack`, the physics arrays are zero-padded on the
    frame axis (padded frames are masked by ``frame_valid`` in every
    kinetic term). Returns (batched KineticData, q_warm (B, N, 54))."""
    from ..dynamics.eom import N_TAU
    from ..solver.kinetic import KineticData

    dev = resolve_device(device)
    N = n_frames or max(kd.base.meas.shape[0] for kd in kds)
    base, q_warm = pad_and_stack([kd.base for kd in kds], q_warms,
                                 n_frames=N, n_cams=n_cams, dtype=dtype,
                                 device=dev)

    def stack(field, pad_frames=True):
        xs = [np.asarray(getattr(kd, field), float) for kd in kds]
        xs = [_pad_to(x, N, 0) if pad_frames else x.reshape(())
              for x in xs]
        return torch.as_tensor(np.stack(xs), dtype=dtype, device=dev)

    anchors = [_pad_to(np.broadcast_to(
        np.asarray(kd.tau_anchor, float).reshape(-1, N_TAU),
        (kd.base.meas.shape[0], N_TAU)), N, 0) for kd in kds]
    return KineticData(
        base=base, stance=stack("stance"), grf_fixed=stack("grf_fixed"),
        grf_xy_fixed=stack("grf_xy_fixed"),
        use_fixed_grf=stack("use_fixed_grf", False), q_warm=q_warm,
        tau_anchor=torch.as_tensor(np.stack(anchors), dtype=dtype,
                                   device=dev),
        tau_anchor_weight=stack("tau_anchor_weight", False),
        ground_z=stack("ground_z", False)), q_warm


# ---------------------------------------------------------------------------
# several devices: the trial mesh
# ---------------------------------------------------------------------------

Mesh = Tuple[torch.device, ...]


def trial_mesh(n_devices: Optional[int] = None,
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """1-D mesh over the trial (data-parallel) axis: ``devices`` (default:
    every CUDA device; raises without one), the first ``n_devices`` of
    them. A device may appear more than once (several shards on one
    card, or on the CPU)."""
    if devices is None:
        resolve_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(resolve_device(d) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a trial mesh needs at least one device")
    return devs


def _map_tree(fn: Callable, tree):
    """``fn`` on every leaf of a tree of NamedTuples, tuples, lists and
    dicts."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_tree(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip_tree(fn: Callable, trees: list):
    """``fn`` on the matching leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*[_zip_tree(fn, list(xs)) for xs in zip(*trees)])
    if isinstance(t, (tuple, list)):
        return type(t)(_zip_tree(fn, list(xs)) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _zip_tree(fn, [x[k] for x in trees]) for k in t}
    return fn(*trees)


def shard_batch(batch, mesh: Mesh) -> list:
    """One shard of ``batch`` per device of ``mesh``: every tensor (or
    numpy array) with a leading axis split into ``len(mesh)`` contiguous
    equal chunks, chunk i on ``mesh[i]`` (numpy chunks stay numpy); 0-dim
    tensors copied to every device, other leaves shared. The leading axis
    must divide by the mesh's size (``pipeline/batched._pad_group`` pads a
    group so)."""
    n = len(mesh)

    def split(x, i):
        if not (torch.is_tensor(x) or isinstance(x, np.ndarray)):
            return x
        if x.ndim == 0:
            return x.to(mesh[i]) if torch.is_tensor(x) else x
        if x.shape[0] % n:
            raise ValueError(f"a leading axis of {x.shape[0]} does not "
                             f"split over a mesh of {n}")
        k = x.shape[0] // n
        part = x[i * k:(i + 1) * k]
        return part.to(mesh[i]) if torch.is_tensor(part) else part

    return [_map_tree(lambda x, i=i: split(x, i), batch) for i in range(n)]


def gather(shards: list, device: DeviceLike = None):
    """The inverse of :func:`shard_batch` on the outputs of the shards (a
    list in mesh order): tensors concatenated on their leading axis on
    ``device`` (default: the first shard's), numpy arrays concatenated,
    0-dim tensors and other leaves taken from the first shard."""
    def cat(*xs):
        x = xs[0]
        if torch.is_tensor(x) and x.ndim:
            dev = x.device if device is None else device
            return torch.cat([y.to(dev) for y in xs])
        if isinstance(x, np.ndarray) and x.ndim:
            return np.concatenate(xs)
        return x

    return _zip_tree(cat, shards)


def _first_device(tree) -> Optional[torch.device]:
    found = []
    _map_tree(lambda x: found.append(x.device) if torch.is_tensor(x)
              else None, tree)
    return found[0] if found else None


def on_mesh(fn: Callable, mesh: Mesh, device: DeviceLike = None) -> Callable:
    """``fn`` (a batched function of trial-axis arguments, such as a
    solver) over the mesh: ``run(*args)`` shards every argument
    (:func:`shard_batch`), calls ``fn`` on each shard on its own host
    thread under ``torch.cuda.device`` of its device (so the kernel
    launches on that device's current stream), and gathers the outputs in
    lane order (:func:`gather`) on ``device`` (default: the first tensor
    argument's). A shard's exception is raised here."""
    def run(*args):
        shards = [shard_batch(a, mesh) for a in args]

        def one(i):
            d = mesh[i]
            ctx = torch.cuda.device(d) if d.type == "cuda" \
                else contextlib.nullcontext()
            with ctx:
                return fn(*[s[i] for s in shards])

        with ThreadPoolExecutor(len(mesh)) as pool:
            outs = list(pool.map(one, range(len(mesh))))
        home = device if device is not None else _first_device(args)
        return gather(outs, home)

    return run


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None,
                     verbose: bool = True) -> dict:
    """One short batched solve of each kind over an ``n_devices`` mesh
    (JAX ``__graft_entry__.dryrun_multichip``): ``n_devices`` procedural
    trials of 64 frames (``bench_lib.build_dryrun_problems``),
    the 6-camera multi-view kinematic solve (stages (10, 2), (1, 2)), the
    monocular data-driven solve (GMM and AR priors, base anchored to the
    warm start; the same stages) and the physics solve (stance over the
    middle third, GMM on, stage (1, 2)) from the data-driven solution,
    each sharded over the mesh (``devices``, default the CUDA devices).
    The means and maxima over the trials are taken on the host after the
    gather. Returns the three mean costs (raises if one is not finite)."""
    from ..models import params as params_mod
    from ..pipeline import bench_lib
    from ..pipeline.estimator import DD_BASE_ANCHOR
    from ..solver import kinematic as kin
    from ..solver import kinetic as kn

    mesh = trial_mesh(n_devices, devices)
    if len(mesh) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(mesh)}")
    home = mesh[0]
    subject = params_mod.get_subject("acinoset")
    n_frames = 64
    datas_mv, datas_mono, q0s = bench_lib.build_dryrun_problems(
        n_devices, n_frames=n_frames, device=home)
    stages = ((10.0, 2), (1.0, 2))
    out = {}

    def report(name, st):
        cost = st.cost.double().cpu().numpy()
        out[name] = float(cost.mean())
        if not np.isfinite(out[name]):
            raise AssertionError(f"dryrun_multichip: the {name} solve gave "
                                 f"non-finite costs {cost.tolist()}")
        if verbose:
            print(f"dryrun_multichip({n_devices}): {name} ok, mean cost "
                  f"{out[name]:.3f}, max lam "
                  f"{float(st.lam.max()):.3g}, on {[str(d) for d in mesh]}")

    bat_mv, q0b = pad_and_stack(datas_mv, q0s, n_frames=n_frames,
                                device=home)
    fte_mv = kin.KinematicFTE(kin.KinematicConfig(), subject)
    report("multi-view kinematic", on_mesh(
        fte_mv.make_solver(stages=stages), mesh)(q0b, bat_mv))
    bat_dd, qdb = pad_and_stack(datas_mono, q0s, n_frames=n_frames,
                                device=home)
    bat_dd = bat_dd._replace(base_ref=qdb[:, :, :6])
    fte_dd = kin.KinematicFTE(kin.KinematicConfig(
        use_gmm=True, use_ar=True, **DD_BASE_ANCHOR), subject)
    st_dd = on_mesh(fte_dd.make_solver(stages=stages), mesh)(qdb, bat_dd)
    report("monocular data-driven", st_dd)
    q_np = st_dd.q.double().cpu().numpy()
    kds, q_warms = [], []
    for i, d in enumerate(datas_mono):
        n = d.meas.shape[0]
        stance = np.zeros((n, 4))
        stance[n // 3: 2 * n // 3] = 1.0
        kds.append(kn.KineticData(
            base=d, stance=stance, grf_fixed=np.zeros((n, 4)),
            grf_xy_fixed=np.zeros((n, 4, 4)), use_fixed_grf=np.asarray(0.0),
            q_warm=q_np[i, :n], tau_anchor=np.zeros((1, kn.dyn.N_TAU)),
            tau_anchor_weight=np.asarray(0.0), ground_z=np.asarray(0.0)))
        q_warms.append(q_np[i, :n])
    kbat, qw = pad_and_stack_kinetic(kds, q_warms, n_frames=n_frames,
                                     device=home)
    kfte = kn.KineticFTE(kn.KineticConfig(use_gmm=True), subject)
    report("physics", on_mesh(kfte.make_solver(stages=((1.0, 2),)), mesh)(
        qw, kbat))
    return out
