"""AcinoSet interchange IO: scene calibration, metadata, DLC tables,
fte.pickle and per-camera 2D reprojection outputs.

Port of ``cheetah_pose_estimation_tpu/data/io.py`` without pandas, in the
same formats, so each package reads the other's trees:

* ``extrinsic_calib/N_cam_scene_sba.json``: camera intrinsics, distortion
  and extrinsics;
* ``metadata.json``: start/end frame, cam_sync offsets, ground plane height,
  monocular camera;
* DLC prediction tables ``dlc/cam*.csv`` with the 3-level column header
  (scorer, bodyparts, {x, y, likelihood}) that pandas writes for a
  MultiIndex: one header row per level, each headed by the level's name, the
  frame index in column 0, floats as ``repr`` and NaN as an empty field;
* ``fte.pickle`` with keys positions/x/dx/ddx/q/dq/ddq/com_pos/com_vel/tau/
  meas_err/obj_cost/processing_time_s/start_frame;
* ``cam<i>_fte.csv`` reprojections with the 2-level (bodyparts, coords)
  header (read back with :func:`load_reprojection_table`).

A trial's DLC tables are read as the JAX package reads them by default:
CSV tables by the C++ reader of ``native/`` (float32 pixels and
likelihoods, bit for bit JAX's read), and a directory that also holds
``.h5`` tables (a tree the JAX package wrote) exactly, in float64, from
their ``.csv`` siblings (JAX reads the ``.h5`` tables exactly, and the
``.csv`` holds the same values). ``load_dlc_points(..., use_native=False)``
always reads exactly, with the numpy reader (:func:`read_table`), as the
JAX package's pandas reader does.

The ``.h5`` forms are neither read nor written: there is no HDF5 reader
here. The JAX writer puts a ``.csv`` beside every ``.h5`` it writes, so its
trees are readable; a trial directory that holds only ``.h5`` tables raises.
"""
from __future__ import annotations

import csv
import json
import os
import pickle
from glob import glob
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..models.skeleton import MARKERS

# ---------------------------------------------------------------------------
# scene calibration
# ---------------------------------------------------------------------------


def load_scene(fpath: str):
    """(k_arr, d_arr, r_arr, t_arr, cam_res) from a scene json."""
    with open(fpath, "r", encoding="utf-8") as f:
        data = json.load(f)
    cam_res = tuple(data["camera_resolution"])
    k_arr = np.array([c["k"] for c in data["cameras"]], dtype=np.float64)
    d_arr = np.array([c["d"] for c in data["cameras"]], dtype=np.float64)
    r_arr = np.array([c["r"] for c in data["cameras"]], dtype=np.float64)
    t_arr = np.array([c["t"] for c in data["cameras"]], dtype=np.float64)
    return k_arr, d_arr, r_arr, t_arr, cam_res


def save_scene(fpath: str, k_arr, d_arr, r_arr, t_arr,
               cam_res: Tuple[int, int]):
    cams = []
    for k, d, r, t in zip(k_arr, d_arr, r_arr, t_arr):
        cams.append({
            "k": np.asarray(k).tolist(),
            "d": np.asarray(d).reshape(-1, 1).tolist(),
            "r": np.asarray(r).tolist(),
            "t": np.asarray(t).reshape(-1, 1).tolist(),
        })
    os.makedirs(os.path.dirname(fpath), exist_ok=True)
    with open(fpath, "w", encoding="utf-8") as f:
        json.dump({"camera_resolution": list(cam_res), "cameras": cams}, f)


def find_scene_file(dir_path: str, scene_fname: Optional[str] = None):
    """Walk up from dir_path looking for extrinsic_calib/N_cam_scene_sba.json.
    Returns (k, d, r, t, cam_res, n_cams, path)."""
    if scene_fname is None:
        n_cams = len(glob(os.path.join(dir_path, "cam[1-9].mp4")))
        scene_fname = (f"{n_cams}_cam_scene_sba.json" if n_cams
                       else "[1-9]_cam_scene*.json")
    path = dir_path
    while path and path != os.path.sep:
        pattern = os.path.join(path, "extrinsic_calib", scene_fname)
        candidates = sorted(
            p for p in glob(pattern)
            if "before_corrections" not in p or p == pattern)
        if candidates:
            fpath = candidates[-1]
            k, d, r, t, res = load_scene(fpath)
            n_cams = int(os.path.basename(fpath)[0])
            return k, d, r, t, res, n_cams, fpath
        parent = os.path.dirname(path)
        if parent == path:
            break
        path = parent
    raise FileNotFoundError(
        os.path.join("extrinsic_calib", str(scene_fname)))


# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

def load_metadata(data_dir: str) -> Dict:
    with open(os.path.join(data_dir, "metadata.json"), "r",
              encoding="utf-8") as f:
        return json.load(f)


def save_metadata(data_dir: str, start_frame: int, end_frame: int,
                  cam_sync: Optional[List[Dict]] = None,
                  ground_plane_height: float = 0.0,
                  monocular_cam: int = 0, **extra):
    os.makedirs(data_dir, exist_ok=True)
    meta = dict(start_frame=int(start_frame), end_frame=int(end_frame),
                cam_sync=cam_sync or [],
                ground_plane_height=float(ground_plane_height),
                monocular_cam=int(monocular_cam), **extra)
    with open(os.path.join(data_dir, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump(meta, f)


# ---------------------------------------------------------------------------
# CSV tables in pandas' MultiIndex layout
# ---------------------------------------------------------------------------

class Table(NamedTuple):
    """A table read from, or to be written as, a pandas-style CSV:
    ``index`` (n,) int, ``columns`` one tuple of level values per column,
    ``values`` (n, n_columns) float64 (NaN for empty fields), and the
    column levels' ``names``."""
    index: np.ndarray
    columns: List[Tuple[str, ...]]
    values: np.ndarray
    names: Tuple[str, ...]


def csv_float(v) -> str:
    """A float as pandas writes it to CSV: ``repr``, NaN (and None) as an
    empty field."""
    if v is None:
        return ""
    v = float(v)
    return "" if v != v else repr(v)


def write_table(fpath: str, table: Table) -> None:
    """Write ``table`` as ``DataFrame.to_csv`` does for named column levels
    and an unnamed integer index."""
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    with open(fpath, "w", encoding="utf-8", newline="") as f:
        for lev, name in enumerate(table.names):
            f.write(",".join([name] + [c[lev] for c in table.columns])
                    + "\n")
        for i, row in zip(table.index, np.asarray(table.values)):
            f.write(",".join([str(int(i))] + [csv_float(v) for v in row])
                    + "\n")


def read_table(fpath: str, n_levels: int) -> Table:
    """Read a CSV written as :func:`write_table` (or pandas) writes it, with
    ``n_levels`` header rows. Floats are parsed exactly."""
    with open(fpath, "r", encoding="utf-8", newline="") as f:
        rows = list(csv.reader(f))
    head, body = rows[:n_levels], [r for r in rows[n_levels:] if r]
    names = tuple(h[0] for h in head)
    columns = list(zip(*[h[1:] for h in head]))
    index = np.array([int(r[0]) for r in body], dtype=np.int64)
    values = np.array([[float(v) if v != "" else np.nan for v in r[1:]]
                       for r in body], dtype=np.float64).reshape(
                           len(body), len(columns))
    return Table(index, columns, values, names)


# ---------------------------------------------------------------------------
# DLC prediction tables
# ---------------------------------------------------------------------------

DLC_SCORER = "cheetah_tpu"
DLC_LEVELS = ("scorer", "bodyparts", "coords")
XYL = ("x", "y", "likelihood")


def save_dlc_table(fpath: str, xy: np.ndarray, likelihood: np.ndarray,
                   bodyparts: Sequence[str] = MARKERS,
                   scorer: str = DLC_SCORER, start_frame: int = 0):
    """Write a DLC-style prediction table, xy (n_frames, L, 2) and
    likelihood (n_frames, L), as ``<fpath without extension>.csv``."""
    n = xy.shape[0]
    data = np.concatenate([np.asarray(xy, np.float64),
                           np.asarray(likelihood, np.float64)[..., None]],
                          axis=2)
    cols = [(scorer, bp, c) for bp in bodyparts for c in XYL]
    write_table(os.path.splitext(fpath)[0] + ".csv",
                Table(np.arange(start_frame, start_frame + n), cols,
                      data.reshape(n, -1), DLC_LEVELS))


def _no_h5(path: str):
    raise NotImplementedError(
        f"{path}: .h5 tables need an HDF5 reader, which this package does "
        "not have; write the tables as .csv (the JAX package writes one "
        "beside every .h5)")


def load_dlc_table(fpath: str) -> Table:
    """Load a DLC table from its CSV form (a ``.h5`` path reads the
    ``.csv`` beside it, and raises when there is none)."""
    base, ext = os.path.splitext(fpath)
    if ext == ".h5":
        if not os.path.exists(base + ".csv"):
            _no_h5(fpath)
        fpath = base + ".csv"
    return read_table(fpath, 3)


def load_dlc_points(dlc_dir: str, n_cams: Optional[int] = None,
                    use_native: bool = True):
    """All per-camera DLC tables of a trial as arrays.

    Returns (xy (n_frames, C, L, 2), likelihood (n_frames, C, L),
    bodyparts). Table rows are aligned on the frame index (missing frames
    NaN / likelihood 0). CSV-only directories go through the threaded C++
    reader (``native.load_tables``, float32 values; it raises when it
    cannot be built); with ``use_native=False``, or beside ``.h5`` tables
    (which the JAX package reads exactly instead of its CSV tables),
    through the exact numpy reader."""
    paths = sorted(glob(os.path.join(dlc_dir, "*.csv")))
    h5 = sorted(glob(os.path.join(dlc_dir, "*.h5")))
    if not paths and h5:
        _no_h5(h5[0])
    if n_cams is not None:
        assert len(paths) == n_cams, (len(paths), n_cams)
    if use_native and paths and not h5:
        return _load_dlc_points_native(paths)
    tables = [load_dlc_table(p) for p in paths]
    bodyparts = list(dict.fromkeys(c[1] for c in tables[0].columns))
    n_frames = max(int(t.index.max()) for t in tables) + 1
    C, L = len(tables), len(bodyparts)
    xy = np.full((n_frames, C, L, 2), np.nan)
    lik = np.zeros((n_frames, C, L))
    for c, t in enumerate(tables):
        col = {k[1:]: j for j, k in enumerate(t.columns)}
        for l, bp in enumerate(bodyparts):
            xy[t.index, c, l, 0] = t.values[:, col[(bp, "x")]]
            xy[t.index, c, l, 1] = t.values[:, col[(bp, "y")]]
            lik[t.index, c, l] = t.values[:, col[(bp, "likelihood")]]
    return xy, lik, bodyparts


def _load_dlc_points_native(paths: List[str]):
    """The tables at ``paths`` through the C++ reader, on one thread per
    table; the body parts from the first table's header."""
    from .. import native

    tables = native.load_tables(paths)
    with open(paths[0], "r", encoding="utf-8") as f:
        header = [f.readline() for _ in range(2)]
    bp_line = header[1] if header[0].lower().startswith("scorer") \
        else header[0]
    bodyparts = list(dict.fromkeys(
        c for c in bp_line.strip().split(",")[1:] if c))
    n_frames = max(int(idx.max()) for _, _, idx in tables) + 1
    C, L = len(tables), len(bodyparts)
    xy = np.full((n_frames, C, L, 2), np.nan)
    lik = np.zeros((n_frames, C, L))
    for c, (xy_t, lik_t, idx) in enumerate(tables):
        xy[idx, c] = xy_t
        lik[idx, c] = lik_t
    return xy, lik, bodyparts


# ---------------------------------------------------------------------------
# fte.pickle + reprojections
# ---------------------------------------------------------------------------

def save_fte_pickle(out_fpath: str, positions: np.ndarray, *, x, dx, ddx, q,
                    dq, ddq, com_pos, com_vel, tau: Dict, meas_err,
                    obj_cost: float, processing_time_s: float,
                    start_frame: int):
    """Write the fte.pickle schema of the JAX package (and the reference)."""
    payload = dict(
        positions=np.asarray(positions), x=np.asarray(x), dx=np.asarray(dx),
        ddx=np.asarray(ddx), q=np.asarray(q), dq=np.asarray(dq),
        ddq=np.asarray(ddq), com_pos=np.asarray(com_pos),
        com_vel=np.asarray(com_vel), tau=tau,
        meas_err=np.asarray(meas_err), obj_cost=obj_cost,
        processing_time_s=processing_time_s, start_frame=int(start_frame))
    os.makedirs(os.path.dirname(out_fpath), exist_ok=True)
    with open(out_fpath, "wb") as f:
        pickle.dump(payload, f)


def load_fte_pickle(fpath: str) -> Dict:
    with open(fpath, "rb") as f:
        return pickle.load(f)


def save_3d_cheetah_as_2d(positions_3d_arr: Sequence[np.ndarray],
                          out_dir: str, k_arr, d_arr, r_arr, t_arr,
                          cam_res, project_func, start_frame: int,
                          sync_offset_arr: Optional[List[int]] = None,
                          bodyparts: Sequence[str] = MARKERS,
                          out_fname: str = "fte"):
    """Per-camera 2D reprojection tables ``cam<i>_<out_fname>.csv`` in DLC
    format (likelihood empty), out-of-frame points NaN."""
    os.makedirs(out_dir, exist_ok=True)
    n_cams = len(k_arr)
    sync = sync_offset_arr or [0] * n_cams
    cols = [(bp, c) for bp in bodyparts for c in XYL]
    for i in range(n_cams):
        pos3d = np.asarray(positions_3d_arr[i])
        n_frames = len(pos3d)
        proj = np.asarray(project_func(
            pos3d.reshape(-1, 3), k_arr[i], d_arr[i], r_arr[i],
            t_arr[i])).reshape(n_frames, -1, 2)
        oob = ((proj > np.asarray(cam_res)[None, None, :])
               | (proj < 0)).any(axis=2)
        proj = np.where(oob[..., None], np.nan, proj)
        data = np.full((n_frames, len(bodyparts), 3), np.nan)
        data[:, :, :2] = proj
        write_table(os.path.join(out_dir, f"cam{i + 1}_{out_fname}.csv"),
                    Table(np.arange(start_frame - sync[i],
                                    start_frame + n_frames - sync[i]),
                          cols, data.reshape(n_frames, -1),
                          ("bodyparts", "coords")))


def load_reprojection_table(fpath: str) -> Table:
    """A ``cam<i>_<name>.csv`` reprojection table (2-level header); a
    ``.h5`` path reads the ``.csv`` beside it, and raises when there is
    none."""
    base, ext = os.path.splitext(fpath)
    if ext == ".h5":
        if not os.path.exists(base + ".csv"):
            _no_h5(fpath)
        fpath = base + ".csv"
    return read_table(fpath, 2)
