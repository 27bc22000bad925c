"""AcinoSet interchange IO: scene calibration, metadata, DLC tables,
fte.pickle and per-camera 2D reprojection outputs.

Port of ``cheetah_pose_estimation_tpu/data/io.py`` without pandas, in the
same formats, so each package reads the other's trees:

* ``extrinsic_calib/N_cam_scene_sba.json``: camera intrinsics, distortion
  and extrinsics;
* ``metadata.json``: start/end frame, cam_sync offsets, ground plane height,
  monocular camera;
* DLC prediction tables ``dlc/cam*.h5`` and ``dlc/cam*.csv`` with the
  3-level columns (scorer, bodyparts, {x, y, likelihood}); as CSV, the
  header that pandas writes for a MultiIndex: one header row per level,
  each headed by the level's name, the frame index in column 0, floats as
  ``repr`` and NaN as an empty field;
* ``fte.pickle`` with keys positions/x/dx/ddx/q/dq/ddq/com_pos/com_vel/tau/
  meas_err/obj_cost/processing_time_s/start_frame;
* ``cam<i>_fte.csv`` reprojections with the 2-level (bodyparts, coords)
  header (read back with :func:`load_reprojection_table`).

The trees the port writes hold CSV tables only (the JAX package writes a
``.h5`` beside each): its JAX references were solved on CSV-only trees.

The ``.h5`` forms are read and written by :mod:`.hdf5` (numpy, ``struct``
and ``zlib``; no h5py, PyTables or pandas): :func:`load_pandas_h5` reads
pandas' PyTables "table" format (DeepLabCut's predictions, the reference's
pose datasets) and its "fixed" format, :func:`write_pandas_h5` writes the
"table" format as the JAX package does.

A trial's DLC tables are read as the JAX package reads them: ``.h5``
tables first where the directory holds any (exactly, in float64; a
directory with both forms reads the ``.h5``, whose values a JAX tree's
``.csv`` siblings hold too), else the CSV tables, by the C++ reader of
``native/`` (float32 pixels and likelihoods, bit for bit JAX's default
read) or, with ``load_dlc_points(..., use_native=False)``, exactly by the
numpy reader (:func:`read_table`), as the JAX package's pandas reader
reads them. A ``.h5`` path whose file does not exist reads the ``.csv``
beside it; one that exists and fails to read raises (the JAX package falls
back to the ``.csv`` on any error instead; here a reader fault cannot
hide).
"""
from __future__ import annotations

import csv
import json
import os
import pickle
from glob import glob
from io import BytesIO
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


def _label_tuple(c) -> tuple:
    """A column label as the JAX reader decodes it: bytes to str, inside
    a tuple too; a flat label as a 1-tuple."""
    dec = lambda x: x.decode() if isinstance(x, bytes) else x
    return tuple(dec(x) for x in c) if isinstance(c, tuple) else (dec(c),)


class _LabelUnpickler(pickle.Unpickler):
    """Unpickles column labels and nothing else: builtin containers,
    strings and numbers, and numpy scalars (labels of a numpy dtype)."""
    ALLOWED = {("builtins", "list"), ("builtins", "tuple"),
               ("_codecs", "encode"),
               ("numpy.core.multiarray", "scalar"),
               ("numpy._core.multiarray", "scalar"), ("numpy", "dtype")}

    def find_class(self, module, name):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(
                f"column labels may not hold {module}.{name}")
        return super().find_class(module, name)


def load_pandas_h5(fpath: str) -> Table:
    """A pandas-written HDF5 table (JAX ``data/io.py:155-200``), read by
    :mod:`.hdf5`: the PyTables "table" format (``<key>/table``, a compound
    dataset of ``index`` and ``values_block_*`` fields, the column labels
    pickled in the group's ``non_index_axes``) that DeepLabCut and the
    reference's datasets use, and the "fixed" format (``axis0`` or
    ``axis0_level*``/``axis0_label*``, ``axis1``, ``block0_values``). The
    first key of the file is read. Labels are decoded as the JAX reader
    decodes them; 3-level labels get the DLC level names, others empty
    names. Only ``non_index_axes`` is unpickled, and only into labels
    (:class:`_LabelUnpickler`)."""
    from . import hdf5

    with hdf5.File(fpath) as f:
        g = f[f.keys()[0]]
        if "table" in g:
            t = g["table"][...]
            index = t["index"]
            values = np.concatenate(
                [t[n].reshape(len(t), -1) for n in t.dtype.names
                 if n.startswith("values")], axis=1)
            raw = g.attrs["non_index_axes"]
            cols = _LabelUnpickler(BytesIO(bytes(raw))).load()[0][1]
        else:
            index = g["axis1"][...]
            values = g["block0_values"][...]
            nlev = sum(1 for k in g.keys() if k.startswith("axis0_level"))
            if nlev:
                levels = [[_label_tuple(v)[0]
                           for v in g[f"axis0_level{i}"][...]]
                          for i in range(nlev)]
                labels = [g[f"axis0_label{i}"][...] for i in range(nlev)]
                cols = [tuple(levels[i][labels[i][j]] for i in range(nlev))
                        for j in range(len(labels[0]))]
            else:
                cols = list(g["axis0"][...])
    columns = [_label_tuple(c) for c in cols]
    nlev = len(columns[0]) if columns else 1
    names = DLC_LEVELS if nlev == 3 else ("",) * nlev
    return Table(np.array(index), columns, values, names)


def write_pandas_h5(fpath: str, table: Table,
                    key: str = "df_with_missing") -> None:
    """Write ``table`` in pandas' PyTables "table" layout as the JAX package
    writes it (JAX ``data/io.py:125-153``): group ``key`` with the pandas
    attributes (labels pickled, protocol 0, into ``non_index_axes``), and
    a contiguous compound dataset ``table`` of ``index`` (int64) and
    ``values_block_0`` (float64, one entry per column)."""
    from . import hdf5

    values = np.asarray(table.values, np.float64)
    n = len(table.index)
    arr = np.empty(n, [("index", "<i8"),
                       ("values_block_0", "<f8", (values.shape[1],))])
    arr["index"] = np.asarray(table.index, np.int64)
    arr["values_block_0"] = values.reshape(n, -1)
    cols = [c if len(c) > 1 else c[0] for c in table.columns]
    attrs = {
        "pandas_type": np.bytes_(b"frame_table"),
        "table_type": np.bytes_(b"appendable_frame"),
        "levels": np.int64(len(table.names)),
        "non_index_axes": np.bytes_(pickle.dumps([(1, cols)], protocol=0)),
        "index_cols": np.bytes_(pickle.dumps([(0, "index")], protocol=0)),
        "encoding": np.bytes_(b"UTF-8")}
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    hdf5.write(fpath, hdf5.H5Group(
        {key: hdf5.H5Group({"table": hdf5.H5Dataset(arr)}, attrs)}))


def save_dlc_table(fpath: str, xy: np.ndarray, likelihood: np.ndarray,
                   bodyparts: Sequence[str] = MARKERS,
                   scorer: str = DLC_SCORER, start_frame: int = 0):
    """Write a DLC-style prediction table, xy (n_frames, L, 2) and
    likelihood (n_frames, L). A ``.h5`` path writes the ``.h5`` and the
    ``.csv`` beside it (as JAX's ``save_dlc_table`` does); any other path
    writes ``<fpath without extension>.csv`` alone."""
    n = xy.shape[0]
    data = np.concatenate([np.asarray(xy, np.float64),
                           np.asarray(likelihood, np.float64)[..., None]],
                          axis=2)
    cols = [(scorer, bp, c) for bp in bodyparts for c in XYL]
    table = Table(np.arange(start_frame, start_frame + n), cols,
                  data.reshape(n, -1), DLC_LEVELS)
    base, ext = os.path.splitext(fpath)
    if ext == ".h5":
        write_pandas_h5(fpath, table)
    write_table(base + ".csv", table)


def h5_or_csv(fpath: str) -> Tuple[str, bool]:
    """Which form of a table to read: (path, whether it is a ``.h5``). A
    ``.h5`` path is read when its file exists, else the ``.csv`` beside it
    (a ``.h5`` that exists and fails to read raises: no CSV hides a reader
    fault); any other path as it is."""
    base, ext = os.path.splitext(fpath)
    if ext != ".h5":
        return fpath, False
    return (fpath, True) if os.path.exists(fpath) else (base + ".csv", False)


def load_dlc_table(fpath: str) -> Table:
    """Load a DLC table: a ``.h5`` that exists through
    :func:`load_pandas_h5`, else the CSV (a ``.h5`` path whose file does not
    exist reads the ``.csv`` beside it)."""
    path, h5 = h5_or_csv(fpath)
    return load_pandas_h5(path) if h5 else read_table(path, 3)


def load_dlc_points(dlc_dir: str, n_cams: Optional[int] = None,
                    use_native: bool = True):
    """All per-camera DLC tables of a trial as arrays.

    Returns (xy (n_frames, C, L, 2), likelihood (n_frames, C, L),
    bodyparts). Table rows are aligned on the frame index (missing frames
    NaN / likelihood 0). The directory's ``.h5`` tables where it holds any
    (read exactly), else its CSV tables: through the threaded C++ reader
    (``native.load_tables``, float32 values; it raises when it cannot be
    built), or with ``use_native=False`` through the exact numpy
    reader."""
    paths = sorted(glob(os.path.join(dlc_dir, "*.h5"))) \
        or sorted(glob(os.path.join(dlc_dir, "*.csv")))
    if n_cams is not None:
        assert len(paths) == n_cams, (len(paths), n_cams)
    if use_native and paths and paths[0].endswith(".csv"):
        return _load_dlc_points_native(paths)
    tables = [load_dlc_table(p) for p in paths]
    bodyparts = list(dict.fromkeys(c[1] for c in tables[0].columns))
    n_frames = max(int(t.index.max()) for t in tables) + 1
    C, L = len(tables), len(bodyparts)
    xy = np.full((n_frames, C, L, 2), np.nan)
    lik = np.zeros((n_frames, C, L))
    for c, t in enumerate(tables):
        col = {k[1:]: j for j, k in enumerate(t.columns)}
        idx = t.index.astype(int)
        for l, bp in enumerate(bodyparts):
            xy[idx, c, l, 0] = t.values[:, col[(bp, "x")]]
            xy[idx, c, l, 1] = t.values[:, col[(bp, "y")]]
            lik[idx, c, l] = t.values[:, col[(bp, "likelihood")]]
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
    """A ``cam<i>_<name>`` reprojection table (2-level columns): a ``.h5``
    that exists through :func:`load_pandas_h5`, else the CSV (a ``.h5``
    path whose file does not exist reads the ``.csv`` beside it)."""
    path, h5 = h5_or_csv(fpath)
    return load_pandas_h5(path) if h5 else read_table(path, 2)
