"""Training-data plumbing for the learned priors.

Port of ``cheetah_pose_estimation_tpu/priors/dataset.py``. A pose table is
28 pose columns (``POSE_COLUMNS``) of concatenated segments, each segment
delimited by an index that resets to 0. The JAX loader reads it with
pandas; here the ``.h5`` form (pandas' PyTables tables, as the reference
ships ``dataset_full_pose.h5``) through ``data/io.load_pandas_h5`` and the
CSV form with numpy (the port runs without pandas).
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np

from ..data import io
from ..data.io import csv_float

POSE_COLUMNS = [
    "base_x", "base_y", "base_z", "base_phi", "base_theta", "base_psi",
    "bodyF_phi", "bodyF_theta", "bodyF_psi", "neck_phi", "neck_theta",
    "neck_psi", "tail0_theta", "tail0_psi", "tail1_theta", "tail1_psi",
    "ufl_theta", "lfl_theta", "hfl_theta", "ufr_theta", "lfr_theta",
    "hfr_theta", "ubl_theta", "lbl_theta", "ubr_theta", "lbr_theta",
    "hbl_theta", "hbr_theta",
]


class PoseTable(NamedTuple):
    """The rows of a pose dataset: ``index`` (n,) restarts at 0 on every
    segment, ``data`` (n, len(columns)) float64."""
    index: np.ndarray
    data: np.ndarray
    columns: Tuple[str, ...] = tuple(POSE_COLUMNS)


def load_pose_dataset(path: str) -> PoseTable:
    """Read a pose table (JAX ``dataset.py:27-41``): a ``.h5`` (pandas'
    HDF5 "table" or "fixed" format) through ``data/io.load_pandas_h5``, or
    a CSV (a header row, then the index column and the pose columns, as
    ``pandas.DataFrame.to_csv`` writes them). A ``.h5`` path whose file does
    not exist reads the ``.csv`` beside it; one that exists and fails to
    read raises."""
    path, h5 = io.h5_or_csv(path)
    if h5:
        t = io.load_pandas_h5(path)
        return PoseTable(index=np.asarray(t.index, np.int64),
                         data=np.asarray(t.values, np.float64),
                         columns=tuple(str(c[0]) for c in t.columns))
    if os.path.splitext(path)[1] != ".csv":
        raise NotImplementedError(
            f"{path}: a pose dataset is read from .h5 or .csv")
    with open(path, encoding="utf-8") as f:
        header = f.readline().rstrip("\r\n").split(",")
    rows = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                      ndmin=2)
    return PoseTable(index=rows[:, 0].astype(np.int64), data=rows[:, 1:],
                     columns=tuple(header[1:]))


def save_pose_dataset(path: str, table: PoseTable) -> None:
    """Write a pose table as CSV, as ``pandas.DataFrame.to_csv`` writes the
    JAX package's frame (a header row with an empty first field, then the
    index and the pose columns; floats as ``repr``), so both packages read
    it. A ``.h5`` path writes the ``.h5`` in pandas' "table" format
    (``data/io.write_pandas_h5``) and the ``.csv`` beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    base, ext = os.path.splitext(path)
    if ext == ".h5":
        io.write_pandas_h5(path, io.Table(
            np.asarray(table.index, np.int64),
            [(c,) for c in table.columns],
            np.asarray(table.data, np.float64), ("",)))
        path = base + ".csv"
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(",".join([""] + list(table.columns)) + "\n")
        for i, row in zip(table.index, np.asarray(table.data, np.float64)):
            f.write(",".join([str(int(i))] + [csv_float(v) for v in row])
                    + "\n")


def segment_bounds(index: np.ndarray) -> List[Tuple[int, int]]:
    """Split on index resets to 0 (multi-run concatenation)."""
    starts = np.where(np.asarray(index) == 0)[0]
    if len(starts) == 0:
        return [(0, len(index))]
    bounds = [(int(a), int(b)) for a, b in zip(starts, starts[1:])]
    bounds.append((int(starts[-1]), len(index)))
    return bounds


def series_to_supervised(X: np.ndarray, n_in: int,
                         n_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding-window supervised table for one contiguous segment.

    Row for target time t (t from n_in*n_step to len-1):
      features = [x[t - n_in*n_step], ..., x[t - n_step]], target = x[t].

    Returns (features (m, d*n_in), targets (m, d)).
    """
    X = np.asarray(X)
    n, d = X.shape
    first = n_in * n_step
    if n <= first:
        return np.empty((0, d * n_in)), np.empty((0, d))
    rows = [X[first - lag * n_step: n - lag * n_step]
            for lag in range(n_in, 0, -1)]
    return np.concatenate(rows, axis=1), X[first:]


def windowed_dataset(data: np.ndarray, index: np.ndarray, n_in: int,
                     n_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """series_to_supervised per segment, concatenated."""
    Xs, ys = [], []
    for a, b in segment_bounds(index):
        f, t = series_to_supervised(data[a:b], n_in, n_step)
        Xs.append(f)
        ys.append(t)
    return np.concatenate(Xs, axis=0), np.concatenate(ys, axis=0)
