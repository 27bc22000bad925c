"""Training-data plumbing for the learned priors.

Port of ``cheetah_pose_estimation_tpu/priors/dataset.py``. A pose table is
28 pose columns (``POSE_COLUMNS``) of concatenated segments, each segment
delimited by an index that resets to 0. The JAX loader reads it with
pandas; here the CSV form is read and written with numpy (the port runs
without pandas), and the ``.h5`` form is not read yet.
"""
from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np

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
    """Read a pose table written as CSV (a header row, then the index column
    and the pose columns, as ``pandas.DataFrame.to_csv`` writes them)."""
    if os.path.splitext(path)[1] != ".csv":
        raise NotImplementedError(
            f"{path}: only the CSV form of a pose dataset is read")
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
    it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
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
