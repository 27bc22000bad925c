"""Pickle and dill helpers, the windowed supervised table, and the prior
cache's location.

Port of ``cheetah_pose_estimation_tpu/utils/data_ops.py`` without pandas:
:func:`series_to_supervised` returns its table's values, column names and
row index as arrays. ``dill`` is imported only by the two functions that
need it, as in the JAX package, and they raise where it is not installed.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, List, NamedTuple, Optional

import numpy as np


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_dill(path: str) -> Any:
    import dill
    with open(path, "rb") as f:
        return dill.load(f)


def save_dill(path: str, obj: Any) -> None:
    import dill
    with open(path, "wb") as f:
        dill.dump(obj, f)


class SupervisedTable(NamedTuple):
    """What the JAX function's DataFrame holds: ``values`` (rows, (n_in +
    1) d), the integer column names ``columns`` 0 .. (n_in + 1) d - 1 and
    the row ``index``, the target's position in its series."""
    values: np.ndarray
    columns: List[int]
    index: np.ndarray


def series_to_supervised(data, n_in: int = 1, n_step: int = 1
                         ) -> SupervisedTable:
    """Sliding-window supervised table: per target time t (from n_in n_step
    on) the columns [x(t - n_in s), ..., x(t - s), x(t)], s = n_step. The
    row index is t, so a segment boundary shows as index == n_in s."""
    X = np.asarray(data)
    if X.ndim == 1:
        X = X[:, None]
    n = X.shape[0]
    first = n_in * n_step
    cols = [X[first - lag * n_step: n - lag * n_step]
            for lag in range(n_in, 0, -1)]
    values = np.concatenate(cols + [X[first:]], axis=1)
    return SupervisedTable(values, list(range(values.shape[1])),
                           np.arange(first, n))


def prior_cache_dir(dataset_path: str) -> Optional[str]:
    """Where the priors trained on ``dataset_path`` are cached: the
    dataset's own directory when it is writable, else nowhere (None: the
    priors are trained on every call). The JAX package falls back to a
    directory under the home directory instead; the port writes nothing
    outside the dataset's directory. The cache files carry the port's own
    names, so neither package reads a fit the other made."""
    d = os.path.dirname(os.path.abspath(dataset_path))
    return d if os.access(d, os.W_OK) else None
