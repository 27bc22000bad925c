"""Pickle helpers and the prior cache's location.

Port of ``load_pickle``, ``save_pickle`` and ``prior_cache_dir`` of
``cheetah_pose_estimation_tpu/utils/data_ops.py``.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Optional


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def prior_cache_dir(dataset_path: str) -> Optional[str]:
    """Where the priors trained on ``dataset_path`` are cached: the
    dataset's own directory when it is writable, else nowhere (None: the
    priors are trained on every call). The JAX package falls back to a
    directory under the home directory instead; the port writes nothing
    outside the dataset's directory. The cache files carry the port's own
    names, so neither package reads a fit the other made."""
    d = os.path.dirname(os.path.abspath(dataset_path))
    return d if os.access(d, os.W_OK) else None
