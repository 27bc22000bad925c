"""Pickle helpers.

Port of ``load_pickle`` and ``save_pickle`` of
``cheetah_pose_estimation_tpu/utils/data_ops.py``.
"""
from __future__ import annotations

import pickle
from typing import Any


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
