"""Force-plate tables (``grf/data_synth.csv``, ``grf/data.csv``).

Port of ``cheetah_pose_estimation_tpu/pipeline/grf_io.py`` in the CSV form
that the JAX writer writes beside every ``.h5`` table: a header
``force_plate,frame,Fx,Fy,Fz`` and one row per (plate, frame), the plates in
ascending order, the values formatted as numpy formats float64 scalars.
The port writes that file byte for byte; it has no HDF5 reader or writer,
so a ``.h5`` path raises.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..data.io import _no_h5

HEADER = "force_plate,frame,Fx,Fy,Fz"


def _csv_path(path: str) -> str:
    if os.path.splitext(path)[1] == ".h5":
        _no_h5(path)
    return path


def save_force_plate_df(path: str, frames: Dict[int, np.ndarray]) -> None:
    """frames: {force_plate_index: (n_frames, 3) Fx, Fy, Fz}."""
    path = _csv_path(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for plate in sorted(frames):
            F = np.asarray(frames[plate], dtype=np.float64)
            for fr in range(F.shape[0]):
                f.write(f"{np.int64(plate)},{np.int64(fr)},{F[fr, 0]},"
                        f"{F[fr, 1]},{F[fr, 2]}\n")


def load_force_plate_df(path: str) -> Dict[int, np.ndarray]:
    """{force_plate_index: (n_frames, 3)}, each plate's rows in frame
    order."""
    path = _csv_path(path)
    with open(path, encoding="utf-8") as f:
        header = f.readline().strip()
        if header != HEADER:
            raise ValueError(f"{path}: header {header!r}, expected "
                             f"{HEADER!r}")
        rows = [ln.split(",") for ln in f.read().splitlines() if ln]
    plates = np.array([int(r[0]) for r in rows], np.int64)
    frames = np.array([int(r[1]) for r in rows], np.int64)
    vals = np.array([[float(x) for x in r[2:5]] for r in rows],
                    np.float64).reshape(-1, 3)
    out: Dict[int, np.ndarray] = {}
    for plate in np.unique(plates):
        sel = plates == plate
        out[int(plate)] = vals[sel][np.argsort(frames[sel], kind="stable")]
    return out
