"""Force-plate tables (``grf/data_synth.h5``, ``grf/data.h5`` and their
``.csv`` siblings).

Port of ``cheetah_pose_estimation_tpu/pipeline/grf_io.py``. The ``.h5``
form is the JAX package's (and the reference's, pandas' PyTables "table"
format): a compound dataset ``force_plate_data_df/table`` of fields
``index``, ``values_block_0`` (Fx, Fy, Fz), ``frame`` and ``force_plate``
with the ``CLASS``, ``NROWS`` and ``FIELD_i_NAME`` attributes, read and
written by ``data/hdf5``. The ``.csv`` form is the sibling the JAX writer
writes beside it: a header ``force_plate,frame,Fx,Fy,Fz`` and one row per
(plate, frame), the plates in ascending order, the values formatted as
numpy formats float64 scalars. A ``.h5`` path writes both forms; a ``.csv``
path writes the CSV alone (the port's own trees hold CSV tables only). A
``.h5`` path reads the ``.h5`` when it exists, else the ``.csv`` beside
it.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..data import hdf5
from ..data.io import h5_or_csv

KEY = "force_plate_data_df"
HEADER = "force_plate,frame,Fx,Fy,Fz"
FIELDS = ("index", "values_block_0", "frame", "force_plate")


def _rows(frames: Dict[int, np.ndarray]) -> np.ndarray:
    rows = [(0, F, fr, plate) for plate in sorted(frames)
            for fr, F in enumerate(np.asarray(frames[plate], np.float64))]
    table = np.array(rows, dtype=[("index", "<i8"),
                                  ("values_block_0", "<f8", (3,)),
                                  ("frame", "<i8"), ("force_plate", "<i8")])
    table["index"] = np.arange(len(table))
    return table


def save_force_plate_df(path: str, frames: Dict[int, np.ndarray]) -> None:
    """frames: {force_plate_index: (n_frames, 3) Fx, Fy, Fz}."""
    table = _rows(frames)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    base, ext = os.path.splitext(path)
    if ext == ".h5":
        attrs = {"CLASS": np.bytes_(b"TABLE"),
                 "NROWS": np.int64(len(table))}
        attrs.update({f"FIELD_{i}_NAME": np.bytes_(n.encode())
                      for i, n in enumerate(FIELDS)})
        hdf5.write(path, hdf5.H5Group({KEY: hdf5.H5Group(
            {"table": hdf5.H5Dataset(table, attrs)})}))
    with open(base + ".csv" if ext == ".h5" else path, "w") as f:
        f.write(HEADER + "\n")
        for r in table:
            F = r["values_block_0"]
            f.write(f"{r['force_plate']},{r['frame']},{F[0]},{F[1]},"
                    f"{F[2]}\n")


def load_force_plate_df(path: str) -> Dict[int, np.ndarray]:
    """{force_plate_index: (n_frames, 3)}, each plate's rows in frame
    order."""
    path, h5 = h5_or_csv(path)
    if h5:
        with hdf5.File(path) as f:
            table = f[KEY]["table"][...]
        plates, frames = table["force_plate"], table["frame"]
        vals = table["values_block_0"]
    else:
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
