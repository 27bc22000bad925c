"""Write the HDF5 fixtures of ``tests/data/h5/`` and record what chip_smoke
phase 19 ("h5") and ``tests/test_torch_hdf5.py`` /
``tests/test_torch_grf_parity.py`` hold the port to, on the host CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/data/jax_h5_reference.py

(~40 s, most of it JAX's eager force solve.) The fixtures, written with
h5py and the JAX package's writers (``FIXTURES``):

* ``dlc_jax.h5``, ``force_plate_jax.h5``, ``pose_jax.h5``: the JAX
  writers' files (``save_dlc_table``, ``grf_io.save_force_plate_df``,
  ``_write_pandas_h5_table`` of a pose table): contiguous compound tables;
* ``dlc_chunked.h5``: a DLC table laid out as PyTables lays one out: a
  chunked compound table with ``maxshape=(None,)``, chunks of 7 rows that
  do not divide its 20, PyTables' and pandas' attributes on the group and
  the table (enough to put them in a continuation block), then grown to 23
  rows: its last chunk unallocated, read as the fill value it sets;
* ``dlc_gzip.h5``, ``dlc_shuffle_gzip.h5``, ``dlc_fletcher32.h5``: the same
  table with those filters;
* ``dlc_big_endian.h5``: the table with big-endian index and values;
* ``dlc_fixed_levels.h5``, ``pose_fixed_flat.h5``: pandas' "fixed" format
  with ``axis0_level*``/``axis0_label*`` and with plain ``axis0``;
* ``generic_v1.h5``: superblock version 1 (a non-default chunk B-tree K),
  4-byte offsets and lengths, a 512-byte user block; a group of 12 members,
  compact, scalar and string datasets, a compound with padding and mixed
  byte orders, a 2-D chunked dataset with edge chunks in both dimensions,
  a 1-D one of 150 chunks (a two-level chunk B-tree), float16, array and
  non-ASCII-named attributes, and a variable-length string attribute
  (which the port raises on when asked for it).

Recorded in ``tests/data/jax_h5_f64.json``:

* ``fixtures``: per file, every object as h5py reads it (each dataset's and
  attribute's ``chip_smoke.array_digest``), and the JAX readers' tables
  (``load_pandas_h5`` and ``grf_io.load_force_plate_df``:
  ``chip_smoke.table_digest``);
* ``grf_parity``: the JAX package's ``grf_parity`` rows, float64, on the
  2-trial 16-frame tree of ``chip_smoke.write_reference_tree``;
* ``ref_tree``: the JAX ``load_reference_trajectories`` (with and without
  the force-plate trials), ``reference_trial_paths`` and
  ``_reference_gt_trajectory`` of the test trials on that tree.
"""
import ctypes
import glob
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)
OUT_DIR = os.path.join(HERE, "h5")
OUT_JSON = os.path.join(HERE, "jax_h5_f64.json")
N_ROWS, CHUNK, GROWN = 20, 7, 23


def dlc_frame(seed=0):
    """A 20-frame DLC table (24 markers) as the JAX package builds one, a
    NaN in it."""
    from cheetah_pose_estimation_tpu.models.skeleton import MARKERS

    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 2000, (N_ROWS, len(MARKERS), 2))
    xy[3, 4] = np.nan
    return xy, rng.uniform(size=(N_ROWS, len(MARKERS))), MARKERS


def dlc_columns():
    from cheetah_pose_estimation_tpu.data.io import DLC_SCORER
    from cheetah_pose_estimation_tpu.models.skeleton import MARKERS

    return [(DLC_SCORER, m, c) for m in MARKERS
            for c in ("x", "y", "likelihood")]


def dlc_records(order="<"):
    xy, lik, _ = dlc_frame()
    values = np.concatenate([xy, lik[..., None]], axis=2).reshape(N_ROWS, -1)
    arr = np.empty(N_ROWS, [("index", order + "i8"),
                            ("values_block_0", order + "f8",
                             (values.shape[1],))])
    arr["index"] = np.arange(5, 5 + N_ROWS)
    arr["values_block_0"] = values
    return arr


def pandas_group_attrs(g, cols):
    """pandas' and PyTables' attributes of a "table" format group."""
    p = lambda v: np.bytes_(pickle.dumps(v, protocol=0))
    for k, v in (("TITLE", b""), ("CLASS", b"GROUP"), ("VERSION", b"1.0"),
                 ("pandas_type", b"frame_table"), ("pandas_version",
                                                   b"0.15.2"),
                 ("encoding", b"UTF-8"), ("errors", b"strict"),
                 ("table_type", b"appendable_frame"), ("nan_rep", b"nan")):
        g.attrs[k] = np.bytes_(v)
    g.attrs["levels"] = np.int64(3)
    g.attrs["index_cols"] = p([(0, "index")])
    g.attrs["values_cols"] = p(["values_block_0"])
    g.attrs["non_index_axes"] = p([(1, cols)])
    g.attrs["data_columns"] = p([])
    g.attrs["info"] = p({1: {"names": ["scorer", "bodyparts", "coords"],
                             "type": "MultiIndex"}, "index": {}})


def table_attrs(ds, cols, n):
    for k, v in (("CLASS", b"TABLE"), ("VERSION", b"2.7"), ("TITLE", b""),
                 ("FIELD_0_NAME", b"index"),
                 ("FIELD_1_NAME", b"values_block_0"),
                 ("index_kind", b"integer"),
                 ("values_block_0_dtype", b"float64"),
                 ("values_block_0_kind", pickle.dumps(cols, protocol=0)),
                 ("values_block_0_meta", b"N."), ("index_meta", b"N."),
                 ("values_block_0_encoding", b"UTF-8")):
        ds.attrs[k] = np.bytes_(v)
    ds.attrs["FIELD_0_FILL"] = np.int64(0)
    ds.attrs["FIELD_1_FILL"] = np.float64(0.0)
    ds.attrs["NROWS"] = np.int64(n)
    ds.attrs["AUTO_INDEX"] = np.uint8(1)


def pytables_like(path, order="<", grow=False, **filters):
    import h5py

    arr = dlc_records(order)
    cols = dlc_columns()
    with h5py.File(path, "w") as f:
        g = f.create_group("df_with_missing")
        pandas_group_attrs(g, cols)
        kw = dict(chunks=(CHUNK,), maxshape=(None,)) if grow or filters \
            else {}
        if grow:
            fill = np.zeros((), arr.dtype)
            fill["index"] = -1
            fill["values_block_0"] = np.nan
            kw["fillvalue"] = fill
        ds = g.create_dataset("table", data=arr, **kw, **filters)
        table_attrs(ds, cols, GROWN if grow else N_ROWS)
        if grow:
            ds.resize((GROWN,))


def fixed_format(path, levels):
    """pandas' "fixed" format: a DLC frame with 3-level columns
    (``axis0_level*``/``axis0_label*``), or a pose frame with plain
    ``axis0``."""
    import h5py

    from cheetah_pose_estimation_tpu.priors.dataset import POSE_COLUMNS

    with h5py.File(path, "w") as f:
        g = f.create_group("df" if levels else "pose")
        for k, v in (("pandas_type", b"frame"), ("pandas_version", b"0.15.2"),
                     ("encoding", b"UTF-8"), ("errors", b"strict")):
            g.attrs[k] = np.bytes_(v)
        g.attrs["ndim"] = np.int64(2)
        g.attrs["nblocks"] = np.int64(1)
        if levels:
            cols = dlc_columns()
            values = dlc_records()["values_block_0"]
            g.attrs["axis0_variety"] = np.bytes_(b"multi")
            g.attrs["axis0_nlevels"] = np.int64(3)
            for i in range(3):
                lev = sorted({c[i] for c in cols})
                g.create_dataset(f"axis0_level{i}",
                                 data=np.array(lev, dtype="S"))
                g.create_dataset(f"axis0_label{i}", data=np.array(
                    [lev.index(c[i]) for c in cols], np.int8))
            g.create_dataset("axis1", data=np.arange(5, 5 + N_ROWS))
        else:
            rng = np.random.default_rng(3)
            values = rng.normal(size=(30, len(POSE_COLUMNS)))
            g.attrs["axis0_variety"] = np.bytes_(b"regular")
            g.create_dataset("axis0", data=np.array(POSE_COLUMNS, "S"))
            g.create_dataset("block0_items",
                             data=np.array(POSE_COLUMNS, "S"))
            g.create_dataset("axis1", data=np.r_[np.arange(12),
                                                 np.arange(18)])
        g.create_dataset("block0_values", data=values)


def generic_v1(path):
    import h5py

    fcpl = h5py.h5p.create(h5py.h5p.FILE_CREATE)
    fcpl.set_sizes(4, 4)
    fcpl.set_userblock(512)
    # a chunk B-tree K other than 32 makes HDF5 write superblock version 1;
    # h5py does not bind H5Pset_istore_k, its HDF5 library does
    lib = ctypes.CDLL(glob.glob(os.path.join(
        os.path.dirname(h5py.__file__), "..", "h5py.libs", "libhdf5-*"))[0])
    lib.H5Pset_istore_k.argtypes = (ctypes.c_int64, ctypes.c_uint)
    if lib.H5Pset_istore_k(fcpl.id, 16) < 0:
        raise RuntimeError("H5Pset_istore_k failed")
    fid = h5py.h5f.create(path.encode(), h5py.h5f.ACC_TRUNC, fcpl=fcpl)
    rng = np.random.default_rng(7)
    with h5py.File(fid) as f:
        many = f.create_group("many")
        for i in range(12):
            many.create_dataset(f"m{i:02d}", data=np.arange(i + 1,
                                                            dtype="<u2"))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        data = np.array([3, -1, 4, -1, 5], "<i2")
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.py_create(data.dtype),
                             h5py.h5s.create_simple((5,)), dcpl=dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)
        f.create_dataset("scalar", data=np.float32(2.5))
        f.create_dataset("strings", data=np.array([b"a", b"bb", b"ccc",
                                                   b"dddd"], "S8"))
        padded = np.dtype({"names": ["a", "b", "c"],
                           "formats": ["<i2", ">f8", "S3"],
                           "offsets": [0, 8, 16], "itemsize": 24})
        rec = np.zeros(5, padded)
        rec["a"], rec["b"] = np.arange(5), rng.normal(size=5)
        rec["c"] = [b"x", b"yy", b"zzz", b"", b"w"]
        f.create_dataset("padded", data=rec)
        f.create_dataset("grid", data=rng.normal(size=(13, 9)),
                         chunks=(4, 4), compression="gzip")
        f.create_dataset("long", data=np.arange(300, dtype="<i4"),
                         chunks=(2,))
        f.create_dataset("halfs", data=rng.normal(size=6).astype("<f2"))
        f.create_dataset("big", data=np.arange(4, dtype=">i8"))
        f.create_dataset("bytes", data=np.arange(7, dtype="u1"))
        f["grid"].attrs["scale"] = np.array([0.5, 2.0])
        f["grid"].attrs["größe"] = np.int32(3)
        f.attrs["note"] = "variable-length"
        f.attrs["vec"] = np.arange(3, dtype="<f4")


def write_fixtures(out_dir=OUT_DIR):
    """Write every fixture into ``out_dir``."""
    from cheetah_pose_estimation_tpu.data import io as jio
    from cheetah_pose_estimation_tpu.pipeline import grf_io as jgrf
    from cheetah_pose_estimation_tpu.priors.dataset import POSE_COLUMNS

    import pandas as pd

    os.makedirs(out_dir, exist_ok=True)
    xy, lik, markers = dlc_frame()
    jio.save_dlc_table(os.path.join(out_dir, "dlc_jax.h5"), xy, lik,
                       start_frame=5, write_csv=False)
    rng = np.random.default_rng(1)
    with tempfile.TemporaryDirectory() as tmp:
        jgrf.save_force_plate_df(os.path.join(tmp, "grf", "data.h5"), {
            0: rng.normal(size=(12, 3)), 2: rng.normal(size=(9, 3))})
        os.replace(os.path.join(tmp, "grf", "data.h5"),
                   os.path.join(out_dir, "force_plate_jax.h5"))
    pose = pd.DataFrame(rng.normal(size=(30, len(POSE_COLUMNS))),
                        columns=POSE_COLUMNS,
                        index=np.r_[np.arange(12), np.arange(18)])
    jio._write_pandas_h5_table(os.path.join(out_dir, "pose_jax.h5"), pose)
    pytables_like(os.path.join(out_dir, "dlc_chunked.h5"), grow=True)
    pytables_like(os.path.join(out_dir, "dlc_gzip.h5"), compression="gzip",
                  compression_opts=4)
    pytables_like(os.path.join(out_dir, "dlc_shuffle_gzip.h5"),
                  compression="gzip", shuffle=True)
    pytables_like(os.path.join(out_dir, "dlc_fletcher32.h5"),
                  fletcher32=True)
    pytables_like(os.path.join(out_dir, "dlc_big_endian.h5"), order=">")
    fixed_format(os.path.join(out_dir, "dlc_fixed_levels.h5"), levels=True)
    fixed_format(os.path.join(out_dir, "pose_fixed_flat.h5"), levels=False)
    generic_v1(os.path.join(out_dir, "generic_v1.h5"))


FIXTURES = ("dlc_jax.h5", "force_plate_jax.h5", "pose_jax.h5",
            "dlc_chunked.h5", "dlc_gzip.h5", "dlc_shuffle_gzip.h5",
            "dlc_fletcher32.h5", "dlc_big_endian.h5", "dlc_fixed_levels.h5",
            "pose_fixed_flat.h5", "generic_v1.h5")
PANDAS = tuple(n for n in FIXTURES if n.startswith(("dlc", "pose")))


def attr_record(v):
    if isinstance(v, str):
        return {"str": v}
    from chip_smoke import array_digest

    return array_digest(np.asarray(v))


def h5py_objects(path):
    """Every object of a file as h5py reads it: kind, attributes and (for
    a dataset) the data, as ``chip_smoke.array_digest``."""
    import h5py

    from chip_smoke import array_digest

    out = {}

    def visit(name, obj):
        rec = {"kind": "dataset" if isinstance(obj, h5py.Dataset)
               else "group",
               "attrs": {k: attr_record(v) for k, v in obj.attrs.items()}}
        if rec["kind"] == "dataset":
            rec["data"] = array_digest(obj[()])
        out[name] = rec

    with h5py.File(path, "r") as f:
        visit("/", f)
        f.visititems(visit)
    return out


def record_fixtures(out_dir=OUT_DIR):
    from chip_smoke import array_digest, table_digest

    from cheetah_pose_estimation_tpu.data import io as jio
    from cheetah_pose_estimation_tpu.pipeline import grf_io as jgrf

    rec = {}
    for name in FIXTURES:
        path = os.path.join(out_dir, name)
        r = {"bytes": os.path.getsize(path), "objects": h5py_objects(path)}
        if name in PANDAS:
            df = jio.load_pandas_h5(path)
            r["table"] = table_digest(
                df.index.to_numpy(),
                [c if isinstance(c, tuple) else (c,) for c in df.columns],
                df.to_numpy())
        if name == "force_plate_jax.h5":
            r["force_plates"] = {str(k): array_digest(v) for k, v in
                                 jgrf.load_force_plate_df(path).items()}
        rec[name] = r
    return rec


def record_reference_tree():
    """The JAX package's grf_parity rows and reference-tree loaders on
    ``chip_smoke.write_reference_tree``'s tree, float64."""
    import jax

    jax.config.update("jax_enable_x64", True)
    from chip_smoke import array_digest, write_reference_tree

    from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
    from cheetah_pose_estimation_tpu.pipeline import grf_parity as jgp
    from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd

    with tempfile.TemporaryDirectory() as root:
        write_reference_tree(root)
        t0 = time.time()
        df = jgp.grf_parity(out_csv=None,
                            root=os.path.join(root, "kinetic_dataset"),
                            verbose=False)
        wall = time.time() - t0
        rows = [{k: (v if isinstance(v, str) else None if np.isnan(v)
                     else float(v) if isinstance(v, float) else int(v))
                 for k, v in r.items()} for r in df.to_dict("records")]
        jbl.REF_TEST_SET = jrd.REF_TEST_SET = root

        def trajs(**kw):
            return [[s, fps, array_digest(q)] for q, s, fps in
                    jbl.load_reference_trajectories(**kw)]

        gt = {}
        for i, (cheetah, date, trial) in enumerate(jrd.TEST_SET[:3]):
            gt["/".join((date, cheetah, trial))] = array_digest(
                jrd._reference_gt_trajectory(date, cheetah, trial,
                                             40 + 2 * i, i))
        for i, (cheetah, date, trial) in enumerate(jrd.KINETIC_SET[:3]):
            d = os.path.join("kinetic_dataset", date)
            gt["/".join((d, cheetah, f"trial{trial}"))] = array_digest(
                jrd._reference_gt_trajectory(d, cheetah, f"trial{trial}",
                                             50, 100 + i, 200.0))
        tree = {"trajectories": trajs(),
                "trajectories_kinetic": trajs(include_kinetic=True),
                "trial_paths": jbl.reference_trial_paths(),
                "gt": gt}
    return {"rows": rows, "jax_wall_s": wall}, tree


def main():
    import h5py

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.time()
    write_fixtures()
    out = {"meta": {"h5py": h5py.__version__,
                    "hdf5": h5py.version.hdf5_version,
                    "jax": jax.__version__},
           "fixtures": record_fixtures()}
    out["grf_parity"], out["ref_tree"] = record_reference_tree()
    out["meta"]["wall_s"] = time.time() - t0
    with open(OUT_JSON, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    total = sum(r["bytes"] for r in out["fixtures"].values())
    print(f"wrote {len(FIXTURES)} fixtures ({total} B) and {OUT_JSON} in "
          f"{out['meta']['wall_s']:.1f} s")


if __name__ == "__main__":
    main()
