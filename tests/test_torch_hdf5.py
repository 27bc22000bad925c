"""The port's HDF5 reader and writer (``data/hdf5``) and the ``.h5`` forms of
its tables against h5py and the JAX package's readers, on the CPU.

The fixtures of ``tests/data/h5/`` (``tests/data/jax_h5_reference.py``:
the JAX writers' files, PyTables-like chunked tables with gzip,
shuffle+gzip and fletcher32, a continuation block and unallocated chunks,
big-endian values, pandas' "fixed" format, a superblock-1 file with 4-byte
offsets and a user block) must read bit for bit as h5py and the JAX
readers read them, here and as ``tests/data/jax_h5_f64.json`` recorded
(phase 19 of ``chip_smoke.py`` holds the card's reads to that record). The
port's written ``.h5`` files must read in h5py and in the JAX readers as
the JAX writers' do. What the reader does not read raises
``NotImplementedError`` naming it; a ``.h5`` that exists and fails to read
never falls back to its ``.csv``.
"""
import json
import os
import pickle
import shutil
import struct
import sys

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests", "data"))

import chip_smoke  # noqa: E402
import jax_h5_reference as ref_script  # noqa: E402
from cheetah_pose_estimation_tpu.data import io as jio  # noqa: E402
from cheetah_pose_estimation_tpu.pipeline import contacts as jcontacts  # noqa: E402,E501
from cheetah_pose_estimation_tpu.pipeline import grf_io as jgrf  # noqa: E402
from cheetah_pose_estimation_tpu.priors import dataset as jds  # noqa: E402
from cheetah_pose_estimation_tpu_torch.data import hdf5  # noqa: E402
from cheetah_pose_estimation_tpu_torch.data import io as tio  # noqa: E402
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.models import params as tparams  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib  # noqa: E402
from cheetah_pose_estimation_tpu_torch.pipeline import contacts as tcontacts  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.pipeline import grf_io as tgrf  # noqa: E402,E501
from cheetah_pose_estimation_tpu_torch.priors import dataset as tds  # noqa: E402,E501

torch.set_num_threads(1)
FIXTURES = os.path.join(REPO, "tests", "data", "h5")
with open(os.path.join(REPO, "tests", "data", "jax_h5_f64.json"),
          encoding="utf-8") as _f:
    RECORD = json.load(_f)["fixtures"]


def live_record(name):
    """What h5py and the JAX readers read of a fixture now, recorded as
    ``jax_h5_reference.py`` records it."""
    path = os.path.join(FIXTURES, name)
    r = {"bytes": os.path.getsize(path),
         "objects": ref_script.h5py_objects(path)}
    if name in ref_script.PANDAS:
        df = jio.load_pandas_h5(path)
        r["table"] = chip_smoke.table_digest(
            df.index.to_numpy(),
            [c if isinstance(c, tuple) else (c,) for c in df.columns],
            df.to_numpy())
    if name == "force_plate_jax.h5":
        r["force_plates"] = {str(k): chip_smoke.array_digest(v) for k, v in
                             jgrf.load_force_plate_df(path).items()}
    return r


@pytest.mark.parametrize("name", ref_script.FIXTURES)
def test_fixture_reads_bit_for_bit(name):
    live = live_record(name)
    # the record phase 19 holds the card to is what h5py and JAX read here
    assert live == RECORD[name]
    secs, bad = chip_smoke.h5_fixture_check({name: live})
    assert not bad, bad


def test_fixture_features():
    """The fixtures hold what they are meant to exercise."""
    f = hdf5.File(os.path.join(FIXTURES, "dlc_chunked.h5"))
    t = f["df_with_missing/table"]
    raw_count = f._u(f._at(t.addr) + 2, 2)
    assert raw_count > len(t._msgs)                  # a continuation
    assert t.chunks == (7,) and t.shape == (23,)
    assert t[...]["index"][-3:].tolist() == [-1, -1, -1]
    f = hdf5.File(os.path.join(FIXTURES, "generic_v1.h5"))
    assert f._buf[512 + 8] == 1 and (f._so, f._sl, f._base) == (4, 4, 512)
    long_ = f["long"]
    assert f._buf[f._at(long_._btree) + 5] == 1      # two-level chunk tree
    assert f["compact"].layout == 0 and len(f["many"].keys()) == 12
    assert [fid for fid, _ in hdf5.File(os.path.join(
        FIXTURES, "dlc_shuffle_gzip.h5"))["df_with_missing/table"]
        .filters] == [2, 1]


def _same_h5py(a, b):
    """Two files hold the same objects, attributes and data for h5py."""
    ra, rb = ref_script.h5py_objects(a), ref_script.h5py_objects(b)
    assert ra == rb


@pytest.mark.parametrize("kind", ["dlc", "force_plate", "pose"])
def test_writer_matches_jax_writer(tmp_path, kind):
    """h5py and the JAX readers read the port's ``.h5`` as the JAX
    writer's; the ``.csv`` siblings are byte for byte the same."""
    j, t = tmp_path / "jax", tmp_path / "port"
    rng = np.random.default_rng(4)
    if kind == "dlc":
        xy, lik = rng.uniform(0, 2000, (9, 24, 2)), rng.uniform(size=(9, 24))
        xy[2, 5] = np.nan
        jio.save_dlc_table(str(j / "cam1.h5"), xy, lik, start_frame=3)
        tio.save_dlc_table(str(t / "cam1.h5"), xy, lik, start_frame=3)
        a, b = jio.load_pandas_h5(str(j / "cam1.h5")), \
            jio.load_pandas_h5(str(t / "cam1.h5"))
        assert a.equals(b) and list(a.columns) == list(b.columns)
        c = tio.load_dlc_table(str(t / "cam1.h5"))
        assert np.array_equal(c.values, a.to_numpy(), equal_nan=True)
        assert c.names == ("scorer", "bodyparts", "coords")
        name = "cam1"
    elif kind == "force_plate":
        frames = {0: rng.normal(size=(6, 3)), 3: rng.normal(size=(4, 3))}
        jgrf.save_force_plate_df(str(j / "grf" / "data.h5"), frames)
        tgrf.save_force_plate_df(str(t / "grf" / "data.h5"), frames)
        a = jgrf.load_force_plate_df(str(j / "grf" / "data.h5"))
        b = jgrf.load_force_plate_df(str(t / "grf" / "data.h5"))
        c = tgrf.load_force_plate_df(str(t / "grf" / "data.h5"))
        assert a.keys() == b.keys() == c.keys()
        assert all(np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k])
                   for k in a)
        j, t, name = j / "grf", t / "grf", "data"
    else:
        import pandas as pd

        tab = bench_lib.procedural_pose_table((100,), n_frames=30)
        df = pd.DataFrame(tab.data, columns=list(tab.columns),
                          index=tab.index)
        os.makedirs(j)
        jio._write_pandas_h5_table(str(j / "pose.h5"), df)
        df.to_csv(str(j / "pose.csv"))
        tds.save_pose_dataset(str(t / "pose.h5"), tab)
        a = jds.load_pose_dataset(str(j / "pose.h5"))
        b = jds.load_pose_dataset(str(t / "pose.h5"))
        assert a.equals(b) and list(a.columns) == list(b.columns)
        c = tds.load_pose_dataset(str(t / "pose.h5"))
        assert np.array_equal(c.data, a.to_numpy())
        assert np.array_equal(c.index, a.index.to_numpy())
        name = "pose"
    _same_h5py(str(j / f"{name}.h5"), str(t / f"{name}.h5"))
    assert (j / f"{name}.csv").read_bytes() == (t / f"{name}.csv").read_bytes()


def test_writer_general_tree(tmp_path):
    """Nested groups, scalar and array attributes, byte strings, a
    compound of scalars (version 1) and one with an array member, both
    byte orders, an empty dataset: h5py reads what was written."""
    rec = np.zeros(4, [("a", "<i4"), ("b", ">f8"), ("s", "S5")])
    rec["a"], rec["b"], rec["s"] = [1, 2, 3, 4], [.5, -1, 2e300, 0], b"ab"
    arr = np.zeros(3, [("i", "<u2"), ("v", "<f4", (2, 3))])
    arr["v"] = np.arange(18).reshape(3, 2, 3)
    data = {"rec": rec, "arr": arr, "grid": np.arange(12.).reshape(3, 4),
            "be": np.arange(5, dtype=">i8"), "empty": np.zeros(0, "<f8"),
            "scalar": np.array(7, "<u1")}
    root = hdf5.H5Group({
        "g": hdf5.H5Group({k: hdf5.H5Dataset(v, {"k": np.int16(i)})
                           for i, (k, v) in enumerate(data.items())},
                          {"title": np.bytes_(b"x"),
                           "vec": np.arange(3.0)}),
        "h": hdf5.H5Group({})}, {"top": np.float32(1.5)})
    path = str(tmp_path / "t.h5")
    hdf5.write(path, root)
    with h5py.File(path, "r") as f:
        assert sorted(f) == ["g", "h"] and f.attrs["top"] == np.float32(1.5)
        assert f["g"].attrs["title"] == b"x"
        assert np.array_equal(f["g"].attrs["vec"], np.arange(3.0))
        for i, (k, v) in enumerate(data.items()):
            got = f["g"][k][()]
            assert chip_smoke.array_digest(got) == \
                chip_smoke.array_digest(v), k
            assert f["g"][k].attrs["k"] == i
    port = hdf5.File(path)
    for k, v in data.items():
        assert chip_smoke.array_digest(port["g"][k][()]) == \
            chip_smoke.array_digest(v), k
    with pytest.raises(TypeError, match="pass byte strings"):
        hdf5.write(path, hdf5.H5Group({}, {"s": np.array(["x"])}))
    with pytest.raises(ValueError, match="at most 8"):
        hdf5.write(path, hdf5.H5Group({str(i): hdf5.H5Group({})
                                       for i in range(9)}))


def _unsupported(path, case):
    if case == "superblock version 3":
        with h5py.File(path, "w", libver="latest") as f:
            f["x"] = np.arange(3)
    elif case == "superblock version 2":
        with h5py.File(path, "w", libver=("v108", "v108")) as f:
            f["x"] = np.arange(3)
    elif case == "version-2 object header":
        with h5py.File(path, "w", track_order=True) as f:
            f["x"] = np.arange(3)
    elif case == "filter 32000":
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(30.0), chunks=(10,),
                             compression="lzf")
    elif case == "filter 6 (scale-offset)":
        with h5py.File(path, "w") as f:
            f.create_dataset("x", data=np.arange(30), chunks=(10,),
                             scaleoffset=0)
    elif case == "enumerated datatype (class 8)":
        with h5py.File(path, "w") as f:
            f["x"] = np.array([True, False])
    elif case == "variable-length datatype (class 9)":
        with h5py.File(path, "w") as f:
            f["x"] = np.array(["a", "bb"], dtype=h5py.string_dtype())


@pytest.mark.parametrize("case", [
    "superblock version 3", "superblock version 2", "version-2 object header",
    "filter 32000", "filter 6 (scale-offset)",
    "enumerated datatype (class 8)", "variable-length datatype (class 9)"])
def test_unsupported_raises_naming_it(tmp_path, case):
    path = str(tmp_path / "x.h5")
    _unsupported(path, case)
    with pytest.raises(NotImplementedError, match=case.replace(
            "(", r"\(").replace(")", r"\)")):
        hdf5.File(path)["x"][...]


def _attr_v(name, value, ver):
    """An attribute message body of version 2 or 3 (no padding; version 3
    with the name's character set)."""
    arr = np.asarray(value)
    raw = name.encode() + b"\0"
    dt, sp = hdf5._encode_dtype(arr.dtype), hdf5._encode_space(arr.shape)
    head = struct.pack("<BBHHH", ver, 0, len(raw), len(dt), len(sp))
    if ver == 3:
        head += b"\1"
    return head + raw + dt + sp + arr.tobytes()


def _dtype_v3(dt):
    """A version-3 datatype message: compound members without padding,
    offsets in as few bytes as the size needs, arrays of version 3."""
    if dt.subdtype is not None:
        base, dims = dt.subdtype
        return struct.pack("<B3sIB", 0x3A, b"\0\0\0", dt.itemsize,
                           len(dims)) + struct.pack(f"<{len(dims)}I", *dims) \
            + _dtype_v3(base)
    if not dt.names:
        return hdf5._encode_dtype(dt)
    nb = int(np.log2(dt.itemsize)) // 8 + 1
    out = struct.pack("<BHxI", 0x36, len(dt.names), dt.itemsize)
    for n in dt.names:
        fdt, off = dt.fields[n][:2]
        out += n.encode() + b"\0" + off.to_bytes(nb, "little") \
            + _dtype_v3(fdt)
    return out


def test_later_message_versions(tmp_path):
    """Attribute messages of versions 2 and 3 and a compound (version 3)
    with an array member (version 3), patched in place over a written
    file's messages: the port reads what h5py reads."""
    path = str(tmp_path / "v.h5")
    arr = np.zeros(3, [("index", "<i8"), ("values", "<f8", (4,))])
    arr["index"], arr["values"] = [4, 5, 6], np.arange(12.).reshape(3, 4)
    hdf5.write(path, hdf5.H5Group({"t": hdf5.H5Dataset(arr, {
        "a2": np.int64(11), "a3": np.arange(3, dtype="<i4")})}))
    f = hdf5.File(path)
    buf = bytearray(f._buf)
    names = iter(("a2", "a3"))
    for t, _, p, n in f["t"]._msgs:
        if t == 12:
            name = next(names)
            body = _attr_v(name, f["t"].attrs[name], 2 if name == "a2"
                           else 3)
        elif t == 3:
            body = _dtype_v3(arr.dtype)
        else:
            continue
        assert len(body) <= n
        buf[p:p + n] = body.ljust(n, b"\0")
    with open(path, "wb") as fh:
        fh.write(bytes(buf))
    g = hdf5.File(path)["t"]
    assert [g.file._buf[p] >> (4 if t == 3 else 0) for t, _, p, _ in
            g._msgs if t in (3, 12)] == [3, 2, 3]
    with h5py.File(path, "r") as h:
        assert chip_smoke.array_digest(h["t"][()]) == \
            chip_smoke.array_digest(g[()]) == chip_smoke.array_digest(arr)
        for k in ("a2", "a3"):
            assert chip_smoke.array_digest(h["t"].attrs[k]) == \
                chip_smoke.array_digest(g.attrs[k])


def test_fletcher32_checksum_is_verified(tmp_path):
    path = tmp_path / "f.h5"
    shutil.copy(os.path.join(FIXTURES, "dlc_fletcher32.h5"), path)
    ds = hdf5.File(str(path))["df_with_missing/table"]
    _, _, _, addr = next(ds._chunk_index(ds._btree))
    buf = bytearray(path.read_bytes())
    buf[ds.file._at(addr) + 100] ^= 1
    path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="fletcher32"):
        hdf5.File(str(path))["df_with_missing/table"][...]


def test_labels_unpickle_no_globals(tmp_path):
    """``load_pandas_h5`` unpickles column labels only."""
    path = str(tmp_path / "evil.h5")
    arr = np.zeros(2, [("index", "<i8"), ("values_block_0", "<f8", (1,))])

    class Evil:
        def __reduce__(self):
            return (os.getcwd, ())

    hdf5.write(path, hdf5.H5Group({"df": hdf5.H5Group(
        {"table": hdf5.H5Dataset(arr)},
        {"non_index_axes": np.bytes_(pickle.dumps([(1, [Evil()])], 0))})}))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        tio.load_pandas_h5(path)


def _trial(root, n=12, seed=1):
    subject = tparams.get_subject("acinoset")
    tr = tsyn.synthesize(tsyn.gallop_trajectory(n, seed=seed), subject,
                         seed=seed)
    tsyn.write_trial_dir(tr, str(root), "trial_a", monocular_cam=1)
    return os.path.join(str(root), "trial_a", "dlc")


def test_h5_only_trial_dir_loads(tmp_path):
    """An ``.h5``-only trial directory (the port's writer, CSVs removed)
    reads as JAX reads it, as the exact CSV read, and through
    ``init_trajectory``."""
    from cheetah_pose_estimation_tpu.data import io as jdio
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator

    dlc = _trial(tmp_path)
    exact = tio.load_dlc_points(dlc, use_native=False)
    for csv in sorted(os.listdir(dlc)):
        tio.write_pandas_h5(os.path.join(dlc, csv[:-4] + ".h5"),
                            tio.load_dlc_table(os.path.join(dlc, csv)))
        os.remove(os.path.join(dlc, csv))
    port = tio.load_dlc_points(dlc, 6)
    jax_ = jdio.load_dlc_points(dlc, 6)
    for a, b, c in zip(port[:2], jax_[:2], exact[:2]):
        assert np.array_equal(a, b, equal_nan=True)
        assert np.array_equal(a, c, equal_nan=True)
    assert port[2] == list(jax_[2]) == exact[2]
    est = estimator.init_trajectory(str(tmp_path), "trial_a", "acinoset")
    assert est.xy.shape == (12, 6, 24, 2) and np.isfinite(est.xy).all()


def test_both_forms_read_the_h5_and_a_bad_h5_raises(tmp_path):
    """Beside its ``.csv`` the ``.h5`` is read (the values of a JAX tree's
    two forms are the same); a ``.h5`` that exists and fails to read
    raises, where the JAX reader falls back to the ``.csv``."""
    dlc = _trial(tmp_path)
    csv = os.path.join(dlc, "cam1.csv")
    tab = tio.load_dlc_table(csv)
    tio.write_pandas_h5(os.path.join(dlc, "cam1.h5"), tab._replace(
        values=tab.values + 1.0))
    assert np.array_equal(tio.load_dlc_table(os.path.join(
        dlc, "cam1.h5")).values, tab.values + 1.0, equal_nan=True)
    with open(os.path.join(dlc, "cam1.h5"), "r+b") as f:
        f.truncate(600)
    with pytest.raises(Exception) as e:
        tio.load_dlc_table(os.path.join(dlc, "cam1.h5"))
    assert not isinstance(e.value, AssertionError)
    assert jio.load_dlc_table(os.path.join(dlc, "cam1.h5")).shape == \
        tab.values.shape                                # JAX: the CSV


@pytest.mark.parametrize("what", ["dlc", "pose", "force_plate"])
def test_missing_h5_reads_the_csv(tmp_path, what):
    if what == "dlc":
        dlc = _trial(tmp_path)
        a = tio.load_dlc_table(os.path.join(dlc, "cam2.h5"))
        b = tio.load_dlc_table(os.path.join(dlc, "cam2.csv"))
        assert np.array_equal(a.values, b.values, equal_nan=True)
    elif what == "pose":
        tab = bench_lib.procedural_pose_table((100,), n_frames=20)
        tds.save_pose_dataset(str(tmp_path / "validation_dataset.csv"), tab)
        got = tds.load_pose_dataset(str(tmp_path / "validation_dataset.h5"))
        assert np.array_equal(got.data, tab.data)
    else:
        frames = {1: np.arange(9.0).reshape(3, 3)}
        tgrf.save_force_plate_df(str(tmp_path / "grf" / "data.csv"), frames)
        assert not (tmp_path / "grf" / "data.h5").exists()
        got = tgrf.load_force_plate_df(str(tmp_path / "grf" / "data.h5"))
        assert np.array_equal(got[1], frames[1])


def test_measured_grf_profile_h5_matches_jax(tmp_path):
    """The measured force-plate branch of ``get_grf_profile`` on a ``.h5``
    table: the port's read equals JAX's (h5py) and the port's read of the
    ``.csv`` form."""
    for form in ("h5", "csv"):
        chip_smoke.force_plate_trial(str(tmp_path / form), form)
    args = (50, 1.0, 1.0 / 400.0)
    kw = dict(kinetic_dataset=True, synthetic_data=False)
    d_h5, d_csv = str(tmp_path / "h5"), str(tmp_path / "csv")
    port = tcontacts.get_grf_profile(args[0], d_h5, d_h5, *args[1:], **kw)
    port_csv = tcontacts.get_grf_profile(args[0], d_csv, d_csv, *args[1:],
                                         **kw)
    jax_ = jcontacts.get_grf_profile(args[0], d_h5, d_h5, *args[1:], **kw)
    assert port == port_csv
    for p, j in zip(port, jax_):
        assert p.keys() == j.keys()
        for k in p:
            assert np.array_equal(np.asarray(p[k]), np.asarray(j[k])), k
    assert any(any(v) for v in port[0].values())
