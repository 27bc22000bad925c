"""Port parity of the force-plate tables and the GRF synthesis against the
JAX package, in float64: the port's CSV table is byte-identical to the CSV
the JAX writer writes beside its ``.h5`` and reads back to JAX's ``.h5``
read exactly; ``synth_grf_data`` for each limb role in both directions and
``get_grf_profile`` in both branches (the synthesized table, and a made-up
3500 Hz measured table through the polyphase resampling) agree exactly or
within 1e-12 (scipy's spline and filter on the same float64 inputs)."""
import json
import os

import numpy as np
import pytest

from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.pipeline import grf_io as jgrf
from cheetah_pose_estimation_tpu_torch.pipeline import contacts as tcon
from cheetah_pose_estimation_tpu_torch.pipeline import grf_io as tgrf

FEET = ("HFL_foot", "HFR_foot", "HBL_foot", "HBR_foot")


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return {0: rng.normal(size=(7, 3)) * 100.0,
            2: rng.normal(size=(5, 3)) * np.array([1e-7, 1.0, 3e5]),
            3: np.array([[0.0, -0.0, 1.0], [0.1, 1e16, -2.5e-12]])}


def test_force_plate_csv_is_the_jax_sibling(tmp_path):
    frames = _frames()
    jgrf.save_force_plate_df(str(tmp_path / "jax" / "data_synth.h5"), frames)
    tgrf.save_force_plate_df(str(tmp_path / "port" / "data_synth.csv"),
                             frames)
    a = (tmp_path / "jax" / "data_synth.csv").read_bytes()
    b = (tmp_path / "port" / "data_synth.csv").read_bytes()
    assert a == b
    ja = jgrf.load_force_plate_df(str(tmp_path / "jax" / "data_synth.h5"))
    tb = tgrf.load_force_plate_df(str(tmp_path / "port" / "data_synth.csv"))
    assert sorted(ja) == sorted(tb) == [0, 2, 3]
    for k in ja:
        assert np.array_equal(ja[k], tb[k])
        assert np.array_equal(tb[k], frames[k])


def test_force_plate_h5_raises(tmp_path):
    """The ``.h5`` form is written (with its ``.csv``) and read back as
    JAX reads it; a ``.h5`` that is not an HDF5 file raises, even with a
    ``.csv`` beside it."""
    tgrf.save_force_plate_df(str(tmp_path / "ok" / "data.h5"), _frames())
    ja = jgrf.load_force_plate_df(str(tmp_path / "ok" / "data.h5"))
    tb = tgrf.load_force_plate_df(str(tmp_path / "ok" / "data.h5"))
    assert ja.keys() == tb.keys()
    assert all(np.array_equal(ja[k], tb[k]) for k in ja)
    tgrf.save_force_plate_df(str(tmp_path / "bad" / "data.csv"), _frames())
    (tmp_path / "bad" / "data.h5").write_bytes(b"not hdf5")
    with pytest.raises(ValueError, match="not an HDF5 file"):
        tgrf.load_force_plate_df(str(tmp_path / "bad" / "data.h5"))


def _contacts(tmp, roles, start=100, n=40, last_beyond=False):
    """An autogen-contact.json with one stance per foot; ``roles`` per foot
    (None: the foot has no stance)."""
    c = {}
    for i, (name, role) in enumerate(zip(FEET, roles)):
        if role is None:
            c[name] = None
            continue
        s = start + 3 + 7 * i
        e = s + 9 + i
        if last_beyond and i == 3:
            e = start + n + 2
        c[name] = [[s, e, i + 1, role], [s + 20, e + 20, i + 1, role]]
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "autogen-contact.json"), "w") as f:
        json.dump({"start_frame": start, "end_frame": start + n,
                   "contacts": c}, f)


@pytest.mark.parametrize("direction", [1.0, -1.0])
@pytest.mark.parametrize("roles", [
    ("leading", "trailing", "leading", "trailing"),
    ("trailing", "leading", "trailing", "leading"),
    ("leading", None, "TBD", "trailing")])
def test_synth_grf_data_matches_jax(tmp_path, roles, direction):
    for speed in (8.0, 12.5):
        jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
        for d in (jdir, tdir):
            _contacts(d, roles, last_beyond=roles[1] is None)
        jcon.synth_grf_data(speed, direction, jdir)
        tcon.synth_grf_data(speed, direction, tdir)
        with open(os.path.join(jdir, "data_synth.csv"), "rb") as f:
            a = f.read()
        with open(os.path.join(tdir, "data_synth.csv"), "rb") as f:
            b = f.read()
        assert a == b
        tb = tgrf.load_force_plate_df(os.path.join(tdir, "data_synth.csv"))
        assert len(tb) == sum(r in ("leading", "trailing") for r in roles) \
            - (roles[1] is None)
        for F in tb.values():
            assert F[:, 2].max() > 1.0 and np.all(F[:, 1] == 0.0)


def _profile_case(root, synthetic):
    """A trial directory with a force-plate table for both packages:
    ``grf/data_synth`` (from synth_grf_data) or a measured 3500 Hz
    ``grf/data`` with its contacts in ``metadata.json``."""
    grf = os.path.join(root, "grf")
    if synthetic:
        _contacts(grf, ("leading", "trailing", "trailing", "leading"))
        jcon.synth_grf_data(11.0, -1.0, grf)
        return 100
    os.makedirs(grf, exist_ok=True)
    rng = np.random.default_rng(3)
    t = np.arange(9000) / 3500.0
    frames = {}
    for plate in range(3):
        F = np.stack([np.sin(2 * np.pi * (3 + plate) * t),
                      0.3 * np.cos(2 * np.pi * 5 * t),
                      400 * np.exp(-(t - 1.2) ** 2 / 0.01) + 2.0], 1)
        frames[plate] = F + rng.normal(scale=0.5, size=F.shape)
    jgrf.save_force_plate_df(os.path.join(grf, "data.h5"), frames)
    contacts = {"HFL_foot": [[12, 30, 1, "leading"]],
                "HFR_foot": [[40, 58, 2, "trailing"]],
                "HBL_foot": None,
                "HBR_foot": [[70, 91, 3, "leading"]]}
    with open(os.path.join(root, "metadata.json"), "w") as f:
        json.dump({"start_frame": 10, "end_frame": 110,
                   "contacts": contacts}, f)
    return 100


@pytest.mark.parametrize("synthetic", [True, False])
def test_get_grf_profile_matches_jax(tmp_path, synthetic):
    root = str(tmp_path)
    n = _profile_case(root, synthetic)
    kw = dict(kinetic_dataset=not synthetic, synthetic_data=synthetic)
    for direction, scale in ((1.0, 1.0), (-1.0, 1.0 / 350.0)):
        gz_j, gxy_j = jcon.get_grf_profile(n, root, root, direction, scale,
                                           **kw)
        gz_t, gxy_t = tcon.get_grf_profile(n, root, root, direction, scale,
                                           **kw)
        assert list(gz_j) == list(gz_t) == list(FEET)
        for foot in FEET:
            a, b = np.asarray(gz_j[foot]), np.asarray(gz_t[foot])
            assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(a).max())
            a, b = np.asarray(gxy_j[foot]), np.asarray(gxy_t[foot])
            assert np.abs(a - b).max() <= 1e-12 * max(1.0, np.abs(a).max())
        assert max(max(v) for v in gz_t.values()) > 0.0
