"""Port parity of the synthetic test set: the correlated DLC failure model,
``synthesize`` with it, ``write_trial_dir`` and the dataset CLI's
``materialize_synthetic_testset``, against the JAX package in float64.

Tolerances: ``corrupt_dlc`` on the same inputs and generator state is the
same numpy arithmetic (identical). Rendered pixels go through two float64
camera models (<= 1e-10 px, observed ~1e-12); every random decision and
every likelihood is identical, so the likelihood gate patterns are equal.
The tree digest chip_smoke holds the port to agrees on the two trees (the
same gate md5; projections within 1e-10 px). The port reads the trees with
its exact reader (``use_native=False``): its default C++ read rounds the
pixels to float32, as the JAX package's default read does.
"""
import importlib.util
import os
import pickle

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import io as jio
from cheetah_pose_estimation_tpu.data import synthetic as jsyn
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu_torch.data import io as tio
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corrupt_dlc_identical():
    rng = np.random.default_rng(0)
    meas = rng.uniform(0, 2000, size=(60, 3, 24, 2))
    lik = rng.uniform(0, 1, size=(60, 3, 24))
    a = jsyn.corrupt_dlc(meas, lik, np.random.default_rng(7),
                         occlusion_rate=6.0, confusion_rate=4.0)
    b = tsyn.corrupt_dlc(meas, lik, np.random.default_rng(7),
                         occlusion_rate=6.0, confusion_rate=4.0)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[1], lik)          # something was corrupted


@pytest.fixture(scope="module")
def trials():
    """The same corrupted 6-camera trial rendered by both packages."""
    q = jsyn.gallop_trajectory(30, fps=90.0, seed=3)
    jsub, tsub = jparams.get_subject("jules"), tparams.get_subject("jules")
    markers = tsyn.fk_markers_np(q, tsub)
    scene = tsyn.ring_cameras(markers.mean(axis=(0, 1)), fps=90.0, seed=3)
    kw = dict(noise_px=1.5, outlier_frac=0.02, seed=3, subject_name="jules",
              occlusion_rate=2.0, confusion_rate=1.2)
    return (jsyn.synthesize(q, jsub, jsyn.SyntheticScene(*scene), **kw),
            tsyn.synthesize(q, tsub, scene, **kw))


def test_synthesize_with_corruption(trials):
    j, t = trials
    assert np.array_equal(j.likelihood, t.likelihood)
    assert np.abs(j.meas - t.meas).max() <= 1e-10
    assert np.abs(j.markers_gt - t.markers_gt).max() <= 1e-12


def test_write_trial_dir(trials, tmp_path):
    j, t = trials
    jsyn.write_trial_dir(j, str(tmp_path / "jax"), "2017_x/jules/run",
                         monocular_cam=2, ground_plane_height=0.125)
    tsyn.write_trial_dir(t, str(tmp_path / "port"), "2017_x/jules/run",
                         monocular_cam=2, ground_plane_height=0.125)
    jd, td = tmp_path / "jax" / "2017_x/jules/run", \
        tmp_path / "port" / "2017_x/jules/run"
    assert sorted(os.listdir(td / "dlc")) == [f"cam{c}.csv"
                                              for c in range(1, 7)]
    for name in ("metadata.json", "extrinsic_calib/6_cam_scene_sba.json"):
        assert (td / name).read_text() == (jd / name).read_text()
    a = tio.load_dlc_points(str(jd / "dlc"), 6, use_native=False)
    b = tio.load_dlc_points(str(td / "dlc"), 6, use_native=False)
    assert np.array_equal(a[1], b[1])
    assert np.abs(a[0] - b[0]).max() <= 1e-10
    for c in range(1, 7):
        assert (td / "dlc" / f"cam{c}.csv").read_text().splitlines()[:3] \
            == (jd / "dlc" / f"cam{c}.csv").read_text().splitlines()[:3]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """``materialize_synthetic_testset`` of both packages for the first two
    test-set trials."""
    root = tmp_path_factory.mktemp("trees")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jrd, "TEST_SET", jrd.TEST_SET[:2])
        mp.setattr(trd, "TEST_SET", trd.TEST_SET[:2])
        mj = jrd.materialize_synthetic_testset(str(root / "jax"))
        mt = trd.materialize_synthetic_testset(str(root / "port"))
    finally:
        mp.undo()
    assert mj == mt and len(mt) == 2
    return root, mt


def test_materialized_trees_match(trees):
    root, paths = trees
    for p in paths:
        jd, td = root / "jax" / p, root / "port" / p
        xj, lj, _ = tio.load_dlc_points(str(jd / "dlc"), 6,
                                        use_native=False)
        xt, lt, _ = tio.load_dlc_points(str(td / "dlc"), 6,
                                        use_native=False)
        assert np.array_equal(lj, lt)
        assert np.array_equal(lj > 0.5, lt > 0.5)
        assert np.abs(xj - xt).max() <= 1e-10
        mj, mt = tio.load_metadata(str(jd)), tio.load_metadata(str(td))
        assert abs(mj.pop("ground_plane_height")
                   - mt.pop("ground_plane_height")) <= 1e-12
        assert mj == mt
        sj = tio.load_scene(str(jd / "extrinsic_calib/6_cam_scene_sba.json"))
        st = tio.load_scene(str(td / "extrinsic_calib/6_cam_scene_sba.json"))
        for a, b in zip(sj[:4], st[:4]):
            assert np.abs(a - b).max() <= 1e-12
        with open(jd / "synthetic_gt.pickle", "rb") as f:
            gj = pickle.load(f)
        with open(td / "synthetic_gt.pickle", "rb") as f:
            gt = pickle.load(f)
        assert np.array_equal(gj["q"], gt["q"])
        assert np.abs(gj["positions"] - gt["positions"]).max() <= 1e-12
        # the JAX CLI reads the port's tree
        xjj, ljj, _ = jio.load_dlc_points(str(td / "dlc"), 6,
                                          use_native=False)
        assert np.array_equal(ljj > 0.5, lt > 0.5)


def test_tree_digests_agree(trees):
    """The digest chip_smoke holds the port's tree to (``chip_smoke.digest``,
    which the JAX reference script records too) of each package's tree,
    each read by its own package."""
    root, paths = trees
    ref = _load("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    for p in paths:
        xj, lj, _ = jio.load_dlc_points(str(root / "jax" / p / "dlc"), 6,
                                        use_native=False)
        xt, lt, _ = tio.load_dlc_points(str(root / "port" / p / "dlc"), 6,
                                        use_native=False)
        dj, dt = ref.digest(xj, lj), ref.digest(xt, lt)
        assert dj["gate_md5"] == dt["gate_md5"]
        assert dj["n_gated"] == dt["n_gated"] and dj["shape"] == dt["shape"]
        assert abs(dj["lik_sum"] - dt["lik_sum"]) <= 1e-9
        assert max(abs(a - b) for a, b in zip(dj["px_proj"],
                                              dt["px_proj"])) <= 1e-10
