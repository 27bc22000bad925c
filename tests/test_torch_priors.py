"""Port parity of the learned priors: relative pose, pose tables and their
windows, the GMM (EM, densities, solver export) and the AR motion model
(OLS, FISTA lasso, anchors), against the JAX package in float64.

Tolerances: the relative-pose map, the window functions and the CSV loader
are the same exact operations (equality). The procedural pose table is the
same numpy recipe (<= 1e-15). Densities and exports are the same float64
expressions (<= 1e-12 relative). 50 EM steps from the same initial means
and the 4000 FISTA steps accumulate only float64 summation-order noise
(<= 1e-8 relative; coefficients within 1e-8 of their largest).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.priors import armodel as jar
from cheetah_pose_estimation_tpu.priors import dataset as jds
from cheetah_pose_estimation_tpu.priors import gmm as jgmm
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.models import skeleton as tsk
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
from cheetah_pose_estimation_tpu_torch.priors import armodel as tar
from cheetah_pose_estimation_tpu_torch.priors import dataset as tds
from cheetah_pose_estimation_tpu_torch.priors import gmm as tgmm

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "jax_stage15_reference", os.path.join(os.path.dirname(__file__), "data",
                                          "jax_stage15_reference.py"))
ref15 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref15)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The training and validation pose tables as the JAX side writes them
    (pandas CSV) and the port's own builds of the same tables."""
    tmp = tmp_path_factory.mktemp("pose")
    paths = {}
    for name, seeds in (("train", bench_lib.TRAIN_SEEDS),
                        ("val", bench_lib.VAL_SEEDS)):
        paths[name] = str(tmp / f"{name}.csv")
        ref15.pose_table_frame(seeds).to_csv(paths[name])
    return (paths, bench_lib.procedural_pose_table(bench_lib.TRAIN_SEEDS),
            bench_lib.procedural_pose_table(bench_lib.VAL_SEEDS))


@pytest.fixture(scope="module")
def jax_gmm(tables):
    _, train, _ = tables
    X = train.data[:, 6:28]
    return X, jgmm.GMMParams(*[np.asarray(p) for p in jgmm._fit(
        X, 5, 42, 50, 1e-4, 1e-6)])


def test_relative_pose_is_exact():
    np.testing.assert_array_equal(tsk.A_REL, jsk.A_REL)
    np.testing.assert_array_equal(tsk.REL_MASK, jsk.REL_MASK)
    assert tsk.NX == jsk.NX == 28
    q = np.random.default_rng(0).normal(size=(3, 7, 54))
    np.testing.assert_array_equal(
        tsk.relative_pose(torch.as_tensor(q)).numpy(),
        np.asarray(jsk.relative_pose(jnp.asarray(q))))


@pytest.mark.parametrize("n_in,n_step", [(4, 1), (3, 2), (20, 1)])
def test_window_functions_are_exact(n_in, n_step):
    rng = np.random.default_rng(n_in)
    X = rng.normal(size=(30, 5))
    for a, b in zip(tds.series_to_supervised(X, n_in, n_step),
                    jds.series_to_supervised(X, n_in, n_step)):
        np.testing.assert_array_equal(a, b)
    index = np.concatenate([np.arange(12), np.arange(18)])
    for a, b in zip(tds.windowed_dataset(X, index, n_in, n_step),
                    jds.windowed_dataset(X, index, n_in, n_step)):
        np.testing.assert_array_equal(a, b)
    assert tds.segment_bounds(index) == jds.segment_bounds(index)


def test_csv_loader_and_pose_table_match_jax(tables):
    """The port reads back exactly what pandas wrote (as pandas does with
    its round-trip float parser); the JAX loader's default pandas parser
    is not round-trip exact and differs by a few ulp."""
    import pandas as pd

    paths, train, val = tables
    for name, seeds, ours in (("train", bench_lib.TRAIN_SEEDS, train),
                              ("val", bench_lib.VAL_SEEDS, val)):
        written = ref15.pose_table_frame(seeds)
        tab = tds.load_pose_dataset(paths[name])
        np.testing.assert_array_equal(tab.data, written.to_numpy())
        np.testing.assert_array_equal(tab.index, written.index.values)
        np.testing.assert_array_equal(tab.data, pd.read_csv(
            paths[name], index_col=0, float_precision="round_trip"))
        df = jds.load_pose_dataset(paths[name])
        assert np.abs(tab.data - df.to_numpy()).max() <= 1e-14
        np.testing.assert_array_equal(tab.index, df.index.values)
        assert list(tab.columns) == list(df.columns) == tds.POSE_COLUMNS
        # the port's table vs the same recipe through the JAX package
        assert np.abs(ours.data - written.to_numpy()).max() <= 1e-15
        np.testing.assert_array_equal(ours.index, written.index.values)
    assert train.data.shape == (9600, 28) and val.data.shape == (2400, 28)


def test_gmm_densities_and_export_match_jax(jax_gmm):
    """Score and export to 1e-12. The per-sample log densities go through
    two Cholesky factorizations (LAPACK here, XLA's own in JAX) of
    covariances of condition ~2e5, whose factors differ by ~1.6e-14; that
    moves the densities by ~1.2e-12 of their largest (bound 5e-12)."""
    X, params = jax_gmm
    tparams = convert.gmm_params(params, device="cpu")
    lj = jgmm._log_gaussians(jnp.asarray(X), params.means, params.covs, 1e-6)
    lt = tgmm._log_gaussians(torch.as_tensor(X), tparams.means,
                             tparams.covs, 1e-6)
    assert _rel(lj, lt.numpy()) <= 5e-12
    assert abs(jgmm.score(params, X) - tgmm.score(tparams, X)) <= \
        1e-12 * abs(jgmm.score(params, X))
    pj, pt = jgmm.to_solver_prior(params), tgmm.to_solver_prior(tparams)
    for a, b in zip(pj, pt):
        assert _rel(a, b) <= 1e-12


def test_em_from_jax_initial_means_matches_jax(jax_gmm):
    """50 EM steps from given initial means: the JAX package's own
    k-means++ draw (the port's draw is held equal to it in
    ``tests/test_torch_kmeanspp.py``)."""
    X, params = jax_gmm
    means0 = np.asarray(jgmm._kmeanspp_init(jax.random.PRNGKey(42),
                                            jnp.asarray(X), 5))
    ours = tgmm._fit(X, 5, 42, 50, 1e-6, means0=means0, device="cpu")
    for a, b in zip(params, ours):
        assert _rel(a, b.numpy()) <= 1e-8


def test_gmm_fit_is_seeded_finite_and_raises_on_bad_data(tables):
    _, train, _ = tables
    X = train.data[:600, 6:28]
    a = tgmm.fit(X, 3, seed=7, max_iter=5, device="cpu")
    b = tgmm.fit(X, 3, seed=7, max_iter=5, device="cpu")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert all(torch.isfinite(x).all() for x in a)
    bad = X.copy()
    bad[3, 4] = np.inf
    with pytest.raises(Exception):
        tgmm.fit(bad, 3, seed=7, max_iter=5, device="cpu")


def test_ar_fits_match_jax(tables):
    _, train, _ = tables
    X, y = tds.windowed_dataset(train.data, train.index, 4)
    for a, b in zip(tar.fit_linear(X, y), jar.fit_linear(X, y)):
        assert np.abs(a - b).max() <= 1e-10
    Wt, bt = tar.fit_multitask_lasso(X, y, 1e-2, device="cpu")
    Wj, bj = jar.fit_multitask_lasso(X, y, 1e-2)
    assert np.abs(Wt - Wj).max() <= 1e-8 * np.abs(Wj).max()
    assert np.abs(bt - bj).max() <= 1e-8 * np.abs(bj).max()


def test_motion_model_and_anchors_match_jax(tables):
    paths, train, val = tables
    mj = jar.train_motion_model(paths["train"], window_size=4, lasso=True,
                                validation_fname=paths["val"])
    mt = tar.train_motion_model(paths["train"], window_size=4, lasso=True,
                                validation=paths["val"], device="cpu")
    ma = tar.train_motion_model(train, window_size=4, lasso=True,
                                validation=val, device="cpu")
    for m in (mt, ma):
        assert _rel(mj.error_variance, m.error_variance) <= 1e-12
        assert abs(mj.train_rmse - m.train_rmse) <= 1e-12 * mj.train_rmse
        assert abs(mj.validation_rmse - m.validation_rmse) <= \
            1e-12 * mj.validation_rmse
    # anchors from one trained model, the JAX one carried across
    mc = convert.motion_model(mj)
    x = train.data[:240] + np.random.default_rng(1).normal(
        scale=0.02, size=(240, 28))
    ypj, vlj = jar.anchor_predictions(mj, x)
    ypt, vlt = tar.anchor_predictions(mc, x)
    assert _rel(ypj, ypt) <= 1e-12
    np.testing.assert_array_equal(vlj, vlt)
    vl = vlj * (np.arange(240) < 200)
    assert _rel(jar.adaptive_motion_weights(mj, ypj, x, vl),
                tar.adaptive_motion_weights(mc, ypt, x, vl)) <= 1e-12
    assert _rel(jar.motion_weights(mj), tar.motion_weights(mc)) <= 1e-12


def test_prior_caches_round_trip_under_their_own_names(tmp_path,
                                                       monkeypatch):
    """``gmm.fit`` and ``train_motion_model`` with a cache directory (the
    dataset's own, ``data_ops.prior_cache_dir``) store their fits there
    under the port's names and load them back unchanged without training;
    the JAX package's fits in the same directory carry other names, so
    neither package reads the other's."""
    from cheetah_pose_estimation_tpu.utils import data_ops as jops
    from cheetah_pose_estimation_tpu_torch.utils import data_ops as tops

    train = bench_lib.procedural_pose_table((100, 101), n_frames=60)
    val = bench_lib.procedural_pose_table((200,), n_frames=60)
    dset = str(tmp_path / "dataset_full_pose.csv")
    tds.save_pose_dataset(dset, train)
    tds.save_pose_dataset(str(tmp_path / "validation_dataset.csv"), val)
    cache = tops.prior_cache_dir(dset)
    assert cache == jops.prior_cache_dir(dset) == str(tmp_path)
    X = train.data[:, 6:28]
    g1 = tgmm.fit(X, 3, max_iter=5, device="cpu", cache_dir=cache)
    m1 = tar.train_motion_model(dset, device="cpu", cache_dir=cache)
    jgmm.fit(X, n_components=3, max_iter=5, cache_dir=cache)
    names = sorted(os.listdir(tmp_path))
    ours = [n for n in names if n.endswith(".torch.pkl")]
    assert [n.split("_model_")[0] for n in ours] == ["gmm", "lr"]
    assert any(n.endswith(".tpu") for n in names)

    def no_training(*a, **k):
        raise AssertionError("trained although a cached fit exists")

    monkeypatch.setattr(tgmm, "_fit", no_training)
    monkeypatch.setattr(tar, "fit_multitask_lasso", no_training)
    g2 = tgmm.fit(X, 3, max_iter=5, device="cpu", cache_dir=cache)
    m2 = tar.train_motion_model(dset, device="cpu", cache_dir=cache)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)
    assert np.array_equal(m1.coef, m2.coef)
    assert np.array_equal(m1.intercept, m2.intercept)
    assert m1.validation_rmse == m2.validation_rmse
    # other settings are another fit
    with pytest.raises(AssertionError, match="trained although"):
        tgmm.fit(X, 3, max_iter=6, device="cpu", cache_dir=cache)
