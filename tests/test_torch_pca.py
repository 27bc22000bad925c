"""Port parity of the remaining prior options against the JAX package,
float64 on the CPU: the PCA pose model (``priors/pca.py``), the AR motion
model's ``num_vars``, ``start_idx``, ``window_time`` and ``pose_model``
options, and the depth line-scan's ``shifts``, ``margin``, ``dtype``,
``finish_stages`` and ``dead_zone_m``.

Tolerances: the PCA is the same numpy SVD on tables both packages read
from one CSV (<= 1e-10); the AR coefficients come from FISTA in float64
(<= 1e-6 relative, the existing AR bar); the line-scan gives the same
shifts and q within 1e-6 (two short LM solves in a row, each step through
a factorization whose float64 rounding differs).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.priors import armodel as jar
from cheetah_pose_estimation_tpu.priors import pca as jpca
from cheetah_pose_estimation_tpu_torch import convert
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.priors import armodel as tar
from cheetah_pose_estimation_tpu_torch.priors import dataset as tds
from cheetah_pose_estimation_tpu_torch.priors import pca as tpca

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")

_spec = importlib.util.spec_from_file_location(
    "jax_stage15_reference", os.path.join(os.path.dirname(__file__), "data",
                                          "jax_stage15_reference.py"))
ref15 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref15)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Short procedural training and validation tables as CSV files
    (pandas' bytes, which both packages read)."""
    tmp = tmp_path_factory.mktemp("pca")
    paths = {}
    for name, seeds in (("train", range(100, 106)), ("val", range(200,
                                                                   202))):
        paths[name] = str(tmp / f"{name}.csv")
        ref15.pose_table_frame(seeds, n_frames=120).to_csv(paths[name])
    return paths


@pytest.mark.parametrize("standardise,n_comps", [(False, 5), (True, 3)])
def test_pca_fit_matches_jax(tables, standardise, n_comps):
    pj = jpca.fit(tables["train"], n_comps=n_comps, standardise=standardise)
    for src in (tables["train"], tds.load_pose_dataset(tables["train"])):
        pt = tpca.fit(src, n_comps=n_comps, standardise=standardise)
        for f in ("P", "PC", "mean", "std", "error_variance",
                  "explained_variance"):
            assert _rel(getattr(pt, f), getattr(pj, f)) <= 1e-10, f
        assert abs(pt.rmse - pj.rmse) <= 1e-10 * pj.rmse
        assert _rel(pt.pc_std(), pj.pc_std()) <= 1e-10
        assert (pt.n_comps, pt.num_vars, pt.ext_dim, pt.standardise) == (
            pj.n_comps, pj.num_vars, pj.ext_dim, pj.standardise)


def test_pca_project_matches_jax(tables):
    pj = jpca.fit(tables["train"])
    pt = tpca.fit(tables["train"])
    X = tds.load_pose_dataset(tables["val"]).data
    for full in (True, False):
        x = X if full else X[:, 6:28]
        z_j = pj.project(x, full_state=full)
        z_t = pt.project(x, full_state=full)
        assert z_t.shape == (len(X), 11 if full else 5)
        assert _rel(z_t, z_j) <= 1e-10
        back_j = pj.project(z_j, full_state=full, inverse=True)
        back_t = pt.project(z_t, full_state=full, inverse=True)
        assert back_t.shape == x.shape and _rel(back_t, back_j) <= 1e-10
        assert _rel(pt.project(x[0], full_state=full), z_j[0]) <= 1e-10


def test_ar_with_pose_model_matches_jax(tables, tmp_path):
    pj = jpca.fit(tables["train"])
    pt = tpca.fit(tables["train"])
    mj = jar.train_motion_model(tables["train"], pose_model=pj,
                                validation_fname=tables["val"])
    mt = tar.train_motion_model(tables["train"], pose_model=pt,
                                validation=tables["val"], device="cpu")
    assert mt.coef.shape == mj.coef.shape == (11, 44)
    assert _rel(mt.coef, mj.coef) <= 1e-6
    assert _rel(mt.intercept, mj.intercept) <= 1e-6
    assert _rel(mt.error_variance, mj.error_variance) <= 1e-6
    assert abs(mt.validation_rmse - mj.validation_rmse) \
        <= 1e-6 * mj.validation_rmse
    # the cache tells a PCA model from a full-space one
    cache = str(tmp_path / "cache")
    tar.train_motion_model(tables["train"], pose_model=pt,
                           validation=tables["val"], device="cpu",
                           cache_dir=cache)
    tar.train_motion_model(tables["train"], validation=tables["val"],
                           device="cpu", cache_dir=cache)
    assert len(os.listdir(cache)) == 2
    again = tar.train_motion_model(tables["train"], pose_model=pt,
                                   validation=tables["val"], device="cpu",
                                   cache_dir=cache)
    assert np.array_equal(again.coef, mt.coef)


@pytest.mark.parametrize("kw", [dict(num_vars=22, start_idx=6),
                                dict(window_time=2, window_size=3),
                                dict(num_vars=12, start_idx=16,
                                     window_time=3, lasso=False)])
def test_ar_options_match_jax(tables, kw):
    mj = jar.train_motion_model(tables["train"],
                                validation_fname=tables["val"], **kw)
    mt = tar.train_motion_model(tables["train"], validation=tables["val"],
                                device="cpu", **kw)
    assert mt.coef.shape == mj.coef.shape
    assert _rel(mt.coef, mj.coef) <= 1e-6
    assert _rel(mt.intercept, mj.intercept) <= 1e-6
    assert abs(mt.train_rmse - mj.train_rmse) <= 1e-6 * mj.train_rmse
    assert mt.window_time == mj.window_time


# -- the line-scan's options -------------------------------------------------

SCAN = ((1.0, 4),)
FINISH = ((3.0, 2), (1.0, 3))
SHIFTS = (-0.5, -0.3, -0.1, 0.0, 0.1)


def _problem():
    """2 procedural trials of 16 frames near their true trajectories (1 cm
    of noise), trial 1 pushed 0.3 m back along its camera rays."""
    datas, qs = [], []
    rng = np.random.default_rng(5)
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(2)):
        d, _, _ = jbl.build_monocular_problem(q[:16], "acinoset", fps,
                                              seed=i)
        datas.append(d)
        qs.append(q[:16] + rng.normal(scale=0.01, size=(16, 54)))
    bj, qj = jbatch.pad_and_stack(datas, qs, n_frames=16, dtype=jnp.float64)
    q = np.array(qj, np.float64)
    R, t = np.asarray(bj.cam.R), np.asarray(bj.cam.t)
    rays = np.stack([jda.camera_ray(q[i], R[i, 0], t[i, 0])
                     for i in range(2)])
    q[1, :, :3] += 0.3 * rays[1]
    rays[1] = jda.camera_ray(q[1], R[1, 0], t[1, 0])
    return bj, q, rays


def test_depth_linescan_options_match_jax():
    bj, q, rays = _problem()
    jscan = jda.make_depth_linescan(SUBJECT, jnp.float64, shifts=SHIFTS,
                                    stages=SCAN, finish_stages=FINISH,
                                    margin=0.02)
    tscan = tda.make_depth_linescan(SUBJECT, SCAN, shifts=SHIFTS,
                                    finish_stages=FINISH, margin=0.02,
                                    dtype=torch.float64)
    tplain = tda.make_depth_linescan(SUBJECT, SCAN, shifts=SHIFTS,
                                     margin=0.02)
    bt, qt = convert.kinematic_problem(bj, q, batched=True, device="cpu")
    seen, shifts_by_case = set(), []
    # the body-scale bound 2 |median| + 0.15 m rules -0.3 out on trial 1
    # while the median clears the dead zone
    for med, dz in ((None, 0.05), (np.array([0.2, -0.06]), 0.05),
                    (np.array([0.2, -0.06]), 0.1)):
        qo_j, sh_j = jscan(jnp.asarray(q), bj, rays, med, dead_zone_m=dz)
        qo_t, sh_t = tscan(qt, bt, rays, med, dead_zone_m=dz)
        np.testing.assert_array_equal(sh_j, sh_t)
        assert qo_t.dtype == torch.float64
        assert np.abs(np.asarray(qo_j) - qo_t.numpy()).max() <= 1e-6
        # unaccepted lanes keep their input bit for bit; accepted ones
        # take the finish, which moves them off the unfinished winner
        qo_p, sh_p = tplain(qt, bt, rays, med, dead_zone_m=dz)
        np.testing.assert_array_equal(sh_p, sh_t)
        for i in range(2):
            if sh_t[i] == 0.0:
                assert torch.equal(qo_t[i], qt[i])
            else:
                assert (qo_t[i] - qo_p[i]).abs().max() > 1e-6
        seen.update(float(s) for s in sh_t)
        shifts_by_case.append(sh_t.tolist())
    assert seen - {0.0}, seen            # some lane was accepted
    assert shifts_by_case[1] != shifts_by_case[2]   # the dead zone acts
