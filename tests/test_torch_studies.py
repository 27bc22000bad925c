"""Port parity of the studies (``pipeline/studies.py``) against the JAX
package, in float64 on the CPU, on the small JAX-made tree of
``test_torch_cli.py`` (2 jules trials of 24 frames, 3 cameras): the padded
GMM prior (inert within 1e-12), ``model_selection_analysis`` (GMM lists
within 1e-8 relative from the same k-means++ draw, AR lists within 1e-6,
equal non-zero counts; each package reads the other's pickle),
``run_grid_search_batched`` on a 2 x 1 x 2 grid (rows within 1e-6
relative, JAX's header and row order), and the CLI's study flags (each
reaches its study with the JAX CLI's arguments; no JAX flag is missing
from the port's parser).

Every study reads what the port's batched ground-truth and data-driven
modes saved (:func:`saved`: float64, both packages' schedules shortened
alike as in ``test_torch_cli.py``), copied for each package. The priors
are trained by both packages on the small procedural tables of
``test_torch_serial_kinematics.pose_tables``, the port's EM from the JAX
package's k-means++ draw. The ablations, the per-trial forms and the
degradation sweep are in ``test_torch_studies_ablation.py``,
``test_torch_studies_serial.py`` and ``test_torch_studies_sweep.py``
(xdist spreads the files; most of each one's time is the JAX package
compiling its solvers)."""
import argparse
import csv
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu.pipeline import studies as jst
from cheetah_pose_estimation_tpu.utils import data_ops as jops
from cheetah_pose_estimation_tpu_torch.models import params
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin
from cheetah_pose_estimation_tpu_torch.utils import data_ops as tops

from test_torch_cli import TRIALS, _short_schedules, tree  # noqa: F401
from test_torch_serial_kinematics import pose_tables

torch.set_num_threads(1)
SCAN = ((1.0, 4),)


def short_studies(mp):
    """Both packages' schedules shortened alike (``test_torch_cli.
    _short_schedules``, and the port's data-driven line-scan), the same
    GMM draw."""
    _short_schedules(mp)
    d = jda.make_depth_linescan.__defaults__
    mp.setattr(jda.make_depth_linescan, "__defaults__",
               d[:2] + (SCAN,) + d[3:])
    mp.setattr(tpb.run_data_driven, "__defaults__",
               (((10.0, 3), (3.0, 3), (1.0, 8)), SCAN, None))


@pytest.fixture(scope="module")
def saved(tree, tmp_path_factory):  # noqa: F811
    """(root, the training table, the output directory of the port's
    batched ground-truth and data-driven modes on the tree)."""
    root, _ = tree
    work = tmp_path_factory.mktemp("studies")
    out = str(work / "out")
    with pytest.MonkeyPatch.context() as mp:
        dset = pose_tables(work)
        short_studies(mp)
        tpb.run_monocular_batched(root, out, TRIALS,
                                  modes=("ground-truth", "data-driven"),
                                  data_driven_dataset=dset,
                                  dtype=torch.float64, device="cpu",
                                  verbose=False)
    return root, dset, out


def outputs(saved, tmp_path):  # noqa: F811
    """A copy of the saved outputs for each package: (jax, port)."""
    dirs = [str(tmp_path / s) for s in ("jax", "port")]
    for d in dirs:
        shutil.copytree(saved[2], d)
    return dirs


def rel(a, b):
    return abs(a - b) / max(abs(a), abs(b), 1e-300)


def rows_match(jrows, trows, tol, exact=("n", "n_components", "window",
                                         "lasso", "config",
                                         "lr_non_zeros")):
    """Each of JAX's rows against the port's: the same columns in the same
    order; counts and labels equal, every number within ``tol``
    relative."""
    assert len(jrows) == len(trows)
    for j, t in zip(jrows, trows):
        assert list(j) == list(t)
        for k, v in j.items():
            if k in exact:
                assert v == t[k], (k, j, t)
            else:
                assert rel(float(v), float(t[k])) <= tol, (k, j, t)


def read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_pad_gmm_is_inert():
    """A 3-component prior padded to 8 (``_pad_gmm``, the JAX package's
    arrays too): the pose prior's negative log-likelihood, its cost term,
    gradient and curvature unchanged within 1e-12."""
    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    rng = np.random.default_rng(0)
    subject = params.get_subject("jules")
    fte = tkin.KinematicFTE(tkin.KinematicConfig(use_gmm=True), subject)
    d, q0, _ = bench_lib.build_monocular_problem(
        syn.gallop_trajectory(16, seed=1), "jules", 120.0, seed=1)
    q0 = q0 + rng.normal(scale=0.05, size=q0.shape)
    x22 = torch.einsum("ij,tj->ti", fte._table("_A22", torch.as_tensor(q0)),
                       torch.as_tensor(q0)).numpy()
    # components near the trajectory's poses, so the prior's terms are
    # far above the 1e-12 floor of its density
    K, D = 3, 22
    A = rng.normal(size=(K, D, D))
    cov = 0.01 * (A @ A.transpose(0, 2, 1) / D + np.eye(D))
    gp = tkin.GMMPrior(
        means=x22[[2, 8, 13]] + rng.normal(scale=0.02, size=(K, D)),
        prec=np.linalg.inv(cov),
        log_norm=np.log(1.0 / K) - 0.5 * np.linalg.slogdet(
            2 * np.pi * cov)[1])
    padded = tst._pad_gmm(gp, 8)
    jpad = jst._pad_gmm(gp, 8)
    for a, b in zip(padded, jpad):
        assert np.array_equal(a, np.asarray(b))
    assert tst._pad_gmm(gp, 3) is gp
    out = []
    for prior in (gp, padded):
        bat, q = pbatch.pad_and_stack([d._replace(gmm=prior)], [q0],
                                      dtype=torch.float64, device="cpu")
        x22 = torch.einsum("ij,btj->bti", fte._table("_A22", q), q)
        g, H = fte._normal(q, bat, 1.0)
        out.append((fte._gmm_neglog(x22, bat.gmm), fte._cost(q, bat, 1.0),
                    g, H.diag, H.lower))
    for a, b in zip(*out):
        scale = max(1.0, float(a.abs().max()))
        assert float((a - b).abs().max()) <= 1e-12 * scale


def test_model_selection_matches_jax(tmp_path, monkeypatch):
    """Both packages' model-selection curves on the same tables, 1-2
    components and windows: GMM lists within 1e-8 relative, AR RMSEs
    within 1e-6 and equal non-zero counts; each package's pickle holds the
    JAX keys and reads back through the other's loader."""
    dset = pose_tables(tmp_path)
    kw = dict(pose_components=(1, 2), window_sizes=(1, 2))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j = jst.model_selection_analysis(dset, out_dir=jdir, **kw)
    t = tst.model_selection_analysis(dset, out_dir=tdir, device="cpu", **kw)
    assert list(j) == list(t)
    for k in j:
        assert len(j[k]) == len(t[k]) == (2 if k.startswith("gmm") else 4)
        tol = 1e-8 if k.startswith("gmm") else 1e-6
        for a, b in zip(j[k], t[k]):
            if k == "lr_non_zeros":
                assert int(a) == int(b)
            else:
                assert rel(float(a), float(b)) <= tol, (k, a, b)
    jp = os.path.join(jdir, "grid_search.pickle")
    tp = os.path.join(tdir, "grid_search.pickle")
    assert tops.load_pickle(jp).keys() == jops.load_pickle(tp).keys()
    for k, v in jops.load_pickle(tp).items():
        assert [float(x) for x in v] == [float(x) for x in t[k]]
    for k, v in tops.load_pickle(jp).items():
        assert [float(x) for x in v] == [float(x) for x in j[k]]


def test_grid_search_batched_matches_jax(saved, tmp_path,  # noqa: F811
                                         monkeypatch):
    """A 2 x 1 x 2 grid (3 and 5 components, window 4, lasso on and off)
    over both trials as one batch of 8 lanes: each row's MPE, MPJPE, count
    and model statistics within 1e-6 of JAX's, the CSV with JAX's header
    and row order."""
    root, dset, _ = saved
    jout, tout = outputs(saved, tmp_path)
    short_studies(monkeypatch)
    grid = dict(pose_components=(3, 5), windows=(4,),
                lasso_options=(True, False), data_driven_dataset=dset)
    jdf = jst.run_grid_search_batched(root, jout, TRIALS, dtype=jnp.float64,
                                      mesh=None, verbose=False, **grid)
    trows = tst.run_grid_search_batched(root, tout, TRIALS,
                                        dtype=torch.float64, device="cpu",
                                        verbose=False, **grid)
    assert all(r["n"] == 2 for r in trows)
    rows_match(jdf.to_dict("records"), trows, 1e-6)
    jh, jr = read_csv(os.path.join(jout, "grid_search_results.csv"))
    th, tr = read_csv(os.path.join(tout, "grid_search_results.csv"))
    assert jh == th
    assert [r[:3] for r in jr] == [r[:3] for r in tr]


def test_grid_search_without_saved_solutions(saved, tmp_path,  # noqa: F811
                                             monkeypatch):
    """Where the multi-view solutions are missing the rows say so (no
    trial scored, NaN errors, written as empty fields), as in JAX."""
    root, dset, _ = saved
    short_studies(monkeypatch)
    rows = tst.run_grid_search_batched(
        root, str(tmp_path), TRIALS[:1], pose_components=(3,), windows=(2,),
        lasso_options=(True,), data_driven_dataset=dset,
        dtype=torch.float64, device="cpu", verbose=False)
    assert rows[0]["n"] == 0 and np.isnan(rows[0]["mpe"])
    _, body = read_csv(os.path.join(str(tmp_path),
                                    "grid_search_results.csv"))
    assert body[0][3:6] == ["", "", "0"]


class Stop(Exception):
    pass


def _options(main, monkeypatch):
    """The option strings of ``main``'s parser."""
    seen = {}

    def parse(self, argv=None, namespace=None):
        seen["opts"] = set(self._option_string_actions)
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(Stop):
        main([])
    monkeypatch.undo()
    return seen["opts"]


def test_parser_has_every_jax_flag(monkeypatch):
    jax_opts = _options(jrd.main, monkeypatch)
    port_opts = _options(trd.main, monkeypatch)
    assert jax_opts - port_opts == set()
    assert port_opts - jax_opts == {"--device"}


STUDY_FUNCS = ("run_grid_search_batched", "run_grid_search",
               "model_selection_analysis", "run_degradation_sweep",
               "run_data_driven_ablation_batched",
               "run_data_driven_ablation_study",
               "run_physics_ablation_batched",
               "run_physics_based_ablation_study")


def _calls(main, studies_mod, results_mod, argv, monkeypatch):
    """The studies (and the figures) ``main(argv)`` calls, stubbed, with
    their arguments (the port's ``device`` left out)."""
    calls = []

    def stub(name):
        def run(*a, **k):
            k.pop("device", None)
            calls.append((name, a, k))
            return [] if name != "model_selection_analysis" else {}
        return run

    for f in STUDY_FUNCS:
        monkeypatch.setattr(studies_mod, f, stub(f))
    for f in ("data_driven_analysis", "ablation_study"):
        monkeypatch.setattr(results_mod, f, stub(f))
    main(argv)
    return calls


@pytest.mark.parametrize("flags", [
    ["--run_grid_search", "--batched"], ["--run_grid_search"],
    ["--run_degradation_sweep"], ["--run_degradation_sweep",
                                  "--sweep_physics"],
    ["--run_data_driven_ablation_study", "--batched"],
    ["--run_data_driven_ablation_study"],
    ["--run_physics_based_ablation_study", "--batched",
     "--override_default_cam", "--trials", "3"],
    ["--run_physics_based_ablation_study"],
    ["--run_grid_search", "--run_data_driven_ablation_study",
     "--run_physics_based_ablation_study", "--batched", "--trials", "2"]])
def test_study_flags_reach_the_studies(tmp_path, monkeypatch, flags):
    """Each study flag calls the port's study with the JAX CLI's
    arguments, in JAX's order; both ablation CSVs present make the
    ablation figure."""
    from cheetah_pose_estimation_tpu.pipeline import results as jres
    from cheetah_pose_estimation_tpu.utils import device as jdev
    from cheetah_pose_estimation_tpu_torch.pipeline import results as tres
    monkeypatch.setattr(jdev, "enable_compile_cache", lambda: None)
    out = str(tmp_path)
    for f in ("data_driven_ablation_results.csv",
              "physics_based_ablation_results.csv"):
        open(os.path.join(out, f), "w").close()
    argv = flags + ["--root_dir", "r", "--out_dir_prefix", out]
    jcalls = _calls(jrd.main, jst, jres, argv, monkeypatch)
    tcalls = _calls(trd.main, tst, tres, argv + ["--device", "cpu"],
                    monkeypatch)
    assert jcalls and [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for (name, ja, jk), (_, ta, tk) in zip(jcalls, tcalls):
        assert ta == ja and tk == jk, name


def _study_files(out, rng):
    """Made-up study outputs, written by the port: both ablation CSVs, a
    grid CSV and a model-selection pickle."""
    for name in ("data_driven_ablation_results.csv",
                 "physics_based_ablation_results.csv"):
        tst._write_csv(out, name, [
            dict(config=c, mpe=float(rng.uniform(50, 150)),
                 mpjpe=float(rng.uniform(20, 40)),
                 cvr=float(rng.uniform(0.3, 1.0)), n=2)
            for c, _, _ in tst.ABLATION_CONFIGS])
    tst._write_csv(out, "grid_search_results.csv", [
        dict(n_components=k, window=w, lasso=l, mpe=float(rng.uniform(90, 120)),
             mpjpe=float(rng.uniform(20, 40)), n=2)
        for k in (3, 5, 8) for w in (2, 4, 6, 10) for l in (True, False)])
    sel = {k: [float(x) for x in rng.normal(size=7 if "gmm" in k else 14)]
           for k in ("gmm_train_likelihood", "gmm_validation_likelihood",
                     "lr_train_rmse", "lr_validation_rmse", "lr_non_zeros")}
    tops.save_pickle(os.path.join(out, "grid_search.pickle"), sel)
    return sel


def test_study_figures_match_jax(tmp_path, capsys, monkeypatch):
    """The studies' figures read the port's CSVs and pickle as the JAX
    package's read them (pandas there): the same PDFs written, the
    ablation bars' values those of the CSVs, the model-selection dict
    returned as JAX's; without matplotlib, a line names each PDF."""
    from cheetah_pose_estimation_tpu.pipeline import results as jres
    from cheetah_pose_estimation_tpu_torch.pipeline import results as tres
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        sel = _study_files(str(d), np.random.default_rng(0))
    jres.ablation_study(str(jdir))
    series = tres.ablation_study(str(tdir))
    jres.data_driven_analysis(str(jdir))
    data = tres.data_driven_analysis(str(tdir))
    assert data == sel
    pdfs = ("ablation-study.pdf", "gmm_model_selection.pdf",
            "ar_model_selection.pdf", "gmm_components_vs_error.pdf",
            "ar_window_vs_error.pdf")
    for n in pdfs:
        assert (jdir / n).exists() and (tdir / n).exists(), n
    rows = {r["config"]: r for r in tres._read_rows(
        str(tdir / "physics_based_ablation_results.csv"))}
    assert series["physics-based"]["mpjpe"] == [
        float(rows[c]["mpjpe"]) for c in tres.ABLATION_LABELS]
    monkeypatch.setattr(tres, "_pyplot", lambda: None)
    for n in pdfs:
        os.remove(tdir / n)
    tres.ablation_study(str(tdir))
    tres.data_driven_analysis(str(tdir))
    out = capsys.readouterr().out
    for n in pdfs:
        assert str(tdir / n) in out and not (tdir / n).exists()


def test_post_process_plot(tmp_path, capsys, monkeypatch):
    """``dataset_post_process`` draws the modes' mean errors
    (``data_driven_mpjpe_result.pdf``), or names the PDF it skipped."""
    from cheetah_pose_estimation_tpu_torch.pipeline import results as tres
    res = {"t1": {"default": {"mpe": 10.0, "mpjpe": 5.0},
                  "data-driven": {"mpe": 8.0, "mpjpe": 4.0}},
           "t2": {"default": {"mpe": 12.0, "mpjpe": 6.0}}}
    trd._post_process_plots(res, str(tmp_path))
    assert (tmp_path / "data_driven_mpjpe_result.pdf").exists()
    monkeypatch.setattr(tres, "_pyplot", lambda: None)
    trd._post_process_plots(res, str(tmp_path / "x"))
    assert "data_driven_mpjpe_result.pdf" in capsys.readouterr().out


@pytest.mark.parametrize("flag, fn", [
    ("--run_grid_search", "run_grid_search_batched"),
    ("--run_data_driven_ablation_study", "run_data_driven_ablation_batched"),
    ("--run_physics_based_ablation_study", "run_physics_ablation_batched"),
    ("--run_degradation_sweep", "run_degradation_sweep")])
def test_study_flags_need_the_card_or_cpu(monkeypatch, tmp_path, flag, fn):
    """The study flags and their entry points take the card by default and
    raise without one, before solving anything; on the CPU, a root
    without trials gives rows that scored none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, out = str(tmp_path / "videos"), str(tmp_path / "out")
    args = () if fn == "run_degradation_sweep" else (root, out, TRIALS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        getattr(tst, fn)(*args)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        trd.main([flag, "--batched", "--root_dir", root, "--out_dir_prefix",
                  out])
    assert not os.path.exists(out)
    if args:
        rows = getattr(tst, fn)(*args, device="cpu", verbose=False,
                                data_driven_dataset=pose_tables(tmp_path))
        assert rows and all(r["n"] == 0 for r in rows)
