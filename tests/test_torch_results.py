"""Port parity of the results layer against the JAX package, live and in
float64 on the CPU (numpy and the EOM, no solver): the functions of
``pipeline/results.py`` ported in full, ``metrics.compare_traj_error``,
``pipeline/visualize.py`` and ``ops/losses.cauchy`` and ``fair``. Each
function gets the seeded inputs of the matching test in
``tests/test_results.py`` where it has one, plus a seeded case of its own;
the numbers must agree within 1e-12 relative. The plots must write their
file where matplotlib is installed; with matplotlib blocked a plot-only
function writes nothing and returns False, one that also returns data
returns the same data and names the file it skipped.

The JAX package's ``plot_3d_pose`` indexes the float that ``gmm.score``
returns and raises; the port's likelihoods are held to JAX's GMM fit and
score of the same poses instead.
"""
import os
import pickle
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.data import io as jio
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.ops import losses as jlosses
from cheetah_pose_estimation_tpu.pipeline import metrics as JM
from cheetah_pose_estimation_tpu.pipeline import results as JR
from cheetah_pose_estimation_tpu.pipeline import visualize as JV
from cheetah_pose_estimation_tpu.priors import dataset as jds
from cheetah_pose_estimation_tpu.priors import gmm as jgmm
from cheetah_pose_estimation_tpu_torch.data import io as tio
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.ops import losses as tlosses
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
from cheetah_pose_estimation_tpu_torch.pipeline import metrics as TM
from cheetah_pose_estimation_tpu_torch.pipeline import results as TR
from cheetah_pose_estimation_tpu_torch.pipeline import visualize as TV
from cheetah_pose_estimation_tpu_torch.priors import dataset as tds

torch.set_num_threads(1)
TOL = 1e-12


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.nanmax(np.abs(b))) if b.size else 0.0, 1e-300)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.nanmax(np.abs(a - b), initial=0.0) <= tol * scale, (a, b)


def _same_dict(t, j):
    assert set(t) == set(j)
    for k in j:
        _close(t[k], j[k])


@pytest.fixture
def no_matplotlib(monkeypatch):
    """matplotlib blocked: importing it raises ImportError."""
    for name in [m for m in sys.modules if m.startswith("matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _gallop(n=20, seed=0):
    return tsyn.gallop_trajectory(n, seed=seed)


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_cauchy_fair(seed):
    r = np.random.default_rng(seed).normal(scale=10.0, size=500)
    for name, c in (("cauchy", 7.0), ("fair", 7.0), ("cauchy", 0.5)):
        t = getattr(tlosses, name)(torch.as_tensor(r), c).numpy()
        j = np.asarray(getattr(jlosses, name)(jnp.asarray(r), c))
        _close(t, j)


def test_kinematic_error():
    rng = np.random.default_rng(4)
    q, q_ref = rng.normal(size=(12, 54)), rng.normal(size=(10, 54))
    _same_dict(TR.kinematic_error(q, q_ref), JR.kinematic_error(q, q_ref))
    assert TR.kinematic_error(q, q) == {"base_rmse": 0.0,
                                        "relative_rmse": 0.0}


def test_grf_error():
    rng = np.random.default_rng(5)
    est = rng.uniform(0, 2, size=(30, 4))
    meas = {0: rng.uniform(0, 2, size=(30, 3)),
            1: rng.uniform(0, 2, size=(25, 3))}
    contacts = {"HFL_foot": [[12, 18, 1, "leading"]],
                "HFR_foot": [[14, 20, 2, "trailing"], [30, 40, 2, "x"]],
                "HBL_foot": None,
                "HBR_foot": [[11, 15, 3, "leading"]]}   # no plate 2
    for sf in (10, 12):
        _same_dict(TR.grf_error(est, meas, contacts, sf),
                   JR.grf_error(est, meas, contacts, sf))
    assert TR.grf_error(est, {}, contacts, 10)["n"] == 0


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_contact_detection_analysis(case):
    if case == "jax_test":
        pred = {"HFL_foot": [[10, 20, 0, "leading"]], "HFR_foot": None,
                "HBL_foot": None, "HBR_foot": None}
        lab = {"HFL_foot": [[12, 20, 0, "leading"]], "HFR_foot": None,
               "HBL_foot": None, "HBR_foot": None}
        kw = dict(n_frames=40, start_frame=0)
    else:
        pred = {"HFL_foot": [[3, 9, 1]], "HFR_foot": [[20, 31, 1]],
                "HBL_foot": [[5, 6, 1], [40, 44, 1]], "HBR_foot": None}
        lab = {"HFL_foot": [[4, 10, 1]], "HFR_foot": None,
               "HBL_foot": [[2, 7, 1]], "HBR_foot": [[10, 12, 1]]}
        kw = dict(n_frames=30, start_frame=2)
    t = TR.contact_detection_analysis(pred, lab, **kw)
    _same_dict(t, JR.contact_detection_analysis(pred, lab, **kw))


def test_determine_dlc_performance(tmp_path, monkeypatch):
    """The JAX package reads the CSV tables through pandas here (its C++
    parser rounds pixels by ~6e-5)."""
    d = list(jio.load_dlc_points.__defaults__)
    d[-1] = False
    monkeypatch.setattr(jio.load_dlc_points, "__defaults__", tuple(d))
    rng = np.random.default_rng(6)
    n, L = 15, 24
    for sub, start in (("dlc", 0), ("hand", 2)):
        for c in range(2):
            xy = rng.uniform(0, 500, size=(n, L, 2))
            lik = rng.uniform(0, 1, size=(n, L))
            if sub == "hand":
                lik = (lik > 0.3).astype(float)
            tio.save_dlc_table(str(tmp_path / sub / f"cam{c + 1}.csv"), xy,
                               lik, start_frame=start)
    for thresh in (0.5, 0.9):
        _same_dict(TR.determine_dlc_performance(
            str(tmp_path / "dlc"), str(tmp_path / "hand"), thresh),
            JR.determine_dlc_performance(str(tmp_path / "dlc"),
                                         str(tmp_path / "hand"), thresh))


def test_plot_cost_functions(tmp_path, request):
    out = str(tmp_path / "cost.pdf")
    assert TR.plot_cost_functions(out) and os.path.getsize(out) > 0
    request.getfixturevalue("no_matplotlib")
    assert TR.plot_cost_functions(str(tmp_path / "x.pdf")) is False
    assert not os.path.exists(tmp_path / "x.pdf")


def _fte(path, q, fps=100.0, **extra):
    """A saved solution of q (N, 54): markers, rates by differences."""
    subject = tparams.get_subject("acinoset")
    dq = np.gradient(q, axis=0) * fps
    ddq = np.gradient(dq, axis=0) * fps
    pos = tsyn.fk_markers_np(q, subject)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(dict(q=q, dq=dq, ddq=ddq, positions=pos, **extra), f)
    return pos


def test_plot_eom_error(tmp_path, request):
    q = _gallop(16, seed=3)
    p = str(tmp_path / "fte.pickle")
    _fte(p, q)
    t = TR.plot_eom_error(p, tparams.get_subject("acinoset"),
                          str(tmp_path / "eom.pdf"), device="cpu")
    j = JR.plot_eom_error(p, jparams.get_subject("acinoset"),
                          str(tmp_path / "jeom.pdf"))
    _close(t, j)
    assert os.path.getsize(tmp_path / "eom.pdf") > 0
    request.getfixturevalue("no_matplotlib")
    t2 = TR.plot_eom_error(p, tparams.get_subject("acinoset"),
                           str(tmp_path / "x.pdf"), device="cpu")
    assert np.array_equal(t, t2) and not os.path.exists(tmp_path / "x.pdf")


def _power_case(case):
    if case == "jax_test":
        from cheetah_pose_estimation_tpu_torch.dynamics.eom import TORQUE_MAP
        fps, N = 100.0, 20
        q = np.zeros((N, 54))
        col = TORQUE_MAP.names.index("UFL_LFL_torque:y")
        (j,) = np.nonzero(TORQUE_MAP.B[:, col] == 1.0)
        q[:, j[0]] = 2.0 * np.arange(N) / fps
        tau = np.zeros((N, len(TORQUE_MAP.names)))
        tau[:, col] = 3.0
        return q, tau, fps, 1.0
    rng = np.random.default_rng(7)
    return _gallop(24), rng.normal(size=(22, 22)), 120.0, 9.81


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_power_values(case, tmp_path, capsys, request):
    q, tau, fps, fs = _power_case(case)
    _same_dict(TR.get_power_values(q, tau, fps, fs),
               JR.get_power_values(q, tau, fps, fs))
    out = str(tmp_path / "p.pdf")
    _same_dict(TR.plot_power_values(q, tau, fps, out, fs),
               JR.plot_power_values(q, tau, fps, str(tmp_path / "j.pdf"),
                                    fs))
    assert os.path.getsize(out) > 0
    request.getfixturevalue("no_matplotlib")
    skipped = str(tmp_path / "x.pdf")
    stats = TR.plot_power_values(q, tau, fps, skipped, fs)
    assert stats == TR.plot_power_values(q, tau, fps, out, fs)
    assert not os.path.exists(skipped) and skipped in capsys.readouterr().out


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_torque_error(case):
    if case == "jax_test":
        t1, t2 = np.ones((10, 4)), np.zeros((12, 4))
    else:
        rng = np.random.default_rng(8)
        t1, t2 = rng.normal(size=(9, 22)), rng.normal(size=(7, 22))
    for t, j in zip(TR.torque_error(t1, t2), JR.torque_error(t1, t2)):
        _close(t, j)


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_align_error_trajectories(case, tmp_path, request):
    if case == "jax_test":
        trajs = [np.linspace(0, 1, n) for n in (5, 9, 17)]
    else:
        rng = np.random.default_rng(9)
        trajs = [rng.uniform(0, 100, size=n) for n in (11, 30, 23, 30)]
    t, j = TR.align_error_trajectories(trajs), \
        JR.align_error_trajectories(trajs)
    assert t[0] == j[0]
    for a, b in zip(t[1:], j[1:]):
        _close(a, b)
    out = tmp_path / "bands.pdf"
    sets = ([x + 1 for x in trajs], trajs, [x * 2 for x in trajs])
    assert TR.align_error_and_plot(*sets, str(out)) and out.exists()
    request.getfixturevalue("no_matplotlib")
    assert TR.align_error_and_plot(*sets, str(tmp_path / "x.pdf")) is False
    assert not (tmp_path / "x.pdf").exists()


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_save_error_dists(case, tmp_path, request):
    rng = np.random.default_rng(0 if case == "jax_test" else 10)
    px = ({0: rng.uniform(0, 5, 100), 2: rng.uniform(0, 8, 50)}
          if case == "jax_test" else
          {1: rng.exponential(3.0, 40), 3: rng.exponential(1.0, (5, 7))})
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    _close(TR.save_error_dists(px, str(tdir)),
           JR.save_error_dists(px, str(jdir)))
    for d in (tdir, jdir):
        assert (d / "overall_error_hist.pdf").exists()
        assert (d / "cams_error_hist.pdf").exists()
    with open(tdir / "reprojection.pickle", "rb") as f:
        t = pickle.load(f)
    with open(jdir / "reprojection.pickle", "rb") as f:
        j = pickle.load(f)
    assert set(t) == set(j) == {"error", "mean_error", "med_error"}
    for k in j:
        _close(t[k], j[k])
    request.getfixturevalue("no_matplotlib")
    bdir = tmp_path / "b"
    _close(TR.save_error_dists(px, str(bdir)), (t["mean_error"],
                                                t["med_error"]))
    assert sorted(os.listdir(bdir)) == ["reprojection.pickle"]


def test_plot_3d_pose(tmp_path, request):
    """The likelihoods against JAX's GMM (``gmm.fit``, seed 42, no cache)
    scoring the same solved and distorted poses."""
    q = _gallop(12, seed=4)
    p = str(tmp_path / "fte.pickle")
    _fte(p, q)
    dset = str(tmp_path / "pose.csv")
    tds.save_pose_dataset(dset, bench_lib.procedural_pose_table(
        (100, 101, 102), n_frames=80))
    subject = tparams.get_subject("acinoset")
    out = str(tmp_path / "pose.pdf")
    ll = TR.plot_3d_pose(p, 5, subject, dset, out, device="cpu")
    assert os.path.getsize(out) > 0
    model = jgmm.fit(jds.load_pose_dataset(dset).iloc[:, 6:28].to_numpy(),
                     n_components=5, seed=42)
    q_bad = q[5].copy()
    q_bad[3:12:3] = np.pi / 6
    q_bad[3:12:2] = -np.pi / 6
    x = np.asarray(jsk.relative_pose(np.stack([q[5], q_bad])))[:, 6:]
    _close(ll, [jgmm.score(model, x[:1]), jgmm.score(model, x[1:])], 1e-9)
    assert ll[0] > ll[1]
    request.getfixturevalue("no_matplotlib")
    assert TR.plot_3d_pose(p, 5, subject, dset, str(tmp_path / "x.pdf"),
                           device="cpu") == ll
    assert not os.path.exists(tmp_path / "x.pdf")


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_std_dev(case):
    rng = np.random.default_rng(0 if case == "jax_test" else 11)
    pred = rng.normal(size=(10, 3))
    targ = pred + 1.0 if case == "jax_test" else rng.normal(size=(10, 3))
    if case == "own":
        targ[2, 1] = np.nan
    _close(TR.std_dev(pred, targ), JR.std_dev(pred, targ))


def _joint_trees(tmp_path, case):
    rng = np.random.default_rng(3 if case == "jax_test" else 12)
    pos = rng.normal(size=(8, 24, 3))
    if case == "jax_test":
        tau_gt = {"hip": rng.normal(size=(8, 2)),
                  "knee": rng.normal(size=(8,))}
        tau = {"knee": np.concatenate([tau_gt["knee"], np.zeros(3)]),
               "hip": np.concatenate([tau_gt["hip"] + 0.5,
                                      np.zeros((3, 2))], axis=0)}
        pos_est = pos
    else:
        tau_gt = {m: rng.normal(size=(8, k))
                  for m, k in (("a", 3), ("b", 1), ("c", 2))}
        tau = {"c": rng.normal(size=(6, 3)), "a": rng.normal(size=(9, 3)),
               "d": rng.normal(size=(8, 1))}
        pos_est = pos + rng.normal(scale=0.01, size=pos.shape)
    kw = dict(cheetah="jules", date="2019_03_09", trial="02")
    for root, t, p in (("gt", tau_gt, pos), ("est", tau, pos_est)):
        d = tmp_path / root / "kinetic_dataset" / kw["date"] \
            / kw["cheetah"] / f"trial{kw['trial']}" / "fte_kinetic"
        d.mkdir(parents=True)
        with open(d / "fte.pickle", "wb") as f:
            pickle.dump({"positions": p, "tau": t}, f)
    return str(tmp_path / "est"), str(tmp_path / "gt"), kw


@pytest.mark.parametrize("case", ["jax_test", "own"])
def test_check_joint_estimation(case, tmp_path):
    est, gt, kw = _joint_trees(tmp_path, case)
    t = TR.check_joint_estimation(est, gt, **kw)
    _same_dict(t, JR.check_joint_estimation(est, gt, **kw))
    s = TR.check_joint_estimation(gt, gt, **kw)
    assert s == {"mpjpe_mm": 0.0, "torque_rmse": 0.0}


def test_animate_torque_plot(tmp_path, request):
    rng = np.random.default_rng(1)
    tau = {"hip": rng.normal(size=(6, 2)), "knee": rng.normal(size=(6, 1))}
    out = tmp_path / "torque.gif"
    assert TR.animate_torque_plot(tau, fps=10.0, out_path=str(out))
    assert out.stat().st_size > 0
    request.getfixturevalue("no_matplotlib")
    assert TR.animate_torque_plot(tau, 10.0, str(tmp_path / "x.gif")) \
        is False
    assert not (tmp_path / "x.gif").exists()


def _compare_tree(root):
    """A trial's multi-view solve and its three monocular solutions for
    camera 2 (the kinetic one also as ``fte2``), of different lengths."""
    rng = np.random.default_rng(13)
    gt = _fte(str(root / "fte_kinematic" / "fte.pickle"), _gallop(20))
    for sub, n, s in (("fte_kinematic_orig_2", 20, 0.05),
                      ("fte_kinematic_2", 18, 0.02),
                      ("fte_kinetic_2", 20, 0.03)):
        q = _gallop(20)[:n] + rng.normal(scale=s, size=(n, 54))
        _fte(str(root / sub / "fte.pickle"), q)
        if sub == "fte_kinetic_2":
            _fte(str(root / sub / "fte2.pickle"), q[::-1].copy())
    return gt


@pytest.mark.parametrize("kinetic", [(False, "fte"), (True, "fte"),
                                     (True, "fte2")])
def test_compare_traj_error(kinetic, tmp_path, request):
    include, fname = kinetic
    _compare_tree(tmp_path)
    t = TM.compare_traj_error(str(tmp_path), 2, include, fname)
    j = JM.compare_traj_error(str(tmp_path), 2, include, fname,
                              save_plots=False)
    assert list(t) == list(j) == ["single view", "data-driven"] + (
        ["physics-based"] if include else [])
    for mode in j:
        for k in ("mpe_mm", "mpjpe_mm", "smoothness_mm"):
            _close(t[mode][k], j[mode][k])
        _close(t[mode]["per_joint"], j[mode]["per_joint"].to_numpy()[:, 0])
    last = "fte_kinetic_2" if include else "fte_kinematic_2"
    suffix = "" if fname == "fte" else "2"
    for n in ("traj_error", "mpjpe_dist"):
        assert (tmp_path / last / f"{n}{suffix}.pdf").stat().st_size > 0
    request.getfixturevalue("no_matplotlib")
    for n in ("traj_error", "mpjpe_dist"):
        os.remove(tmp_path / last / f"{n}{suffix}.pdf")
    b = TM.compare_traj_error(str(tmp_path), 2, include, fname)
    assert {m: v["mpe_mm"] for m, v in b.items()} == \
        {m: v["mpe_mm"] for m, v in t.items()}
    assert not (tmp_path / last / f"traj_error{suffix}.pdf").exists()


def test_visualize(tmp_path, request):
    assert TV.SKELETON_EDGES == JV.SKELETON_EDGES
    p = str(tmp_path / "a" / "fte.pickle")
    pos = _fte(p, _gallop(12))
    ref_p = str(tmp_path / "b" / "fte.pickle")
    _fte(ref_p, _gallop(12, seed=1))
    assert TV.plot_pose(pos[0], str(tmp_path / "pose.pdf"), overlay=pos[1])
    assert TV.plot_pose(pos, str(tmp_path / "pose2.png"))
    written = TV.render_trial(p, reference_pickle_path=ref_p, fps=10.0)
    jwritten = JV.render_trial(p, str(tmp_path / "j.mp4"), ref_p, 10.0)
    assert os.path.splitext(written) == (
        os.path.join(os.path.dirname(p), "animation"),
        os.path.splitext(jwritten)[1])
    assert os.path.getsize(written) > 0
    w2 = TV.animate(pos, str(tmp_path / "s.mp4"), stride=2)
    assert os.path.getsize(w2) > 0
    request.getfixturevalue("no_matplotlib")
    assert TV.plot_pose(pos[0], str(tmp_path / "x.pdf")) is False
    assert TV.render_trial(p, str(tmp_path / "x.mp4")) is False
    assert TV.animate(pos, str(tmp_path / "y.mp4")) is False
    assert not any(f.startswith(("x", "y")) for f in os.listdir(tmp_path))
