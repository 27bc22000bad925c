"""The PyTorch port runs without JAX, pandas or the JAX package: in a fresh
interpreter where importing ``jax``, ``jaxlib`` or ``pandas`` fails as on a
machine without them, import the port, build and solve a 2-trial 16-frame
problem on the CPU, train small priors and run the data-driven stage and
then the physics stage on it with tiny schedules; render the first trial of the dataset CLI's synthetic test
set (``--materialize_synthetic``) and run the CLI's ground-truth mode on it
(``run_monocular_batched``, multi-view), then the serial per-trial path on
it (``run_monocular``, the default and physics-based modes, tiny
schedules, priors trained on small procedural tables), and import the
force-plate analysis and the static GRF solver and run the solver on a
short trajectory, and write, read and assemble the first trial's pairwise
pseudo-measurements (``data/ppm``); then check
``sys.modules``. No
module of ``cheetah_pose_estimation_tpu`` may be loaded: the port keeps its
own copies of the tables it needs."""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    # as on a machine without them: importing raises ModuleNotFoundError,
    # importlib.util.find_spec returns None
    for blocked in ("jax", "jaxlib", "pandas"):
        sys.modules[blocked] = None
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from cheetah_pose_estimation_tpu_torch.data import synthetic as syn
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.solver import kinematic as kin
    datas, q0s = [], []
    for i in range(2):
        d, q0, _ = bench_lib.build_monocular_problem(
            syn.gallop_trajectory(16, seed=i), "acinoset", 120.0, seed=i)
        datas.append(d)
        q0s.append(q0)
    batched, q0b = pbatch.pad_and_stack(datas, q0s, device="cpu")
    from cheetah_pose_estimation_tpu_torch.models import params
    fte = kin.KinematicFTE(kin.KinematicConfig(),
                           params.get_subject("acinoset"))
    probe = fte.make_solver(stages=((10.0, 2),), driver="fixed")
    full = fte.make_solver(stages=((3.0, 2), (1.0, 2)))
    st = pbatch.make_multistart_probe(probe, full)(q0b, batched)
    assert st.q.shape == (2, 16, 54) and torch.isfinite(st.cost).all()
    from cheetah_pose_estimation_tpu_torch import convert
    from cheetah_pose_estimation_tpu_torch.pipeline import batched as pb
    from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor
    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.priors import armodel, dataset
    from cheetah_pose_estimation_tpu_torch.priors import gmm
    train = bench_lib.procedural_pose_table((100, 101), n_frames=60)
    val = bench_lib.procedural_pose_table((200,), n_frames=60)
    prior = gmm.to_solver_prior(gmm.fit(train.data[:, 6:28], 2, max_iter=5,
                                        device="cpu"))
    mm = armodel.train_motion_model(train, validation=val, device="cpu")
    q, ok, shifts = pb.run_data_driven(
        st.q, batched, convert.gmm_prior(prior, 2, device="cpu"), mm,
        params.get_subject("acinoset"), stages=((10.0, 1), (1.0, 2)),
        scan_stages=((1.0, 1),))
    assert q.shape == (2, 16, 54) and torch.isfinite(q).all()
    assert ok.shape == (2,) and shifts.shape == (2,)
    from cheetah_pose_estimation_tpu_torch.pipeline import contacts
    gphs = [contacts.estimate_ground_height(
        syn.gallop_trajectory(16, seed=i), params.get_subject("acinoset"))
        for i in range(2)]
    timings = {}
    st2, kbat = pb.run_physics(q, datas, [120.0, 120.0],
                               params.get_subject("acinoset"), prior,
                               ground_heights=gphs,
                               stages=((3.0, 1), (1.0, 2)), timings=timings)
    assert st2.q.shape == (2, 16, 54) and torch.isfinite(st2.q).all()
    assert sorted(timings) == ["curvature", "host_prep", "lm"]
    import os
    import tempfile
    from cheetah_pose_estimation_tpu_torch.data import io
    from cheetah_pose_estimation_tpu_torch.pipeline import metrics
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    from cheetah_pose_estimation_tpu_torch.utils import data_ops
    tmp = tempfile.mkdtemp()
    run_dataset.TEST_SET = run_dataset.TEST_SET[:1]
    run_dataset.main(["--materialize_synthetic", "--root_dir", tmp])
    (c, d, t), = run_dataset.TEST_SET
    xy, lik, _ = io.load_dlc_points(os.path.join(tmp, d, c, t, "dlc"), 6)
    assert xy.shape == (40, 6, 24, 2) and lik.shape == (40, 6, 24)
    rep = {}
    pb.run_monocular_batched(tmp, os.path.join(tmp, "out"),
                             run_dataset.TEST_SET, modes=("ground-truth",),
                             device="cpu", verbose=False, report=rep)
    out = data_ops.load_pickle(os.path.join(tmp, "out", d, c, t,
                                            "fte_kinematic", "fte.pickle"))
    assert out["q"].shape == (40, 54) and np.isfinite(out["q"]).all()
    truth = data_ops.load_pickle(os.path.join(tmp, d, c, t,
                                              "synthetic_gt.pickle"))
    mpjpe = metrics.traj_error(truth["positions"], out["positions"],
                               centered=True)[0].mean()
    assert mpjpe < 60.0, mpjpe
    assert rep["ground-truth"]["trials"] == [os.path.join(d, c, t)]
    from cheetah_pose_estimation_tpu_torch.solver import kinetic as kn
    kin.KinematicFTE.make_solver.__defaults__ = (
        ((10.0, 1), (1.0, 2)),) + kin.KinematicFTE.make_solver.__defaults__[1:]
    kn.KineticFTE.make_solver.__defaults__ = (
        ((3.0, 1), (1.0, 2)),) + kn.KineticFTE.make_solver.__defaults__[1:]
    depth_anchor.POLISH_STAGES = ((1.0, 2),)
    dset = os.path.join(tmp, "priors", "dataset_full_pose.csv")
    dataset.save_pose_dataset(dset, train)
    os.environ["CHEETAH_DATA_DRIVEN_DATASET"] = dset
    rep = {}
    run_dataset.run_monocular(tmp, os.path.join(tmp, "serial"),
                              modes=("default", "physics-based"),
                              dtype=torch.float64, device="cpu",
                              verbose=False, report=rep)
    base = os.path.join(tmp, "serial", d, c, t)
    for sub in ("fte_kinematic_orig_2", "fte_kinetic_2"):
        out = data_ops.load_pickle(os.path.join(base, sub, "fte.pickle"))
        assert out["q"].shape == (40, 54) and np.isfinite(out["q"]).all()
    assert os.path.exists(os.path.join(base, "grf", "data_synth.csv"))
    assert rep["physics-based"]["per_trial"][os.path.join(d, c, t)][
        "attempt"] == 1
    from cheetah_pose_estimation_tpu_torch.pipeline import results
    from cheetah_pose_estimation_tpu_torch.solver import static_grf
    qk = torch.as_tensor(syn.gallop_trajectory(6, fps=200.0, seed=0))
    gz, gxy = static_grf.estimate_static_grf(
        qk, torch.zeros_like(qk), torch.zeros_like(qk),
        torch.ones(6, 4, dtype=torch.float64), params.get_subject("shiraz"))
    assert gz.shape == (6, 4) and torch.isfinite(gxy).all()
    assert sorted(results.check_grf(gxy.numpy())) == ["n_invalid", "ok"]
    from cheetah_pose_estimation_tpu_torch.data import ppm
    est = estimator.init_trajectory(tmp, os.path.join(d, c, t), c)
    pose, plik, pws = ppm.synthesize_ppm(xy[:, 0], lik[:, 0], seed=0)
    ppm.save_ppm_pickle(os.path.join(tmp, "pw.pickle"), pose, plik, pws)
    meas, w = ppm.assemble_ppm_measurements(
        xy, lik, [ppm.load_ppm_pickle(os.path.join(tmp, "pw.pickle"))] * 6,
        0, 40)
    assert meas.shape == (40, 6, 24, 2, 3) and w.shape == (40, 6, 24, 3)
    assert np.array_equal(meas[..., 0], est.data.meas[..., 0])
    bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                 and m.split(".")[0] in ("jax", "jaxlib", "pandas",
                                         "cheetah_pose_estimation_tpu"))
    print("FORBIDDEN", bad)
    assert not bad, bad
""")


def test_port_imports_no_jax_pandas_or_jax_package():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FORBIDDEN []" in proc.stdout
