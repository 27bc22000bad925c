"""The PyTorch port runs without JAX, pandas, matplotlib or the JAX
package: in a fresh interpreter where importing ``jax``, ``jaxlib``,
``pandas`` or ``matplotlib`` fails as on a machine without them, import
the port, build and solve a 2-trial 16-frame problem on the CPU, train small priors and run the data-driven stage and
then the physics stage on it with tiny schedules; render the first trial of the dataset CLI's synthetic test
set (``--materialize_synthetic``) and run the CLI's ground-truth mode on it
(``run_monocular_batched``, multi-view), then the serial per-trial path on
it (``run_monocular``, the default and physics-based modes, tiny
schedules, priors trained on small procedural tables), the model
selection and the batched data-driven ablation (``--run_data_driven_
ablation_study --batched``) on it, the solver options (the fixed-length
driver, the joint shutter-delay solve, the physics stage with the
complementarity penalty and 3D tracking, the rolling AR refinement), and
import the
force-plate analysis and the static GRF solver and run the solver on a
short trajectory, and write, read and assemble the first trial's pairwise
pseudo-measurements (``data/ppm``), the dynamics tools (a tiny
trajectory-generation solve, RK4 steps with passive elements) and the
remaining prior options (a PCA fit, a PCA-space AR model, a line-scan with
a finish), the three response studies (the forced-vs-gated bench and a
deadband row on two 16-frame trials) and the results layer
(``compare_traj_error``, the power traces, plots that report False with
matplotlib blocked too); then check ``sys.modules``. No
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
    for blocked in ("jax", "jaxlib", "pandas", "matplotlib"):
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
    probe = fte.make_solver(stages=((10.0, 2),), driver="scan")
    full = fte.make_solver(stages=((3.0, 2), (1.0, 2)))
    st = pbatch.make_multistart_probe(probe, full)(q0b, batched)
    assert st.q.shape == (2, 16, 54) and torch.isfinite(st.cost).all()
    st_scan = fte.make_solver(stages=((3.0, 2), (1.0, 2)), driver="scan")(
        q0b, batched)
    assert st_scan.it.tolist() == [4, 4]
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
        scan_stages=((1.0, 1),), motion_prior_rolling=1)
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
    from cheetah_pose_estimation_tpu_torch.pipeline import studies
    dataset.save_pose_dataset(os.path.join(tmp, "priors",
                                           "validation_dataset.csv"), val)
    sel = studies.model_selection_analysis(
        dset, pose_components=(1,), window_sizes=(1,), out_dir=tmp,
        device="cpu")
    assert [len(v) for v in sel.values()] == [1, 1, 2, 2, 2]
    pbatch.PROBE_STAGES, pbatch.FULL_STAGES = ((10.0, 1),), ((1.0, 2),)
    rep = run_dataset.main(["--run_data_driven_ablation_study", "--batched",
                            "--root_dir", tmp, "--out_dir_prefix",
                            os.path.join(tmp, "out"), "--device", "cpu"],
                           report={})
    rows = rep["studies"]["dd_ablation"]["result"]
    assert [r["n"] for r in rows] == [1] * 4, rows
    assert os.path.exists(os.path.join(tmp, "out",
                                       "data_driven_ablation_results.csv"))
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
    # the solver options: the joint shutter-delay solve, then the physics
    # stage with the complementarity penalty and 3D tracking
    kin.KinematicFTE.make_joint_shutter_solver.__defaults__ = (2,) + \
        kin.KinematicFTE.make_joint_shutter_solver.__defaults__[1:]
    opt = os.path.join(tmp, "options")
    est = estimator.init_trajectory(tmp, os.path.join(d, c, t), c,
                                    shutter_delay_estimation=True)
    assert estimator.estimate_kinematics(est, out_dir_prefix=opt,
                                         dtype=torch.float64, device="cpu")
    assert est.shutter_delay.shape == (6,) and est.shutter_delay[0] == 0.0
    assert sorted(est.solution_details())[0] == "cost"
    estimator.determine_contacts(est, out_dir_prefix=opt)
    assert estimator.estimate_kinetics(
        est, enable_lcp=True, use_2d_reprojections=False, out_dir_prefix=opt,
        save=False, dtype=torch.float64, device="cpu")
    assert results.check_lcp(est.grf_z, np.zeros_like(est.grf_z))["ok"]
    # the dynamics tools: a tiny task solve, RK4 steps with passive
    # elements; the PCA prior, the PCA-space AR model, a finished line-scan
    from cheetah_pose_estimation_tpu_torch.dynamics import passive, simulate
    from cheetah_pose_estimation_tpu_torch.dynamics import tasks
    from cheetah_pose_estimation_tpu_torch.priors import pca
    sub = params.get_subject("acinoset")
    out = tasks.high_speed_stop(sub, n_frames=6, settle_frames=2,
                                max_iters=2, device="cpu",
                                dtype=torch.float64)
    assert out["q"].shape == (6, 54) and out["iterations"] == 2
    joint = [("base", "tail0", "y")]
    ext = passive.make_ext_q_fn(
        sub, passive.cylinder_drag_coefficients(sub),
        passive.make_torque_spring(joint, 50.0, device="cpu"),
        passive.make_torque_damper(joint, 5.0, device="cpu"))
    qs, _ = simulate.simulate(sub, simulate.drop_pose(sub, height=0.9),
                              np.zeros(54), 4 * 2e-4, record_every=2,
                              ext_q_fn=ext, device="cpu")
    assert qs.shape == (3, 54) and np.isfinite(qs).all()
    pm = pca.fit(train)
    mmp = armodel.train_motion_model(train, validation=val, pose_model=pm,
                                     device="cpu")
    assert mmp.coef.shape == (11, 44) and np.isfinite(mmp.coef).all()
    qn = st.q.double().numpy()
    rays = np.stack([depth_anchor.camera_ray(
        qn[i], batched.cam.R[i, 0].numpy(), batched.cam.t[i, 0].numpy())
        for i in range(2)])
    # margin -1 accepts the zero shift, so the finish runs on both lanes
    scan = depth_anchor.make_depth_linescan(
        sub, ((1.0, 1),), shifts=(0.5, 0.0, 0.5), margin=-1.0,
        finish_stages=((1.0, 1), (1.0, 1)))
    q_fin, sh = scan(st.q, batched, rays)
    assert q_fin.shape == (2, 16, 54) and torch.isfinite(q_fin).all()
    assert not torch.equal(q_fin, st.q) and sh.tolist() == [0.0, 0.0]
    # the response studies on two 16-frame trials, then the results layer
    bench_lib.load_reference_trajectories = lambda m=None: [
        (syn.gallop_trajectory(16, seed=i), "acinoset", 120.0)
        for i in range(2)]
    fvg = studies.run_forced_vs_gated_bench(
        out_csv=os.path.join(tmp, "fvg", "fvg.csv"), n_frames=16,
        dtype=torch.float64, device="cpu", verbose=False)
    assert [r["trial"] for r in fvg] == ["synthetic_gallop_0",
                                         "synthetic_gallop_1"]
    assert np.isfinite([r["mpe_dd_forced_anch"] for r in fvg]).all()
    db = studies.run_deadband_sweep(
        base_deadbands=(None,), grf_maxes=(5.0,), n_frames=16, max_trials=2,
        out_dir=tmp, dtype=torch.float64, device="cpu", verbose=False)
    assert db[0]["base_deadband"] == "floor"
    assert np.isfinite(db[0]["comvel_rmse"])
    import shutil
    shutil.copytree(os.path.join(tmp, "out", d, c, t, "fte_kinematic"),
                    os.path.join(base, "fte_kinematic"))
    cmp = metrics.compare_traj_error(base, 2, include_kinetic=True)
    assert list(cmp) == ["single view", "physics-based"]
    assert np.isfinite(cmp["physics-based"]["mpjpe_mm"])
    power = results.get_power_values(qk.numpy(), np.ones((6, 22)), 200.0)
    assert np.isfinite(np.hstack(list(power.values()))).all()
    assert results.plot_cost_functions(os.path.join(tmp, "c.pdf")) is False
    assert not os.path.exists(os.path.join(tmp, "c.pdf"))
    from cheetah_pose_estimation_tpu_torch.pipeline import visualize
    assert visualize.render_trial(os.path.join(
        base, "fte_kinetic_2", "fte.pickle")) is False
    bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                 and m.split(".")[0] in ("jax", "jaxlib", "pandas",
                                         "matplotlib",
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
