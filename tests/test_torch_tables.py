"""The port's copies of the JAX package's numpy-only tables are exact, and
the port's device default is the card.

``cheetah_pose_estimation_tpu_torch/models/params.py`` and ``noise.py`` are
copies (the port imports nothing of the JAX package): every subject field
and every noise table equals the original bit for bit (numpy
``array_equal``). ``resolve_device()`` never gives the CPU: without a card
it raises, and the CPU is used only when asked for.
"""
import dataclasses

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import noise as jnoise
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu_torch.models import noise as tnoise
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.utils import device as tdevice


@pytest.mark.parametrize("name", ["acinoset", "jules", "phantom", "shiraz",
                                  "arabia", "unknown"])
def test_subject_params_equal_jax(name):
    a, b = tparams.get_subject(name), jparams.get_subject(name)
    for f in dataclasses.fields(jparams.SubjectParams):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert np.array_equal(np.asarray(va), np.asarray(vb)), f.name
    assert a.total_mass == b.total_mass


def test_link_tables_equal_jax():
    assert tparams.LINK_NAMES == jparams.LINK_NAMES
    assert tparams.LINK_INDEX == jparams.LINK_INDEX
    assert (tparams.N_LINKS, tparams.NQ) == (jparams.N_LINKS, jparams.NQ)
    assert sorted(tparams.PARAMETERS) == sorted(jparams.PARAMETERS)


def test_noise_tables_equal_jax():
    for name in ("R_BASE", "_R_PW1", "_R_PW2", "R_PW", "_Q_STD", "Q",
                 "EOM_SLACK_FLOOR", "KINEMATIC_M"):
        assert np.array_equal(getattr(tnoise, name), getattr(jnoise, name)), \
            name
    for n in (1, 3):
        for kinetic in (False, True):
            assert np.array_equal(tnoise.measurement_weights(n, kinetic),
                                  jnoise.measurement_weights(n, kinetic))
    for floor in (1e-6, 0.0):
        assert np.array_equal(tnoise.acc_model_weights(floor),
                              jnoise.acc_model_weights(floor))


def test_ppm_tables_equal_jax():
    assert tnoise.N_DLC_PARTS == jnoise.N_DLC_PARTS
    assert tnoise.DLC_MARKER_INDEX == jnoise.DLC_MARKER_INDEX
    assert tnoise.PAIRWISE_GRAPH == jnoise.PAIRWISE_GRAPH
    assert list(tnoise.PAIRWISE_GRAPH) == list(jnoise.PAIRWISE_GRAPH)


def test_resolve_device_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    assert tdevice.resolve_device(torch.device("cpu")).type == "cpu"


def test_entry_points_need_the_card_or_cpu(monkeypatch):
    """Without a card, an entry point called without ``device`` raises
    instead of quietly taking the CPU."""
    from cheetah_pose_estimation_tpu_torch.parallel import batch as pbatch
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, q0, _ = bench_lib.build_monocular_problem(
        bench_lib.syn.gallop_trajectory(8, seed=0), "acinoset", 120.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pbatch.pad_and_stack([d], [q0])
    batched, q0b = pbatch.pad_and_stack([d], [q0], device="cpu")
    assert q0b.device.type == "cpu" and batched.meas.device.type == "cpu"


def test_physics_entry_points_need_the_card_or_cpu(monkeypatch):
    """The physics stage's batch builders take the card by default too."""
    from cheetah_pose_estimation_tpu_torch.models import params
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = bench_lib.syn.gallop_trajectory(12, seed=0)
    d, _, _ = bench_lib.build_monocular_problem(q, "acinoset", 120.0)
    subject = params.get_subject("acinoset")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench_lib.build_physics_batch([d], [q], [120.0], subject)
    kbat, qw = bench_lib.build_physics_batch([d], [q], [120.0], subject,
                                             device="cpu")
    assert qw.device.type == "cpu" and kbat.stance.device.type == "cpu"
    assert kbat.stance.shape == (1, 12, 4)


@pytest.mark.parametrize("flag", ["--run_acinoset", "--run_analysis"])
def test_dataset_flags_need_the_card_or_cpu(monkeypatch, tmp_path, flag):
    """The AcinoSet and analysis flags and their entry points take the
    card by default and raise without one, before solving anything."""
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, out = str(tmp_path / "videos"), str(tmp_path / "out")
    fn = (run_dataset.run_acinoset if flag == "--run_acinoset"
          else run_dataset.run_monocular_all)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(root, out)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_dataset.main([flag, "--clean", "--root_dir", root,
                          "--out_dir_prefix", out])
    # on the CPU, an empty root solves nothing
    assert fn(root, out, device="cpu") in ([], None)


def _dynamics_entry_points():
    """Each new entry point of the dynamics tools and prior options, called
    at a tiny size with the given device keyword."""
    from cheetah_pose_estimation_tpu_torch.dynamics import passive, simulate
    from cheetah_pose_estimation_tpu_torch.dynamics import tasks
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.priors import armodel, pca

    sub = tparams.get_subject("acinoset")
    joint = [("base", "tail0", "y")]

    def pca_ar(**kw):
        tab = bench_lib.procedural_pose_table((100,), n_frames=30)
        return armodel.train_motion_model(tab, validation=tab,
                                          pose_model=pca.fit(tab), **kw)

    return {
        "high_speed_stop": lambda **kw: tasks.high_speed_stop(
            sub, n_frames=5, settle_frames=2, max_iters=1,
            dtype=torch.float64, **kw),
        "periodic_gallop": lambda **kw: tasks.periodic_gallop(
            sub, n_frames=6, foot_order=((1, 3), (2, 4), (3, 5), (4, 6)),
            max_iters=1, dtype=torch.float64, **kw),
        "simulate": lambda **kw: simulate.simulate(
            sub, simulate.drop_pose(sub), np.zeros(54), 2e-4,
            record_every=1, **kw),
        "drop_test": lambda **kw: simulate.drop_test(sub, duration=2e-4,
                                                     **kw),
        "make_torque_spring": lambda **kw: passive.make_torque_spring(
            joint, 1.0, **kw),
        "make_torque_damper": lambda **kw: passive.make_torque_damper(
            joint, 1.0, **kw),
        "train_motion_model(pose_model)": pca_ar,
    }


@pytest.mark.parametrize("entry", sorted(_dynamics_entry_points()))
def test_dynamics_entry_points_need_the_card_or_cpu(monkeypatch, entry):
    """The trajectory-generation tasks, the simulator, the passive elements
    and the PCA-space AR model take the card by default, raise without
    one, and run on the CPU when told."""
    fn = _dynamics_entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()
    assert fn(device="cpu") is not None


def _response_entry_points():
    """The response studies' and the results layer's entry points that
    compute on a device, called without a device."""
    from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib
    from cheetah_pose_estimation_tpu_torch.pipeline import results, studies

    sub = tparams.get_subject("acinoset")
    return {
        "run_forced_vs_gated_bench": studies.run_forced_vs_gated_bench,
        "run_deadband_sweep": studies.run_deadband_sweep,
        "run_physics_lever_sweep": studies.run_physics_lever_sweep,
        "make_anchor_polish": lambda: bench_lib.make_anchor_polish(sub),
        "plot_eom_error": lambda: results.plot_eom_error("x", sub, "x.pdf"),
        "plot_3d_pose": lambda: results.plot_3d_pose("x", 0, sub, "x",
                                                     "x.pdf"),
    }


@pytest.mark.parametrize("entry", sorted(_response_entry_points()))
def test_response_entry_points_need_the_card(monkeypatch, entry):
    """The response studies, the bench anchor polish and the results
    functions that run the kinematics or the EOM take the card by default
    and raise without one before any work (their CPU runs, with
    ``device="cpu"``, are in test_torch_responses.py and
    test_torch_results.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _response_entry_points()[entry]()
