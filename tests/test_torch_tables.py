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
