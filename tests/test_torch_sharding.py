"""The port's trial mesh against the JAX package's, and against the port's
own unsharded path, on the CPU in float64.

* ``_pad_group`` pads as JAX's does, and ``shard_batch`` gives device i of
  the mesh the lanes that JAX's ``shard_batch`` puts on its device i (on
  JAX's virtual 8-device CPU mesh): the same chunks, bit for bit.
* One LM evaluation and damped step (``tests/test_sharding_equivalence.py``'s
  kinematic ``one_step``) over a 2-entry CPU mesh equals JAX's
  single-device step (cost within 1e-10 relative, the step within 1e-8 of
  its scale: float64 through two packages' factorizations) and the port's
  unsharded step within 1e-12.
* ``run_monocular_batched`` on ``test_torch_cli.py``'s tree, its schedules
  shortened as that file does (and the kinetic solve to (3, 2), (1, 3)):
  over all four modes with ``mesh=("cpu", "cpu")``, and over the
  ground-truth and default modes with a 3-entry mesh (2 trials padded to
  3), equals ``mesh=None`` within 1e-10 (the physics mode's torques
  within 1e-8: the per-frame elimination amplifies the trajectories'
  rounding). Each lane's solve is independent of the others, so only the
  batch's float64 rounding can differ.
* ``dryrun_multichip`` on a 2-entry CPU mesh: the three costs finite.
"""
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.parallel import batch as jbatch
from cheetah_pose_estimation_tpu.pipeline import batched as jpb
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.solver import gn as jgn
from cheetah_pose_estimation_tpu.solver import kinematic as jkin
from cheetah_pose_estimation_tpu_torch.data import synthetic as tsyn
from cheetah_pose_estimation_tpu_torch.models import params as tparams
from cheetah_pose_estimation_tpu_torch.parallel import batch as tbatch
from cheetah_pose_estimation_tpu_torch.pipeline import batched as tpb
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib as tbl
from cheetah_pose_estimation_tpu_torch.solver import gn as tgn
from cheetah_pose_estimation_tpu_torch.solver import kinematic as tkin
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn
from test_torch_cli import CAM, PATHS, TRIALS, _short_schedules, tree  # noqa

torch.set_num_threads(1)
CPU2 = ("cpu", "cpu")
# the solved torques come out of the per-frame torque/GRF elimination,
# whose conditioning turns the trajectories' 1e-11 rounding into ~6e-10
TOL_TAU = 1e-8
MODES = ("ground-truth", "default", "data-driven", "physics-based")


def test_pad_group_follows_jax():
    for n_dev in (1, 2, 3, 4):
        jmesh = jbatch.trial_mesh(n_dev)
        tmesh = tbatch.trial_mesh(devices=["cpu"] * n_dev)
        assert len(tmesh) == n_dev
        for n in (1, 2, 3, 5, 8):
            ests = list(range(n))
            assert tpb._pad_group(ests, tmesh) == jpb._pad_group(ests, jmesh)
    assert tpb._pad_group([0, 1, 2], None) == ([0, 1, 2], 3)


def _problems(n, N=24):
    datas, q0s = [], []
    for i in range(n):
        q_gt = tsyn.gallop_trajectory(n_frames=20 + (i % 3), seed=i)
        d, q0, _ = tbl.build_monocular_problem(
            q_gt, "acinoset", 120.0, seed=i, n_cams=2, cam_idx=1)
        datas.append(d)
        q0s.append(q0)
    return datas, q0s


def test_shard_batch_follows_jax():
    datas, q0s = _problems(8)
    jb, _ = jbatch.pad_and_stack(datas, q0s, n_frames=24, dtype=jnp.float64)
    tb, _ = tbatch.pad_and_stack(datas, q0s, n_frames=24,
                                 dtype=torch.float64, device="cpu")
    for n_dev in (2, 4, 8):
        jmesh = jbatch.trial_mesh(n_dev)
        js = jbatch.shard_batch(jb, jmesh)
        ts = tbatch.shard_batch(tb, tbatch.trial_mesh(devices=["cpu"] * n_dev))
        assert len(ts) == n_dev
        dev_pos = {d: i for i, d in enumerate(jmesh.devices.flat)}
        for jl, tl in zip(jax.tree.leaves(js), zip(*[
                list(tbatch._leaves(s)) for s in ts])):
            for shard in jl.addressable_shards:
                i = dev_pos[shard.device]
                assert np.array_equal(np.asarray(shard.data),
                                      tl[i].numpy())
    # numpy leaves split too, 0-dim ones are shared
    parts = tbatch.shard_batch((np.arange(6), np.asarray(2.0)), CPU2)
    assert [p[0].tolist() for p in parts] == [[0, 1, 2], [3, 4, 5]]
    assert all(p[1] == 2.0 for p in parts)
    with pytest.raises(ValueError, match="does not split"):
        tbatch.shard_batch(torch.zeros(3, 2), tbatch.trial_mesh(
            devices=CPU2))


def test_one_step_on_mesh_equals_single_device():
    datas, q0s = _problems(4)
    jb, jq = jbatch.pad_and_stack(datas, q0s, n_frames=24, dtype=jnp.float64)
    tb, tq = tbatch.pad_and_stack(datas, q0s, n_frames=24,
                                  dtype=torch.float64, device="cpu")
    jfte = jkin.KinematicFTE(jkin.KinematicConfig(),
                             jparams.get_subject("acinoset"))
    tfte = tkin.KinematicFTE(tkin.KinematicConfig(),
                             tparams.get_subject("acinoset"))

    @jax.jit
    @jax.vmap
    def j_step(q0, data):
        g, H = jfte._normal(q0, data, 1.0)
        dq = jgn._scaled_solve(g, H, jnp.asarray(1.0, q0.dtype), 1e-8)
        return jfte._cost(q0, data, 1.0), dq

    def t_step(q0, data):
        g, H = tfte._normal(q0, data, 1.0)
        dq = tgn._scaled_solve(g, H, torch.ones(q0.shape[0],
                                                dtype=q0.dtype), 1e-8)
        return tfte._cost(q0, data, 1.0), dq

    c1, dq1 = (np.asarray(x) for x in j_step(jq, jb))
    c2, dq2 = (x.numpy() for x in tbatch.on_mesh(t_step, tbatch.trial_mesh(
        devices=CPU2))(tq, tb))
    c3, dq3 = (x.numpy() for x in t_step(tq, tb))
    assert np.abs(c2 - c1).max() <= 1e-10 * np.abs(c1).max()
    assert np.abs(dq2 - dq1).max() <= 1e-8 * np.abs(dq1).max()
    assert np.abs(c2 - c3).max() <= 1e-12 * np.abs(c3).max()
    assert np.abs(dq2 - dq3).max() <= 1e-12 * np.abs(dq3).max()


def test_resolve_mesh(monkeypatch):
    cpu = torch.device("cpu")
    assert tpb._resolve_mesh("auto", 5, cpu) is None
    assert tpb._resolve_mesh(None, 5, cpu) is None
    assert tpb._resolve_mesh(CPU2, 5, cpu) == (cpu, cpu)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tpb._resolve_mesh("auto", 5, torch.device("cuda", 0)) is None


@pytest.fixture(scope="module")
def cli_runs(tree, tmp_path_factory):
    """``run_monocular_batched`` over the four modes with no mesh, a
    2-entry and a 3-entry CPU mesh (each its own output tree)."""
    from cheetah_pose_estimation_tpu_torch.priors import dataset

    root, _ = tree
    work = tmp_path_factory.mktemp("mesh")
    dset = str(work / "priors" / "dataset_full_pose.csv")
    dataset.save_pose_dataset(dset, tbl.procedural_pose_table(
        (100, 101), n_frames=60))
    dataset.save_pose_dataset(str(work / "priors" / "validation_dataset.csv"),
                              tbl.procedural_pose_table((200,), n_frames=60))
    mp = pytest.MonkeyPatch()
    out, reps = {}, {}
    try:
        _short_schedules(mp)
        mp.setattr(tpb.run_data_driven, "__defaults__",
                   (((10.0, 3), (3.0, 3), (1.0, 8)), ((1.0, 4),), None))
        mp.setattr(tpb.run_physics, "__defaults__",
                   (None, ((3.0, 2), (1.0, 3)), None, None))
        for name, mesh, modes in (("none", None, MODES), ("two", CPU2, MODES),
                                  ("three", ("cpu",) * 3, MODES[:2])):
            out[name] = str(work / name)
            reps[name] = {}
            tpb.run_monocular_batched(
                root, out[name], TRIALS, modes=modes,
                data_driven_dataset=dset, dtype=torch.float64, device="cpu",
                verbose=False, report=reps[name], mesh=mesh)
    finally:
        mp.undo()
    return out, reps


@pytest.mark.parametrize("mesh", ["two", "three"])
def test_run_monocular_batched_on_mesh_equals_unsharded(cli_runs, mesh):
    out, reps = cli_runs
    subs = ("fte_kinematic", f"fte_kinematic_orig_{CAM}",
            f"fte_kinematic_{CAM}", f"fte_kinetic_{CAM}")
    modes = MODES if mesh == "two" else MODES[:2]
    subs = subs[:len(modes)]
    for p in PATHS:
        for sub in subs:
            with open(os.path.join(out["none"], p, sub, "fte.pickle"),
                      "rb") as f:
                a = pickle.load(f)
            with open(os.path.join(out[mesh], p, sub, "fte.pickle"),
                      "rb") as f:
                b = pickle.load(f)
            assert a.keys() == b.keys()
            assert a["tau"].keys() == b["tau"].keys()
            for k in ("q", "positions", "com_vel") + tuple(a["tau"]):
                x = np.asarray(a[k] if k in a else a["tau"][k], float)
                y = np.asarray(b[k] if k in b else b["tau"][k], float)
                assert x.shape == y.shape
                tol = 1e-10 if k in a else TOL_TAU
                assert np.abs(x - y).max() <= tol * max(
                    1.0, np.abs(x).max()), (p, sub, k)
            assert abs(a["obj_cost"] - b["obj_cost"]) <= 1e-10 * max(
                1.0, abs(a["obj_cost"])), (p, sub)
    for mode in modes:
        assert reps[mesh][mode]["trials"] == reps["none"][mode]["trials"] \
            == PATHS
    for key in ("polish_ray_shift", "polish_changed"):
        assert np.allclose(reps[mesh]["default"][key],
                           reps["none"]["default"][key], rtol=1e-10)
    if mesh == "two":
        for key in ("prior_ok", "scan_shifts"):
            assert reps[mesh]["data-driven"][key] == \
                reps["none"]["data-driven"][key]
        assert reps[mesh]["physics-based"]["stance"] == \
            reps["none"]["physics-based"]["stance"]


def test_dryrun_multichip_on_cpu_mesh(monkeypatch):
    """The dry run's three solves over a 2-entry CPU mesh (priors trained
    on small procedural tables: the full ones take longer on the CPU), and
    its problems against JAX's ``build_dryrun_problems``."""
    train = tbl.train_priors
    monkeypatch.setattr(tbl, "train_priors", lambda tr, va, device=None:
                        train(tbl.procedural_pose_table((100,), 60),
                              tbl.procedural_pose_table((200,), 60),
                              device=device))
    out = tbatch.dryrun_multichip(2, devices=CPU2, verbose=False)
    assert sorted(out) == ["monocular data-driven", "multi-view kinematic",
                           "physics"]
    assert np.isfinite(list(out.values())).all()
    datas_mv, datas_mono, q0s = tbl.build_dryrun_problems(2, n_frames=16,
                                                          device="cpu")
    jmv, jmono, jq = jbl.build_dryrun_problems(2, n_frames=16)
    for a, b in zip(datas_mv, jmv):
        assert np.shape(b.meas) == a.meas.shape == (16, 6, 24, 2, 1)
        assert np.abs(a.meas - np.asarray(b.meas)).max() <= 1e-9
    for a, b in zip(q0s, jq):
        assert np.abs(a - np.asarray(b)).max() <= 1e-9
    assert all(d.meas.shape == (16, 1, 24, 2, 1) for d in datas_mono)
    assert datas_mono[0].gmm.means.shape == (5, 22)
