"""Port parity of the serial path's physics-based solve against the JAX
package, in float64, on the small JAX-made tree of ``test_torch_cli.py``:
from the same saved data-driven warm start, ``determine_contacts`` (the
contact files and the synthesized force tables, byte for byte) and
``estimate_kinetics`` in each of the CLI's three attempt configurations
(the GRFs solved for; fixed to the synthesized profiles; fixed and without
the pose prior), with both packages' kinetic schedule shortened alike to
(3, 3), (1, 5): the same pruned stance, q and the final objective within
1e-6 (the bar of ``test_torch_kinetic_solve.py``), torques and GRFs within
1e-6 of their scale. The GMM pose prior is trained by both packages on the
same small procedural table, the port's EM started from the JAX package's
k-means++ draw. The procedural warm start's feet slide faster than the
stance pruning allows, which would leave no stance and no GRF to solve or
fix; both packages' pruning speeds are raised alike so the detected
stances stay."""
import os
import pickle

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn

from test_torch_cli import CAM, PATHS, TRIALS, _dd_artifacts, tree  # noqa
from test_torch_serial_kinematics import (instrumented, pose_tables,
                                          same_gmm_draw)

torch.set_num_threads(1)
KSHORT = ((3.0, 3), (1.0, 5))
# the JAX CLI's attempts (run_dataset.run_monocular); the port's are
# run_dataset.PHYSICS_ATTEMPTS (joint_estimation changes nothing there)
JAX_ATTEMPTS = (dict(joint_estimation=True),
                dict(joint_estimation=False, synthesised_grf=True),
                dict(joint_estimation=False, synthesised_grf=True,
                     disable_pose_prior=True))


def kinetic_schedules(mp):
    for fte in (jkn.KineticFTE, tkn.KineticFTE):
        mp.setattr(fte.make_solver, "__defaults__",
                   (KSHORT,) + fte.make_solver.__defaults__[1:])


def keep_stances(mp):
    """Both packages' stance pruning with its speed limits raised alike."""
    for kn in (jkn, tkn):
        d = kn.prune_stance.__defaults__
        mp.setattr(kn.prune_stance, "__defaults__",
                   (1e3,) + d[1:2] + (1e3,) + d[3:])


def priors_for_both(mp, path):
    """The training table both packages' physics solves read, under
    ``path``."""
    dset = pose_tables(path)
    same_gmm_draw(mp)
    mp.setattr(jest, "DATA_DRIVEN_DATASET", dset)
    mp.setenv("CHEETAH_DATA_DRIVEN_DATASET", dset)
    return dset


@pytest.fixture(scope="module")
def priors_dir(tmp_path_factory):
    """One training table for the module: both packages cache their fits
    beside it, so each trains its GMM once."""
    return tmp_path_factory.mktemp("priors")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(a).max())


@pytest.mark.parametrize("attempt", [0, 1, 2])
def test_estimate_kinetics_matches_jax(tree, priors_dir, tmp_path,
                                       monkeypatch, attempt):
    root, qs = tree
    kinetic_schedules(monkeypatch)
    keep_stances(monkeypatch)
    priors_for_both(monkeypatch, priors_dir)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    _dd_artifacts(root, qs, jout, jest)
    _dd_artifacts(root, qs, tout, test_)
    (c, _, _), p = TRIALS[0], PATHS[0]
    rec = {}
    ej = jest.init_trajectory(root, p, c, monocular_enable=True,
                              kinematic_model=False)
    et = test_.init_trajectory(root, p, c, monocular_enable=True,
                               kinematic_model=False)
    jest.determine_contacts(ej, monocular=True, out_dir_prefix=jout)
    test_.determine_contacts(et, monocular=True, out_dir_prefix=tout)
    for f in ("autogen-contact.json", "autogen-contact-02.json",
              "data_synth.csv", "data_synth_02.csv"):
        with open(os.path.join(jout, p, "grf", f), "rb") as fh:
            a = fh.read()
        with open(os.path.join(tout, p, "grf", f), "rb") as fh:
            b = fh.read()
        assert a == b, f
    with instrumented(rec):
        assert jest.estimate_kinetics(ej, out_dir_prefix=jout,
                                      **JAX_ATTEMPTS[attempt])
    rep = {}
    assert test_.estimate_kinetics(et, out_dir_prefix=tout,
                                   dtype=torch.float64, device="cpu",
                                   report=rep,
                                   **trd.PHYSICS_ATTEMPTS[attempt])
    assert rep["stance"] == rec["physics-based"][p]["stance"]
    assert np.sum(rep["stance"]) > 0
    sub = f"fte_kinetic_{CAM}"
    with open(os.path.join(jout, p, sub, "fte.pickle"), "rb") as f:
        a = pickle.load(f)
    with open(os.path.join(tout, p, sub, "fte.pickle"), "rb") as f:
        b = pickle.load(f)
    assert sorted(a) == sorted(b)
    assert _rel(a["q"], b["q"]) <= 1e-6
    assert _rel(a["obj_cost"], b["obj_cost"]) <= 1e-6
    assert type(a["obj_cost"]) is type(b["obj_cost"]) is float
    assert sorted(a["tau"]) == sorted(b["tau"])
    for k in a["tau"]:
        assert _rel(a["tau"][k], b["tau"][k]) <= 1e-6, k
    for k in ("grf_z", "grf_xy"):
        assert _rel(getattr(ej, k), getattr(et, k)) <= 1e-6, k
    if attempt > 0:
        # the fixed profiles are the synthesized ones: nonzero in stance
        assert np.abs(et.grf_z).max() > 0.0


def test_physics_fallback_catches_only_what_jax_catches(monkeypatch,
                                                         capsys):
    """The physics-based mode's attempts: a ``ValueError`` or
    ``FileNotFoundError`` moves on to the next attempt and is printed with
    its type; the kernel's input, build and launch errors (``RuntimeError``)
    propagate; an unacceptable solution moves on; the accepted attempt's
    1-based index is recorded, None when none was."""
    from cheetah_pose_estimation_tpu_torch.ops import cuda_banded

    outcomes = []

    def kinetics(est, report=None, **kw):
        out = outcomes.pop(0)
        if isinstance(out, BaseException):
            raise out
        return out

    monkeypatch.setattr(test_, "estimate_kinetics", kinetics)
    monkeypatch.setattr(test_, "determine_contacts", lambda *a, **k: None)
    kw = dict(out_dir_prefix="out")
    trial = lambda **k: None
    outcomes[:] = [ValueError("singular"), FileNotFoundError("no grf"), True]
    tr = {}
    assert trd._physics_attempts(trial, "t", tr, kw)
    assert tr["attempt"] == 3
    assert tr["attempts"] == ["ValueError: singular",
                              "FileNotFoundError: no grf", "ok"]
    out = capsys.readouterr().out
    assert "attempt 1 failed: ValueError: singular" in out
    assert "attempt 2 failed: FileNotFoundError: no grf" in out
    outcomes[:] = [False, False, False]
    tr = {}
    assert not trd._physics_attempts(trial, "t", tr, kw)
    assert tr["attempt"] is None and tr["attempts"] == ["not acceptable"] * 3
    assert "physics-based FAILED for t" in capsys.readouterr().out
    for err in (cuda_banded.KernelInputError("rhs must be contiguous"),
                RuntimeError("banded_solve kernel launch failed")):
        outcomes[:] = [err, True]
        with pytest.raises(RuntimeError):
            trd._physics_attempts(trial, "t", {}, kw)
