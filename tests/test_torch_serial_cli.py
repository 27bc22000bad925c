"""Port parity of the dataset CLI's serial per-trial path as a whole,
``run_dataset.run_monocular`` against the JAX package's, in float64, on the
first trial of the small JAX-made tree of ``test_torch_cli.py`` through all
four modes (multi-view ground truth, default, data-driven, physics-based),
every schedule shortened alike (the helpers of
``test_torch_serial_kinematics.py`` and ``test_torch_serial_kinetics.py``):
the same artifact tree (the JAX package also writes each force table as
``.h5``, which the port does not), the same decisions and physics attempt,
each mode's q within its bar (1e-8 / 1e-8 / 1e-6, and 1e-6 for the physics
solve warm-started from the data-driven one), the same contact files and
the force tables within 1e-6 (they follow the warm start's speed)."""
import os
import pickle
from glob import glob

import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import run_dataset as jrd
from cheetah_pose_estimation_tpu_torch.pipeline import grf_io as tgrf
from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset as trd

from test_torch_cli import CAM, PATHS, TRIALS, tree  # noqa: F401
from test_torch_serial_kinematics import (instrumented, same_decisions,
                                          serial_schedules)
from test_torch_serial_kinetics import kinetic_schedules, priors_for_both

torch.set_num_threads(1)
TOL = {"fte_kinematic": 1e-8, f"fte_kinematic_orig_{CAM}": 1e-8,
       f"fte_kinematic_{CAM}": 1e-6, f"fte_kinetic_{CAM}": 1e-6}
MODE_OF = {"fte_kinematic": "ground-truth",
           f"fte_kinematic_orig_{CAM}": "default",
           f"fte_kinematic_{CAM}": "data-driven"}


def _files(out):
    return sorted(os.path.relpath(f, out) for f in glob(
        os.path.join(out, "**", "*"), recursive=True)
        if os.path.isfile(f) and not f.endswith(".h5"))


def test_run_monocular_matches_jax(tree, tmp_path, monkeypatch):
    root, _ = tree
    serial_schedules(monkeypatch)
    kinetic_schedules(monkeypatch)
    dset = priors_for_both(monkeypatch, tmp_path)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    trials, p = TRIALS[:1], PATHS[0]
    rec, rep = {}, {}
    with instrumented(rec):
        jrd.run_monocular(root, jout, trials, data_driven_dataset=dset,
                          verbose=False)
    trd.run_monocular(root, tout, trials, data_driven_dataset=dset,
                      verbose=False, dtype=torch.float64, device="cpu",
                      report=rep)
    assert _files(jout) == _files(tout)
    assert len(_files(tout)) == 4 * 4 + 4
    for mode in ("ground-truth", "default", "data-driven"):
        assert rep[mode]["trials"] == [p]
        same_decisions(
            {k: v for k, v in rep[mode]["per_trial"][p].items()
             if k not in ("wall_s", "launches")}, rec[mode][p])
    phys = rep["physics-based"]["per_trial"][p]
    assert phys["attempt"] == rec["physics-based"][p]["attempt"] == 1
    assert phys["stance"] == rec["physics-based"][p]["stance"]
    for sub, tol in TOL.items():
        with open(os.path.join(jout, p, sub, "fte.pickle"), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(tout, p, sub, "fte.pickle"), "rb") as f:
            b = pickle.load(f)
        assert sorted(a) == sorted(b)
        assert np.abs(a["q"] - b["q"]).max() <= tol * max(
            1.0, np.abs(a["q"]).max()), sub
    for f in ("autogen-contact.json", "autogen-contact-02.json"):
        with open(os.path.join(jout, p, "grf", f), "rb") as fh:
            a = fh.read()
        with open(os.path.join(tout, p, "grf", f), "rb") as fh:
            b = fh.read()
        assert a == b, f
    # the force tables follow the warm start's speed, which carries the
    # data-driven solve's 1e-6
    for f in ("data_synth.csv", "data_synth_02.csv"):
        a = tgrf.load_force_plate_df(os.path.join(jout, p, "grf", f))
        b = tgrf.load_force_plate_df(os.path.join(tout, p, "grf", f))
        assert sorted(a) == sorted(b), f
        for k in a:
            assert np.abs(a[k] - b[k]).max() <= 1e-6 * max(
                1.0, np.abs(a[k]).max()), (f, k)


def test_serial_cli_needs_the_card_unless_told(tree, tmp_path, monkeypatch):
    """Without ``--device`` the serial path runs on the card, and without a
    card it raises before it solves anything."""
    root, _ = tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        trd.main(["--run_monocular", "--clean", "--root_dir", root,
                  "--out_dir_prefix", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
