"""Port parity of ``run_degradation_sweep`` against the JAX package, in
float64 on the CPU: rates 0 and 4, the first two procedural bench trials
(40 and 42 frames, padded to 48), with the physics-based column; both
packages' schedules shortened alike (``test_torch_cli._short_schedules``,
the kinetic (3, 3), (1, 5)) and the stance pruning speeds raised alike.
The JAX function makes its arrays float32 and rounds its rows to 0.1 mm:
here its float32 is float64 and its rounding is off, so each mean MPJPE
is held to the port's unrounded value (``report["rows"]``) within 1e-6
relative; the port's CSV has JAX's header and its values rounded as JAX
rounds them.

Marked ``slow`` (the repository's marker for compile-heavy solver
pipelines; the tier-1 run leaves them out): the JAX package compiles a
kinetic solver for each configuration, minutes each on the CPU. Run with
``python -m pytest -m slow tests/test_torch_studies_*.py``."""
import csv
import os

import jax.numpy as jnp
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import studies as jst
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst

from test_torch_cli import _short_schedules
from test_torch_serial_kinematics import pose_tables
from test_torch_serial_kinetics import keep_stances, kinetic_schedules

torch.set_num_threads(1)
pytestmark = pytest.mark.slow
COLUMNS = ["rate", "default_mpjpe", "dd_mpjpe", "improvement_pct",
           "physics_mpjpe", "physics_vs_dd_pct"]


def test_degradation_sweep_matches_jax(tmp_path, monkeypatch):
    dset = pose_tables(tmp_path)
    _short_schedules(monkeypatch)
    kinetic_schedules(monkeypatch)
    keep_stances(monkeypatch)
    monkeypatch.setattr(jest, "DATA_DRIVEN_DATASET", dset)
    monkeypatch.setenv("CHEETAH_DATA_DRIVEN_DATASET", dset)
    kw = dict(rates=(0.0, 4.0), n_frames=48, data_driven_dataset=dset,
              include_physics=True, max_trials=2, verbose=False)
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    with monkeypatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        mp.setattr(jst, "round", lambda v, nd=None: v, raising=False)
        jrows = jst.run_degradation_sweep(out_dir=jout, **kw).to_dict(
            "records")
    rep = {}
    trows = tst.run_degradation_sweep(out_dir=tout, dtype=torch.float64,
                                      device="cpu", report=rep, **kw)
    assert len(jrows) == len(trows) == len(rep["rows"]) == 2
    for j, raw, t in zip(jrows, rep["rows"], trows):
        assert j["rate"] == raw["rate"] == t["rate"]
        for k in ("default_mpjpe", "dd_mpjpe", "physics_mpjpe"):
            assert abs(j[k] - raw[k]) <= 1e-6 * abs(j[k]), (k, j, raw)
            assert t[k] == round(raw[k], 1)
    with open(os.path.join(jout, "degradation_sweep.csv")) as f:
        jh = next(csv.reader(f))
    with open(os.path.join(tout, "degradation_sweep.csv")) as f:
        th, *body = list(csv.reader(f))
    assert jh == th == COLUMNS
    assert [float(r[1]) for r in body] == [t["default_mpjpe"]
                                           for t in trows]
