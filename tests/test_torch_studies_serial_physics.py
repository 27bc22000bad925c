"""Port parity of ``run_physics_based_ablation_study`` (the physics
ablation one trial at a time) against the JAX package, in float64 on the
CPU, on the first trial and the saved outputs of ``test_torch_studies.py``:
each row within 1e-6 relative of JAX's, with the kinetic schedule
shortened alike and the stance pruning speeds raised alike
(``test_torch_serial_kinetics.py``).

Marked ``slow`` (the repository's marker for compile-heavy solver
pipelines; the tier-1 run leaves them out): the JAX package compiles a
kinetic solver for each configuration, minutes each on the CPU. Run with
``python -m pytest -m slow tests/test_torch_studies_*.py``."""
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import studies as jst
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst

from test_torch_cli import TRIALS, tree  # noqa: F401
from test_torch_serial_kinetics import keep_stances, kinetic_schedules
from test_torch_studies import outputs, rows_match, saved  # noqa: F401
from test_torch_studies_serial import serial_priors

torch.set_num_threads(1)
pytestmark = pytest.mark.slow


def test_physics_ablation_serial_matches_jax(saved, tmp_path,  # noqa: F811
                                             monkeypatch):
    root, dset, _ = saved
    jout, tout = outputs(saved, tmp_path)
    kinetic_schedules(monkeypatch)
    keep_stances(monkeypatch)
    serial_priors(monkeypatch, dset)
    jdf = jst.run_physics_based_ablation_study(root, jout, TRIALS,
                                               max_trials=1)
    trows = tst.run_physics_based_ablation_study(
        root, tout, TRIALS, max_trials=1, dtype=torch.float64, device="cpu")
    assert [r["n"] for r in trows] == [1] * 4
    rows_match(jdf.to_dict("records"), trows, 1e-6)
