"""Port parity of the studies' per-trial forms against the JAX package, in
float64 on the CPU, on the first trial and the saved outputs of
``test_torch_studies.py``: ``run_grid_search`` on a 1 x 1 x 1 grid (3
components, window 4, lasso) and ``run_data_driven_ablation_study``, each
row within 1e-6 relative of JAX's, with the serial schedules of
``test_torch_serial_kinematics.py``. The serial physics ablation is in
``test_torch_studies_serial_physics.py``. The ablation is marked ``slow``
(the repository's marker for compile-heavy solver pipelines; the tier-1
run leaves it out): the JAX package compiles the serial data-driven
solvers anew for each of its four configurations."""
import pytest
import torch

from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import studies as jst
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst

from test_torch_cli import TRIALS, tree  # noqa: F401
from test_torch_serial_kinematics import serial_schedules
from test_torch_studies import outputs, rows_match, saved  # noqa: F401

torch.set_num_threads(1)


def serial_priors(mp, dset):
    """Both packages' default training table is ``dset``."""
    mp.setattr(jest, "DATA_DRIVEN_DATASET", dset)
    mp.setenv("CHEETAH_DATA_DRIVEN_DATASET", dset)


def test_grid_search_serial_matches_jax(saved, tmp_path,  # noqa: F811
                                        monkeypatch):
    root, dset, _ = saved
    jout, tout = outputs(saved, tmp_path)
    serial_schedules(monkeypatch)
    serial_priors(monkeypatch, dset)
    grid = dict(pose_components=(3,), windows=(4,), lasso_options=(True,),
                max_trials=1)
    jdf = jst.run_grid_search(root, jout, TRIALS, **grid)
    trows = tst.run_grid_search(root, tout, TRIALS, dtype=torch.float64,
                                device="cpu", **grid)
    assert trows[0]["n"] == 1
    rows_match(jdf.to_dict("records"), trows, 1e-6)


@pytest.mark.slow
def test_data_driven_ablation_serial_matches_jax(saved, tmp_path,  # noqa
                                                 monkeypatch):
    root, dset, _ = saved
    jout, tout = outputs(saved, tmp_path)
    serial_schedules(monkeypatch)
    serial_priors(monkeypatch, dset)
    jdf = jst.run_data_driven_ablation_study(root, jout, TRIALS,
                                             max_trials=1)
    trows = tst.run_data_driven_ablation_study(
        root, tout, TRIALS, max_trials=1, dtype=torch.float64, device="cpu")
    assert [r["n"] for r in trows] == [1] * 4
    rows_match(jdf.to_dict("records"), trows, 1e-6)
