"""Port parity of ``run_physics_ablation_batched`` against the JAX package,
in float64 on the CPU, on the two trials and the saved outputs of
``test_torch_studies.py``: each row within 1e-6 relative of JAX's, the CSV
with JAX's header and row order, the pruned stances equal (and not all
empty). The kinetic schedule is shortened alike to (3, 3), (1, 5) and both
packages' stance pruning speeds are raised alike, so that the procedural
warm starts keep stances (``test_torch_serial_kinetics.py``). Most of the
file's time is the JAX package compiling one kinetic solver for each of
the four configurations.

Marked ``slow`` (the repository's marker for compile-heavy solver
pipelines; the tier-1 run leaves them out): the JAX package compiles a
kinetic solver for each configuration, minutes each on the CPU. Run with
``python -m pytest -m slow tests/test_torch_studies_*.py``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu.pipeline import studies as jst
from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst

from test_torch_cli import PATHS, TRIALS, tree  # noqa: F401
from test_torch_serial_kinetics import keep_stances, kinetic_schedules
from test_torch_studies import outputs, rows_match, saved  # noqa: F401
from test_torch_studies import short_studies
from test_torch_studies_ablation import _check_csv

torch.set_num_threads(1)
pytestmark = pytest.mark.slow


def test_physics_ablation_batched_matches_jax(saved, tmp_path,  # noqa
                                              monkeypatch):
    root, dset, _ = saved
    jout, tout = outputs(saved, tmp_path)
    short_studies(monkeypatch)
    kinetic_schedules(monkeypatch)
    keep_stances(monkeypatch)
    jdf = jst.run_physics_ablation_batched(
        root, jout, TRIALS, data_driven_dataset=dset, dtype=jnp.float64,
        verbose=False)
    trows = tst.run_physics_ablation_batched(
        root, tout, TRIALS, data_driven_dataset=dset, dtype=torch.float64,
        verbose=False, device="cpu")
    assert all(r["n"] == 2 for r in trows)
    rows_match(jdf.to_dict("records"), trows, 1e-6)
    _check_csv(jout, tout, "physics_based_ablation_results.csv")
    # the stances each package pruned, from its own contact files and the
    # warm starts
    nonempty = 0
    for p in PATHS:
        est = jest.init_trajectory(root, p, "jules", monocular_enable=True)
        d = jest._load_warm_start(est, True, jout)
        with open(os.path.join(jout, p, "grf", "autogen-contact.json")) as f:
            cj = json.load(f)
        N = est.params.end_frame - est.params.start_frame
        js = jkn.prune_stance(jkn.stance_matrix(cj["contacts"],
                                                cj["start_frame"], N),
                              np.asarray(d["q"]),
                              jparams.get_subject("jules"),
                              1.0 / est.scene.fps)
        et = test_.init_trajectory(root, p, "jules", monocular_enable=True)
        st = test_._pruned_stance(
            et, os.path.join(tout, p),
            np.asarray(test_._load_warm_start(et, True, tout)["q"]), N)
        assert np.array_equal(np.asarray(js), st)
        nonempty += int(st.sum() > 0)
    assert nonempty > 0
