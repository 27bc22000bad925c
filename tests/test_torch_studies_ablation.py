"""Port parity of ``run_data_driven_ablation_batched`` against the JAX
package, in float64 on the CPU, on the two trials and the saved outputs of
``test_torch_studies.py``: each row within 1e-6 relative of JAX's, the CSV
with JAX's header and row order. The batched physics ablation is in
``test_torch_studies_physics.py``."""
import os

import jax.numpy as jnp
import torch

from cheetah_pose_estimation_tpu.pipeline import studies as jst
from cheetah_pose_estimation_tpu_torch.pipeline import studies as tst

from test_torch_cli import TRIALS, tree  # noqa: F401
from test_torch_studies import (outputs, read_csv, rows_match, saved,  # noqa
                                short_studies)

torch.set_num_threads(1)


def _check_csv(jout, tout, name):
    jh, jr = read_csv(os.path.join(jout, name))
    th, tr = read_csv(os.path.join(tout, name))
    assert jh == th == ["config", "mpe", "mpjpe", "cvr", "n"]
    assert [r[0] for r in jr] == [r[0] for r in tr] == [
        "both", "no-pose", "no-motion", "neither"]


def test_data_driven_ablation_batched_matches_jax(saved, tmp_path,  # noqa
                                                  monkeypatch):
    root, dset, _ = saved
    jout, tout = outputs(saved, tmp_path)
    short_studies(monkeypatch)
    jdf = jst.run_data_driven_ablation_batched(
        root, jout, TRIALS, data_driven_dataset=dset, dtype=jnp.float64,
        verbose=False)
    trows = tst.run_data_driven_ablation_batched(
        root, tout, TRIALS, data_driven_dataset=dset, dtype=torch.float64,
        verbose=False, device="cpu")
    assert all(r["n"] == 2 for r in trows)
    rows_match(jdf.to_dict("records"), trows, 1e-6)
    _check_csv(jout, tout, "data_driven_ablation_results.csv")
