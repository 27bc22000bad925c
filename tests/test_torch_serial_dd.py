"""Port parity of the serial path's data-driven mode against the JAX
package, in float64, on the small JAX-made tree of ``test_torch_cli.py``
with both packages' schedules shortened alike (the helpers of
``test_torch_serial_kinematics.py``): ``estimate_kinematics`` with the
learned priors (the bootstrap multistart, the GMM chain and its gate, the
AR anchors, the polish, the line-scan), q within 1e-6 (the bar of
``test_torch_cli.py``'s data-driven case), the same decisions and
artifacts. The priors are trained by both packages on the same small
procedural tables, the port's EM from its own k-means++ draw, which is
the JAX package's (``priors/gmm.kmeanspp_indices``).

The line-scan case holds the saved objective after a re-polish: both
packages save it under the data of the solve before the shift (not the
re-polish's shifted base pin and anchors), so the two agree."""
import numpy as np
import torch

from cheetah_pose_estimation_tpu.pipeline import depth_anchor as jda
from cheetah_pose_estimation_tpu.pipeline import estimator as jest
from cheetah_pose_estimation_tpu_torch.pipeline import depth_anchor as tda
from cheetah_pose_estimation_tpu_torch.pipeline import estimator as test_

from test_torch_cli import PATHS, tree  # noqa: F401
from test_torch_serial_kinematics import (_one_trial, _pickle, _sub,
                                          check_estimate_kinematics,
                                          instrumented, pose_tables,
                                          serial_schedules)

torch.set_num_threads(1)


def test_data_driven_mode_matches_jax(tree, tmp_path, monkeypatch):
    check_estimate_kinematics(tree, tmp_path, monkeypatch, "data-driven")


def test_obj_cost_after_repolish_matches_jax(tree, tmp_path, monkeypatch):
    """Both packages' line-scans patched to return the same nonzero shift:
    the re-polish runs from the shifted trajectory with the base pin and
    AR anchors moved with it. The trajectories agree (1e-6), and the
    port's saved objective equals the JAX package's saved one (both under
    the data before the shift) within 1e-6 relative; neither is the
    re-polished problem's objective."""
    root, _ = tree
    serial_schedules(monkeypatch)
    dset = pose_tables(tmp_path)
    SHIFT = -0.2

    def fixed_scan(orig):
        def make(*a, **k):
            run = orig(*a, **k)

            def scan(q_in, *aa, **kk):
                q, _ = run(q_in, *aa, **kk)
                return q, np.full(q_in.shape[0], SHIFT)
            return scan
        return make

    monkeypatch.setattr(jda, "make_depth_linescan",
                        fixed_scan(jda.make_depth_linescan))
    monkeypatch.setattr(tda, "make_depth_linescan",
                        fixed_scan(tda.make_depth_linescan))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    rec, seen = {}, 0
    for i, p in enumerate(PATHS):
        ej, et = _one_trial(root, i, True)
        with instrumented(rec):
            jest.estimate_kinematics(ej, monocular_constraints=True,
                                     data_driven_dataset=dset,
                                     out_dir_prefix=jout)
        rep = {}
        test_.estimate_kinematics(et, monocular_constraints=True,
                                  data_driven_dataset=dset,
                                  out_dir_prefix=tout, dtype=torch.float64,
                                  device="cpu", report=rep)
        r = rec["data-driven"][p]
        assert rep["prior_ok"] == r["prior_ok"]
        if not rep["prior_ok"]:
            continue
        seen += 1
        assert rep["scan_shift"] == r["scan_shift"] == SHIFT
        a, b = _pickle(jout, p, _sub("data-driven")), \
            _pickle(tout, p, _sub("data-driven"))
        assert np.abs(a["q"] - b["q"]).max() <= 1e-6 * max(
            1.0, np.abs(a["q"]).max())
        assert abs(b["obj_cost"] - a["obj_cost"]) <= 1e-6 * max(
            1.0, abs(a["obj_cost"]))
        like = r["obj_cost_repolish"]
        assert abs(a["obj_cost"] - like) > 1e-3 * max(1.0, abs(like))
        break
    assert seen > 0
