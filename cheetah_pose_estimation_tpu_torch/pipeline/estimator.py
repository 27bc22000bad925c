"""Data-driven mode settings and the per-trial prior gate.

Port of the parts of ``cheetah_pose_estimation_tpu/pipeline/estimator.py``
that the batched data-driven stage reads; the serial trial estimator is not
ported yet.
"""
from __future__ import annotations

import numpy as np

# base-pose anchor of the prior-constrained solves (solver.kinematic
# base_ref / base_anchor_*): a stiff translation pin (sigma ~2.5 cm) and a
# soft rotation pin, so the pose prior cannot trade global depth for
# manifold poses
DD_BASE_ANCHOR = dict(base_anchor_trans=1.6e3, base_anchor_rot=1e2)

# prior gate threshold on the chain's prior-free cost against the
# prior-free solve's
PRIOR_GUARD_RATIO = 1.30


def prior_gate_accept(c_chain, c_free):
    """Per-trial prior gate: the GMM chain is accepted when its prior-free
    cost does not exceed the prior-free solve's by more than
    (PRIOR_GUARD_RATIO - 1) x max(|cost|, 1).

    Not a plain ratio test: the smoothed redescending loss is slightly
    negative at well-fit residuals, so totals can be negative and
    ``c_chain <= r * c_free`` would invert there. Elementwise on arrays."""
    c_chain = np.asarray(c_chain, np.float64)
    c_free = np.asarray(c_free, np.float64)
    margin = (PRIOR_GUARD_RATIO - 1.0) * np.maximum(np.abs(c_free), 1.0)
    return c_chain <= c_free + margin
