"""Measurement and process noise tables.

The port's own copy of the tables of
``cheetah_pose_estimation_tpu/models/noise.py`` that the port reads:
per-marker pixel standard deviations R for the base DLC predictions and
the two pairwise pseudo-measurement rows (inflated x2 for the rigid-body
assumption), and per-DOF process noise Q for the constant-acceleration
motion model (zero entries = unpenalized DOFs), the per-coordinate EOM
slack floor of the physics stage, and the AcinoSet DLC part indices and
pairwise graph that the pseudo-measurements (``data/ppm.py``) read.
``tests/test_torch_tables.py`` holds every value equal to the original.
"""
from __future__ import annotations

import numpy as np

# per-marker pixel std (marker order = skeleton.MARKERS)
R_BASE = np.array([
    1.2, 1.24, 1.18, 2.08, 2.04, 2.52, 2.73, 1.83,
    3.47, 2.75, 2.69, 2.24, 3.4, 2.91, 2.85, 2.27,
    3.26, 2.76, 2.33, 2.4, 3.53, 2.69, 2.49, 2.34,
])

_R_PW1 = np.array([
    2.71, 3.06, 2.99, 4.07, 5.53, 4.67, 6.05, 5.6,
    5.01, 5.11, 5.24, 4.85, 5.18, 5.28, 5.5, 4.9,
    4.7, 4.7, 5.21, 5.11, 5.1, 5.27, 5.75, 5.44,
])

_R_PW2 = np.array([
    2.8, 3.24, 3.42, 3.8, 4.4, 5.43, 5.22, 7.29,
    8.19, 6.5, 5.9, 6.18, 8.83, 6.52, 6.22, 6.34,
    6.8, 6.12, 5.37, 5.98, 7.83, 6.44, 6.1, 6.38,
])

# (3, 24): stacked [base, pw1, pw2] then doubled
R_PW = np.stack([R_BASE, _R_PW1, _R_PW2]) * 2.0

# DLC part index of each skeleton marker within the AcinoSet 25-part DLC
# model output
DLC_MARKER_INDEX = {
    "nose": 23, "r_eye": 0, "l_eye": 1, "neck_base": 24, "spine": 6,
    "tail_base": 22, "tail1": 11, "tail2": 12,
    "l_shoulder": 13, "l_front_knee": 14, "l_front_ankle": 15,
    "l_front_paw": 16, "r_shoulder": 2, "r_front_knee": 3,
    "r_front_ankle": 4, "r_front_paw": 5,
    "l_hip": 17, "l_back_knee": 18, "l_back_ankle": 19, "l_back_paw": 20,
    "r_hip": 7, "r_back_knee": 8, "r_back_ankle": 9, "r_back_paw": 10,
}
N_DLC_PARTS = 25

# the two source parts of each marker's pairwise pseudo-measurements
PAIRWISE_GRAPH = {
    "r_eye": [23, 1], "l_eye": [23, 0], "nose": [0, 1],
    "neck_base": [6, 23], "spine": [22, 24], "tail_base": [6, 11],
    "tail1": [6, 22], "tail2": [11, 22],
    "l_shoulder": [14, 24], "l_front_knee": [13, 15],
    "l_front_ankle": [13, 14], "l_front_paw": [14, 15],
    "r_shoulder": [3, 24], "r_front_knee": [2, 4],
    "r_front_ankle": [2, 3], "r_front_paw": [3, 4],
    "l_hip": [18, 22], "l_back_knee": [17, 19],
    "l_back_ankle": [17, 18], "l_back_paw": [18, 19],
    "r_hip": [8, 22], "r_back_knee": [7, 9],
    "r_back_ankle": [7, 8], "r_back_paw": [8, 9],
}

# per-DOF process noise std, in q order (54); squared below.
_Q_STD = np.array([
    4, 7, 5, 13, 9, 26,          # base x y z phi theta psi
    10, 53, 34,                  # bodyF
    32, 18, 12,                  # neck
    0, 90, 43,                   # tail0
    0, 118, 51,                  # tail1
    0, 247, 0, 0, 186, 0, 0, 91, 0,      # UFL LFL HFL
    0, 194, 0, 0, 164, 0, 0, 91, 0,      # UFR LFR HFR
    0, 295, 0, 0, 243, 0,                # UBL LBL
    0, 334, 0, 0, 149, 0,                # UBR LBR
    0, 132, 0, 0, 132, 0,                # HBL HBR
], dtype=float)

Q = _Q_STD**2

# per-coordinate EOM model-mismatch floor (body-weight units), in q order:
# the RMS of the eliminated EOM slack at dynamically consistent solutions;
# the physics stage's epsilon-insensitive slack band is a multiple of it
EOM_SLACK_FLOOR = np.array([
    0.342, 0.422, 0.526, 0.046, 0.027, 0.056,
    0.045, 0.033, 0.068, 0.046, 0.022, 0.043,
    0.000, 0.022, 0.043, 0.000, 0.022, 0.043,
    0.021, 0.029, 0.013, 0.023, 0.032, 0.011,
    0.011, 0.024, 0.004, 0.023, 0.070, 0.013,
    0.027, 0.092, 0.010, 0.014, 0.052, 0.007,
    0.034, 0.133, 0.021, 0.025, 0.037, 0.020,
    0.100, 0.083, 0.054, 0.040, 0.028, 0.027,
    0.020, 0.088, 0.015, 0.018, 0.058, 0.013,
], dtype=float)


def measurement_weights(n_pairwise: int = 1,
                        kinetic_dataset: bool = False) -> np.ndarray:
    """(W, 24) weight rows 1/R for W in {1, 3}; the kinetic dataset uses a
    flat pixel std of 7 for every marker."""
    R = R_PW.copy()
    if kinetic_dataset:
        R[:] = 7.0
    return 1.0 / R[:n_pairwise]


def acc_model_weights(floor: float = 1e-6) -> np.ndarray:
    """(54,) constant-acceleration model weights 1/Q; ``floor`` is the
    vanishingly small weight of the DOFs with Q = 0 (leg/tail roll and yaw),
    so the solver picks the smooth representative of their null directions.
    Pass floor=0 for strict reference parity."""
    w = np.full_like(Q, floor)
    nz = Q != 0
    w[nz] = 1.0 / Q[nz]
    return w
