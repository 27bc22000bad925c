"""Per-subject cheetah morphology parameters.

The port's own copy of the numpy-only tables of
``cheetah_pose_estimation_tpu/models/params.py`` (per-link mass [kg],
cylinder radius [m] and length [m] for each of the five subjects; friction
coefficient; torque bounds in body-weight units), carrying what the port
reads. ``tests/test_torch_tables.py`` holds every value equal to the
original.

Link order (base(body_B), bodyF, neck, tail0, tail1, UFL, LFL, HFL, UFR,
LFR, HFR, UBL, LBL, UBR, LBR, HBL, HBR) and the q layout in R^54 (base x, y,
z, phi, theta, psi, then phi, theta, psi per remaining link) are the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from math import pi
from typing import Dict

import numpy as np

LINK_NAMES = (
    "base", "bodyF", "neck", "tail0", "tail1",
    "UFL", "LFL", "HFL", "UFR", "LFR", "HFR",
    "UBL", "LBL", "UBR", "LBR", "HBL", "HBR",
)
N_LINKS = len(LINK_NAMES)
NQ = 6 + 3 * (N_LINKS - 1)  # 54

LINK_INDEX = {name: i for i, name in enumerate(LINK_NAMES)}


# q-vector slices: base occupies q[0:6]; link i>0 occupies q[3*i+3 : 3*i+6].
def q_slice(link: int) -> slice:
    return slice(0, 6) if link == 0 else slice(3 * link + 3, 3 * link + 6)


def angle_slice(link: int) -> slice:
    """Slice of q holding (phi, theta, psi) for a link."""
    return slice(3, 6) if link == 0 else slice(3 * link + 3, 3 * link + 6)


@dataclasses.dataclass(frozen=True)
class SubjectParams:
    """Morphology of one subject as flat per-link arrays (length N_LINKS)."""

    name: str
    mass: np.ndarray     # (17,) kg
    radius: np.ndarray   # (17,) m
    length: np.ndarray   # (17,) m
    friction_coeff: float
    torque_bounds: tuple  # in body-weight units

    @property
    def total_mass(self) -> float:
        return float(self.mass.sum())


def _make(name: str, body_B, body_F, neck, tail0, tail1, f_thigh, f_calf,
          f_hock, b_thigh, b_calf, b_hock, friction_coeff=1.3,
          torque_bounds=(-2.0, 2.0)) -> SubjectParams:
    # each arg: (mass, radius, length); link order per LINK_NAMES
    # (UFL LFL HFL UFR LFR HFR UBL LBL UBR LBR HBL HBR — back hocks last)
    rows = [body_B, body_F, neck, tail0, tail1,
            f_thigh, f_calf, f_hock, f_thigh, f_calf, f_hock,
            b_thigh, b_calf, b_thigh, b_calf, b_hock, b_hock]
    arr = np.array(rows, dtype=np.float64)
    cols = [arr[:, k].copy() for k in range(3)]
    for c in cols:   # read-only: the tables made from a subject stay true
        c.setflags(write=False)
    return SubjectParams(name, *cols, friction_coeff, torque_bounds)


# (mass, radius, length) triples
PARAMETERS: Dict[str, SubjectParams] = {
    "arabia": _make(
        "arabia",
        body_B=(18.0, 0.54 / (2 * pi), 0.252),
        body_F=(9.0, 0.673 / (2 * pi), 0.378),
        neck=(0.4, 0.1, 0.218 + 0.09),
        tail0=(0.4, 0.0255, 0.30),
        tail1=(0.2, 0.0255, 0.30),
        f_thigh=(0.162, 0.012, 0.242),
        f_calf=(0.067, 0.008, 0.232),
        f_hock=(0.02, 0.008, 0.1),
        b_thigh=(0.189, 0.012, 0.267),
        b_calf=(0.156, 0.01, 0.278),
        b_hock=(0.06, 0.01, 0.17),
    ),
    "shiraz": _make(
        "shiraz",
        body_B=(19.0, 0.54 / (2 * pi), 0.252),
        body_F=(13.0, 0.673 / (2 * pi), 0.378),
        neck=(0.4, 0.1, 0.218 + 0.09),
        tail0=(0.4, 0.0255, 0.30),
        tail1=(0.2, 0.0255, 0.30),
        f_thigh=(0.162, 0.012, 0.242),
        f_calf=(0.067, 0.008, 0.232),
        f_hock=(0.02, 0.008, 0.12),
        b_thigh=(0.189, 0.012, 0.267),
        b_calf=(0.156, 0.01, 0.278),
        b_hock=(0.06, 0.01, 0.17),
    ),
    "phantom": _make(
        "phantom",
        body_B=(18.6, 0.594 / (2 * pi), 0.296),
        body_F=(12.4, 0.717 / (2 * pi), 0.444),
        neck=(0.4, 0.1, 0.31),
        tail0=(0.4, 0.0255, 0.28),
        tail1=(0.2, 0.0255, 0.36),
        f_thigh=(0.2052, 0.012, 0.26),
        f_calf=(0.0816, 0.005, 0.27),
        f_hock=(0.02, 0.008, 0.125),
        b_thigh=(0.252, 0.012, 0.26),
        b_calf=(0.12, 0.01, 0.29),
        b_hock=(0.072, 0.01, 0.265),
    ),
    "jules": _make(
        "jules",
        body_B=(21.0, 0.594 / (2 * pi), 0.296),
        body_F=(14.0, 0.717 / (2 * pi), 0.444),
        neck=(0.4, 0.1, 0.35),
        tail0=(0.4, 0.0255, 0.28),
        tail1=(0.2, 0.0255, 0.36),
        f_thigh=(0.2052, 0.012, 0.24),
        f_calf=(0.0816, 0.005, 0.28),
        f_hock=(0.02, 0.008, 0.155),
        b_thigh=(0.252, 0.012, 0.27),
        b_calf=(0.12, 0.01, 0.33),
        b_hock=(0.072, 0.01, 0.245),
    ),
    "acinoset": _make(
        "acinoset",
        body_B=(28.0, 0.594 / (2 * pi), 0.37),
        body_F=(14.0, 0.717 / (2 * pi), 0.37),
        neck=(0.4, 0.1, 0.218 + 0.09),
        tail0=(0.4, 0.0255, 0.28),
        tail1=(0.2, 0.0255, 0.36),
        f_thigh=(0.171 * 1.2, 0.012, 0.24),
        f_calf=(0.068 * 1.2, 0.005, 0.28),
        f_hock=(0.02, 0.008, 0.14),
        b_thigh=(0.210 * 1.2, 0.012, 0.32),
        b_calf=(0.100 * 1.2, 0.01, 0.25),
        b_hock=(0.060 * 1.2, 0.01, 0.22),
    ),
}


def get_subject(name: str) -> SubjectParams:
    """Subject lookup; unknown names map to the generic "acinoset"
    cheetah, as in the JAX package."""
    if name not in ("jules", "phantom", "shiraz", "arabia"):
        name = "acinoset"
    return PARAMETERS[name]
