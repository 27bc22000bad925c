"""Port parity of the per-frame static GRF solve against the JAX package,
in float64 on the CPU: ``solver.static_grf.estimate_static_grf`` on the
same numpy-made trajectories and stances (a random one with mixed stance,
a stand, a flight phase) within 1e-10 body weights of the JAX solve, and
the port's versions of the three physical checks of
``tests/test_static_grf.py``: a stand on four feet carries the body weight
inside the friction cone, a flight phase has no GRF, and the solved GRFs
never worsen the base's equation-of-motion residual. Also: the force-plate
pipeline's entry points raise without a card unless given
``device="cpu"``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.models import params as jP
from cheetah_pose_estimation_tpu.solver import static_grf as jsg
from cheetah_pose_estimation_tpu_torch.dynamics import eom as tdyn
from cheetah_pose_estimation_tpu_torch.models import params as tP
from cheetah_pose_estimation_tpu_torch.solver import static_grf as tsg

torch.set_num_threads(1)


def _stand(n=3):
    q = np.zeros((n, 54))
    q[:, 2] = 0.6
    q[:, 5] = np.pi
    for i in range(1, 17):
        q[:, 3 * i + 5] = np.pi
    return q, np.zeros_like(q), np.zeros_like(q), np.ones((n, 4))


def _flight():
    q = np.zeros((2, 54))
    q[:, 2] = 1.0
    q[:, 5] = np.pi
    return q, np.zeros_like(q), np.zeros_like(q), np.zeros((2, 4))


def _random(seed=0, n=6):
    rng = np.random.default_rng(seed)
    q = rng.normal(scale=0.2, size=(n, 54))
    q[:, 2] += 0.5
    dq = rng.normal(scale=0.5, size=(n, 54))
    ddq = rng.normal(scale=1.0, size=(n, 54))
    stance = (rng.uniform(size=(n, 4)) < 0.6).astype(float)
    stance[0] = 1.0
    return q, dq, ddq, stance


CASES = {"random": _random, "stand": _stand, "flight": _flight}


def _port(case, subject="acinoset"):
    q, dq, ddq, stance = (torch.as_tensor(a) for a in CASES[case]())
    gz, gxy = tsg.estimate_static_grf(q, dq, ddq, stance,
                                      tP.get_subject(subject))
    return gz.numpy(), gxy.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("subject", ["acinoset", "shiraz"])
def test_static_grf_matches_jax(case, subject):
    arrays = CASES[case]()
    gz_j, gxy_j = jsg.estimate_static_grf(
        *(jnp.asarray(a) for a in arrays), jP.get_subject(subject))
    gz_t, gxy_t = _port(case, subject)
    assert gz_t.dtype == np.float64 and gxy_t.shape == (len(gz_t), 4, 4)
    np.testing.assert_allclose(gz_t, np.asarray(gz_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(gxy_t, np.asarray(gxy_j), rtol=0, atol=1e-10)
    if case == "random":
        stance = arrays[3]
        assert np.all(gz_t[stance == 0] == 0.0) and gz_t.max() > 0.0


def test_static_stand_supports_weight():
    gz, gxy = _port("stand")
    np.testing.assert_allclose(gz.sum(axis=1), 1.0, atol=0.05)
    assert (gz >= 0).all()
    assert np.all(gxy.sum(axis=2) <= 1.3 * gz + 1e-6)


def test_flight_phase_zero_grf():
    gz, gxy = _port("flight")
    np.testing.assert_allclose(gz, 0.0)
    np.testing.assert_allclose(gxy, 0.0)


def test_grf_reduces_base_eom_residual():
    subj = tP.get_subject("acinoset")
    q, dq, ddq, _ = (torch.as_tensor(a) for a in _random(n=4))
    stance = torch.ones(4, 4, dtype=torch.float64)
    gz, gxy = tsg.estimate_static_grf(q, dq, ddq, stance, subj)
    scale = subj.total_mass * tdyn.GRAVITY
    res0 = tdyn.eom_residual(q, dq, ddq, torch.zeros_like(gz),
                             torch.zeros_like(gxy), subj)[:, :6] / scale
    res1 = tdyn.eom_residual(q, dq, ddq, gz, gxy, subj)[:, :6] / scale
    assert (res1.norm(dim=1) <= res0.norm(dim=1) + 1e-9).all()
    assert (res1.norm(dim=1) < res0.norm(dim=1)).any()


@pytest.mark.parametrize("entry", ["estimate_static_grf", "estimate_grf",
                                   "run_kinetic", "kinetic_analysis"])
def test_entry_points_need_the_card_unless_cpu(entry, tmp_path):
    """Without ``device="cpu"`` the force-plate entry points run on the
    card and raise where there is none, before touching their inputs."""
    import types

    from cheetah_pose_estimation_tpu_torch.pipeline import estimator
    from cheetah_pose_estimation_tpu_torch.pipeline import run_dataset

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    est = types.SimpleNamespace(params=None)
    call = {"estimate_static_grf": lambda: estimator.estimate_static_grf(est),
            "estimate_grf": lambda: estimator.estimate_grf(est),
            "run_kinetic": lambda: run_dataset.run_kinetic(
                str(tmp_path), str(tmp_path)),
            "kinetic_analysis": lambda: run_dataset.kinetic_analysis(
                str(tmp_path), str(tmp_path))}[entry]
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        call()
