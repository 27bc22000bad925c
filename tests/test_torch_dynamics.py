"""Port parity of the rigid-body dynamics and the contact detection against
the JAX package, float64, on configurations drawn from numpy seeds.

Tolerances: the rotation tables, link Jacobians, mass matrix, bias terms
(velocity products and gravity), feet, generalized contact forces and EOM
residual are the same functions in closed form where the JAX package uses
nested autodiff (observed <= 4e-16 relative); bound 1e-12 relative
(max |a - b| / max |a|). The torque map is exact. The closed-form mass
matrix equals the port's own nested-autodiff one (``mass_matrix_ad``) to
1e-12, and 0.5 dq^T M dq the kinetic energy. Contact detection, stance
matrices and pruned stances from the same trajectories are exactly equal,
and so is the whole physics batch that ``build_physics_batch`` stacks from
them (its float leaves to 1e-12).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cheetah_pose_estimation_tpu.dynamics import eom as jeom
from cheetah_pose_estimation_tpu.models import params as jparams
from cheetah_pose_estimation_tpu.models import skeleton as jsk
from cheetah_pose_estimation_tpu.ops import rotations as jrot
from cheetah_pose_estimation_tpu.pipeline import bench_lib as jbl
from cheetah_pose_estimation_tpu.pipeline import contacts as jcon
from cheetah_pose_estimation_tpu.solver import kinetic as jkn
from cheetah_pose_estimation_tpu_torch.dynamics import eom as teom
from cheetah_pose_estimation_tpu_torch.models import skeleton as tsk
from cheetah_pose_estimation_tpu_torch.ops import rotations as trot
from cheetah_pose_estimation_tpu_torch.pipeline import bench_lib as tbl
from cheetah_pose_estimation_tpu_torch.pipeline import contacts as tcon
from cheetah_pose_estimation_tpu_torch.solver import kinetic as tkn

torch.set_num_threads(1)
SUBJECT = jparams.get_subject("acinoset")
FS = SUBJECT.total_mass * jeom.GRAVITY
TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


@pytest.fixture(scope="module")
def states():
    """Six configurations with velocities, accelerations and contact
    forces (numpy seed 0)."""
    rng = np.random.default_rng(0)
    q = rng.normal(scale=0.5, size=(6, 54))
    q[:, :3] = rng.normal(size=(6, 3))
    return dict(q=q, dq=rng.normal(scale=2.0, size=(6, 54)),
                ddq=rng.normal(scale=20.0, size=(6, 54)),
                gz=rng.uniform(0.0, 3.0, size=(6, 4)),
                gxy=rng.uniform(0.0, 1.0, size=(6, 4, 4)))


def test_rotation_maps_match_jax(states):
    ang = states["q"][:, 3:6]
    ta = torch.as_tensor(ang)
    assert _rel(jrot.euler_rate_to_body_omega(jnp.asarray(ang)),
                trot.euler_rate_to_body_omega(ta)) <= TOL
    _, dE = trot.euler_rate_to_body_omega(ta, derivative=True)
    dEj = jax.vmap(jax.jacfwd(jrot.euler_rate_to_body_omega))(
        jnp.asarray(ang))
    assert _rel(dEj[..., :2], dE) <= TOL
    assert float(jnp.abs(dEj[..., 2]).max()) == 0.0
    ddRj = jax.vmap(jax.jacfwd(jax.jacfwd(jrot.euler_zyx)))(jnp.asarray(ang))
    assert _rel(ddRj, trot.euler_zyx_second_derivative(ta)) <= TOL


def test_omega_selector_matches_jax(states):
    want = jax.vmap(jeom._omega_selector)(jnp.asarray(states["q"]))
    assert _rel(want, teom._omega_selector(torch.as_tensor(
        states["q"]))) <= TOL


def test_link_points_and_jacobians_match_jax(states):
    assert _rel(jsk.com_coefficients(SUBJECT),
                tsk.com_coefficients(SUBJECT)) <= TOL
    C = jsk.bottom_coefficients(SUBJECT)
    assert _rel(C, tsk.bottom_coefficients(SUBJECT)) <= TOL
    q = states["q"]
    cj, Jj = jax.vmap(lambda x: jsk.com_and_jacobian(x, SUBJECT))(
        jnp.asarray(q))
    ct, Jt = tsk.com_and_jacobian(torch.as_tensor(q), SUBJECT)
    assert _rel(cj, ct) <= TOL and _rel(Jj, Jt) <= TOL
    pj, Pj = jax.vmap(lambda x: jsk.points_and_jacobian_from_coeffs(
        x, jnp.asarray(C)))(jnp.asarray(q))
    pt, Pt = tsk.points_and_jacobian_from_coeffs(torch.as_tensor(q),
                                                 torch.as_tensor(C))
    assert _rel(pj, pt) <= TOL and _rel(Pj, Pt) <= TOL


def _jax_fn(name):
    return {
        "mass_matrix": lambda q, dq, ddq, gz, gxy: jeom.mass_matrix(
            q, SUBJECT),
        "bias_terms": lambda q, dq, ddq, gz, gxy: jeom.bias_terms(
            q, dq, SUBJECT),
        "foot_points": lambda q, dq, ddq, gz, gxy: jeom.foot_points(
            q, SUBJECT),
        "grf_generalized_forces": lambda q, dq, ddq, gz, gxy:
            jeom.grf_generalized_forces(q, gz, gxy, SUBJECT, FS),
        "eom_residual": lambda q, dq, ddq, gz, gxy: jeom.eom_residual(
            q, dq, ddq, gz, gxy, SUBJECT),
    }[name]


def _torch_fn(name):
    return {
        "mass_matrix": lambda q, dq, ddq, gz, gxy: teom.mass_matrix(
            q, SUBJECT),
        "bias_terms": lambda q, dq, ddq, gz, gxy: teom.bias_terms(
            q, dq, SUBJECT),
        "foot_points": lambda q, dq, ddq, gz, gxy: teom.foot_points(
            q, SUBJECT),
        "grf_generalized_forces": lambda q, dq, ddq, gz, gxy:
            teom.grf_generalized_forces(q, gz, gxy, SUBJECT, FS),
        "eom_residual": lambda q, dq, ddq, gz, gxy: teom.eom_residual(
            q, dq, ddq, gz, gxy, SUBJECT),
    }[name]


@pytest.mark.parametrize("name", ["mass_matrix", "bias_terms", "foot_points",
                                  "grf_generalized_forces", "eom_residual"])
def test_dynamics_match_jax(states, name):
    keys = ("q", "dq", "ddq", "gz", "gxy")
    want = jax.vmap(_jax_fn(name))(*[jnp.asarray(states[k]) for k in keys])
    got = _torch_fn(name)(*[torch.as_tensor(states[k]) for k in keys])
    assert _rel(want, got) <= TOL, _rel(want, got)


def test_bias_terms_zero_velocity_is_gravity(states):
    """With dq = 0 only gravity remains, and it equals dPE/dq."""
    q = torch.as_tensor(states["q"][0])
    G = teom.bias_terms(q, torch.zeros_like(q), SUBJECT)
    dpe = torch.func.grad(lambda x: teom.potential_energy(x, SUBJECT))(q)
    assert _rel(dpe, G) <= TOL


def test_mass_matrix_matches_nested_autodiff(states):
    q = torch.as_tensor(states["q"])
    M = teom.mass_matrix(q, SUBJECT)
    for i in range(3):
        assert _rel(teom.mass_matrix_ad(q[i], SUBJECT), M[i]) <= TOL
    dq = torch.as_tensor(states["dq"])
    ke = teom.kinetic_energy(q, dq, SUBJECT)
    quad = 0.5 * torch.einsum("bi,bij,bj->b", dq, M, dq)
    assert _rel(ke, quad) <= TOL
    assert _rel(jax.vmap(lambda a, b: jeom.kinetic_energy(a, b, SUBJECT))(
        jnp.asarray(states["q"]), jnp.asarray(states["dq"])), ke) <= TOL
    assert _rel(jax.vmap(lambda a: jeom.potential_energy(a, SUBJECT))(
        jnp.asarray(states["q"])), teom.potential_energy(q, SUBJECT)) <= TOL


def test_torque_map_exact():
    assert np.array_equal(jeom.TORQUE_MAP.B, teom.TORQUE_MAP.B)
    assert jeom.TORQUE_MAP.names == teom.TORQUE_MAP.names
    assert teom.N_TAU == jeom.N_TAU == 22
    assert np.array_equal(jeom.POLYGON_D, teom.POLYGON_D)
    tau = np.random.default_rng(1).normal(size=(5, 22))
    a, b = jeom.tau_as_dict(tau), teom.tau_as_dict(tau)
    assert list(a) == list(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)


@pytest.fixture(scope="module")
def gallops():
    """Three procedural gallops (40, 52, 58 frames) with 5 mm of noise, the
    fps and ground heights: the shapes of the bench's warm starts."""
    rng = np.random.default_rng(7)
    out = []
    for i, (q, _, fps) in enumerate(jbl.load_reference_trajectories(10)):
        if i not in (0, 6, 9):
            continue
        out.append((q + rng.normal(scale=0.005, size=q.shape), fps,
                    jcon.estimate_ground_height(q, SUBJECT)))
    return out


def test_contact_detection_matches_jax(gallops):
    for q, fps, gph in gallops:
        dq = np.zeros_like(q)
        dq[1:] = (q[1:] - q[:-1]) * fps
        hj, vj = jcon.foot_kinematics(q, dq, SUBJECT)
        ht, vt = tcon.foot_kinematics(q, dq, SUBJECT)
        assert _rel(hj, ht) <= TOL and _rel(vj, vt) <= TOL
        assert abs(tcon.estimate_ground_height(q, SUBJECT)
                   - jcon.estimate_ground_height(q, SUBJECT)) <= 1e-12
        assert tcon.positive_zero_crossings(vt[:, 0, 2]) == \
            jcon.positive_zero_crossings(vj[:, 0, 2])
        for speed in (8.0, 12.0):
            cj, tj = jcon.contact_detection(q, dq, SUBJECT, 0, speed, fps,
                                            ground_plane_height=gph)
            ct, tt = tcon.contact_detection(q, dq, SUBJECT, 0, speed, fps,
                                            ground_plane_height=gph)
            assert (cj, tj) == (ct, tt)
            sj = jkn.stance_matrix(cj, 0, q.shape[0])
            st = tkn.stance_matrix(ct, 0, q.shape[0])
            assert np.array_equal(sj, st) and sj.sum() > 0
            h = 1.0 / fps
            assert np.array_equal(jkn.prune_stance(sj, q, SUBJECT, h),
                                  tkn.prune_stance(st, q, SUBJECT, h))


def test_build_physics_batch_matches_jax(gallops):
    """The JAX package's ``build_physics_batch`` and the port's, from the
    same problems, warm starts, fps and ground heights: equal stance and
    every leaf within 1e-12."""
    jdatas, tdatas, qs, fpss, gphs = [], [], [], [], []
    rng = np.random.default_rng(3)
    gp = jbl.empty_priors(1)[0]._replace(
        means=rng.normal(scale=0.1, size=(1, 22)))
    for i, (q, fps, gph) in enumerate(gallops):
        d, _, _ = jbl.build_monocular_problem(q, "acinoset", fps, seed=i)
        jdatas.append(d._replace(gmm=gp))
        d2, _, _ = tbl.build_monocular_problem(q, "acinoset", fps, seed=i)
        tdatas.append(d2)
        qs.append(q)
        fpss.append(fps)
        gphs.append(gph)
    jb, jq = jbl.build_physics_batch(jdatas, qs, fpss, SUBJECT, n_frames=64,
                                     dtype=jnp.float64, use_gmm=False,
                                     ground_heights=gphs)
    tb, tq = tbl.build_physics_batch(tdatas, qs, fpss, SUBJECT,
                                     gmm_prior=gp, n_frames=64,
                                     dtype=torch.float64,
                                     ground_heights=gphs, device="cpu")
    assert np.array_equal(np.asarray(jb.stance), tb.stance.numpy())
    assert tb.stance.sum() > 0
    assert _rel(jq, tq) <= TOL
    for name in ("grf_fixed", "grf_xy_fixed", "use_fixed_grf", "q_warm",
                 "tau_anchor", "tau_anchor_weight", "ground_z"):
        a = np.broadcast_to(np.asarray(getattr(jb, name)),
                            tuple(getattr(tb, name).shape))
        assert np.abs(a - getattr(tb, name).numpy()).max() <= TOL * max(
            1.0, np.abs(a).max()), name
    for name in ("meas", "weight", "frame_valid", "h"):
        assert _rel(getattr(jb.base, name),
                    getattr(tb.base, name).numpy()) <= TOL, name
    assert _rel(jb.base.gmm.means, tb.base.gmm.means.numpy()) <= TOL
