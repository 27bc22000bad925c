"""Kinematic FTE: trajectory estimation as a robust nonlinear least-squares
problem over q in R^(N x 54), solved by damped Gauss-Newton on a
block-banded normal system.

Port of ``cheetah_pose_estimation_tpu/solver/kinematic.py`` for the default
configuration (``KinematicConfig()``: redescending measurement loss,
joint-limit hinges, joint-manifold weld, Tikhonov floor) and for the
data-driven mode's terms: the GMM pose prior, the AR motion anchor and the
base-pose anchor; and for the monocular ground-plane polish the ground,
penetration and no-slip terms. Every function takes a batch of trials:
q (B, N, 54), ``KinematicData`` leaves with a leading trial axis, and a
per-trial annealing scale (B,). The measurement loss is the redescending
one or, for the physics stage, the Huber loss (``loss="huber"``). The
live-shutter coupling is not ported yet and raises ``NotImplementedError``
when switched on.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models import skeleton as sk
from ..models.params import SubjectParams
from ..ops import banded, camera, losses
from ..utils.device import Tables, constant

NQ = 54
BANDWIDTH = 3
_ACC_STENCIL = np.array([1.0, -3.0, 3.0, -1.0])
# paw-marker rows of the 24-marker FK, ordered like dynamics.eom.FOOT_NAMES
# (HFL, HFR, HBL, HBR) so stance matrices from pipeline.contacts line up
_PAW_IDX = [sk.MARKERS.index(m) for m in
            ("l_front_paw", "r_front_paw", "l_back_paw", "r_back_paw")]


class CameraSet(NamedTuple):
    """Stacked cameras, batched: K (B,C,3,3), D (B,C,4), R (B,C,3,3),
    t (B,C,3)."""
    K: torch.Tensor
    D: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor


class GMMPrior(NamedTuple):
    """Gaussian-mixture pose prior over the 22 relative joint angles."""
    means: torch.Tensor      # (B, K, 22)
    prec: torch.Tensor       # (B, K, 22, 22) inverse covariances
    log_norm: torch.Tensor   # (B, K) log w_k - 0.5 log det(2 pi Sigma_k)


class ARAnchor(NamedTuple):
    """Fixed AR motion-model predictions the relative pose is pulled to."""
    y_pred: torch.Tensor     # (B, N, 28)
    weight: torch.Tensor     # (B, 28) = 1/sigma^2 (0 disables a dimension)
    valid: torch.Tensor      # (B, N) 1 for frames with an active anchor


class KinematicData(NamedTuple):
    """Per-trial arrays with a leading trial axis; the fields map one to one
    onto the JAX package's ``KinematicData`` (``convert.py``). Per-trial
    problems from the host builders hold numpy arrays until
    ``parallel.batch.pad_and_stack`` stacks them into tensors."""
    meas: torch.Tensor          # (B, N, C, L, 2, W) pixel measurements
    weight: torch.Tensor        # (B, N, C, L, W) 1/R weights, gated
    cam: CameraSet
    h: torch.Tensor             # (B,) timestep = 1/fps
    acc_weight: torch.Tensor    # (B, 54) model error weights 1/Q
    frame_valid: torch.Tensor   # (B, N) 1 for real frames, 0 for padding
    gmm: GMMPrior
    ar: ARAnchor
    sd_tau: torch.Tensor = np.zeros(1)          # (B, C) shutter delays
    sd_vel: torch.Tensor = np.zeros((1, 3))     # (B, N, 3)
    sd_acc: torch.Tensor = np.zeros((1, 3))     # (B, N, 3)
    # ground-plane anchor: the plane's elevation (B,) and a per-frame
    # per-foot stance confidence (B, N, 4) in [0, 1]; zero stance weights
    # (the default) leave only the penetration hinge
    ground_z: torch.Tensor = np.zeros(())
    stance_w: torch.Tensor = np.zeros((1, 4))
    # per-trial weight of the pose-prior term (B,): 1 on gate-accepted
    # trials, 0 on rejected ones, so one solver serves both
    gmm_scale: torch.Tensor = np.ones(())
    # reference base trajectory of the base-pose anchor, (B, N, 6) or
    # (B, 1, 6)
    base_ref: torch.Tensor = np.zeros((1, 6))


def map_data(fn: Callable, data):
    """Apply ``fn`` to every array leaf of a (nested) NamedTuple."""
    if isinstance(data, tuple) and hasattr(data, "_fields"):
        return type(data)(*[map_data(fn, x) for x in data])
    return fn(data)


@dataclasses.dataclass(frozen=True)
class KinematicConfig:
    fisheye: bool = True
    robust: bool = True
    loss: str = "redescending"
    use_gmm: bool = False
    use_ar: bool = False
    kinetic_dataset: bool = False
    limit_penalty: float = 1e5
    curvature_floor: float = 1e-3
    cam_multipliers: Tuple[float, ...] = ()
    live_shutter: bool = False
    weld_weight: float = 1e6
    # ground-plane anchor weights: a quadratic pull of stance-foot z onto
    # the plane (1/m^2), a one-sided hinge keeping every foot above it on
    # all valid frames, and a quadratic on the frame-to-frame xy
    # displacement of stance feet (couples q_t and q_t-1 through the banded
    # lower block)
    ground_weight: float = 0.0
    penetration_weight: float = 0.0
    noslip_weight: float = 0.0
    base_anchor_trans: float = 0.0
    base_anchor_rot: float = 0.0
    tikhonov: float = 1e-2


# ---------------------------------------------------------------------------
# Joint-limit tables (reference cheetah.py:203-356, absolute-angle branch)
# ---------------------------------------------------------------------------

def _ang(link: str, comp: str) -> int:
    i = sk.LINK_NAMES.index(link)
    base = 3 if i == 0 else 3 * i + 3
    return base + {"phi": 0, "theta": 1, "psi": 2}[comp]


def joint_limit_table(kinetic_dataset: bool = False):
    """Rows (g, lo, hi) with lo <= g . q <= hi (numpy)."""
    PI = np.pi
    rows = []

    def rel(a, b, comp, lo, hi):
        g = np.zeros(NQ)
        g[_ang(a, comp)] += 1.0
        g[_ang(b, comp)] -= 1.0
        rows.append((g, lo, hi))

    def absq(a, comp, lo, hi):
        g = np.zeros(NQ)
        g[_ang(a, comp)] += 1.0
        rows.append((g, lo, hi))

    if kinetic_dataset:
        rel("neck", "bodyF", "psi", -0.05, 0.05)
        rel("neck", "bodyF", "phi", -0.05, 0.05)
        absq("base", "phi", -0.05, 0.05)
        rel("bodyF", "base", "psi", -0.1, 0.1)
        rel("bodyF", "base", "phi", -0.1, 0.1)
        rel("base", "tail0", "psi", -0.1, 0.1)
    else:
        rel("neck", "bodyF", "psi", -PI / 6, PI / 6)
        rel("neck", "bodyF", "phi", -PI / 6, PI / 6)
        absq("base", "phi", -PI / 6, PI / 6)
        rel("bodyF", "base", "psi", -PI / 6, PI / 6)
        rel("bodyF", "base", "phi", -PI / 6, PI / 6)
        rel("base", "tail0", "psi", -PI / 1.5, PI / 1.5)
    rel("neck", "bodyF", "theta", -PI / 6, PI / 6)
    rel("bodyF", "base", "theta", -PI / 6, PI / 6)
    rel("base", "tail0", "theta", -PI / 1.5, PI / 1.5)
    rel("tail0", "tail1", "theta", -PI / 1.5, PI / 1.5)
    rel("tail0", "tail1", "psi", -PI / 1.5, PI / 1.5)
    for body, thigh, calf, hock, name in (
            ("bodyF", "UFL", "LFL", "HFL", "FL"),
            ("bodyF", "UFR", "LFR", "HFR", "FR"),
            ("base", "UBL", "LBL", "HBL", "BL"),
            ("base", "UBR", "LBR", "HBR", "BR")):
        rel(body, thigh, "theta", -0.75 * PI, 0.75 * PI)
        lo, hi = (0.0, PI) if name.startswith("B") else (-PI, 0.0)
        rel(thigh, calf, "theta", lo, hi)
        lo, hi = (-0.75 * PI, 0.0) if name.startswith("B") else (-PI / 4,
                                                                 0.75 * PI)
        rel(calf, hock, "theta", lo, hi)
    G = np.stack([r[0] for r in rows])
    lo = np.array([r[1] for r in rows])
    hi = np.array([r[2] for r in rows])
    return G, lo, hi


# ---------------------------------------------------------------------------
# Constant-acceleration (third difference) banded quadratic
# ---------------------------------------------------------------------------

def _residual_valid(frame_valid: torch.Tensor) -> torch.Tensor:
    """(B, N): third-difference residual t is valid when t >= 3 and frames
    t-3..t are all real."""
    v = frame_valid
    rv = torch.zeros_like(v)
    if v.shape[1] > 3:
        rv[:, 3:] = v[:, 3:] * v[:, 2:-1] * v[:, 1:-2] * v[:, :-3]
    return rv


def acc_banded(h: torch.Tensor, acc_weight: torch.Tensor,
               frame_valid: torch.Tensor) -> banded.BlockBanded:
    """Hessian (factor 2 included) of sum_t sum_p W_p w[t, p]^2, with
    h (B,), acc_weight (B, 54), frame_valid (B, N)."""
    B, N = frame_valid.shape
    c = _ACC_STENCIL
    res_valid = _residual_valid(frame_valid)
    h2 = h[:, None] * h[:, None]
    w = 2.0 * acc_weight / (h2 * h2)      # h^4 rounded as XLA's integer_pow

    def shifted(a):
        # seg[:, t] = res_valid[:, t + a] (zero past the end)
        seg = torch.zeros_like(res_valid)
        if N - a > 0:
            seg[:, :N - a] = res_valid[:, a:]
        return seg

    diag_coef = torch.zeros_like(res_valid)
    low_coef = [torch.zeros_like(res_valid) for _ in range(BANDWIDTH)]
    for a in range(4):
        diag_coef = diag_coef + c[a] * c[a] * shifted(a)
        for k in range(1, BANDWIDTH + 1):
            b = a + k
            if b <= 3:
                # H[t+k, t] += c_a c_b res_valid[t+b]
                low_coef[k - 1] = low_coef[k - 1] + c[a] * c[b] * shifted(b)
    eyeW = torch.diag_embed(w)                                # (B, 54, 54)
    diag = diag_coef[..., None, None] * eyeW[:, None]
    lower = torch.stack([lc[..., None, None] * eyeW[:, None]
                         for lc in low_coef], dim=1)
    return banded.BlockBanded(diag=diag, lower=lower)


def _diff_T(e: torch.Tensor) -> torch.Tensor:
    """Adjoint of the forward difference along frames: (B, M, d) ->
    (B, M + 1, d), out[s] = e[s - 1] - e[s] (zero outside 0..M-1)."""
    p = torch.nn.functional.pad(e, (0, 0, 1, 1))
    return p[:, :-1] - p[:, 1:]


def acc_gradient(q: torch.Tensor, h: torch.Tensor, acc_weight: torch.Tensor,
                 frame_valid: torch.Tensor) -> torch.Tensor:
    """(B, N, 54) gradient of :func:`acc_cost`, D^T W (D q) with D the
    third difference, taken as nested first differences.

    It equals ``banded.matvec(acc_banded(...), q)`` (the JAX package's
    form), but that product cancels terms of ~1e8 (1/h^4 at 200 fps is
    1.6e9) down to entries of ~1e4, so in float32 its error is ~1e2 and
    the LM steps follow noise (ROADMAP Queue 3 #2, #14). A difference of
    two values within a factor 2 of each other is exact (Sterbenz), as a
    smooth trajectory's neighbouring frames mostly are, so the rounding
    left is mostly that of the weights. In float64 the two forms agree to
    ~1e-11 of the gradient's largest entry."""
    if q.shape[1] <= 3:
        return torch.zeros_like(q)
    d = q
    for _ in range(3):
        d = d[:, 1:] - d[:, :-1]
    h2 = h[:, None, None] * h[:, None, None]
    fv = frame_valid
    rv = (fv[:, 3:] * fv[:, 2:-1] * fv[:, 1:-2] * fv[:, :-3])[..., None]
    e = 2.0 * rv * acc_weight[:, None, :] * d / (h2 * h2)
    # d[t] = q[t+3] - 3 q[t+2] + 3 q[t+1] - q[t]: the residual of acc_cost
    return _diff_T(_diff_T(_diff_T(e)))


def acc_cost(q: torch.Tensor, h: torch.Tensor, acc_weight: torch.Tensor,
             frame_valid: torch.Tensor) -> torch.Tensor:
    """(B,) constant-acceleration cost."""
    if q.shape[1] <= 3:
        return q.new_zeros(q.shape[0])
    w3 = (q[:, 3:] - 3 * q[:, 2:-1] + 3 * q[:, 1:-2] - q[:, :-3]) \
        / h[:, None, None] ** 2
    fv = frame_valid
    rv = fv[:, 3:] * fv[:, 2:-1] * fv[:, 1:-2] * fv[:, :-3]
    return (rv[..., None] * acc_weight[:, None, :] * w3 * w3).sum((1, 2))


# ---------------------------------------------------------------------------
# Problem factory
# ---------------------------------------------------------------------------

def _inv_pow4(s: torch.Tensor) -> torch.Tensor:
    """(1/s)^4 rounded as XLA's integer_pow forms it ((x*x)*(x*x))."""
    i2 = (1.0 / s) * (1.0 / s)
    return i2 * i2


def _per_lane(x, like: torch.Tensor) -> torch.Tensor:
    """Scalar or (B,) annealing scale -> (B,) tensor of q's dtype."""
    if not torch.is_tensor(x):
        return torch.full((like.shape[0],), float(x), dtype=like.dtype,
                          device=like.device)
    s = x.to(like.dtype)
    return s.expand(like.shape[0]) if s.ndim == 0 else s


class KinematicFTE:
    """Cost and normal-equation functions for one (config, subject) pair,
    batched over trials."""

    def __init__(self, config: KinematicConfig, subject: SubjectParams):
        unported = [name for name, on in (
            ("live_shutter", config.live_shutter),
            ("loss=" + config.loss,
             config.loss not in ("redescending", "huber"))) if on]
        if unported:
            raise NotImplementedError(
                f"KinematicConfig terms not ported yet: {unported}")
        self.config = config
        self.subject = subject
        self._G, self._lo, self._hi = joint_limit_table(
            config.kinetic_dataset)
        self._A22 = sk.A_REL[6:]  # (22, 54) relative joint angles
        self._A28 = sk.A_REL      # (28, 54)
        self._base_anchor = (config.base_anchor_trans > 0.0
                             or config.base_anchor_rot > 0.0)
        self._ground_on = (config.ground_weight > 0.0
                           or config.penetration_weight > 0.0
                           or config.noslip_weight > 0.0)
        self.tables = Tables()

    def _table(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The instance's constant table ``name`` (``_G``, ``_lo``, ``_hi``,
        ``_A22``, ``_A28``) as a tensor like ``like``, made once."""
        return self.tables.get(name, like, lambda: getattr(self, name))

    def _loss_params(self, s: torch.Tensor):
        """Annealed parameters of the measurement loss, shaped to broadcast
        against residuals (B, N, C, L, 2, W): redescending thresholds
        (3s, 10s, 20s), or the huber threshold (3s,)."""
        sv = s.view(-1, 1, 1, 1, 1, 1)
        if self.config.loss == "huber":
            return (3.0 * sv,)
        return 3.0 * sv, 10.0 * sv, 20.0 * sv

    # -- measurement ---------------------------------------------------------
    def _shutter_shift(self, data: KinematicData, N: int) -> torch.Tensor:
        """(B, N, C, 3) per-frame per-camera world shift tau*vel +
        tau^2*acc from the lagged sd_vel/sd_acc constants (zero by
        default; the live coupling is not ported)."""
        tau = data.sd_tau
        B, C = data.meas.shape[0], data.meas.shape[2]
        shift = (data.sd_vel[:, :, None, :] * tau[:, None, :, None]
                 + data.sd_acc[:, :, None, :] * (tau ** 2)[:, None, :, None])
        return shift.expand(B, N, C, 3)

    def _meas_weights(self, data: KinematicData) -> torch.Tensor:
        """(B, N, C, L, 1, W) weights incl. camera multipliers."""
        w = data.weight[:, :, :, :, None, :]
        if self.config.cam_multipliers:
            m = self.tables.get("cam_multipliers", w, lambda: np.asarray(
                self.config.cam_multipliers))[: w.shape[2]]
            w = w * m[None, None, :, None, None, None]
        return w * data.frame_valid[:, :, None, None, None, None]

    def _cams(self, data: KinematicData):
        """Camera parameters shaped (B, 1, C, 1, ...) against points
        (B, N, C, 24, 3)."""
        cam = data.cam
        return (cam.K[:, None, :, None], cam.D[:, None, :, None],
                cam.R[:, None, :, None], cam.t[:, None, :, None])

    def _points(self, pts: torch.Tensor, data: KinematicData) -> torch.Tensor:
        """Marker positions (B, N, 24, 3) -> per-camera shifted (B, N, C,
        24, 3)."""
        shift = self._shutter_shift(data, pts.shape[1])
        return pts[:, :, None] + shift[:, :, :, None, :]

    # -- full cost -----------------------------------------------------------
    def cost_terms(self, q: torch.Tensor, data: KinematicData,
                   loss_scale=1.0) -> dict:
        """Per-term costs (B,) {measurement, model, pose, motion, limit}."""
        cfg = self.config
        s = _per_lane(loss_scale, q)
        w_all = self._meas_weights(data)
        pts = sk.fk_markers_linear(q, self.subject)
        proj = camera.project_fisheye if cfg.fisheye else \
            camera.project_pinhole
        uv = proj(self._points(pts, data), *self._cams(data))
        res = uv[..., None] - data.meas                  # (B, N, C, L, 2, W)
        if cfg.robust:
            loss = losses.huber if cfg.loss == "huber" else \
                losses.redescending
            meas = loss(w_all * res, *self._loss_params(s))
        else:
            meas = (w_all * res) ** 2
        meas = meas.flatten(1).sum(1)
        model = acc_cost(q, data.h, data.acc_weight, data.frame_valid)
        fv = data.frame_valid
        pose = q.new_zeros(q.shape[0])
        motion = q.new_zeros(q.shape[0])
        if cfg.use_gmm:
            x22 = torch.einsum("ij,btj->bti", self._table("_A22", q), q)
            pose = data.gmm_scale.to(q.dtype) * (
                fv * self._gmm_neglog(x22, data.gmm)).sum(1)
        if cfg.use_ar:
            x28 = torch.einsum("ij,btj->bti", self._table("_A28", q), q)
            r = x28 - data.ar.y_pred
            motion = (data.ar.valid[..., None] * data.ar.weight[:, None, :]
                      * r * r).sum((1, 2))
        penalty = self._limit_cost(q, fv)
        if self._ground_on:
            penalty = penalty + self._ground_cost(pts, data)
        if cfg.weld_weight > 0.0:
            # continuation: soft joint manifold at wide annealing scales
            rw = sk.joint_residuals(q)
            penalty = penalty + _inv_pow4(s) * cfg.weld_weight * (
                fv[..., None] * rw * rw).sum((1, 2))
        if self._base_anchor:
            wb, rb = self._base_residual(q, data)
            penalty = penalty + (fv[..., None] * wb * rb * rb).sum((1, 2))
        return {"measurement": meas, "model": model, "pose": pose,
                "motion": motion, "limit": penalty}

    def _cost_impl(self, q: torch.Tensor, data: KinematicData,
                   loss_scale=1.0) -> torch.Tensor:
        t = self.cost_terms(q, data, loss_scale)
        return (t["measurement"] + t["model"] + t["pose"] + t["motion"]
                + t["limit"])

    def _cost(self, q: torch.Tensor, data: KinematicData,
              loss_scale=1.0) -> torch.Tensor:
        """(B,) total cost, the LM loop's accept/reject arbiter."""
        return self._cost_impl(q, data, loss_scale)

    def objective(self, q: torch.Tensor, data: KinematicData
                  ) -> torch.Tensor:
        """(B,) reference-scaled objective: 1e-3 x the cost at scale 1
        without the joint-limit penalty."""
        return 1e-3 * (self._cost(q, data)
                       - self._limit_cost(q, data.frame_valid))

    # -- GMM pose prior ------------------------------------------------------
    def _gmm_logpdf_terms(self, x22: torch.Tensor, gmm: GMMPrior
                          ) -> torch.Tensor:
        """(B, N, K) log w_k N(x; mu_k, P_k^-1) of x22 (B, N, 22), the
        quadratic form in XLA's order: (P dx) first, then dx . (P dx)."""
        dx = x22[:, :, None, :] - gmm.means[:, None]        # (B, N, K, 22)
        Pdx = torch.einsum("bkij,bnkj->bnki", gmm.prec, dx)
        quad = (dx * Pdx).sum(-1)
        return gmm.log_norm[:, None, :] - 0.5 * quad

    @staticmethod
    def _log_eps(like: torch.Tensor) -> torch.Tensor:
        return torch.log(constant("eps_1e-12", like,
                                  lambda: np.asarray(1e-12)))

    def _gmm_neglog(self, x22: torch.Tensor, gmm: GMMPrior) -> torch.Tensor:
        """(B, N) -log(p(x) + 1e-12)."""
        lse = torch.logsumexp(self._gmm_logpdf_terms(x22, gmm), dim=-1)
        return -torch.logaddexp(lse, self._log_eps(lse))

    # -- base-pose anchor ----------------------------------------------------
    def _base_residual(self, q: torch.Tensor, data: KinematicData):
        """Weights (6,) and residuals (B, N, 6) of the base-pose anchor."""
        cfg = self.config
        wb = self.tables.get("base_anchor", q,
                             lambda: np.array([cfg.base_anchor_trans] * 3
                                              + [cfg.base_anchor_rot] * 3))
        rb = q[..., :6] - data.base_ref.to(q.dtype).expand(q.shape[0],
                                                           q.shape[1], 6)
        return wb, rb

    # -- ground-plane anchor -------------------------------------------------
    @staticmethod
    def _paws(x: torch.Tensor) -> torch.Tensor:
        """The paw rows (B, N, 4, ...) of per-marker x (B, N, 24, ...)."""
        idx = constant("paw_idx", x, lambda: np.asarray(_PAW_IDX),
                       dtype=torch.long)
        return x.index_select(2, idx)

    def _ground_inputs(self, paw: torch.Tensor, data: KinematicData):
        """Plane elevation (B, 1, 1) and stance weights (B, N, 4) masked by
        frame_valid, for paw positions (B, N, 4, 3)."""
        B, N = paw.shape[0], paw.shape[1]
        gz = data.ground_z.to(paw.dtype).reshape(-1, 1, 1)
        sw = data.stance_w.to(paw.dtype).expand(B, N, 4) \
            * data.frame_valid[..., None]
        return gz, sw

    def _ground_cost(self, pts: torch.Tensor, data: KinematicData
                     ) -> torch.Tensor:
        """(B,) ground, penetration and no-slip costs of the markers
        (B, N, 24, 3)."""
        cfg = self.config
        paw = self._paws(pts)                                    # (B,N,4,3)
        fz = paw[..., 2]
        gz, sw = self._ground_inputs(paw, data)
        cost = paw.new_zeros(paw.shape[0])
        if cfg.ground_weight > 0.0:
            r = fz - gz
            cost = cost + cfg.ground_weight * (sw * r * r).sum((1, 2))
        if cfg.penetration_weight > 0.0:
            pen = torch.clamp(gz - fz, min=0.0)
            cost = cost + cfg.penetration_weight * (
                data.frame_valid[..., None] * pen * pen).sum((1, 2))
        if cfg.noslip_weight > 0.0:
            dxy = paw[:, 1:, :, :2] - paw[:, :-1, :, :2]         # (B,N-1,4,2)
            wns = cfg.noslip_weight * sw[:, 1:] * sw[:, :-1]
            cost = cost + (wns * (dxy * dxy).sum(-1)).sum((1, 2))
        return cost

    def _ground_normal(self, pts, Jm, data: KinematicData, g, Hdiag, lower):
        """Add the ground, penetration and no-slip terms' gradient and GN
        curvature to (g, Hdiag, lower). The penetration hinge is one-sided:
        its GN weight is on only where a foot is below the plane. No-slip
        couples frames t and t-1: its cross block H[t, t-1] goes to
        ``lower[:, 0, t-1]``."""
        cfg = self.config
        N = pts.shape[1]
        paw, Jpaw = self._paws(pts), self._paws(Jm)              # (B,N,4,3,54)
        fz, Jz = paw[..., 2], Jpaw[..., 2, :]
        gz, sw = self._ground_inputs(paw, data)
        if cfg.ground_weight > 0.0:
            wg = cfg.ground_weight * sw
            g = g + 2.0 * torch.einsum("btf,btfj->btj", wg * (fz - gz), Jz)
            Hdiag = Hdiag + 2.0 * torch.einsum("btf,btfi,btfj->btij",
                                               wg, Jz, Jz)
        if cfg.penetration_weight > 0.0:
            pen = torch.clamp(gz - fz, min=0.0)
            wp = cfg.penetration_weight * data.frame_valid[..., None]
            g = g - 2.0 * torch.einsum("btf,btfj->btj", wp * pen, Jz)
            Hdiag = Hdiag + 2.0 * torch.einsum(
                "btf,btfi,btfj->btij", wp * (pen > 0).to(pen.dtype), Jz, Jz)
        if cfg.noslip_weight > 0.0:
            Jxy = Jpaw[..., :2, :]                               # (B,N,4,2,54)
            dxy = paw[:, 1:, :, :2] - paw[:, :-1, :, :2]         # (B,N-1,4,2)
            wns = cfg.noslip_weight * sw[:, 1:] * sw[:, :-1]     # (B,N-1,4)
            g = g.clone()
            g[:, 1:] += 2.0 * torch.einsum("btf,btfd,btfdj->btj", wns, dxy,
                                           Jxy[:, 1:])
            g[:, :-1] += -2.0 * torch.einsum("btf,btfd,btfdj->btj", wns,
                                             dxy, Jxy[:, :-1])
            Hdiag = Hdiag.clone()
            Hdiag[:, 1:] += 2.0 * torch.einsum(
                "btf,btfdi,btfdj->btij", wns, Jxy[:, 1:], Jxy[:, 1:])
            Hdiag[:, :-1] += 2.0 * torch.einsum(
                "btf,btfdi,btfdj->btij", wns, Jxy[:, :-1], Jxy[:, :-1])
            lower = lower.clone()
            lower[:, 0, :N - 1] += -2.0 * torch.einsum(
                "btf,btfdi,btfdj->btij", wns, Jxy[:, 1:], Jxy[:, :-1])
        return g, Hdiag, lower

    # -- joint limits --------------------------------------------------------
    def _limit_values(self, q: torch.Tensor):
        G = self._table("_G", q)
        v = torch.einsum("cj,btj->btc", G, q)
        up = torch.clamp(v - self._table("_hi", q), min=0.0)
        lo = torch.clamp(self._table("_lo", q) - v, min=0.0)
        return G, up, lo

    def _limit_cost(self, q: torch.Tensor, frame_valid: torch.Tensor
                    ) -> torch.Tensor:
        _, up, lo = self._limit_values(q)
        viol = up + lo
        return self.config.limit_penalty * (
            frame_valid[..., None] * viol * viol).sum((1, 2))

    # -- normal equations ----------------------------------------------------
    def acc_gradient(self, q: torch.Tensor, data: KinematicData,
                     H_acc: banded.BlockBanded) -> torch.Tensor:
        """(B, N, 54) gradient of the constant-acceleration term, whose
        Hessian is ``H_acc``. The force-plate configuration
        (``kinetic_dataset``, 200 fps) takes it by differences
        (:func:`acc_gradient`): with the JAX package's product its float32
        solves stop 25-35 % MPJPE short of the float64 answer, and its
        gate is float64. The other configurations keep the product: their
        gates hold float32 runs to the JAX package's float32 runs, from
        which the differences move the chaotic monocular modes by several
        per cent (ROADMAP Queue 3 #2)."""
        if self.config.kinetic_dataset:
            return acc_gradient(q, data.h, data.acc_weight, data.frame_valid)
        return banded.matvec(H_acc, q)

    def _normal(self, q: torch.Tensor, data: KinematicData, loss_scale=1.0
                ) -> Tuple[torch.Tensor, banded.BlockBanded]:
        """Gradient (B, N, 54) and block-banded GN curvature of the cost."""
        cfg = self.config
        B, N = q.shape[0], q.shape[1]
        s = _per_lane(loss_scale, q)
        fv = data.frame_valid[..., None]                          # (B, N, 1)

        # measurement: J = J_proj @ J_markers, both in closed form
        pts, Jm = sk.fk_markers_and_jacobian(q, self.subject)
        proj = camera.project_fisheye_and_jacobian if cfg.fisheye else \
            camera.project_pinhole_and_jacobian
        uv, Juv = proj(self._points(pts, data), *self._cams(data))
        res = uv[..., None] - data.meas                          # (B,N,C,L,2,W)
        w = self._meas_weights(data).expand(res.shape)
        if cfg.robust:
            gw, hw = losses.gauss_newton_weights(
                res, w, cfg.curvature_floor,
                loss_params=self._loss_params(s), loss=cfg.loss)
        else:
            gw, hw = 2.0 * w * w * res, 2.0 * w * w * torch.ones_like(res)
        J = torch.einsum("bncmdi,bnmik->bncmdk", Juv, Jm)        # (B,N,C,L,2,54)
        Jf = J.reshape(B, N, -1, NQ)
        g = torch.einsum("bnrk,bnr->bnk", Jf, gw.sum(-1).reshape(B, N, -1))
        hsum = hw.sum(-1).reshape(B, N, -1, 1)
        Hdiag = (Jf * hsum).mT @ Jf

        # constant-acceleration banded quadratic (linear -> exact)
        H_acc = acc_banded(data.h, data.acc_weight, data.frame_valid)
        g = g + self.acc_gradient(q, data, H_acc)
        Hdiag = Hdiag + H_acc.diag

        if cfg.use_gmm:
            # d/dx of -log(p + eps) = p/(p+eps) sum_k gamma_k P_k (x - mu_k),
            # curvature the EM/MM surrogate sum_k gamma_k P_k (PSD)
            A22 = self._table("_A22", q)
            gmm = data.gmm
            x22 = torch.einsum("ij,btj->bti", A22, q)
            lt = self._gmm_logpdf_terms(x22, gmm)                 # (B, N, K)
            lse = torch.logsumexp(lt, dim=-1)
            e = torch.exp(lt - lt.amax(-1, keepdim=True))
            gamma = e / e.sum(-1, keepdim=True)
            factor = torch.exp(lse - torch.logaddexp(lse,
                                                     self._log_eps(lse)))
            dx = x22[:, :, None, :] - gmm.means[:, None]
            gx = torch.einsum("bnkj,bkij->bni", gamma[..., None] * dx,
                              gmm.prec)
            wg = data.gmm_scale.to(q.dtype)[:, None] * factor \
                * data.frame_valid                                # (B, N)
            gx = gx * wg[..., None]
            Hx = torch.einsum("bnk,bkij->bnij", gamma * wg[..., None],
                              gmm.prec)
            g = g + torch.einsum("ij,bti->btj", A22, gx)
            Hdiag = Hdiag + A22.T @ (Hx @ A22)

        if cfg.use_ar:
            A28 = self._table("_A28", q)
            r = torch.einsum("ij,btj->bti", A28, q) - data.ar.y_pred
            wv = data.ar.weight[:, None, :] * data.ar.valid[..., None]
            g = g + 2.0 * torch.einsum("ij,bti->btj", A28, wv * r)
            Hdiag = Hdiag + 2.0 * ((A28.T * wv[..., None, :]) @ A28)

        # joint-limit hinge (active-set quadratic)
        G, up, lo = self._limit_values(q)
        active = ((up > 0) | (lo > 0)).to(q.dtype)
        mu = cfg.limit_penalty
        g = g + 2.0 * mu * torch.einsum("cj,btc->btj", G, fv * (up - lo))
        Hdiag = Hdiag + torch.einsum("ci,ntc,cj->ntij", G,
                                     fv * active * 2.0 * mu, G)

        if cfg.weld_weight > 0.0:
            # joint manifold: exact gradient + frame-local GN, scaled
            # (1/s)^4 like the cost
            rw, Jw = sk.joint_residuals_and_jacobian(q)           # (B,N,74,54)
            ww = (2.0 * cfg.weld_weight * _inv_pow4(s))[:, None, None]
            g = g + ww * fv * torch.einsum("btrj,btr->btj", Jw, rw)
            Hdiag = Hdiag + (ww * fv)[..., None] * (Jw.mT @ Jw)

        if self._base_anchor:
            # base-pose anchor: exact quadratic (diagonal blocks only)
            wb, rb = self._base_residual(q, data)
            g = torch.cat([g[..., :6] + 2.0 * fv * wb * rb, g[..., 6:]], -1)
            Hb = torch.cat([2.0 * wb, wb.new_zeros(NQ - 6)])
            Hdiag = Hdiag + fv[..., None] * torch.diag(Hb)

        lower = H_acc.lower
        if self._ground_on:
            g, Hdiag, lower = self._ground_normal(pts, Jm, data, g, Hdiag,
                                                  lower)

        # padded frames: identity anchor keeps H nonsingular; + Tikhonov
        pad = (1.0 - data.frame_valid)[..., None, None]
        eye = torch.eye(NQ, dtype=q.dtype, device=q.device)
        Hdiag = Hdiag + (pad + cfg.tikhonov) * eye
        return g, banded.BlockBanded(diag=Hdiag, lower=lower)

    # -- annealed solve ------------------------------------------------------
    def make_solver(self,
                    stages: Tuple[Tuple[float, int], ...] = (
                        (10.0, 30), (3.0, 30), (1.0, 150)),
                    ftol: float = 1e-9, lam0: float = 1e-2,
                    linear_solver: Optional[str] = None,
                    driver: str = "while"):
        """Graduated-non-convexity solve: anneal the redescending loss
        thresholds (scale s: wide -> 1). Returns run(q0, data) -> LMState,
        batched over the leading trial axis. ``linear_solver`` is passed
        to ``gn.LMConfig`` (None: the default for the tensors' device)."""
        from . import gn as gn_mod
        if driver not in ("while", "fixed"):
            raise NotImplementedError(f"driver={driver!r} is not ported")
        stages_eff = stages if self.config.robust else \
            ((1.0, sum(it for _, it in stages)),)

        def run(q0: torch.Tensor, data: KinematicData) -> gn_mod.LMState:
            cost_fn = lambda q, s: self._cost_impl(q, data, s)
            normal_fn = lambda q, s: self._normal(q, data, s)
            if driver == "fixed" and len(stages_eff) == 1:
                sc, iters = stages_eff[0]
                s_tr = _per_lane(sc, q0)
                final, _ = gn_mod.lm_solve_scan(
                    lambda q: cost_fn(q, s_tr),
                    lambda q: normal_fn(q, s_tr), q0,
                    gn_mod.LMConfig(max_iters=iters, ftol=ftol, lam0=lam0,
                                    linear_solver=linear_solver))
                return final
            return gn_mod.lm_solve_annealed(
                cost_fn, normal_fn, q0, stages_eff,
                gn_mod.LMConfig(ftol=ftol, lam0=lam0,
                                linear_solver=linear_solver))

        return run
