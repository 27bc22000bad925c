"""Gaussian-mixture pose prior, trained by full-covariance EM.

Port of ``cheetah_pose_estimation_tpu/priors/gmm.py``: seeded k-means++
initial means, ``max_iter`` EM steps (all of them, as the JAX loop runs;
it has no tolerance test), and the export of (means,
precisions, log-normalisers) that the solver's pose-prior term reads
(``solver.kinematic.GMMPrior``). Training runs in float64 on the device the
caller names (the card by default).

The k-means++ draw is ``jax.random``'s, recomputed in numpy on the host
(:class:`_JaxKey`): threefry2x32, ``PRNGKey(seed)``, ``split``,
``randint`` and ``categorical`` (Gumbel-max) as jax 0.9.0 computes them in
float64 (x64 on) with its default ``jax_threefry_partitionable``. So a fit
with the same seed starts from the same means as the JAX package's and
ends in the same EM optimum.
"""
from __future__ import annotations

import hashlib
import math
import os
import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device


class GMMParams(NamedTuple):
    weights: torch.Tensor   # (K,)
    means: torch.Tensor     # (K, D)
    covs: torch.Tensor      # (K, D, D)

    @property
    def n_components(self) -> int:
        return self.means.shape[0]


_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher (20 rounds) of jax's PRNG on uint32
    arrays: key (k1, k2), counters (x1, x2) -> two uint32 words."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


class _JaxKey:
    """A raw threefry key (two uint32 words) and the ``jax.random``
    functions k-means++ draws with, as jax 0.9.0 computes them with x64 on
    and ``jax_threefry_partitionable`` (its default): every draw of shape
    S hashes the flat index i of each element as the counter pair (i >>
    32, i & 0xffffffff)."""

    def __init__(self, k1, k2):
        self.k = (_U32(k1), _U32(k2))

    @classmethod
    def from_seed(cls, seed: int) -> "_JaxKey":
        """``jax.random.PRNGKey(seed)``: (seed >> 32, seed & 0xffffffff)."""
        seed = int(seed)
        return cls((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF)

    def _bits(self, n: int):
        i = np.arange(n, dtype=np.uint64)
        return _threefry2x32(*self.k, (i >> np.uint64(32)).astype(_U32),
                             (i & np.uint64(0xFFFFFFFF)).astype(_U32))

    def split(self, num: int = 2):
        """``jax.random.split``."""
        b1, b2 = self._bits(num)
        return [_JaxKey(a, b) for a, b in zip(b1, b2)]

    def bits64(self, n: int) -> np.ndarray:
        """(n,) uint64 random bits (``random_bits`` of width 64)."""
        b1, b2 = self._bits(n)
        return (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)

    def randint(self, maxval: int) -> int:
        """``jax.random.randint(key, (), 0, maxval)`` for int64: two 64-bit
        draws, reduced by the span with jax's multiplier."""
        k1, k2 = self.split()
        hi, lo = int(k1.bits64(1)[0]), int(k2.bits64(1)[0])
        span = int(maxval)
        mult = (2 ** 32 % span) ** 2 % span
        return ((hi % span) * mult + lo % span) % span

    def uniform(self, n: int) -> np.ndarray:
        """(n,) float64 ``jax.random.uniform`` on [tiny, 1): the top 52
        bits as a mantissa in [1, 2), minus 1."""
        tiny = np.finfo(np.float64).tiny
        bits = (self.bits64(n) >> np.uint64(12)) \
            | np.float64(1.0).view(np.uint64)
        f = bits.view(np.float64) - 1.0
        return np.maximum(tiny, f * (1.0 - tiny) + tiny)

    def categorical(self, logits: np.ndarray) -> int:
        """``jax.random.categorical`` of a 1-D float64 ``logits``: the
        argmax of the logits plus Gumbel noise -log(-log u)."""
        return int(np.argmax(-np.log(-np.log(self.uniform(len(logits))))
                             + logits))


def kmeanspp_indices(X: np.ndarray, k: int, seed: int) -> list:
    """The row indices of X that the JAX package's
    ``_kmeanspp_init(PRNGKey(seed), X, k)`` picks as centres (JAX
    ``priors/gmm.py:41-60``), in float64 on the host: the first uniformly
    (``randint``), each next one by ``categorical`` over log(d2 + 1e-12),
    d2 the squared distance to the nearest centre so far."""
    X = np.asarray(X, np.float64)
    key, sub = _JaxKey.from_seed(seed).split()
    idx = [sub.randint(X.shape[0])]
    d2 = ((X - X[idx[0]]) ** 2).sum(-1)
    for _ in range(1, k):
        key, sub = key.split()
        idx.append(sub.categorical(np.log(d2 + 1e-12)))
        d2 = np.minimum(d2, ((X - X[idx[-1]]) ** 2).sum(-1))
    return idx


def _log_gaussians(X: torch.Tensor, means: torch.Tensor, covs: torch.Tensor,
                   reg: float) -> torch.Tensor:
    """(n, K) log N(x_n; mu_k, Sigma_k + reg I)."""
    D = X.shape[1]
    eye = torch.eye(D, dtype=X.dtype, device=X.device)
    chol = torch.linalg.cholesky(covs + reg * eye[None])
    dx = X[:, None, :] - means[None, :, :]                    # (n, K, D)
    sol = torch.linalg.solve_triangular(chol, dx.permute(1, 2, 0),
                                        upper=False)          # (K, D, n)
    quad = (sol ** 2).sum(1).T                                # (n, K)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2,
                                            dim2=-1)).sum(-1)  # (K,)
    return -0.5 * (quad + logdet[None, :] + D * math.log(2 * math.pi))


def fit(X: np.ndarray, n_components: int, seed: int = 42,
        max_iter: int = 200, reg_covar: float = 1e-6,
        device: DeviceLike = None,
        cache_dir: Optional[str] = None) -> GMMParams:
    """Full-covariance EM on the rows of X, in float64 on ``device``.
    Raises on a non-finite fit.

    With ``cache_dir`` the fit is stored there as
    ``gmm_model_<md5>.torch.pkl``, keyed by the md5 of the data's bytes and
    the settings, and loaded from there when it exists."""
    cache_path = None
    if cache_dir is not None:
        m = hashlib.md5()
        m.update(np.ascontiguousarray(np.asarray(X, np.float64)).tobytes())
        m.update(repr((n_components, seed, max_iter, reg_covar,
                       "jax-kmeans++")).encode())
        cache_path = os.path.join(cache_dir,
                                  f"gmm_model_{m.hexdigest()}.torch.pkl")
        if os.path.isfile(cache_path):
            with open(cache_path, "rb") as f:
                arrays = pickle.load(f)
            dev = resolve_device(device)
            return GMMParams(*[torch.as_tensor(a, device=dev)
                               for a in arrays])
    params = _fit(X, n_components, seed, max_iter, reg_covar, device=device)
    if not all(bool(torch.isfinite(p).all()) for p in params):
        raise RuntimeError("GMM training produced non-finite parameters")
    if cache_path is not None:
        with open(cache_path, "wb") as f:
            pickle.dump(tuple(p.cpu().numpy() for p in params), f)
    return params


def _fit(X, n_components: int, seed: int, max_iter: int, reg_covar: float,
         means0: Optional[np.ndarray] = None,
         device: DeviceLike = None) -> GMMParams:
    """EM from the k-means++ means of JAX's draw with ``seed``
    (:func:`kmeanspp_indices`, on the host), or from ``means0``."""
    dev = resolve_device(device)
    Xn = np.asarray(X, np.float64)
    n, D = Xn.shape
    k = n_components
    if means0 is None:
        means0 = Xn[kmeanspp_indices(Xn, k, seed)]
    X = torch.tensor(Xn, device=dev)
    means = torch.tensor(np.asarray(means0, np.float64), device=dev)
    eye = torch.eye(D, dtype=X.dtype, device=dev)
    covs = (torch.cov(X.T) + reg_covar * eye).expand(k, D, D).clone()
    w = torch.full((k,), 1.0 / k, dtype=X.dtype, device=dev)
    for _ in range(max_iter):
        logp = _log_gaussians(X, means, covs, reg_covar) + torch.log(w)[None]
        resp = torch.softmax(logp, dim=1)                     # (n, K)
        nk = resp.sum(0) + 1e-10
        means = (resp.T @ X) / nk[:, None]
        dx = X[:, None, :] - means[None, :, :]                # (n, K, D)
        covs = torch.einsum("nk,nki,nkj->kij", resp, dx, dx) \
            / nk[:, None, None]
        covs = covs + reg_covar * eye[None]
        w = nk / n
    return GMMParams(weights=w, means=means, covs=covs)


def score(params: GMMParams, X: np.ndarray, reg_covar: float = 1e-6
          ) -> float:
    """Mean per-sample log-likelihood (sklearn ``GaussianMixture.score``),
    on the parameters' device."""
    Xt = torch.as_tensor(np.asarray(X, np.float64),
                         device=params.means.device)
    logp = _log_gaussians(Xt, params.means, params.covs, reg_covar) \
        + torch.log(params.weights)[None]
    return float(torch.logsumexp(logp, dim=1).mean())


def to_solver_prior(params: GMMParams):
    """(means, precisions, log-normalisers) for the in-solver prior, as
    numpy float64 leaves of one (unbatched) ``kinematic.GMMPrior``:
    log_norm_k = log w_k - 0.5 log det(2 pi Sigma_k), so the frame cost
    -log(sum_k exp(log_norm_k - 0.5 dx^T P_k dx) + 1e-12) is the mixture's
    negative log density."""
    from ..solver.kinematic import GMMPrior

    covs = params.covs.detach().cpu().numpy()
    prec = np.linalg.inv(covs)
    _, logdet = np.linalg.slogdet(2 * np.pi * covs)
    log_norm = np.log(params.weights.detach().cpu().numpy() + 1e-300) \
        - 0.5 * logdet
    return GMMPrior(means=params.means.detach().cpu().numpy(), prec=prec,
                    log_norm=log_norm)
