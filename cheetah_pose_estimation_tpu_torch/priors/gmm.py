"""Gaussian-mixture pose prior, trained by full-covariance EM.

Port of ``cheetah_pose_estimation_tpu/priors/gmm.py``: seeded k-means++
initial means, ``max_iter`` EM steps (all of them, as the JAX loop runs;
it has no tolerance test), and the export of (means,
precisions, log-normalisers) that the solver's pose-prior term reads
(``solver.kinematic.GMMPrior``). Training runs in float64 on the device the
caller names (the card by default).
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


def _kmeanspp_init(generator: torch.Generator, X: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding: the first centre uniformly, each next one drawn
    with probability proportional to its squared distance (+1e-12) from the
    nearest centre so far. ``generator`` and ``X`` must be on one device."""
    n = X.shape[0]
    centers = X.new_zeros((k, X.shape[1]))
    idx = torch.randint(n, (1,), generator=generator, device=X.device)
    centers[0] = X[idx[0]]
    for i in range(1, k):
        d2 = ((X[:, None, :] - centers[None, :i, :]) ** 2).sum(-1).amin(1)
        idx = torch.multinomial(d2 + 1e-12, 1, generator=generator)
        centers[i] = X[idx[0]]
    return centers


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
        m.update(repr((n_components, seed, max_iter, reg_covar)).encode())
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
    """EM from k-means++ means drawn by a CPU ``torch.Generator`` seeded
    with ``seed`` (the same draw on every device), or from ``means0``.

    A torch generator cannot reproduce ``jax.random``, so the JAX package's
    own k-means++ draw (``_kmeanspp_init(PRNGKey(seed), X, k)``) differs;
    passing that draw as ``means0`` is how the EM steps are held against
    the JAX ones."""
    dev = resolve_device(device)
    Xc = torch.tensor(np.asarray(X, np.float64))
    n, D = Xc.shape
    k = n_components
    if means0 is None:
        means = _kmeanspp_init(torch.Generator().manual_seed(seed), Xc, k)
    else:
        means = torch.tensor(np.asarray(means0, np.float64))
    X = Xc.to(dev)
    means = means.to(dev)
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
