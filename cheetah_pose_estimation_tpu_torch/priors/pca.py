"""PCA pose model (reference ``PoseModel``, acinoset_models.py:61-170).

Port of ``cheetah_pose_estimation_tpu/priors/pca.py`` (the whole file; numpy
only, a copy kept here because the port imports nothing of the JAX
package): an SVD with sklearn's deterministic sign correction, and the
projection to and from the principal axes over the included dims
(ext_dim..num_vars) with the excluded base dims passed through.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np

from . import dataset as ds


@dataclass
class PoseModel:
    n_comps: int
    num_vars: int
    ext_dim: int
    mean: np.ndarray            # (d,)
    std: np.ndarray             # (d,)
    P: np.ndarray               # (n_comps, d) principal axes
    PC: np.ndarray              # (n, n_comps) training principal components
    error_variance: np.ndarray  # (num_vars,)
    rmse: float
    explained_variance: np.ndarray  # cumulative ratio per component
    standardise: bool = False

    def pc_std(self) -> np.ndarray:
        return np.std(self.PC, axis=0)

    def project(self, X, full_state: bool = True,
                inverse: bool = False) -> np.ndarray:
        """Rows of X to the principal components (``inverse``: back). With
        ``full_state`` the first ``ext_dim`` columns pass through and the
        included dims are ``ext_dim:num_vars`` (JAX ``pca.py:33-52``)."""
        X = np.asarray(X)
        single = X.ndim == 1
        if single:
            X = X[None]
        if full_state:
            ext, body = X[:, :self.ext_dim], X[:, self.ext_dim:self.num_vars]
        else:
            ext, body = None, X
        if inverse:
            out = body @ self.P
            out = out * self.std + self.mean if self.standardise \
                else out + self.mean
        else:
            z = (body - self.mean) / self.std if self.standardise \
                else body - self.mean
            out = z @ self.P.T
        if full_state:
            out = np.concatenate([ext, out], axis=1)
        return out[0] if single else out


def fit(dataset: Union[str, ds.PoseTable], num_vars: int = 28,
        ext_dim: int = 6, n_comps: int = 5,
        standardise: bool = False) -> PoseModel:
    """Fit the pose model on a pose table: a CSV path (as the JAX function
    takes) or a :class:`~.dataset.PoseTable` (JAX ``pca.py:55-84``)."""
    tab = ds.load_pose_dataset(dataset) if isinstance(dataset, str) \
        else dataset
    data = np.asarray(tab.data, np.float64)
    X = data[:, ext_dim:num_vars]
    std = X.std(axis=0)
    mean = X.mean(axis=0)
    X0 = (X - mean) / std if standardise else X - mean

    U, s, VT = np.linalg.svd(X0, full_matrices=False)
    # deterministic sign correction (as sklearn/reference)
    max_abs_cols = np.argmax(np.abs(U), axis=0)
    signs = np.sign(U[max_abs_cols, range(U.shape[1])])
    U *= signs
    VT *= signs[:, np.newaxis]

    eig = s ** 2
    explained = np.cumsum(eig) / np.sum(eig)
    P = VT[:n_comps, :]
    PC = U[:, :n_comps] * s[:n_comps]
    X1 = PC @ P * std + mean if standardise else PC @ P + mean

    X_orig = data[:, :num_vars]
    rmse = float(np.sqrt(np.mean((X_orig[:, ext_dim:] - X1) ** 2)))
    error_variance = np.zeros(num_vars)
    error_variance[ext_dim:] = np.var(X_orig[:, ext_dim:] - X1, axis=0)
    return PoseModel(n_comps=n_comps, num_vars=num_vars, ext_dim=ext_dim,
                     mean=mean, std=std, P=P, PC=PC,
                     error_variance=error_variance, rmse=rmse,
                     explained_variance=explained, standardise=standardise)
