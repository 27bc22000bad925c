"""Windowed linear autoregressive motion model.

Port of ``cheetah_pose_estimation_tpu/priors/armodel.py``: predict the
28-dim relative pose at time t from the previous ``window_size`` poses, by
ordinary least squares or by a MultiTaskLasso (row-grouped L21 penalty)
solved with FISTA. The Gram matrix, its exact largest eigenvalue and the
guards are host numpy in float64; the FISTA iterations run in float64 on
the device the caller names (the card by default). The per-dimension
residual variance on the training set drives the in-solver motion weights.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device
from . import dataset as ds


def unique_id(values: Tuple) -> str:
    """The md5 hex digest of the values' ``str`` forms, in order."""
    m = hashlib.md5()
    for s in [str(x) for x in values]:
        m.update(s.encode())
    return m.hexdigest()


def fit_linear(X: np.ndarray, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """OLS with intercept: returns (coef (d_out, d_in), intercept (d_out,))."""
    Xm, ym = X.mean(axis=0), y.mean(axis=0)
    coef, *_ = np.linalg.lstsq(X - Xm, y - ym, rcond=None)
    coef = coef.T
    return coef, ym - coef @ Xm


def _fista(G: torch.Tensor, Xty: torch.Tensor, alpha: float, step: float,
           iters: int = 4000) -> torch.Tensor:
    """MultiTaskLasso: min (1/2n)||Y - X W^T||_F^2 + alpha sum_j ||W[:, j]||_2,
    by FISTA over the normal-equation form (``G = X^T X / n``, ``Xty = X^T y
    / n``); ``step`` must be <= 1/lambda_max(G). Returns W (d_out, p)."""
    W = G.new_zeros((Xty.shape[1], G.shape[0]))
    Z = W
    tk = torch.ones((), dtype=G.dtype, device=G.device)
    thr = step * alpha
    for _ in range(iters):
        grad = (G @ Z.T - Xty).T                               # (d_out, p)
        V = Z - step * grad
        norms = torch.linalg.norm(V, dim=0, keepdim=True)
        Wn = V * torch.clamp(1.0 - thr / torch.clamp(norms, min=1e-30),
                             min=0.0)
        tn = 0.5 * (1 + torch.sqrt(1 + 4 * tk * tk))
        Z = Wn + ((tk - 1) / tn) * (Wn - W)
        W, tk = Wn, tn
    return W


def fit_multitask_lasso(X: np.ndarray, y: np.ndarray, alpha: float = 1e-2,
                        iters: int = 4000, zero_clip: float = 1e-10,
                        device: DeviceLike = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (coef (d_out, d_in), intercept (d_out,)).

    The step comes from an exact float64 eigvalsh of the Gram matrix (with
    a 0.95 safety factor); a non-finite result, or one whose training
    residual RMS exceeds 1.5x the mean predictor's, is retried with a
    halved step, up to five times, and then raises: the fit never returns
    non-finite or diverged coefficients."""
    dev = resolve_device(device)
    Xm, ym = X.mean(axis=0), y.mean(axis=0)
    Xc64 = np.asarray(X - Xm, np.float64)
    yc64 = np.asarray(y - ym, np.float64)
    n = Xc64.shape[0]
    G64 = Xc64.T @ Xc64 / n
    Xty64 = Xc64.T @ yc64 / n
    L = float(np.linalg.eigvalsh(G64)[-1])
    step = 0.95 / max(L, 1e-30)
    dt = torch.float64 if np.asarray(X).dtype == np.float64 else torch.float32
    G = torch.as_tensor(G64, dtype=dt, device=dev)
    Xty = torch.as_tensor(Xty64, dtype=dt, device=dev)
    y_rms = float(np.sqrt(np.mean(yc64 ** 2)))
    for _ in range(5):
        W = _fista(G, Xty, alpha, step, iters).cpu().numpy()
        if np.isfinite(W).all():
            r_rms = float(np.sqrt(np.mean(
                (yc64 - Xc64 @ np.asarray(W, np.float64).T) ** 2)))
            if r_rms <= 1.5 * y_rms:
                break
        step *= 0.5
    else:
        raise RuntimeError(
            "FISTA produced non-finite or diverged coefficients even after "
            f"step backoff (L={L:.3e}); refusing to return a poisoned model")
    W[np.abs(W) < zero_clip] = 0.0
    return W, ym - W @ Xm


@dataclass
class MotionModel:
    """Trained AR model + residual statistics (numpy)."""

    coef: np.ndarray            # (28, 28*window_size)
    intercept: np.ndarray       # (28,)
    error_variance: np.ndarray  # (28,) train residual variance
    train_rmse: float
    validation_rmse: float
    window_size: int
    window_time: int
    lasso: bool

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        if X.ndim == 1:
            return self.coef @ X + self.intercept
        return X @ self.coef.T + self.intercept[None, :]

    @property
    def model_non_zeros(self) -> int:
        return int(np.count_nonzero(self.coef))


def _table(src: Union[str, ds.PoseTable]) -> ds.PoseTable:
    return ds.load_pose_dataset(src) if isinstance(src, str) else src


def train_motion_model(dataset: Union[str, ds.PoseTable],
                       window_size: int = 4, lasso: bool = True,
                       alpha: float = 1e-2,
                       validation: Union[str, ds.PoseTable, None] = None,
                       device: DeviceLike = None,
                       cache_dir: Optional[str] = None,
                       num_vars: int = 28, start_idx: int = 0,
                       window_time: int = 1,
                       pose_model=None) -> MotionModel:
    """Train the AR motion model over the pose columns ``start_idx`` ..
    ``start_idx + num_vars`` of a pose table (JAX ``armodel.py:158-225``):
    a CSV path (as the JAX function takes) or a
    :class:`~.dataset.PoseTable`. Each target frame is regressed on the
    ``window_size`` frames ``window_time`` apart before it.
    ``validation`` defaults to ``validation_dataset.h5`` beside a training
    path (its ``.csv`` where the ``.h5`` does not exist). Raises on non-finite coefficients.

    ``pose_model`` (a :class:`~.pca.PoseModel`): the rows of both tables
    go through ``pose_model.project`` before the windows, so the model
    lives in the (ext_dim + n_comps)-dim reduced space (reference
    ``MotionModel(pose_model=...)``, acinoset_models.py:182-257).

    With ``cache_dir`` the coefficients are stored there as
    ``lr_model_<md5>.torch.pkl``, keyed by the md5 of the training windows
    and the settings (a PCA model's windows and key differ from a
    full-space one's), and loaded from there when it exists."""
    if validation is None:
        if not isinstance(dataset, str):
            raise ValueError("a validation table is needed when the training "
                             "table is passed as arrays")
        validation = os.path.join(os.path.dirname(dataset),
                                  "validation_dataset.h5")

    def rows(src):
        tab = _table(src)
        data = tab.data[:, start_idx:start_idx + num_vars]
        if pose_model is not None:
            data = pose_model.project(data)
        return ds.windowed_dataset(data, tab.index, window_size, window_time)

    (X, y), (Xv, yv) = rows(dataset), rows(validation)
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        m = hashlib.md5()
        for a in (X, y):
            m.update(np.ascontiguousarray(a, np.float64).tobytes())
        m.update(repr((window_size, lasso, alpha, num_vars, start_idx,
                       window_time, pose_model is not None)).encode())
        cache_path = os.path.join(cache_dir,
                                  f"lr_model_{m.hexdigest()}.torch.pkl")
    if cache_path is not None and os.path.isfile(cache_path):
        with open(cache_path, "rb") as f:
            coef, intercept = pickle.load(f)
    else:
        if lasso:
            coef, intercept = fit_multitask_lasso(X, y, alpha, device=device)
        else:
            coef, intercept = fit_linear(X, y)
        if not (np.isfinite(coef).all() and np.isfinite(intercept).all()):
            raise RuntimeError("AR motion-model training produced non-finite "
                               "coefficients; refusing to return a poisoned "
                               "model")
        if cache_path is not None:
            with open(cache_path, "wb") as f:
                pickle.dump((coef, intercept), f)
    resid = y - (X @ coef.T + intercept[None])
    residv = yv - (Xv @ coef.T + intercept[None])
    return MotionModel(
        coef=coef, intercept=intercept,
        error_variance=np.var(resid, axis=0),
        train_rmse=float(np.sqrt(np.mean(resid ** 2))),
        validation_rmse=float(np.sqrt(np.mean(residv ** 2))),
        window_size=window_size, window_time=window_time, lasso=lasso)


def motion_weights(model: MotionModel) -> np.ndarray:
    """(28,) in-solver weights 1/var (0 where var == 0)."""
    w = np.zeros_like(model.error_variance)
    nz = model.error_variance != 0
    w[nz] = 1.0 / model.error_variance[nz]
    return w


def adaptive_motion_weights(model: MotionModel, y_pred: np.ndarray,
                            x_ref: np.ndarray,
                            valid: np.ndarray) -> np.ndarray:
    """(28,) empirical-Bayes anchor weights 1/(var_train + var_observed):
    each dimension's training variance inflated by the observed prediction
    error on the anchor input itself, so noisy inputs get softer anchors."""
    w = np.zeros_like(model.error_variance)
    m = valid > 0
    if m.sum() == 0:
        return motion_weights(model)
    var_obs = np.mean((y_pred[m] - x_ref[m]) ** 2, axis=0)
    tot = model.error_variance + var_obs
    nz = tot != 0
    w[nz] = 1.0 / tot[nz]
    w[model.error_variance == 0] = 0.0
    return w


def anchor_predictions(model: MotionModel, x_init: np.ndarray):
    """Fixed AR predictions from the initial trajectory x_init (N, 28).
    Returns (y_pred (N, 28), valid (N,)), y_pred[t] defined for t >= the
    window buffer."""
    w, s = model.window_size, model.window_time
    X, _ = ds.series_to_supervised(x_init, w, s)
    N = x_init.shape[0]
    buf = w * s
    y_pred = np.zeros((N, x_init.shape[1]))
    valid = np.zeros(N)
    if X.shape[0] > 0:
        y_pred[buf:] = model.predict(X)
        valid[buf:] = 1.0
    return y_pred, valid
