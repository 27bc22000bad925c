"""Carry a JAX-package problem and its trained priors across into the port.

The port's ``KinematicData`` / ``CameraSet`` / ``GMMPrior`` / ``ARAnchor``
/ ``KineticData`` have the JAX package's fields in the same order, so a
problem built by the JAX package converts leaf by leaf: each leaf is taken
as ``np.asarray(leaf)`` (nothing of JAX is imported here) and becomes a
tensor on ``device``.
Tests use this to make both packages solve byte-identical problems. The
trained priors (``GMMParams``, the solver's ``GMMPrior``, ``MotionModel``)
are this system's weights and carry across the same way.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .priors import armodel, gmm
from .solver import kinematic as kin
from .solver import kinetic as kn
from .utils.device import DeviceLike, resolve_device

_TYPES = {"KinematicData": kin.KinematicData, "CameraSet": kin.CameraSet,
          "GMMPrior": kin.GMMPrior, "ARAnchor": kin.ARAnchor,
          "KineticData": kn.KineticData}


def _convert(x, fn):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = _TYPES[type(x).__name__]
        if cls._fields != x._fields:
            raise TypeError(f"{type(x).__name__} fields differ: "
                            f"{x._fields} vs {cls._fields}")
        return cls(*[_convert(v, fn) for v in x])
    return fn(x)


def kinematic_problem(data, q0, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float64,
                      batched: bool = False
                      ) -> Tuple[kin.KinematicData, torch.Tensor]:
    """JAX ``KinematicData`` (any array leaves) and q0 -> port tensors.

    ``batched=False`` takes one trial and adds the leading trial axis;
    ``batched=True`` takes leaves that already carry it (e.g. the output of
    the JAX ``pad_and_stack``)."""
    dev = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        if not batched:
            a = a[None]
        return torch.as_tensor(a, dtype=dtype, device=dev)

    return _convert(data, leaf), leaf(q0)


def kinetic_problem(data, q0, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float64,
                    batched: bool = False
                    ) -> Tuple[kn.KineticData, torch.Tensor]:
    """JAX ``KineticData`` (any array leaves, its kinematic base included)
    and q0 -> port tensors, as :func:`kinematic_problem` (``batched``: the
    leaves already carry the trial axis, e.g. the output of the JAX
    ``pad_and_stack_kinetic``)."""
    return kinematic_problem(data, q0, device=device, dtype=dtype,
                             batched=batched)


def gmm_params(params, device: DeviceLike = None) -> gmm.GMMParams:
    """JAX ``GMMParams`` (weights, means, covs) -> port float64 tensors."""
    dev = resolve_device(device)
    return gmm.GMMParams(*[torch.tensor(np.asarray(x), dtype=torch.float64,
                                        device=dev) for x in params])


def gmm_prior(prior, B: int, device: DeviceLike = None,
              dtype: torch.dtype = torch.float32) -> kin.GMMPrior:
    """A solver ``GMMPrior`` with array leaves and no trial axis (the JAX
    package's or the port's ``to_solver_prior``) -> tensors broadcast to B
    trials: means (B, K, 22), prec (B, K, 22, 22), log_norm (B, K)."""
    dev = resolve_device(device)
    return kin.GMMPrior(*[torch.as_tensor(np.asarray(x), dtype=dtype,
                                          device=dev).expand(
        (B,) + np.shape(x)).contiguous() for x in prior])


def motion_model(mm) -> armodel.MotionModel:
    """JAX ``MotionModel`` -> the port's (numpy fields, same names)."""
    return armodel.MotionModel(**{
        f: getattr(mm, f) for f in armodel.MotionModel.__dataclass_fields__})
