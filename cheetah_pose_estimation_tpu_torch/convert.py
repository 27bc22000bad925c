"""Carry a JAX-package problem across into the port.

The port's ``KinematicData`` / ``CameraSet`` / ``GMMPrior`` / ``ARAnchor``
have the JAX package's fields in the same order, so a problem built by the
JAX package converts leaf by leaf: each leaf is taken as ``np.asarray(leaf)``
(nothing of JAX is imported here) and becomes a tensor on ``device``.
Tests use this to make both packages solve byte-identical problems.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .solver import kinematic as kin
from .utils.device import DeviceLike, resolve_device

_TYPES = {"KinematicData": kin.KinematicData, "CameraSet": kin.CameraSet,
          "GMMPrior": kin.GMMPrior, "ARAnchor": kin.ARAnchor}


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
