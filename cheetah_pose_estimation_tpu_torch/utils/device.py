"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument and resolves it here. The card
is the default: ``None`` is the current CUDA device, and the CPU is used only
when asked for with ``device="cpu"``. Float32 products run at full
precision: the JAX package forces ``Precision.HIGHEST`` on the whole solver
path (``solver/kinematic.py:818``, ``ops/banded.py:86``) because
reduced-precision products broke its factorizations; on the card the
counterpart of that fault is TF32, so resolving a CUDA device switches TF32
off for matmuls and cuDNN.
"""
from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Hashable, Optional, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

# torch's forward-mode AD levels (``torch.func.jvp``, ``jacfwd``) are
# process-wide: two threads inside them at once delete each other's level.
# The trial mesh (``parallel/batch.on_mesh``) solves its shards on host
# threads, so every forward-mode section holds this lock.
FORWARD_AD = threading.RLock()


def full_precision() -> None:
    """Disable TF32 for float32 matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises when no GPU is visible;
    never falls back to the CPU); otherwise the named device. A CUDA device
    must exist and gets full-precision float32."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        full_precision()
    return dev


def require_cuda() -> torch.device:
    """The current CUDA device; raises when no GPU is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port runs on a CUDA device by default, but "
                           "torch.cuda.is_available() is False; pass "
                           "device=\"cpu\" to run on the CPU")
    full_precision()
    return torch.device("cuda", torch.cuda.current_device())


class Tables:
    """Constant tables of one owner (a subject, a solver instance, or the
    modules' own constants below), each made once and kept as long as the
    owner. On the card every ``torch.as_tensor`` of a host array, and every
    index array, is a copy from pageable memory that waits for the stream to
    drain, so the solvers' per-call constants come from here. ``name`` tells
    the owner's tables apart; what a table is made from belongs to its
    owner, so a name never has to spell it out."""

    def __init__(self):
        self._host: Dict[Hashable, object] = {}
        self._tensors: Dict[tuple, torch.Tensor] = {}

    def host(self, name: Hashable, make: Callable):
        """``make()`` (a host array), made once."""
        if name not in self._host:
            self._host[name] = make()
        return self._host[name]

    def get(self, name: Hashable, like: torch.Tensor, make: Callable,
            dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The host array ``make()`` as a tensor on ``like``'s device, of
        ``dtype`` (default: ``like``'s), made once per (dtype, device)."""
        dtype = like.dtype if dtype is None else dtype
        k = (name, dtype, like.device)
        t = self._tensors.get(k)
        if t is None:
            # a copy, never a view of the (possibly read-only) host array
            t = self._tensors[k] = torch.tensor(np.asarray(make()),
                                                dtype=dtype,
                                                device=like.device)
        return t


_MODULE_TABLES = Tables()
_OWNED: Dict[int, Tables] = {}


def tables_of(owner) -> Tables:
    """The :class:`Tables` of ``owner`` (a subject), made on first use and
    dropped with it. Any object that takes a weak reference will do, so the
    owner's class needs no field for it."""
    key = id(owner)
    t = _OWNED.get(key)
    if t is None:
        t = _OWNED[key] = Tables()
        weakref.finalize(owner, _OWNED.pop, key, None)
    return t


def constant(name: str, like: torch.Tensor, make: Callable,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A module-level constant (one that depends on nothing but its name) as
    a tensor like ``like``; see :class:`Tables`."""
    return _MODULE_TABLES.get(name, like, make, dtype)
