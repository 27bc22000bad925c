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

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


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
