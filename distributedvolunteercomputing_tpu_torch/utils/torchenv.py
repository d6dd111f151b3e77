"""Device and dtype resolution for the port.

The JAX package asks the backend (``utils/jaxenv.py::tpu_backend``) and picks
bf16 compute on the accelerator, f32 elsewhere (``models/common.py``). The
port makes the same choice from the tensor's device: bf16 on CUDA, f32 on the
CPU. Entry points run on CUDA unless the caller asks for the CPU; when no card
is present and the caller did not ask, they raise instead of falling back.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def _pin_fp32_matmul() -> None:
    # f32 products stay full f32 on the card: no TF32 in matmuls or cuDNN.
    # The port's f32 paths are parity checks, and TF32 keeps ~3 digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card; ``"cpu"`` must be asked for explicitly."""
    _pin_fp32_matmul()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_compute_override: Optional[torch.dtype] = None


def compute_dtype(device: Optional[torch.device]) -> torch.dtype:
    """bf16 on the card (tensor-core rate), f32 on the CPU (exact enough to
    compare against the JAX reference)."""
    if _compute_override is not None:
        return _compute_override
    if device is not None and torch.device(device).type == "cuda":
        return torch.bfloat16
    return torch.float32


@contextlib.contextmanager
def compute_dtype_as(dtype: torch.dtype) -> Iterator[None]:
    """Compute in ``dtype`` on every device inside the block: an f32 pass on
    the card, to hold the kernels' f32 path against the plain core."""
    global _compute_override
    prev, _compute_override = _compute_override, dtype
    try:
        yield
    finally:
        _compute_override = prev
