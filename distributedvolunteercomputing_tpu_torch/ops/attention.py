"""Attention ops for the transformer models: the plain core and the router
that sends eligible shapes to the flash kernels (ops/flash_attention.py).

Mirrors ``distributedvolunteercomputing_tpu/ops/attention.py``. The impl names
are the reference's: ``"xla"`` is the plain PyTorch core, ``"flash"`` forces
the flash path (its plain version on the CPU), ``"auto"`` sends every eligible
shape on the card to the kernels. ``set_attention_impl`` is the only switch:
no environment variable can take the main path off the kernels.

The reference's auto thresholds (``_AUTO_FLASH_MIN_T_*``) were measured on a
TPU and are not carried over; the ``DVC_FLASH_BLOCK_Q/K`` knobs tune TPU
sublane tiling and are not read here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from distributedvolunteercomputing_tpu_torch.ops.flash_attention import (
    SUPPORTED_D,
    flash_attention,
)

_IMPLS = ("auto", "xla", "flash")
_impl = "auto"


def set_attention_impl(name: str) -> None:
    """Select the attention core for subsequent calls."""
    global _impl
    if name not in _IMPLS:
        raise ValueError(f"unknown attention impl {name!r}")
    _impl = name


def _route_to_flash(q: torch.Tensor, k: torch.Tensor, causal: bool, mask) -> bool:
    if mask is not None:  # the flash path has no additive-mask support
        return False
    if causal and q.shape[-2] != k.shape[-2]:
        # Flash is top-left aligned, the plain core bottom-right aligned for
        # Tq != Tk: only the square case agrees.
        return False
    if _impl == "flash":
        return True
    return (
        _impl == "auto"
        and q.device.type == "cuda"
        and q.dtype in (torch.float32, torch.bfloat16)
        and q.shape[-1] in SUPPORTED_D
    )


def attention_core_local(
    q: torch.Tensor,  # [B, H, Tq, D]
    k: torch.Tensor,  # [B, H, Tk, D]
    v: torch.Tensor,  # [B, H, Tk, D]
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,  # [B, 1|H, Tq, Tk] bool, True = attend
) -> torch.Tensor:
    """The single-device core: flash kernels or the plain core."""
    if _route_to_flash(q, k, causal, mask):
        return flash_attention(q, k, v, causal)
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        tq, tk = logits.shape[-2:]
        keep = torch.ones((tq, tk), dtype=torch.bool, device=q.device).tril(tk - tq)
        logits = torch.where(keep, logits, -1e30)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# Sequence-parallel routing (ring / Ulysses) arrives with the parallel slice;
# until then the core is the single-device one.
attention_core = attention_core_local


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B, T, H*D] -> [B, H, T, D] as a view (no copy)."""
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def multi_head_attention(
    q: torch.Tensor,  # [B, T, d_model] (already projected)
    k: torch.Tensor,
    v: torch.Tensor,
    n_heads: int,
    causal: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    out = attention_core(
        split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads),
        causal=causal, mask=mask,
    )
    return merge_heads(out)


def rope(x: torch.Tensor, positions: Optional[torch.Tensor] = None, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the last dim of ``x`` [B, H, T, D], in
    f32. The rotated pairs are the interleaved lanes ``(x[..., 2i],
    x[..., 2i + 1])``, as the reference pairs them (not the rotate-half
    convention)."""
    d, t = x.shape[-1], x.shape[-2]
    if positions is None:
        positions = torch.arange(t, device=x.device)
    freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    angles = positions[:, None].float() * freqs[None, :]  # [T, D/2]
    cos, sin = angles.cos(), angles.sin()
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
