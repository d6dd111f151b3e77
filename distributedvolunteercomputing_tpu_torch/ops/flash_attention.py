"""Flash attention: hand-written CUDA kernels (forward, dq, dk/dv) and their
plain PyTorch versions.

Replaces ``distributedvolunteercomputing_tpu/ops/pallas_attention.py``:

=====  ============================  =====================================
kernel TPU kernel it replaces         wrapper / plain version
=====  ============================  =====================================
K1     ``_fwd_kernel``               ``flash_fwd`` / ``flash_fwd_plain``
K2     ``_bwd_dq_kernel``            ``flash_dq`` / ``flash_dq_plain``
K3     ``_bwd_dkv_kernel``           ``flash_dkv`` / ``flash_dkv_plain``
=====  ============================  =====================================

The kernels live in ``csrc/flash_attention.cu``. bf16 K1, K2 and K3 are
Hopper kernels: a producer feeds a ring of K/V (K1, K2) or Q/dO (K3) tiles
through TMA tensor maps that read the caller's strided views in place, and
consumer warpgroups run ``wgmma`` with their accumulators (O, m, l; dQ; dK,
dV) in registers for the whole loop. K1-K3 in f32 (the f32 parity passes)
keep the first design: one block per 64-row tile, scalar products from
shared memory. On an H100 at the flagship shape (B 8, H 12, T 1024, D 64,
bf16, causal) K1 is bound by its bytes (~15 us) and K2/K3 by tensor-core
operations (~20/26 us); PERF.md section 6 has the measured times beside
those bounds (``chip_smoke.py``'s kernels phase). A wrapper
given CPU tensors computes the plain version; given CUDA tensors it launches
its kernel or raises — there is no fallback. ``LAUNCHES`` counts kernel
launches, one per wrapper call that reached the card.

Semantics are the reference's: scale 1/sqrt(D), causal masking top-left
aligned, masked scores set to -1e30 (not -inf), softmax statistics and
accumulation in f32, and P / dS rounded to the input dtype before their
products when the inputs are bf16. The plain versions build the whole
[B, H, Tq, Tk] f32 score matrix; they are references, not a fast path.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

NEG_INF = -1e30
SUPPORTED_D = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain versions (f32 math, the kernels' rounding points)
# ---------------------------------------------------------------------------


def _round_like(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round an f32 intermediate to the input dtype for the next product —
    only when the inputs are sub-f32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled f32 scores [B, H, Tq, Tk], masked to -1e30 (top-left causal)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        tq, tk = s.shape[-2:]
        row = torch.arange(tq, device=s.device)[:, None]
        col = torch.arange(tk, device=s.device)[None, :]
        s = s.masked_fill(col > row, NEG_INF)
    return s


def flash_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O in the input dtype, per-row logsumexp [B, H, Tq] in f32)."""
    s = _scores(q, k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(_round_like(p, v.dtype), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_dq_plain(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    return (torch.matmul(_round_like(ds, k.dtype), k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, causal) - lse[..., None])
    dv = torch.matmul(_round_like(p, v.dtype).transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None])
    dk = torch.matmul(_round_like(ds, q.dtype).transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


_TMA_STRIDE_LIMIT = 1 << 40  # bytes: cuTensorMapEncodeTiled refuses larger strides


def _aligned(x: torch.Tensor) -> bool:
    """Rows the kernels can read 16 bytes at a time, and the TMA tensor maps
    can describe: contiguous last dim, 16-byte aligned base, (batch, head,
    time) strides in multiples of 16 bytes and below 2**40 bytes."""
    vec = 16 // x.element_size()
    return (
        x.stride(-1) == 1
        and x.data_ptr() % 16 == 0
        and all(s % vec == 0 and s * x.element_size() < _TMA_STRIDE_LIMIT for s in x.stride()[:-1])
    )


def kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels can read it in place (the head-split view
    of the fused qkv projection can), else a contiguous copy."""
    if x.device.type != "cuda" or _aligned(x):
        return x
    return x.contiguous()


def _check(name: str, q: torch.Tensor, *rest: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected CUDA or CPU tensors, got {q.device}")
    check_layout(name, q, *rest)


def check_layout(name: str, q: torch.Tensor, *rest: torch.Tensor) -> None:
    """Raise unless the kernels take these inputs: dtype, [B, H, T, D] shapes
    and strides the tensor maps can read in place (on any device, so the
    rule is testable without a card)."""
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 4 or q.shape[-1] not in SUPPORTED_D:
        raise ValueError(f"{name}: expected [B, H, T, D] with D in {SUPPORTED_D}, got {tuple(q.shape)}")
    b, h, tq, d = q.shape
    if min(b, h, tq) < 1 or max(b, h) > 65535:
        raise ValueError(f"{name}: unsupported shape {tuple(q.shape)}")
    for x in (q, *rest):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name}: all inputs must share {q.device} / {q.dtype}")
        if x.dim() != 4 or x.shape[:2] != q.shape[:2] or x.shape[-1] != d or x.shape[2] < 1:
            raise ValueError(f"{name}: shape {tuple(x.shape)} does not match q {tuple(q.shape)}")
        if not _aligned(x):
            raise ValueError(
                f"{name}: layout not readable in place (strides {x.stride()}); "
                "pass kernel_layout(x)"
            )


def _stats(name: str, q: torch.Tensor, *stats: torch.Tensor) -> None:
    for x in stats:
        if x.dtype != torch.float32 or x.shape != q.shape[:3] or not x.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous f32 {tuple(q.shape[:3])}")
        if x.device != q.device:
            raise ValueError(f"{name}: lse/delta on {x.device}, inputs on {q.device}")


def _strides(x: torch.Tensor) -> Tuple[int, int, int]:
    return x.stride(0), x.stride(1), x.stride(2)


def _like_bthd(x: torch.Tensor, t: int) -> torch.Tensor:
    """An empty [B, H, t, D] tensor laid out as [B, t, H, D], so merge_heads
    (and the qkv split's gradient) read it without a copy."""
    b, h, _, d = x.shape
    return torch.empty((b, t, h, d), dtype=x.dtype, device=x.device).transpose(1, 2)


def _launch(name: str, q: torch.Tensor, *args) -> None:
    from distributedvolunteercomputing_tpu_torch.ops import _build

    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"dvc_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.dvc_error_string(err).decode()}")
    LAUNCHES[name] += 1


def flash_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1. (O [B, H, Tq, D] in the input dtype, lse [B, H, Tq] f32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal)
    _check("flash_fwd", q, k, v)
    if k.shape != v.shape:
        raise ValueError(f"flash_fwd: k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, h, tq, d = q.shape
    tk = k.shape[2]
    o = _like_bthd(q, tq)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", q, _DTYPE_CODE[q.dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), *_strides(o),
        b, h, tq, tk, 1.0 / math.sqrt(d), int(causal),
    )
    return o, lse


def flash_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """K2. dq [B, H, Tq, D] in the input dtype."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, do, lse, delta, causal)
    _check("flash_dq", q, k, v, do)
    _stats("flash_dq", q, lse, delta)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dq = _like_bthd(q, tq)
    _launch(
        "flash_dq", q, _DTYPE_CODE[q.dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dq),
        b, h, tq, tk, 1.0 / math.sqrt(d), int(causal),
    )
    return dq


def flash_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3. (dk, dv) [B, H, Tk, D] in the input dtype."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, do, lse, delta, causal)
    _check("flash_dkv", q, k, v, do)
    _stats("flash_dkv", q, lse, delta)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    dk, dv = _like_bthd(k, tk), _like_bthd(v, tk)
    _launch(
        "flash_dkv", q, _DTYPE_CODE[q.dtype], d,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_strides(q), *_strides(k), *_strides(v), *_strides(do), *_strides(dk), *_strides(dv),
        b, h, tq, tk, 1.0 / math.sqrt(d), int(causal),
    )
    return dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is K1 and whose backward is K2 + K3.

    Saves (q, k, v, o, lse), the reference's residuals
    (pallas_attention.py ``_fa_fwd``). delta = rowsum(dO * O) is plain f32
    torch, computed outside the kernels as the reference does."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        q, k, v = kernel_layout(q), kernel_layout(k), kernel_layout(v)
        o, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = kernel_layout(do)
        delta = (do.float() * o.float()).sum(-1)
        dq = flash_dq(q, k, v, do, lse, delta, ctx.causal)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False
) -> torch.Tensor:
    """Drop-in for ``attention_core`` without an additive mask; causal is
    top-left aligned (the router sends only square causal shapes here)."""
    return FlashAttention.apply(q, k, v, causal)
