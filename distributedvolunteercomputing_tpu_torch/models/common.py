"""Shared building blocks of the port's models.

Models are plain functions over nested dicts of tensors, with the JAX
package's layout (``distributedvolunteercomputing_tpu/models/common.py``):
dense weights ``[d_in, d_out]``, block weights stacked on a leading layer
axis, params stored f32. Compute runs in bf16 on the card and f32 on the CPU
(``utils.torchenv.compute_dtype``), chosen from the device of the tensors.

Every ``init`` takes ``dtype``, the params' storage dtype (None: f32), and
casts each leaf as it is made, one stacked layer at a time: a bf16 model
never exists whole in f32 (Llama-2-7B would be 27 GB of it).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributedvolunteercomputing_tpu_torch.utils.pytree import (
    cast_floating,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from distributedvolunteercomputing_tpu_torch.utils.torchenv import compute_dtype

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32) * scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int, scale: Optional[float] = None) -> Params:
    if scale is None:
        scale = 1.0 / (d_in ** 0.5)
    return {
        "w": _normal(gen, (d_in, d_out), scale),
        "b": torch.zeros((d_out,), dtype=torch.float32, device=gen.device),
    }


def dense(p: Params, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    dtype = dtype or compute_dtype(x.device)
    return torch.matmul(x.to(dtype), p["w"].to(dtype)) + p["b"].to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, scale: float = 0.02) -> torch.Tensor:
    return _normal(gen, (vocab, d), scale)


def layernorm_init(d: int, device: torch.device) -> Params:
    return {
        "g": torch.ones((d,), dtype=torch.float32, device=device),
        "b": torch.zeros((d,), dtype=torch.float32, device=device),
    }


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    # Statistics in f32 even when activations are bf16; population variance
    # (jnp.var), output cast back to the input dtype.
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"] + p["b"]).to(x.dtype)


def rmsnorm_init(d: int, device: torch.device) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * p["g"]).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def softmax_xent(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean cross-entropy; ``labels`` are int ids; optional 0/1 mask."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def cast(tree: Any, dtype: Optional[torch.dtype]) -> Any:
    """Every floating leaf of ``tree`` in ``dtype`` (None: unchanged)."""
    return tree if dtype is None else cast_floating(tree, dtype)


def stacked_init(
    layer_init: Callable[[torch.Generator], Params],
    gen: torch.Generator,
    n_layers: int,
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """``n_layers`` identical layers as ONE tree stacked on a leading axis.

    Each layer is drawn in f32 and written into the stack in ``dtype``, so
    the f32 transient is one layer, not the stack."""
    first = cast(layer_init(gen), dtype)
    leaves, treedef = tree_flatten(first)
    stacks = [torch.empty((n_layers,) + tuple(x.shape), dtype=x.dtype, device=x.device) for x in leaves]
    for i in range(n_layers):
        layer_leaves = leaves if i == 0 else tree_leaves(cast(layer_init(gen), dtype))
        for stack, x in zip(stacks, layer_leaves):
            stack[i].copy_(x)
    return tree_unflatten(treedef, stacks)


def layer(blocks: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views; gradients flow to the stack)."""
    return tree_map(lambda x: x[i], blocks)


def _run_layer(body, blocks: Params, i: int, x: torch.Tensor) -> torch.Tensor:
    return body(layer(blocks, i), x)


def scan_blocks(body, blocks: Params, x: torch.Tensor, remat: bool = True) -> torch.Tensor:
    """Run ``x`` through the stacked ``blocks`` in order; ``body`` is
    ``(layer_params, x) -> x``. With ``remat`` each layer is checkpointed and
    recomputed in backward, keeping one layer's activations alive, as the
    reference's ``jax.checkpoint`` per scan step does."""
    n = int(tree_leaves(blocks)[0].shape[0])
    for i in range(n):
        if remat:
            x = checkpoint(_run_layer, body, blocks, i, x, use_reentrant=False)
        else:
            x = _run_layer(body, blocks, i, x)
    return x


class _ProjectF32(torch.autograd.Function):
    """x [N, d] . W -> f32 logits with f32 accumulation from operands in the
    compute dtype: the reference's ``einsum(..., preferred_element_type=f32)``.

    A bf16 ``torch.matmul`` would round the logits to bf16. On the card the
    forward is ``torch.mm(..., out_dtype=torch.float32)`` (bf16 operands, f32
    accumulate, f32 result); that op has no autograd formula, so the backward
    is written here: the f32 cotangent is rounded to the operand dtype, as
    JAX's transpose returns cotangents in the operand dtype. In f32 both
    directions are plain f32 products."""

    @staticmethod
    def forward(ctx, x, w):  # w: [d, V]
        ctx.save_for_backward(x, w)
        if x.dtype == torch.float32:
            return torch.mm(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        # A frozen head (LoRA's base) needs no [d, V] weight product.
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        dw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return dx, dw


def project_vocab(x: torch.Tensor, head: torch.Tensor, head_layout: str) -> torch.Tensor:
    w = head.to(x.dtype)
    w = w.t() if head_layout == "vd" else w
    lead = x.shape[:-1]
    return _ProjectF32.apply(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[-1])


def _chunk_nll(xc, lc, head, head_layout):
    logits = project_vocab(xc, head, head_layout)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None].long())[..., 0]
    return logz - gold


def lm_xent_chunked(
    x: torch.Tensor,
    head: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 128,
    head_layout: str = "vd",
) -> torch.Tensor:
    """Mean LM cross-entropy WITHOUT building the [B, T, V] f32 logits.

    Loops over T in ``chunk``-sized slices, each checkpointed, so peak memory
    is one [B, chunk, V] buffer and backward recomputes each chunk's logits.
    ``head`` is [V, d] (``"vd"``, tied embeddings) or [d, V] (``"dv"``).
    """
    t = x.shape[1]
    if t % chunk != 0:
        chunk = t  # tiny configs: single chunk, same math
    n = t // chunk
    if n <= 1:
        return softmax_xent(project_vocab(x, head, head_layout), labels, mask)
    nll_sum = x.new_zeros((), dtype=torch.float32)
    denom = x.new_zeros((), dtype=torch.float32)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        nll = checkpoint(_chunk_nll, x[:, sl], labels[:, sl], head, head_layout, use_reentrant=False)
        if mask is not None:
            mc = mask[:, sl].float()
            nll_sum = nll_sum + (nll * mc).sum()
            denom = denom + mc.sum()
        else:
            nll_sum = nll_sum + nll.sum()
            denom = denom + nll.numel()
    return nll_sum / torch.clamp(denom, min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
