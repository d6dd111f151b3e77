"""Shared building blocks of the port's models.

Models are plain functions over nested dicts of tensors, with the JAX
package's layout (``distributedvolunteercomputing_tpu/models/common.py``):
dense weights ``[d_in, d_out]``, block weights stacked on a leading layer
axis, params stored f32. Compute runs in bf16 on the card and f32 on the CPU
(``utils.torchenv.compute_dtype``), chosen from the device of the tensors.

Every ``init`` takes ``dtype``, the params' storage dtype (None: f32), and
casts each leaf as it is made, one stacked layer at a time: a bf16 model
never exists whole in f32 (Llama-2-7B would be 27 GB of it).

Under a mesh (``parallel/train_step.py``) the sharded step hands each dp
group a view of the params in which a tensor-parallel leaf is a ``Slices``
(one part per rank of the group, on that rank's device) and a stacked leaf
is a ``Stack`` that gathers one layer at a time. The view is the context the
building blocks below consult: on plain tensors they are the one-device
ops, on ``Slices`` the Megatron split (``col_dense`` per rank's output
columns, ``row_dense`` per rank's input rows with the partial sums added in
rank order on the group's leader, ``head_attention`` per rank's head
group). Cross-rank moves are ``.to(device)`` inside one autograd graph, so
ranks may share a card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

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


# -- tensor parallelism: the leaves and activations of one dp group ----------


class Slices:
    """A sharded leaf as one dp group's ranks hold it: ``parts[j]`` on
    ``devices[j]`` for the group rank ``ranks[j]`` = (ep, tp) coordinates, in
    rank order. ``dims`` names the part's dim split over each axis (None: not
    split), ``sizes`` the axis sizes; ``leader`` is the group's first rank,
    where replicated work and row-parallel sums land."""

    def __init__(self, parts, devices, ranks, dims, sizes, leader):
        self.parts, self.devices, self.ranks = list(parts), list(devices), list(ranks)
        self.dims, self.sizes, self.leader = dims, sizes, leader

    def detach(self) -> "Slices":
        return Slices([p.detach() for p in self.parts], self.devices, self.ranks, self.dims, self.sizes, self.leader)

    def full(self) -> torch.Tensor:
        """The group's whole leaf on the leader (differentiable)."""
        grid: Dict[int, list] = {}
        for (e, _), p in zip(self.ranks, self.parts):
            grid.setdefault(e, []).append(p.to(self.leader))
        rows = [torch.cat(ps, self.dims["tp"]) if self.dims["tp"] is not None else ps[0] for ps in grid.values()]
        return torch.cat(rows, self.dims["ep"]) if self.dims["ep"] is not None else rows[0]


class Stack:
    """A stacked leaf of a dp group's view whose layers are made on demand:
    ``stack[i]`` is layer i as a tensor on the leader or a ``Slices``,
    gathered over dp when the leaf is dp-sharded (FSDP). ``layer`` indexes it
    inside the checkpointed body, so one layer's gathered copy lives at a
    time and the recompute gathers it again."""

    def __init__(self, make, shape, detached: bool = False):
        self._make, self.shape, self._detached = make, torch.Size(shape), detached

    def __getitem__(self, i: int):
        out = self._make(i)
        return out.detach() if self._detached else out

    def detach(self) -> "Stack":
        return Stack(self._make, self.shape, True)


class Parts:
    """An activation split over a dp group's tp ranks: ``parts[j]`` on
    ``devices[j]`` (a column-parallel output, or a head group's attention)."""

    def __init__(self, parts, devices, leader):
        self.parts, self.devices, self.leader = list(parts), list(devices), leader


def full(x: Any) -> Any:
    """A ``Slices`` leaf or ``Parts`` activation whole on the group's leader
    (column parts concatenate in rank order); anything else as it is."""
    if isinstance(x, Slices):
        return x.full()
    if isinstance(x, Parts):
        return torch.cat([p.to(x.leader) for p in x.parts], dim=-1)
    return x


def tp_map(fn: Callable[..., torch.Tensor], *xs: Any) -> Any:
    """``fn`` per rank over ``Parts`` (all of ``xs`` split alike), or once."""
    if not any(isinstance(x, Parts) for x in xs):
        return fn(*xs)
    xs = [x if isinstance(x, Parts) else None for x in xs]
    if any(x is None for x in xs):
        raise ValueError("tp_map over Parts and a whole tensor")
    ref = xs[0]
    return Parts([fn(*ps) for ps in zip(*(x.parts for x in xs))], ref.devices, ref.leader)


def col_matmul(x: torch.Tensor, w: Any) -> Any:
    """x [..., d_in] @ w [d_in, d_out]: per rank on its output columns when
    ``w`` is split, else one product. ``x`` is in the compute dtype."""
    if not isinstance(w, Slices):
        return torch.matmul(x, w.to(x.dtype))
    return Parts([torch.matmul(x.to(d), p.to(x.dtype)) for p, d in zip(w.parts, w.devices)], w.devices, w.leader)


def col_dense(p: Params, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> Any:
    """Column-parallel dense: each tp rank multiplies by its own output-column
    slice of ``w`` and adds its slice of ``b``."""
    if not isinstance(p["w"], Slices):
        return dense(p, x, dtype)
    dtype = dtype or compute_dtype(x.device)
    y = col_matmul(x.to(dtype), p["w"])
    b = p["b"]
    if isinstance(b, Slices):
        return Parts([yj + bj.to(dtype) for yj, bj in zip(y.parts, b.parts)], y.devices, y.leader)
    width = y.parts[0].shape[-1]
    return Parts([yj + b[j * width:(j + 1) * width].to(yj.device, dtype) for j, yj in enumerate(y.parts)],
                 y.devices, y.leader)


def row_matmul(x: Any, w: Any) -> torch.Tensor:
    """x [..., d_in] @ w [d_in, d_out] for a row-split ``w``: each rank
    multiplies its input slice (its ``Parts`` entry, or its feature block of
    a whole ``x``) by its row slice, and the partial sums are added in rank
    order on the group's leader. A replicated ``w`` takes ``x`` whole."""
    if not isinstance(w, Slices):
        x = full(x)
        return torch.matmul(x, w.to(x.dtype))
    if isinstance(x, Parts):
        xs = x.parts
    else:
        blk = x.shape[-1] // len(w.parts)
        xs = [x[..., j * blk:(j + 1) * blk] for j in range(len(w.parts))]
    out = None
    for xj, wj, dev in zip(xs, w.parts, w.devices):
        xj = xj.to(dev)
        part = torch.matmul(xj, wj.to(xj.dtype)).to(w.leader)
        out = part if out is None else out + part
    return out


def row_dense(p: Params, x: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row-parallel dense; the replicated bias is added once, after the sum."""
    dev = x.leader if isinstance(x, Parts) else x.device
    dtype = dtype or compute_dtype(dev)
    return row_matmul(tp_map(lambda t: t.to(dtype), x), p["w"]) + p["b"].to(dev, dtype)


def _columns(x: Parts, start: int, width: int, device: torch.device) -> torch.Tensor:
    """Columns [start, start + width) of a column-split activation, on
    ``device``, gathered from the parts that hold them."""
    c = x.parts[0].shape[-1]
    pieces = []
    while width > 0:
        j, off = divmod(start, c)
        n = min(width, c - off)
        pieces.append(x.parts[j][..., off:off + n].to(device))
        start, width = start + n, width - n
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=-1)


def head_attention(qkv: Any, d_model: int, n_heads: int, causal: bool = False) -> Any:
    """Multi-head attention of a fused ``[q | k | v]`` projection. Split over
    tp its columns are contiguous, so rank 0 may hold all of q and part of k:
    each rank gathers its head group's q, k and v columns (H/tp heads) and
    attends over them, and its output is the row slice of the output
    projection that it multiplies. A head count tp does not divide is
    attended whole on the group's leader."""
    from distributedvolunteercomputing_tpu_torch.ops.attention import multi_head_attention

    if not isinstance(qkv, Parts):
        q, k, v = qkv.split(d_model, dim=-1)
        return multi_head_attention(q, k, v, n_heads, causal=causal)
    tp = len(qkv.parts)
    if n_heads % tp:
        q, k, v = full(qkv).split(d_model, dim=-1)
        return multi_head_attention(q, k, v, n_heads, causal=causal)
    width = d_model // tp
    outs = []
    for r, dev in enumerate(qkv.devices):
        q, k, v = (_columns(qkv, s * d_model + r * width, width, dev) for s in range(3))
        outs.append(multi_head_attention(q, k, v, n_heads // tp, causal=causal))
    return Parts(outs, qkv.devices, qkv.leader)


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
    nll = _token_nll(logits, labels)
    if mask is not None:
        total, count = _nll_sums(nll, mask)
        return total / torch.clamp(count, min=1.0)
    return nll.mean()


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy, in f32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def _nll_sums(nll: torch.Tensor, mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the (masked) nll, the token count)."""
    if mask is None:
        return nll.sum(), nll.new_tensor(float(nll.numel()))
    mask = mask.float()
    return (nll * mask).sum(), mask.sum()


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


def layer(blocks: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views; gradients flow to the stack), or
    of each tree of a list (one per dp group)."""
    if isinstance(blocks, list):
        return [layer(b, i) for b in blocks]
    return tree_map(lambda x: x[i], blocks)


def _run_layer(body, blocks: Any, i: int, x: Any) -> Any:
    return body(layer(blocks, i), x)


def scan_blocks(body, blocks: Any, x: Any, remat: bool = True) -> Any:
    """Run ``x`` through the stacked ``blocks`` in order; ``body`` is
    ``(layer_params, x) -> x``. With ``remat`` each layer is checkpointed and
    recomputed in backward, keeping one layer's activations alive, as the
    reference's ``jax.checkpoint`` per scan step does. The carry ``x`` may be
    a tuple (MoE's ``(x, aux)``), and ``blocks`` a list of trees whose layer
    ``i`` the body gets as a list."""
    n = int(tree_leaves(blocks[0] if isinstance(blocks, list) else blocks)[0].shape[0])
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
    return _token_nll(project_vocab(xc, head, head_layout), lc)


def lm_xent_chunked(
    x: torch.Tensor,
    head: torch.Tensor,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 128,
    head_layout: str = "vd",
    sums: bool = False,
) -> Any:
    """Mean LM cross-entropy WITHOUT building the [B, T, V] f32 logits.

    Loops over T in ``chunk``-sized slices, each checkpointed, so peak memory
    is one [B, chunk, V] buffer and backward recomputes each chunk's logits.
    ``head`` is [V, d] (``"vd"``, tied embeddings) or [d, V] (``"dv"``).
    ``sums``: return (sum of the (masked) nll, the token count) instead, for
    a mean over several dp groups' shares.
    """
    t = x.shape[1]
    if t % chunk != 0:
        chunk = t  # tiny configs: single chunk, same math
    n = t // chunk
    if n <= 1:
        nll_sum, denom = _nll_sums(_token_nll(project_vocab(x, head, head_layout), labels), mask)
    else:
        nll_sum = denom = 0.0
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            nll = checkpoint(_chunk_nll, x[:, sl], labels[:, sl], head, head_layout, use_reentrant=False)
            s, c = _nll_sums(nll, None if mask is None else mask[:, sl])
            nll_sum, denom = nll_sum + s, denom + c
    if sums:
        return nll_sum, denom
    return nll_sum / torch.clamp(denom, min=1.0)


class CoupledLoss:
    """A model's ``loss_fn(params, batch, rng, cfg)`` bound to its config and
    marked ``dp_coupled``: the sharded step calls it ONCE with lists (one
    view and one batch share per dp group), because its result is not the
    mean of per-group losses (BERT's masked mean, MoE's global capacity and
    aux loss). Called with one tree and one batch it is the plain loss."""

    dp_coupled = True

    def __init__(self, fn: Callable[..., Any], cfg: Any):
        self.fn, self.cfg = fn, cfg

    def __call__(self, params: Any, batch: Any, rng: torch.Generator):
        return self.fn(params, batch, rng, self.cfg)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(-1) == labels).float().mean()


def count_params(params: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(params))
