"""Mixture-of-Experts FFN (Switch top-1 / GShard top-2 routing) and
GPT-2-MoE (ported from ``distributedvolunteercomputing_tpu/models/moe.py``).

Routing (``router_top_k``; 1 = Switch Transformer, 2 = GShard top-2):
- router logits [S, E] in f32 -> softmax gates; each token goes to its top-k
  experts (ties to the lower index, as ``jax.lax.top_k``), its output scaled
  by the gate(s) (renormalized over the chosen experts for k > 1; the raw
  gate for k = 1);
- static capacity C = ceil(capacity_factor * router_top_k * S / E) per
  expert; choice i's tokens queue after every earlier choice's, and tokens
  past an expert's capacity are dropped for the FFN (their residual passes);
- load-balancing aux loss (Switch eq. 4): E * sum_e(frac_e * mean_gate_e),
  frac over each token's first choice.

Dispatch and combine are the reference's dense one-hot einsums; the one-hot
``[S, E, C]`` tensors are built by a scatter in the compute dtype (an int64
``one_hot`` of that shape is 671 MB per layer per choice at full width).

Under a mesh (``parallel/train_step.py``) the step calls the loss ONCE for
all dp groups (``common.CoupledLoss``): params and batch are lists with one
entry per dp group. Capacity, queue order and the aux loss's means are over
the GLOBAL batch, as the reference's GSPMD step keeps them: a group's queue
positions start after the per-expert counts of the groups before it (and,
for choice i, after every group's earlier choices), and the aux loss is the
product of the global means. Experts are sharded ``("ep", None, "tp")`` /
``("ep", "tp", None)``: each (ep, tp) rank runs its own experts on its own
hidden slice for every token of its group (tokens are replicated over ep
and tp), and the combine's parts are added in rank order on the group's
leader. That is exact without an all-to-all. The router runs once per
group, on its leader.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from distributedvolunteercomputing_tpu_torch.models import common, gpt2
from distributedvolunteercomputing_tpu_torch.models.gpt2 import GPT2Config


@dataclasses.dataclass(frozen=True)
class GPT2MoEConfig(GPT2Config):
    n_experts: int = 8
    capacity_factor: float = 1.25
    aux_coef: float = 0.01
    # Experts each token is routed to: 1 = Switch, 2 = GShard-style top-2.
    # MoE replaces the dense FFN in EVERY block; d_ff is the per-expert
    # hidden width.
    router_top_k: int = 1

    def __post_init__(self):
        if not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k={self.router_top_k} must be in [1, n_experts={self.n_experts}]"
            )


def moe_init(gen: torch.Generator, cfg: GPT2MoEConfig) -> common.Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    res_scale = 1.0 / ((2 * cfg.n_layers) ** 0.5 * d**0.5)
    return {
        "router": common._normal(gen, (d, e), 0.02),
        # experts stacked on the leading E axis -> sharded over ep
        "moe_in": common._normal(gen, (e, d, f), 0.02),
        "moe_out": common._normal(gen, (e, f, d), res_scale),
    }


# Routing decisions of each moe_ffn call while a ``routing_log`` is open:
# one dict per dp group per call ({"top_idx": [S, K], "kept": [S, K]}).
_ROUTING: Optional[list] = None


@contextlib.contextmanager
def routing_log() -> Iterator[list]:
    """Record the routing of every MoE layer run inside the block (for tests
    and the card's checks; run it around a forward without recompute)."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    sel = gates.detach()
    idx = []
    for i in range(k):
        j = sel.argmax(-1)  # the first of equal maxima
        idx.append(j)
        if i + 1 < k:
            sel = sel.scatter(-1, j[:, None], float("-inf"))
    top_idx = torch.stack(idx, -1)
    return gates.gather(-1, top_idx), top_idx


class _Route:
    """One dp group's routing of one layer, on the group's leader."""

    def __init__(self, x: torch.Tensor, router: torch.Tensor, cfg: GPT2MoEConfig):
        self.tokens = x.reshape(-1, x.shape[-1])
        logits = self.tokens.float() @ router.float()
        self.gates = torch.softmax(logits, dim=-1)  # [S, E]
        top_gates, self.top_idx = _top_k(self.gates, cfg.router_top_k)
        if cfg.router_top_k > 1:
            top_gates = top_gates / top_gates.sum(-1, keepdim=True)
        self.top_gates = top_gates
        self.onehot = [F.one_hot(self.top_idx[:, i], cfg.n_experts).float() for i in range(cfg.router_top_k)]
        self.counts = [oh.sum(0) for oh in self.onehot]  # [E] per choice

    def place(self, offsets: List[torch.Tensor], cap: int) -> None:
        """Queue positions and the kept mask per choice, given the tokens
        queued ahead of this group's choice i (per expert)."""
        self.pos, self.kept = [], []
        for i, oh in enumerate(self.onehot):
            before = torch.cumsum(oh, dim=0) + offsets[i].to(oh.device)[None, :]
            pos = before.gather(-1, self.top_idx[:, i:i + 1])[:, 0] - 1.0
            self.pos.append(pos)
            self.kept.append(pos < cap)


def _dispatch(route: _Route, e0: int, n_e: int, cap: int, dtype: torch.dtype, device):
    """dispatch / combine ``[S, n_e, C]`` for experts [e0, e0 + n_e): one-hot
    slots built by a scatter in ``dtype`` (combine carries the gates)."""
    s = route.tokens.shape[0]
    base = torch.arange(s, device=device) * (n_e * cap)
    disp = torch.zeros(s * n_e * cap, dtype=dtype, device=device)
    comb = torch.zeros(s * n_e * cap, dtype=dtype, device=device)
    for i in range(len(route.pos)):
        e = route.top_idx[:, i].to(device) - e0
        keep = (route.kept[i].to(device) & (e >= 0) & (e < n_e)).to(dtype)
        pos = route.pos[i].to(device).clamp(0, cap - 1).long()  # clipped before the one-hot
        idx = base + e.clamp(0, n_e - 1) * cap + pos
        disp = disp.scatter_add(0, idx, keep)
        comb = comb.scatter_add(0, idx, keep * route.top_gates[:, i].to(device, dtype))
    return disp.view(s, n_e, cap), comb.view(s, n_e, cap)


def _expert_ranks(p: common.Params, n_experts: int, device) -> list:
    """(first expert, experts, moe_in part, moe_out part, device) per rank
    that runs experts: one entry on one device, one per (ep, tp) rank of the
    group under a mesh."""
    w_in, w_out = p["moe_in"], p["moe_out"]
    if not isinstance(w_in, common.Slices):
        return [(0, n_experts, w_in, w_out, device)]
    if not isinstance(w_out, common.Slices) or w_out.ranks != w_in.ranks:
        raise ValueError("moe_in and moe_out are split differently over the group")
    n_e = n_experts // w_in.sizes["ep"] if w_in.dims["ep"] is not None else n_experts
    return [
        ((e * n_e) if w_in.dims["ep"] is not None else 0, n_e, a, b, dev)
        for (e, _), a, b, dev in zip(w_in.ranks, w_in.parts, w_out.parts, w_in.devices)
    ]


def moe_groups(ps: List[common.Params], xs: List[torch.Tensor], cfg: GPT2MoEConfig):
    """The MoE FFN over every dp group at once: ``xs[g]`` [B, T, d] on group
    g's leader -> (ys per group, aux on group 0's leader). Capacity, queue
    order and the aux means are over the whole batch (module docstring)."""
    e_n, k = cfg.n_experts, cfg.router_top_k
    b, t, d = xs[0].shape
    s_all = b * t * len(xs)
    cap = max(math.ceil(cfg.capacity_factor * k * s_all / e_n), 1)
    routes = [_Route(x, p["router"], cfg) for p, x in zip(ps, xs)]
    dev0 = xs[0].device
    counts = [[c.to(dev0) for c in r.counts] for r in routes]
    for g, route in enumerate(routes):
        offsets = []
        for i in range(k):
            off = torch.zeros(e_n, dtype=torch.float32, device=dev0)
            for g2 in range(len(routes)):
                for i2 in range(i):
                    off = off + counts[g2][i2]
            for g2 in range(g):
                off = off + counts[g2][i]
            offsets.append(off)
        route.place(offsets, cap)
        if _ROUTING is not None:
            _ROUTING.append({"top_idx": route.top_idx.detach().clone(),
                             "kept": torch.stack(route.kept, -1).detach().clone()})
    ys = []
    for p, x, route in zip(ps, xs, routes):
        dtype = x.dtype
        y = None
        for e0, n_e, w_in, w_out, dev in _expert_ranks(p, e_n, x.device):
            disp, comb = _dispatch(route, e0, n_e, cap, dtype, dev)
            ein = torch.einsum("sec,sd->ecd", disp, route.tokens.to(dev))  # [n_e, C, d]
            h = common.gelu(torch.einsum("ecd,edf->ecf", ein, w_in.to(dtype)))
            eout = torch.einsum("ecf,efd->ecd", h, w_out.to(dtype))  # [n_e, C, d]
            part = torch.einsum("sec,ecd->sd", comb, eout).to(x.device)
            y = part if y is None else y + part
        ys.append(y.reshape(b, t, d))
    # Load balance over the whole batch: E * sum_e(frac_e * mean_gate_e).
    frac = sum(r.onehot[0].sum(0).to(dev0) for r in routes) / s_all
    mean_gate = sum(r.gates.sum(0).to(dev0) for r in routes) / s_all
    aux = e_n * torch.sum(frac * mean_gate)
    return ys, aux.float()


def moe_ffn(p: common.Params, x: torch.Tensor, cfg: GPT2MoEConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] -> (y [B, T, d], aux_loss scalar)."""
    ys, aux = moe_groups([p], [x], cfg)
    return ys[0], aux


def _layer_init(gen: torch.Generator, cfg: GPT2MoEConfig) -> common.Params:
    res_scale = 1.0 / ((2 * cfg.n_layers) ** 0.5 * cfg.d_model**0.5)
    return {
        "ln1": common.layernorm_init(cfg.d_model, gen.device),
        "qkv": common.dense_init(gen, cfg.d_model, 3 * cfg.d_model, scale=0.02),
        "attn_out": common.dense_init(gen, cfg.d_model, cfg.d_model, scale=res_scale),
        "ln2": common.layernorm_init(cfg.d_model, gen.device),
        "moe": moe_init(gen, cfg),
    }


def init(gen: torch.Generator, cfg: GPT2MoEConfig, dtype: Optional[torch.dtype] = None) -> common.Params:
    """Random params on ``gen.device`` in ``dtype`` (the reference's scales;
    carry JAX params over with models.convert)."""
    return {
        "wte": common.cast(common.embed_init(gen, cfg.vocab, cfg.d_model), dtype),
        "wpe": common.cast(common.embed_init(gen, cfg.max_len, cfg.d_model, scale=0.01), dtype),
        "blocks": common.stacked_init(lambda g: _layer_init(g, cfg), gen, cfg.n_layers, dtype),
        "ln_f": common.cast(common.layernorm_init(cfg.d_model, gen.device), dtype),
    }


def _block(ps: List[common.Params], carry, cfg: GPT2MoEConfig):
    xs, aux = carry
    xs = [gpt2.attn_block(p, x, cfg) for p, x in zip(ps, xs)]
    hs = [common.layernorm(p["ln2"], x) for p, x in zip(ps, xs)]
    ys, layer_aux = moe_groups([p["moe"] for p in ps], hs, cfg)
    return [x + y for x, y in zip(xs, ys)], aux + layer_aux


def loss_fn(
    params: Any, batch: Any, rng: torch.Generator, cfg: GPT2MoEConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's loss. ``params`` and ``batch`` may be lists, one
    entry per dp group (the sharded step's call): the result is the loss of
    the whole batch."""
    views = params if isinstance(params, list) else [params]
    batches = batch if isinstance(batch, list) else [batch]
    xs = [gpt2.embed(v, b["tokens"], cfg) for v, b in zip(views, batches)]
    dev0 = xs[0].device
    aux0 = torch.zeros((), dtype=torch.float32, device=dev0)
    xs, aux = common.scan_blocks(
        lambda ps, carry: _block(ps, carry, cfg), [v["blocks"] for v in views], (xs, aux0), remat=cfg.remat
    )
    lm = None
    for v, b, x in zip(views, batches, xs):
        x = common.layernorm(v["ln_f"], x)
        part = common.lm_xent_chunked(x, v["wte"], b["targets"], chunk=cfg.xent_chunk, head_layout="vd").to(dev0)
        lm = part if lm is None else lm + part
    lm = lm / len(xs)
    aux = aux / cfg.n_layers
    loss = lm + cfg.aux_coef * aux
    return loss, {"loss": loss, "lm_loss": lm, "aux_loss": aux}
