"""Llama-family decoder with LoRA finetuning, capability config 5 (ported
from ``distributedvolunteercomputing_tpu/models/llama.py``).

RMSNorm, RoPE (interleaved lane pairs, ``ops.attention.rope``), SwiGLU, no
biases, grouped kv heads repeated consecutively (``repeat_interleave``, as
``jnp.repeat`` on the head axis). The default config is the reference's
small proxy; ``LlamaConfig.llama2_7b()`` gives the published widths.

With ``lora_rank > 0`` the params split into ``{"base", "lora"}``. The loss
detaches the base (the reference's ``stop_gradient``), so no gradient
reaches it: the train step makes no gradient buffer or optimizer moments
for it (``training/steps.py``) and the swarm ships only the adapters
(``lora_subtree``, the bundle's ``avg_select``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from distributedvolunteercomputing_tpu_torch.models import common
from distributedvolunteercomputing_tpu_torch.models.lora import lora_delta, lora_init
from distributedvolunteercomputing_tpu_torch.ops.attention import attention_core, merge_heads, rope, split_heads
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 2048
    max_len: int = 256
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    n_layers: int = 8
    d_ff: int = 1408
    lora_rank: int = 8
    lora_alpha: float = 16.0
    remat: bool = True  # see GPT2Config.remat

    @classmethod
    def llama2_7b(cls, lora_rank: int = 8) -> "LlamaConfig":
        return cls(
            vocab=32000, max_len=4096, d_model=4096, n_heads=32, n_kv_heads=32,
            n_layers=32, d_ff=11008, lora_rank=lora_rank,
        )


def _no_bias_dense_init(gen: torch.Generator, d_in: int, d_out: int) -> torch.Tensor:
    return common._normal(gen, (d_in, d_out), 1.0 / d_in**0.5)


def _layer_init(gen: torch.Generator, cfg: LlamaConfig) -> common.Params:
    d_kv = cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)
    return {
        "ln_attn": common.rmsnorm_init(cfg.d_model, gen.device),
        "wq": _no_bias_dense_init(gen, cfg.d_model, cfg.d_model),
        "wk": _no_bias_dense_init(gen, cfg.d_model, d_kv),
        "wv": _no_bias_dense_init(gen, cfg.d_model, d_kv),
        "wo": _no_bias_dense_init(gen, cfg.d_model, cfg.d_model),
        "ln_mlp": common.rmsnorm_init(cfg.d_model, gen.device),
        "w_gate": _no_bias_dense_init(gen, cfg.d_model, cfg.d_ff),
        "w_up": _no_bias_dense_init(gen, cfg.d_model, cfg.d_ff),
        "w_down": _no_bias_dense_init(gen, cfg.d_ff, cfg.d_model),
    }


def _lora_layer_init(gen: torch.Generator, cfg: LlamaConfig) -> common.Params:
    d_kv = cfg.n_kv_heads * (cfg.d_model // cfg.n_heads)
    return {
        "q": lora_init(gen, cfg.d_model, cfg.d_model, cfg.lora_rank),
        "v": lora_init(gen, cfg.d_model, d_kv, cfg.lora_rank),
    }


def init(gen: torch.Generator, cfg: LlamaConfig, dtype: Optional[torch.dtype] = None) -> common.Params:
    """Random params on ``gen.device``, each leaf in ``dtype`` as it is made
    (one stacked layer in f32 at a time)."""
    base = {
        "wte": common.cast(common.embed_init(gen, cfg.vocab, cfg.d_model), dtype),
        "blocks": common.stacked_init(lambda g: _layer_init(g, cfg), gen, cfg.n_layers, dtype),
        "ln_f": common.cast(common.rmsnorm_init(cfg.d_model, gen.device), dtype),
        "lm_head": common.cast(_no_bias_dense_init(gen, cfg.d_model, cfg.vocab), dtype),
    }
    if cfg.lora_rank <= 0:
        return base
    lora = {"blocks": common.stacked_init(lambda g: _lora_layer_init(g, cfg), gen, cfg.n_layers, dtype)}
    return {"base": base, "lora": lora}


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    # jnp.repeat on the head axis: each kv head repeated consecutively.
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=1)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int, n_kv: int) -> torch.Tensor:
    qh = rope(split_heads(q, n_heads))
    kh = rope(split_heads(k, n_kv))
    vh = split_heads(v, n_kv)
    n_rep = n_heads // n_kv
    return merge_heads(attention_core(qh, _repeat_kv(kh, n_rep), _repeat_kv(vh, n_rep), causal=True))


def _add_cols(x, delta: torch.Tensor):
    """x + delta, where x may be split over tp by columns (``Parts``)."""
    if not isinstance(x, common.Parts):
        return x + delta
    w = x.parts[0].shape[-1]
    return common.Parts([xj + delta[..., j * w:(j + 1) * w].to(xj.device) for j, xj in enumerate(x.parts)],
                        x.devices, x.leader)


def _block(p: common.Params, lp: Optional[common.Params], x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    # wq/wk/wv are column-parallel under a mesh: when tp divides both head
    # counts each rank's columns are whole heads, and it attends over its
    # head group; otherwise q, k and v are gathered and attended whole on the
    # group's leader. wo and w_down are row-parallel (models/common.py).
    h = common.rmsnorm(p["ln_attn"], x)
    q = common.col_matmul(h, p["wq"])
    k = common.col_matmul(h, p["wk"])
    v = common.col_matmul(h, p["wv"])
    if lp is not None:
        q = _add_cols(q, lora_delta(lp["q"], h, cfg.lora_alpha, cfg.lora_rank))
        v = _add_cols(v, lora_delta(lp["v"], h, cfg.lora_alpha, cfg.lora_rank))
    split = all(isinstance(t, common.Parts) for t in (q, k, v))
    tp = len(q.parts) if split else 1
    if split and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0:
        attn = common.tp_map(lambda qj, kj, vj: _attend(qj, kj, vj, cfg.n_heads // tp, cfg.n_kv_heads // tp), q, k, v)
    else:
        attn = _attend(common.full(q), common.full(k), common.full(v), cfg.n_heads, cfg.n_kv_heads)
    x = x + common.row_matmul(attn, p["wo"])
    h = common.rmsnorm(p["ln_mlp"], x)
    gate = common.tp_map(F.silu, common.col_matmul(h, p["w_gate"]))
    up = common.col_matmul(h, p["w_up"])
    return x + common.row_matmul(common.tp_map(lambda g, u: g * u, gate, up), p["w_down"])


def _lora_body(pl: common.Params, h: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    return _block(pl["base"], pl["lora"], h, cfg)


def _trunk(params: common.Params, tokens: torch.Tensor, cfg: LlamaConfig):
    """Shared forward trunk: (final hidden [B, T, d], the base as used)."""
    lora_enabled = cfg.lora_rank > 0
    base = params["base"] if lora_enabled else params
    if lora_enabled:
        # Freeze the base: no gradient reaches it.
        base = tree_map(lambda t: t.detach(), base)
    x = base["wte"][tokens].to(common.compute_dtype(tokens.device))
    if lora_enabled:
        blocks = {"base": base["blocks"], "lora": params["lora"]["blocks"]}
        x = common.scan_blocks(lambda pl, h: _lora_body(pl, h, cfg), blocks, x, remat=cfg.remat)
    else:
        x = common.scan_blocks(lambda p, h: _block(p, None, h, cfg), base["blocks"], x, remat=cfg.remat)
    return common.rmsnorm(base["ln_f"], x), base


def forward(params: common.Params, tokens: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    x, base = _trunk(params, tokens, cfg)
    return (x @ common.full(base["lm_head"]).to(x.dtype)).float()


def loss_fn(
    params: common.Params, batch: Dict[str, torch.Tensor], rng: torch.Generator, cfg: LlamaConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x, base = _trunk(params, batch["tokens"], cfg)
    loss = common.lm_xent_chunked(x, common.full(base["lm_head"]), batch["targets"], head_layout="dv")
    return loss, {"loss": loss}


def lora_subtree(params: common.Params) -> common.Params:
    """The averaging payload of config 5: the adapters only."""
    return params["lora"]


def with_lora_subtree(params: common.Params, lora: common.Params) -> common.Params:
    return {"base": params["base"], "lora": lora}
