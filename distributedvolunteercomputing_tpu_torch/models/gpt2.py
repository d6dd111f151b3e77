"""GPT-2 — the flagship model, ported from
``distributedvolunteercomputing_tpu/models/gpt2.py``.

Pre-LN decoder with learned positional embeddings and tied input/output
embeddings, over the reference's parameter tree (stacked blocks, dense
weights ``[d_in, d_out]``). The loss streams the tied vocab projection over
time chunks and never builds the [B, T, V] logits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.models import common


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab: int = 50257
    max_len: int = 1024
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    # Recompute each block in backward (one layer's activations alive).
    remat: bool = True
    # Time-chunk size for the streamed vocab projection + xent.
    xent_chunk: int = 128

    @classmethod
    def medium(cls) -> "GPT2Config":
        return cls(d_model=1024, n_heads=16, n_layers=24, d_ff=4096)

    @classmethod
    def large(cls) -> "GPT2Config":
        return cls(d_model=1280, n_heads=20, n_layers=36, d_ff=5120)


def _layer_init(gen: torch.Generator, cfg: GPT2Config) -> common.Params:
    # Fused qkv; residual projections scaled by 1/sqrt(2 * n_layers).
    res_scale = 1.0 / ((2 * cfg.n_layers) ** 0.5 * cfg.d_model ** 0.5)
    return {
        "ln1": common.layernorm_init(cfg.d_model, gen.device),
        "qkv": common.dense_init(gen, cfg.d_model, 3 * cfg.d_model, scale=0.02),
        "attn_out": common.dense_init(gen, cfg.d_model, cfg.d_model, scale=res_scale),
        "ln2": common.layernorm_init(cfg.d_model, gen.device),
        "mlp_in": common.dense_init(gen, cfg.d_model, cfg.d_ff, scale=0.02),
        "mlp_out": common.dense_init(gen, cfg.d_ff, cfg.d_model, scale=res_scale),
    }


def init(gen: torch.Generator, cfg: GPT2Config, dtype: Optional[torch.dtype] = None) -> common.Params:
    """Random params on ``gen.device`` in ``dtype`` (the reference's scales;
    the bits differ from ``jax.random`` — carry JAX params over with
    models.convert)."""
    return {
        "wte": common.cast(common.embed_init(gen, cfg.vocab, cfg.d_model), dtype),
        "wpe": common.cast(common.embed_init(gen, cfg.max_len, cfg.d_model, scale=0.01), dtype),
        "blocks": common.stacked_init(lambda g: _layer_init(g, cfg), gen, cfg.n_layers, dtype),
        "ln_f": common.cast(common.layernorm_init(cfg.d_model, gen.device), dtype),
    }


def attn_block(p: common.Params, x: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """x + the causal self-attention of the pre-LN block (shared with the
    MoE model). Under a mesh qkv is column-parallel, each tp rank attends
    over its head group, and attn_out is row-parallel (``models/common``)."""
    h = common.layernorm(p["ln1"], x)
    attn = common.head_attention(common.col_dense(p["qkv"], h), cfg.d_model, cfg.n_heads, causal=True)
    return x + common.row_dense(p["attn_out"], attn)


def _block(p: common.Params, x: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    x = attn_block(p, x, cfg)
    h = common.layernorm(p["ln2"], x)
    return x + common.row_dense(p["mlp_out"], common.tp_map(common.gelu, common.col_dense(p["mlp_in"], h)))


def embed(params: common.Params, tokens: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Token + position embeddings, added in the params' dtype (f32 unless the
    trainer casts them), then cast to the compute dtype."""
    t = tokens.shape[1]
    x = params["wte"][tokens] + params["wpe"][:t][None]
    return x.to(common.compute_dtype(tokens.device))


def hidden(params: common.Params, tokens: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Final-layer hidden states [B, T, d] (after ln_f, before the vocab projection)."""
    x = common.scan_blocks(
        lambda p, h: _block(p, h, cfg), params["blocks"], embed(params, tokens, cfg), remat=cfg.remat
    )
    return common.layernorm(params["ln_f"], x)


def forward(params: common.Params, tokens: torch.Tensor, cfg: GPT2Config) -> torch.Tensor:
    """Full f32 logits [B, T, V] — for tests; the loss never builds them."""
    return common.project_vocab(hidden(params, tokens, cfg), params["wte"], "vd")


def loss_fn(
    params: common.Params,
    batch: Dict[str, torch.Tensor],
    rng: torch.Generator,
    cfg: GPT2Config,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    x = hidden(params, batch["tokens"], cfg)
    loss = common.lm_xent_chunked(
        x, params["wte"], batch["targets"], chunk=cfg.xent_chunk, head_layout="vd"
    )
    return loss, {"loss": loss}
