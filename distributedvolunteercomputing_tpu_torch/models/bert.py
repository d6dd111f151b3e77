"""BERT-base masked LM, capability config 3 (ported from
``distributedvolunteercomputing_tpu/models/bert.py``).

Post-LN encoder (original BERT) with learned positions and a tied-embedding
MLM head; the loss is the masked, chunked LM cross-entropy over the tied
``wte`` (``"vd"``), which never builds the [B, T, V] logits. Attention is
non-causal and unmasked, so on the card it runs on the flash kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.models import common
from distributedvolunteercomputing_tpu_torch.ops.attention import multi_head_attention

MASK_ID = 103  # [MASK] in the BERT-base vocab


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab: int = 30522
    max_len: int = 512
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    remat: bool = True  # see GPT2Config.remat


def _layer_init(gen: torch.Generator, cfg: BertConfig) -> common.Params:
    return {
        "qkv": common.dense_init(gen, cfg.d_model, 3 * cfg.d_model, scale=0.02),
        "attn_out": common.dense_init(gen, cfg.d_model, cfg.d_model, scale=0.02),
        "ln1": common.layernorm_init(cfg.d_model, gen.device),
        "mlp_in": common.dense_init(gen, cfg.d_model, cfg.d_ff, scale=0.02),
        "mlp_out": common.dense_init(gen, cfg.d_ff, cfg.d_model, scale=0.02),
        "ln2": common.layernorm_init(cfg.d_model, gen.device),
    }


def init(gen: torch.Generator, cfg: BertConfig, dtype: Optional[torch.dtype] = None) -> common.Params:
    return {
        "wte": common.cast(common.embed_init(gen, cfg.vocab, cfg.d_model), dtype),
        "wpe": common.cast(common.embed_init(gen, cfg.max_len, cfg.d_model, scale=0.01), dtype),
        "ln_emb": common.cast(common.layernorm_init(cfg.d_model, gen.device), dtype),
        "blocks": common.stacked_init(lambda g: _layer_init(g, cfg), gen, cfg.n_layers, dtype),
        "mlm_dense": common.cast(common.dense_init(gen, cfg.d_model, cfg.d_model, scale=0.02), dtype),
        "ln_mlm": common.cast(common.layernorm_init(cfg.d_model, gen.device), dtype),
    }


def _block(p: common.Params, x: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    q, k, v = common.dense(p["qkv"], x).split(cfg.d_model, dim=-1)
    attn = multi_head_attention(q, k, v, cfg.n_heads)
    x = common.layernorm(p["ln1"], x + common.dense(p["attn_out"], attn))
    h = common.dense(p["mlp_out"], common.gelu(common.dense(p["mlp_in"], x)))
    return common.layernorm(p["ln2"], x + h)


def hidden(params: common.Params, tokens: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """MLM-head hidden states [B, T, d] (before the tied vocab projection)."""
    t = tokens.shape[1]
    x = (params["wte"][tokens] + params["wpe"][:t][None]).to(common.compute_dtype(tokens.device))
    x = common.layernorm(params["ln_emb"], x)
    x = common.scan_blocks(lambda p, h: _block(p, h, cfg), params["blocks"], x, remat=cfg.remat)
    h = common.gelu(common.dense(params["mlm_dense"], x))
    return common.layernorm(params["ln_mlm"], h)


def forward(params: common.Params, tokens: torch.Tensor, cfg: BertConfig) -> torch.Tensor:
    """Full f32 logits [B, T, V] — for tests; the loss never builds them."""
    return common.project_vocab(hidden(params, tokens, cfg), params["wte"], "vd")


def loss_fn(
    params: common.Params, batch: Dict[str, torch.Tensor], rng: torch.Generator, cfg: BertConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    h = hidden(params, batch["tokens"], cfg)
    loss = common.lm_xent_chunked(h, params["wte"], batch["targets"], mask=batch["mask"], head_layout="vd")
    return loss, {"loss": loss}
