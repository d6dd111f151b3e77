"""BERT-base masked LM, capability config 3 (ported from
``distributedvolunteercomputing_tpu/models/bert.py``).

Post-LN encoder (original BERT) with learned positions and a tied-embedding
MLM head; the loss is the masked, chunked LM cross-entropy over the tied
``wte`` (``"vd"``), which never builds the [B, T, V] logits. Attention is
non-causal and unmasked, so on the card it runs on the flash kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.models import common

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
    # Column-parallel qkv / mlp_in and row-parallel attn_out / mlp_out under
    # a mesh (models/common.py); one device otherwise.
    attn = common.head_attention(common.col_dense(p["qkv"], x), cfg.d_model, cfg.n_heads)
    x = common.layernorm(p["ln1"], x + common.row_dense(p["attn_out"], attn))
    h = common.row_dense(p["mlp_out"], common.tp_map(common.gelu, common.col_dense(p["mlp_in"], x)))
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
    params: Any, batch: Any, rng: torch.Generator, cfg: BertConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The masked mean over the whole batch. ``params`` and ``batch`` may be
    lists, one entry per dp group (the sharded step's call,
    ``common.CoupledLoss``): the groups' masked sums and counts are added
    before the one division, as over the unsplit batch."""
    views = params if isinstance(params, list) else [params]
    batches = batch if isinstance(batch, list) else [batch]
    dev = batches[0]["tokens"].device
    total = count = 0.0
    for p, b in zip(views, batches):
        h = hidden(p, b["tokens"], cfg)
        s, n = common.lm_xent_chunked(h, p["wte"], b["targets"], mask=b["mask"], head_layout="vd", sums=True)
        total, count = total + s.to(dev), count + n.to(dev)
    loss = total / torch.clamp(count, min=1.0)
    return loss, {"loss": loss}
