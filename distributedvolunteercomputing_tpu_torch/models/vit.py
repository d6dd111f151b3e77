"""Vision Transformer (ViT-Tiny at CIFAR scale), ported from
``distributedvolunteercomputing_tpu/models/vit.py``.

Patchification is a reshape/transpose feeding one [B, N, p*p*C] @
[p*p*C, d] projection; a CLS token and learned positions; pre-LN encoder
blocks whose non-causal attention goes through ``ops/attention.py`` (the
flash kernels on the card); the head reads the CLS hidden state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.models import common


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    n_classes: int = 10
    d_model: int = 192
    n_heads: int = 3
    n_layers: int = 12
    d_ff: int = 768
    remat: bool = True  # see GPT2Config.remat

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels


def _layer_init(gen: torch.Generator, cfg: ViTConfig) -> common.Params:
    return {
        "ln1": common.layernorm_init(cfg.d_model, gen.device),
        "qkv": common.dense_init(gen, cfg.d_model, 3 * cfg.d_model, scale=0.02),
        "attn_out": common.dense_init(gen, cfg.d_model, cfg.d_model, scale=0.02),
        "ln2": common.layernorm_init(cfg.d_model, gen.device),
        "mlp_in": common.dense_init(gen, cfg.d_model, cfg.d_ff, scale=0.02),
        "mlp_out": common.dense_init(gen, cfg.d_ff, cfg.d_model, scale=0.02),
    }


def init(gen: torch.Generator, cfg: ViTConfig, dtype: Optional[torch.dtype] = None) -> common.Params:
    if cfg.image_size % cfg.patch_size != 0:
        raise ValueError(f"patch_size {cfg.patch_size} must divide image_size {cfg.image_size}")
    return {
        "patch_proj": common.cast(common.dense_init(gen, cfg.patch_dim, cfg.d_model, scale=0.02), dtype),
        "cls": common.cast(common.embed_init(gen, 1, cfg.d_model)[None], dtype),  # [1, 1, d]
        # +1 position for the CLS token.
        "pos": common.cast(common.embed_init(gen, cfg.n_patches + 1, cfg.d_model), dtype),
        "blocks": common.stacked_init(lambda g: _layer_init(g, cfg), gen, cfg.n_layers, dtype),
        "ln_out": common.cast(common.layernorm_init(cfg.d_model, gen.device), dtype),
        "head": common.cast(common.dense_init(gen, cfg.d_model, cfg.n_classes, scale=0.02), dtype),
    }


def _patchify(x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, C] -> [B, N, p*p*C]."""
    b = x.shape[0]
    s, p = cfg.image_size // cfg.patch_size, cfg.patch_size
    x = x.reshape(b, s, p, s, p, cfg.channels).permute(0, 1, 3, 2, 4, 5)  # [B, s, s, p, p, C]
    return x.reshape(b, s * s, cfg.patch_dim)


def _block(p: common.Params, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    # Pre-LN: residuals stay un-normalized.
    # Tensor-parallel under a mesh (models/common.py); ViT-Tiny's 3 heads
    # attend whole on the group's leader at tp=2.
    h = common.layernorm(p["ln1"], x)
    x = x + common.row_dense(p["attn_out"], common.head_attention(common.col_dense(p["qkv"], h), cfg.d_model,
                                                                  cfg.n_heads))
    h = common.layernorm(p["ln2"], x)
    return x + common.row_dense(p["mlp_out"], common.tp_map(common.gelu, common.col_dense(p["mlp_in"], h)))


def forward(params: common.Params, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Class logits [B, n_classes] (f32) of NHWC images ``x``."""
    dtype = common.compute_dtype(x.device)
    patches = _patchify(x.float(), cfg)
    h = common.dense(params["patch_proj"], patches.to(dtype))  # [B, N, d]
    cls = params["cls"].to(dtype).expand(h.shape[0], 1, cfg.d_model)
    h = torch.cat([cls, h], dim=1) + params["pos"].to(dtype)[None]
    h = common.scan_blocks(lambda p, hh: _block(p, hh, cfg), params["blocks"], h, remat=cfg.remat)
    h = common.layernorm(params["ln_out"], h[:, 0])  # CLS hidden state
    return common.dense(params["head"], h, dtype=torch.float32)


def loss_fn(
    params: common.Params, batch: Dict[str, torch.Tensor], rng: torch.Generator, cfg: ViTConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, batch["x"], cfg)
    loss = common.softmax_xent(logits, batch["y"])
    return loss, {"loss": loss, "accuracy": common.accuracy(logits, batch["y"])}
