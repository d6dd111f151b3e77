"""2-layer MLP for MNIST, capability config 1 (ported from
``distributedvolunteercomputing_tpu/models/mlp.py``): single-volunteer local
SGD, no averaging."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.models import common


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_in: int = 784
    d_hidden: int = 256
    n_classes: int = 10


def init(gen: torch.Generator, cfg: MLPConfig, dtype: Optional[torch.dtype] = None) -> common.Params:
    return {
        "fc1": common.cast(common.dense_init(gen, cfg.d_in, cfg.d_hidden), dtype),
        "fc2": common.cast(common.dense_init(gen, cfg.d_hidden, cfg.n_classes), dtype),
    }


def forward(params: common.Params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    h = torch.relu(common.dense(params["fc1"], x))
    return common.dense(params["fc2"], h).float()


def loss_fn(
    params: common.Params, batch: Dict[str, torch.Tensor], rng: torch.Generator, cfg: MLPConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits = forward(params, batch["x"], cfg)
    loss = common.softmax_xent(logits, batch["y"])
    return loss, {"loss": loss, "accuracy": common.accuracy(logits, batch["y"])}
