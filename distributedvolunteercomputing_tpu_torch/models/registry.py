"""Model registry (ported from ``distributedvolunteercomputing_tpu/models/registry.py``).

Each bundle closes over its config and exposes:

    init(gen) -> params              on ``gen.device``
    loss_fn(params, batch, rng) -> (loss, metrics)
    make_batch(gen, batch_size) -> synthetic batch on ``gen.device``
    avg_select(params) / avg_merge(params, averaged) -> the averaged subtree

Only the GPT-2 family is ported so far; other names raise ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

# The JAX package's other models, ported in later slices.
_NOT_PORTED = ("mnist_mlp", "cifar10_resnet18", "cifar10_vit", "bert_mlm", "gpt2_moe", "llama_lora")


def _identity_select(params: Any) -> Any:
    return params


def _identity_merge(params: Any, averaged: Any) -> Any:
    return averaged


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any
    init: Callable[[torch.Generator], Any]
    loss_fn: Callable[[Any, Batch, torch.Generator], Tuple[torch.Tensor, Metrics]]
    make_batch: Callable[[torch.Generator, int], Batch]
    # What the swarm averages: the payload subtree of the params and how the
    # averaged result merges back (identity for the GPT-2 family).
    avg_select: Callable[[Any], Any] = _identity_select
    avg_merge: Callable[[Any, Any], Any] = _identity_merge


def _gpt2(preset: str, **overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import gpt2
    from distributedvolunteercomputing_tpu_torch.training import data

    base = gpt2.GPT2Config() if preset == "small" else getattr(gpt2.GPT2Config, preset)()
    cfg = dataclasses.replace(base, **overrides)
    return ModelBundle(
        name=f"gpt2_{preset}",
        config=cfg,
        init=lambda gen: gpt2.init(gen, cfg),
        loss_fn=lambda p, b, rng: gpt2.loss_fn(p, b, rng, cfg),
        make_batch=lambda gen, bs: data.synthetic_lm_batch(gen, bs, seq_len=cfg.max_len, vocab=cfg.vocab),
    )


_REGISTRY: Dict[str, Callable[..., ModelBundle]] = {
    "gpt2_small": lambda **kw: _gpt2("small", **kw),
    "gpt2_medium": lambda **kw: _gpt2("medium", **kw),
    "gpt2_large": lambda **kw: _gpt2("large", **kw),
}


def ported_models() -> list:
    return sorted(_REGISTRY)


def get_model(name: str, **overrides: Any) -> ModelBundle:
    if name in _NOT_PORTED:
        raise KeyError(f"model {name!r} is not ported to PyTorch yet; ported: {sorted(_REGISTRY)}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)
