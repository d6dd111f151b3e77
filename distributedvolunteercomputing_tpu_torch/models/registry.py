"""Model registry (ported from ``distributedvolunteercomputing_tpu/models/registry.py``).

Each bundle closes over its config and exposes:

    init(gen, dtype=None) -> params  on ``gen.device``, floating leaves in ``dtype``
    loss_fn(params, batch, rng) -> (loss, metrics)
    make_batch(gen, batch_size) -> synthetic batch on ``gen.device``
    avg_select(params) / avg_merge(params, averaged) -> the averaged subtree

``avg_select`` returns the live tensors of the subtree (no copy): the
trainer writes merged payloads into them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]

def _identity_select(params: Any) -> Any:
    return params


def _identity_merge(params: Any, averaged: Any) -> Any:
    return averaged


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    config: Any
    init: Callable[..., Any]
    loss_fn: Callable[[Any, Batch, torch.Generator], Tuple[torch.Tensor, Metrics]]
    make_batch: Callable[[torch.Generator, int], Batch]
    # What the swarm averages: the payload subtree of the params and how the
    # averaged result merges back (identity for the GPT-2 family).
    avg_select: Callable[[Any], Any] = _identity_select
    avg_merge: Callable[[Any, Any], Any] = _identity_merge


def _mlp(**overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import mlp
    from distributedvolunteercomputing_tpu_torch.training import data

    cfg = dataclasses.replace(mlp.MLPConfig(), **overrides)
    return ModelBundle(
        name="mnist_mlp",
        config=cfg,
        init=lambda gen, dtype=None: mlp.init(gen, cfg, dtype),
        loss_fn=lambda p, b, rng: mlp.loss_fn(p, b, rng, cfg),
        make_batch=lambda gen, bs: data.synthetic_image_batch(gen, bs, shape=(28, 28, 1), n_classes=cfg.n_classes),
    )


def _resnet18(**overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import resnet
    from distributedvolunteercomputing_tpu_torch.training import data

    cfg = dataclasses.replace(resnet.ResNetConfig(), **overrides)
    return ModelBundle(
        name="cifar10_resnet18",
        config=cfg,
        init=lambda gen, dtype=None: resnet.init(gen, cfg, dtype),
        loss_fn=lambda p, b, rng: resnet.loss_fn(p, b, rng, cfg),
        make_batch=lambda gen, bs: data.synthetic_image_batch(gen, bs, shape=(32, 32, 3), n_classes=cfg.n_classes),
    )


def _vit(**overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import vit
    from distributedvolunteercomputing_tpu_torch.training import data

    cfg = dataclasses.replace(vit.ViTConfig(), **overrides)
    return ModelBundle(
        name="cifar10_vit",
        config=cfg,
        init=lambda gen, dtype=None: vit.init(gen, cfg, dtype),
        loss_fn=lambda p, b, rng: vit.loss_fn(p, b, rng, cfg),
        make_batch=lambda gen, bs: data.synthetic_image_batch(
            gen, bs, shape=(cfg.image_size, cfg.image_size, cfg.channels), n_classes=cfg.n_classes
        ),
    )


def _bert(**overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import bert, common
    from distributedvolunteercomputing_tpu_torch.training import data

    cfg = dataclasses.replace(bert.BertConfig(), **overrides)
    return ModelBundle(
        name="bert_mlm",
        config=cfg,
        init=lambda gen, dtype=None: bert.init(gen, cfg, dtype),
        # The masked mean is over the whole batch: one call for every dp group.
        loss_fn=common.CoupledLoss(bert.loss_fn, cfg),
        make_batch=lambda gen, bs: data.synthetic_mlm_batch(
            gen, bs, seq_len=cfg.max_len, vocab=cfg.vocab, mask_id=bert.MASK_ID
        ),
    )


def _llama_lora(**overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import llama
    from distributedvolunteercomputing_tpu_torch.training import data

    cfg = dataclasses.replace(llama.LlamaConfig(), **overrides)
    lora_on = cfg.lora_rank > 0
    return ModelBundle(
        name="llama_lora",
        config=cfg,
        init=lambda gen, dtype=None: llama.init(gen, cfg, dtype),
        loss_fn=lambda p, b, rng: llama.loss_fn(p, b, rng, cfg),
        make_batch=lambda gen, bs: data.synthetic_lm_batch(gen, bs, seq_len=cfg.max_len, vocab=cfg.vocab),
        avg_select=llama.lora_subtree if lora_on else _identity_select,
        avg_merge=llama.with_lora_subtree if lora_on else _identity_merge,
    )


def _gpt2(preset: str, **overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import gpt2
    from distributedvolunteercomputing_tpu_torch.training import data

    base = gpt2.GPT2Config() if preset == "small" else getattr(gpt2.GPT2Config, preset)()
    cfg = dataclasses.replace(base, **overrides)
    return ModelBundle(
        name=f"gpt2_{preset}",
        config=cfg,
        init=lambda gen, dtype=None: gpt2.init(gen, cfg, dtype),
        loss_fn=lambda p, b, rng: gpt2.loss_fn(p, b, rng, cfg),
        make_batch=lambda gen, bs: data.synthetic_lm_batch(gen, bs, seq_len=cfg.max_len, vocab=cfg.vocab),
    )


def _gpt2_moe(**overrides: Any) -> ModelBundle:
    from distributedvolunteercomputing_tpu_torch.models import common, moe
    from distributedvolunteercomputing_tpu_torch.training import data

    cfg = dataclasses.replace(moe.GPT2MoEConfig(), **overrides)
    return ModelBundle(
        name="gpt2_moe",
        config=cfg,
        init=lambda gen, dtype=None: moe.init(gen, cfg, dtype),
        # A sharded step runs every dp group in one call: capacity, queue
        # order and the aux loss are over the whole batch.
        loss_fn=common.CoupledLoss(moe.loss_fn, cfg),
        make_batch=lambda gen, bs: data.synthetic_lm_batch(gen, bs, seq_len=cfg.max_len, vocab=cfg.vocab),
    )


_REGISTRY: Dict[str, Callable[..., ModelBundle]] = {
    "mnist_mlp": _mlp,
    "cifar10_resnet18": _resnet18,
    "cifar10_vit": _vit,
    "bert_mlm": _bert,
    "llama_lora": _llama_lora,
    "gpt2_small": lambda **kw: _gpt2("small", **kw),
    "gpt2_medium": lambda **kw: _gpt2("medium", **kw),
    "gpt2_large": lambda **kw: _gpt2("large", **kw),
    "gpt2_moe": _gpt2_moe,
}


def ported_models() -> list:
    return sorted(_REGISTRY)


def get_model(name: str, **overrides: Any) -> ModelBundle:
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**overrides)
