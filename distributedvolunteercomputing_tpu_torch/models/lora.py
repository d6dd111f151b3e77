"""LoRA adapters as separate tree leaves (ported from
``distributedvolunteercomputing_tpu/models/lora.py``).

Capability config 5 finetunes Llama-2-7B with LoRA under Byzantine-tolerant
averaging. The adapters live in their own subtree, so the swarm averages only
them: 4,194,304 params at rank 8 on q and v over 32 layers, against the
base's 6.74 B.
"""

from __future__ import annotations

from typing import Dict

import torch

from distributedvolunteercomputing_tpu_torch.models import common


def lora_init(gen: torch.Generator, d_in: int, d_out: int, rank: int) -> Dict[str, torch.Tensor]:
    # A ~ N(0, 1/d_in), B = 0: adapters start as identity (zero delta).
    return {
        "a": common._normal(gen, (d_in, rank), 1.0 / d_in**0.5),
        "b": torch.zeros((rank, d_out), dtype=torch.float32, device=gen.device),
    }


def lora_delta(p: Dict[str, torch.Tensor], x: torch.Tensor, alpha: float, rank: int) -> torch.Tensor:
    scale = alpha / rank
    return ((x @ p["a"].to(x.dtype)) @ p["b"].to(x.dtype)) * scale
