"""Optimizers with optax's semantics (ported from
``distributedvolunteercomputing_tpu/training/optim.py``).

``make_optimizer`` builds what the reference builds with optax:
``chain(clip_by_global_norm(grad_clip), adamw | adam | sgd(schedule))``. The
details that differ from PyTorch's own optimizers are kept:

- clipping scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- the learning rate of update ``k`` (0-based) is ``schedule(k)``; with
  ``total_steps`` it is ``warmup_cosine_decay_schedule(0, lr, warmup=1,
  decay_steps=total_steps)``, so the first update has rate 0 and the cosine
  runs over ``k - 1`` for ``total_steps - 1`` steps;
- adam's bias correction uses the incremented count, eps outside the sqrt;
  ``weight_decay`` defaults to 0 (optax's own default of 1e-4 is not used).

Updates are applied to the parameter tensors in place (the counterpart of
the reference donating its state to the jitted step).

Frozen leaves: a leaf whose gradient is None (the loss does not reach it,
as LoRA's base) gets no moments and no update. The moments of a leaf are
made, as zeros, at its first gradient; ``init`` makes none. optax keeps
zero moments for every leaf, which its zero gradients leave at zero, so
the params and the live moments are the same. The state's layout differs:
``mu`` / ``nu`` / ``trace`` hold None for a leaf without moments (the
checkpoint saves and restores that). optax's weight decay would still move
a frozen leaf, so ``adamw`` with ``weight_decay > 0`` raises on one.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_leaves

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def fn(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return fn


def _warmup_cosine(peak: float, warmup: int, decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps), end 0."""
    warm = _linear(0.0, peak, warmup)
    span = decay_steps - warmup

    def fn(count: int) -> float:
        if count < warmup:
            return warm(count)
        t = min(count - warmup, span)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / span))

    return fn


def global_norm(tensors: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt(sum of squares) over all tensors, in f32 (optax.global_norm);
    None (a frozen leaf's zero gradient) adds nothing."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors if t is not None])
    )


class Optimizer:
    """``init(params) -> state``; ``apply(params, grads, state)`` clips,
    computes the update and adds it to the params in place."""

    def __init__(
        self,
        name: str,
        schedule: Schedule,
        weight_decay: float,
        grad_clip: Optional[float],
        momentum: float,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.name = name
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Any) -> Dict[str, Any]:
        """Moments as None per leaf: each is made at the leaf's first gradient."""
        n = len(tree_leaves(params))
        names = ("mu", "nu") if self.name in ("adam", "adamw") else ("trace",)
        return {"count": 0, **{name: [None] * n for name in names}}

    @staticmethod
    def _moments(state: Dict[str, Any], names, leaves, grads) -> None:
        """Zero moments for every leaf that has a gradient and none yet."""
        for name in names:
            slots = state[name]
            if len(slots) != len(leaves):
                raise ValueError(f"optimizer state holds {len(slots)} {name} slots for {len(leaves)} leaves")
            for i, (p, g) in enumerate(zip(leaves, grads)):
                if g is not None and slots[i] is None:
                    slots[i] = torch.zeros_like(p)

    def apply(self, params: Any, grads: List[Optional[torch.Tensor]], state: Dict[str, Any]) -> None:
        self.apply_leaves(tree_leaves(params), grads, state)

    @torch.no_grad()
    def apply_leaves(
        self,
        leaves: List[torch.Tensor],
        grads: List[Optional[torch.Tensor]],
        state: Dict[str, Any],
        g_norm: Optional[torch.Tensor] = None,
    ) -> None:
        """``apply`` over a list of param tensors (a mesh rank's slices). The
        clip uses ``g_norm`` when given (the sharded step's norm over the
        whole tree), else the norm of ``grads``."""
        if self.name == "adamw" and self.weight_decay and any(g is None for g in grads):
            raise ValueError(
                "adamw with weight_decay > 0 on a frozen leaf: optax would decay it; "
                "the port keeps frozen leaves unchanged and supports weight_decay 0 there"
            )
        if self.grad_clip:
            # Selected on the device: no host sync per step.
            g_norm = global_norm(grads) if g_norm is None else g_norm
            keep = g_norm < self.grad_clip
            grads = [
                None if g is None else torch.where(keep, g, g / g_norm.to(g.dtype) * self.grad_clip)
                for g in grads
            ]
        count = state["count"]
        lr = self.schedule(count)
        if self.name in ("adam", "adamw"):
            self._moments(state, ("mu", "nu"), leaves, grads)
            # Bias corrections rounded to f32 as optax computes them
            # (1 - 0.999 ** 1 is 4.7e-5 off 0.001 in f32).
            c = count + 1
            bc1 = float(np.float32(1.0) - np.float32(self.b1) ** c)
            bc2 = float(np.float32(1.0) - np.float32(self.b2) ** c)
            for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
                if g is None:
                    continue
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if self.name == "adamw" and self.weight_decay:
                    upd = upd + self.weight_decay * p
                p.add_((upd * -lr).to(p.dtype))
        else:
            self._moments(state, ("trace",), leaves, grads)
            for p, g, tr in zip(leaves, grads, state["trace"]):
                if g is None:
                    continue
                tr.mul_(self.momentum).add_(g)
                p.add_((tr * -lr).to(p.dtype))
        state["count"] = count + 1


def make_optimizer(
    name: str = "adamw",
    lr: float = 1e-3,
    weight_decay: float = 0.0,
    warmup_steps: int = 0,
    total_steps: Optional[int] = None,
    grad_clip: Optional[float] = 1.0,
    momentum: float = 0.9,
) -> Optimizer:
    if name not in ("adamw", "adam", "sgd"):
        raise ValueError(f"unknown optimizer {name!r}")
    # decay_steps must be strictly past warmup (warmup is clamped to >= 1).
    if total_steps and total_steps > max(warmup_steps, 1):
        schedule = _warmup_cosine(lr, max(warmup_steps, 1), total_steps)
    elif warmup_steps:
        schedule = _linear(0.0, lr, warmup_steps)
    else:
        schedule = lambda count: lr  # noqa: E731
    return Optimizer(name, schedule, weight_decay, grad_clip, momentum)
