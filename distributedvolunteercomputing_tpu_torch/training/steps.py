"""The per-volunteer train step (ported from
``distributedvolunteercomputing_tpu/training/steps.py``).

Forward + backward + optimizer update on the device. PyTorch runs eagerly,
so there is no jit: ``make_train_step`` returns a plain function. The step
updates the state in place (params, optimizer moments, step counter), the
counterpart of the reference donating its state to the jitted step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.training.optim import Optimizer, global_norm
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten, tree_unflatten

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]
LossFn = Callable[[Any, Batch, torch.Generator], Tuple[torch.Tensor, Metrics]]


@dataclasses.dataclass
class TrainState:
    """Everything the volunteer owns on the device: params, opt state, step, rng."""

    params: Any
    opt_state: Any
    step: int
    rng: torch.Generator

    @classmethod
    def create(cls, params: Any, tx: Optimizer, rng: torch.Generator) -> "TrainState":
        return cls(params=params, opt_state=tx.init(params), step=0, rng=rng)


def _value_and_grad(loss_fn: LossFn, params: Any, batch: Batch, rng: torch.Generator):
    """(grads as leaves in tree order, metrics). A leaf the loss does not
    reach (a frozen base the loss detaches) gets None, never a buffer of
    zeros: the reference's zero gradient, which adds nothing to the norm
    and, with weight decay 0, leaves the leaf bit-unchanged."""
    leaves, treedef = tree_flatten(params)
    with torch.enable_grad():
        xs = [p.detach().requires_grad_(True) for p in leaves]
        loss, metrics = loss_fn(tree_unflatten(treedef, xs), batch, rng)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def _add(a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return b if a is None else a if b is None else a + b


def grad_half(
    loss_fn: LossFn, state: TrainState, batch: Batch, accum_steps: int = 1
) -> Tuple[List[torch.Tensor], Metrics]:
    """fwd/bwd half of the step: (grads as leaves in tree order, None for a
    leaf the loss does not reach; metrics).

    ``accum_steps > 1`` splits the batch's leading dim into microbatches and
    averages their grads and metrics: one big batch's semantics, one
    microbatch's activation memory."""
    if accum_steps <= 1:
        grads, metrics = _value_and_grad(loss_fn, state.params, batch, state.rng)
    else:
        g_sum: List[torch.Tensor] = []
        m_sum: Metrics = {}
        micro = {k: v.chunk(accum_steps, dim=0) for k, v in batch.items()}
        for i in range(accum_steps):
            g, m = _value_and_grad(loss_fn, state.params, {k: v[i] for k, v in micro.items()}, state.rng)
            g_sum = g if not g_sum else [_add(a, b) for a, b in zip(g_sum, g)]
            m_sum = m if not m_sum else {k: m_sum[k] + m[k] for k in m}
        inv = 1.0 / accum_steps
        grads = [None if g is None else g * inv for g in g_sum]
        metrics = {k: v * inv for k, v in m_sum.items()}
    metrics["grad_norm"] = global_norm(grads)
    return grads, metrics


def apply_half(tx: Optimizer, state: TrainState, grads: List[torch.Tensor]) -> TrainState:
    """Optimizer-update half of the step (in place)."""
    tx.apply(state.params, grads, state.opt_state)
    state.step += 1
    return state


def make_train_step(
    loss_fn: LossFn, tx: Optimizer, accum_steps: int = 1
) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """``(state, batch) -> (state, metrics)``."""

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        grads, metrics = grad_half(loss_fn, state, batch, accum_steps)
        return apply_half(tx, state, grads), metrics

    return step


def make_eval_step(loss_fn: LossFn) -> Callable[[Any, Batch, torch.Generator], Metrics]:
    @torch.no_grad()
    def ev(params: Any, batch: Batch, rng: torch.Generator) -> Metrics:
        return loss_fn(params, batch, rng)[1]

    return ev
