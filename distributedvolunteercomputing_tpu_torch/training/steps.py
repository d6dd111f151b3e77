"""The per-volunteer train step (ported from
``distributedvolunteercomputing_tpu/training/steps.py``).

Forward + backward + optimizer update on the device. PyTorch runs eagerly,
so there is no jit: ``make_train_step`` returns a plain function. The step
updates the state in place (params, optimizer moments, step counter), the
counterpart of the reference donating its state to the jitted step.

Gradient-averaging mode splits the step in two (``make_grad_step``,
``make_apply_step``) so the gradients can cross the averager between the
backward pass and the optimizer; ``make_multi_step`` runs several fused
steps in one call (the trainer's ``steps_per_call``).
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


def clone_state(state: TrainState) -> TrainState:
    """A copy of the state that shares no tensor or generator with it."""

    def copy(obj: Any) -> Any:
        if isinstance(obj, torch.Tensor):
            return obj.clone()
        if isinstance(obj, dict):
            return {k: copy(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [copy(v) for v in obj]
        return obj

    rng = torch.Generator(device=state.rng.device).set_state(state.rng.get_state())
    return TrainState(copy(state.params), copy(state.opt_state), state.step, rng)


def make_train_step(
    loss_fn: LossFn, tx: Optimizer, accum_steps: int = 1, donate: bool = True
) -> Callable[[TrainState, Batch], Tuple[TrainState, Metrics]]:
    """``(state, batch) -> (state, metrics)``; the state is updated in place
    (the reference donating it), or with ``donate=False`` a copy is."""

    def step(state: TrainState, batch: Batch) -> Tuple[TrainState, Metrics]:
        if not donate:
            state = clone_state(state)
        grads, metrics = grad_half(loss_fn, state, batch, accum_steps)
        return apply_half(tx, state, grads), metrics

    return step


def make_multi_step(
    loss_fn: LossFn, tx: Optimizer, accum_steps: int = 1
) -> Callable[[TrainState, Batch], Tuple[TrainState, torch.Tensor]]:
    """N fused train steps in one call: ``(state, stacked_batches) ->
    (state, per_step_losses)``; the leading axis of every batch leaf is the
    step index.

    The reference scans the same traced body inside one compiled call; here
    it is a Python loop over the fused step, so each step is bit-equal to a
    single call of ``make_train_step`` (same ops, same order). The losses
    stay on the device as one stacked tensor: nothing in the chunk waits for
    the host (the optimizer's bias corrections and schedule are host
    floats). Capturing the chunk as a CUDA graph would take the per-step
    enqueue off the host; that is speed work this function does not do."""
    step = make_train_step(loss_fn, tx, accum_steps)

    def multi(state: TrainState, batches: Batch) -> Tuple[TrainState, torch.Tensor]:
        n = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(n):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()})
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return multi


def make_grad_step(
    loss_fn: LossFn, accum_steps: int = 1
) -> Callable[[TrainState, Batch], Tuple[Any, Metrics, torch.Generator]]:
    """Gradient-averaging mode, half 1: fwd/bwd without the update,
    ``(state, batch) -> (grads, metrics, rng)``. ``grads`` is a tree shaped
    like the params, None at a leaf the loss does not reach (LoRA's frozen
    base); ``rng`` is the state's step generator, for ``make_apply_step``."""

    def grad_step(state: TrainState, batch: Batch) -> Tuple[Any, Metrics, torch.Generator]:
        grads, metrics = grad_half(loss_fn, state, batch, accum_steps)
        return tree_unflatten(tree_flatten(state.params)[1], grads), metrics, state.rng

    return grad_step


def make_apply_step(tx: Optimizer) -> Callable[[TrainState, Any, torch.Generator], TrainState]:
    """Gradient-averaging mode, half 2: the optimizer update from (possibly
    swarm-averaged) grads, a tree shaped like the params (None leaves
    untouched), in place; ``rng`` becomes the state's step generator."""

    def apply_step(state: TrainState, grads: Any, rng: torch.Generator) -> TrainState:
        state.rng = rng
        return apply_half(tx, state, tree_flatten(grads)[0])

    return apply_step


def make_eval_step(loss_fn: LossFn) -> Callable[[Any, Batch, torch.Generator], Metrics]:
    @torch.no_grad()
    def ev(params: Any, batch: Batch, rng: torch.Generator) -> Metrics:
        return loss_fn(params, batch, rng)[1]

    return ev
