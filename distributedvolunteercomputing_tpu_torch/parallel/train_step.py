"""The data-parallel train step over a volunteer's mesh (ported from
``distributedvolunteercomputing_tpu/parallel/train_step.py``, DP only).

The reference compiles one GSPMD computation per slice: params replicated
over ``dp``, the batch's leading dimension split over it, and the gradient
psum emitted by XLA during backward. The port writes that out: each dp rank
holds a full replica of the params and the optimizer state
(``shard_train_state``), runs ``grad_half`` on its share of the batch
(``put_batch``), the ranks' gradients are averaged on rank 0 in rank order
(with equal shares this is the gradient of the full batch's mean loss, as
the psum gives it), and every replica applies the same clipped update to
the same averaged gradients, which leaves the replicas identical. The
reduction is plain torch, as the reference's is XLA's: no Pallas kernel
stands behind it.

Gradient-averaging mode splits that step (``make_sharded_grad_step``: the
ranks' mean gradients on rank 0, which the volunteer's round then averages
with the swarm's; ``make_sharded_apply_step``: every replica applies the
result), and ``make_sharded_multi_step`` runs several fused steps in one call.

Ranks may share a card (``parallel/mesh.py``); their steps then run one
after the other on it. ``fsdp``, ``zero1``, a sequence-sharded batch and any
``sp``/``tp``/``pp``/``ep`` axis above 1 raise "not ported yet".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.parallel.mesh import Mesh, mesh_shape
from distributedvolunteercomputing_tpu_torch.training.optim import Optimizer, global_norm
from distributedvolunteercomputing_tpu_torch.training.steps import (
    Batch,
    LossFn,
    Metrics,
    TrainState,
    apply_half,
    grad_half,
)
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten, tree_unflatten


def dp_ranks(mesh: Mesh) -> List[torch.device]:
    """The mesh's dp ranks; raises for any other axis above 1."""
    other = {k: v for k, v in mesh_shape(mesh).items() if k != "dp" and v > 1}
    if other:
        raise NotImplementedError(f"mesh axes {other} are not ported yet; ported: dp")
    return mesh.flat()


def _dp_only(zero1: bool = False, fsdp: bool = False, seq_sharded: bool = False) -> None:
    for name, on in (("zero1", zero1), ("fsdp", fsdp), ("seq_sharded", seq_sharded)):
        if on:
            raise NotImplementedError(f"{name} is not ported yet; ported: data-parallel replicas")


class DPTrainState:
    """One ``TrainState`` replica per dp rank; rank 0's is the one the host
    reads (``params``, ``step``)."""

    def __init__(self, replicas: List[TrainState]):
        self.replicas = replicas

    @property
    def params(self) -> Any:
        return self.replicas[0].params

    @property
    def step(self) -> int:
        return self.replicas[0].step


def _to(obj: Any, device: torch.device) -> Any:
    """A copy of a tree of tensors (dicts, lists, scalars) on ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _to(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to(v, device) for v in obj)
    return obj


def shard_train_state(
    state: TrainState, mesh: Mesh, zero1: bool = False, fsdp: bool = False
) -> Tuple[DPTrainState, None]:
    """A full replica of ``state`` (params, optimizer moments, step, rng
    seed) on every dp rank. Returns (state, None): the reference's second
    value, its param shardings, has no counterpart for replicas."""
    _dp_only(zero1, fsdp)
    replicas = []
    for dev in dp_ranks(mesh):
        rng = torch.Generator(device=dev).manual_seed(state.rng.initial_seed())
        replicas.append(TrainState(_to(state.params, dev), _to(state.opt_state, dev), state.step, rng))
    return DPTrainState(replicas), None


def put_batch(batch: Dict[str, Any], mesh: Mesh) -> List[Batch]:
    """The batch's leading dimension split evenly over the dp ranks, each
    share on its rank's device."""
    ranks = dp_ranks(mesh)
    out: List[Batch] = [{} for _ in ranks]
    for key, value in batch.items():
        value = torch.as_tensor(value)
        if value.shape[0] % len(ranks):
            raise ValueError(f"batch dim {value.shape[0]} of {key!r} does not split over dp={len(ranks)}")
        for share, part, dev in zip(out, value.chunk(len(ranks), dim=0), ranks):
            share[key] = part.to(dev, non_blocking=True)
    return out


def dp_grad_half(
    loss_fn: LossFn, state: DPTrainState, batches: List[Batch], accum_steps: int = 1
) -> Tuple[List[torch.Tensor], Metrics]:
    """Each rank's ``grad_half`` on its share, then the mean over ranks on
    rank 0, summed in rank order: (grads as leaves in tree order, metrics
    averaged over ranks, ``grad_norm`` of the averaged grads)."""
    if len(batches) != len(state.replicas):
        raise ValueError(f"{len(batches)} batch shares for {len(state.replicas)} replicas")
    per_rank = [grad_half(loss_fn, st, b, accum_steps) for st, b in zip(state.replicas, batches)]
    dev0 = per_rank[0][1]["loss"].device
    inv = 1.0 / len(per_rank)
    # A leaf the loss does not reach has None on every rank (training/steps.py).
    grads = [None if g is None else g.clone() for g in per_rank[0][0]]
    for g_r, _ in per_rank[1:]:
        for acc, g in zip(grads, g_r):
            if acc is not None:
                acc.add_(g.to(dev0))
    grads = [None if g is None else g * inv for g in grads]
    metrics: Metrics = {
        key: torch.stack([m[key].to(dev0) for _, m in per_rank]).sum(0) * inv
        for key in per_rank[0][1]
        if key != "grad_norm"
    }
    metrics["grad_norm"] = global_norm(grads)
    return grads, metrics


def _apply_all(tx: Optimizer, state: DPTrainState, grads: List[Optional[torch.Tensor]], ranks) -> None:
    """Every replica applies the same update to the same gradients (rank
    0's tensors copied to each other rank), in place."""
    if len(state.replicas) != len(ranks):
        raise ValueError(f"{len(state.replicas)} replicas for a mesh of dp={len(ranks)}")
    shares = [grads if dev == ranks[0] else [None if g is None else g.to(dev) for g in grads] for dev in ranks]
    for st, g in zip(state.replicas, shares):
        apply_half(tx, st, g)


def make_sharded_train_step(
    loss_fn: LossFn,
    tx: Optimizer,
    mesh: Mesh,
    seq_sharded_batch: bool = False,
    accum_steps: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
) -> Callable[[DPTrainState, List[Batch]], Tuple[DPTrainState, Metrics]]:
    """``(state, batches) -> (state, metrics)``: ``state`` from
    ``shard_train_state``, ``batches`` from ``put_batch``; updated in place
    (the counterpart of the reference donating its state)."""
    _dp_only(zero1, fsdp, seq_sharded_batch)
    ranks = dp_ranks(mesh)

    def step(state: DPTrainState, batches: List[Batch]) -> Tuple[DPTrainState, Metrics]:
        grads, metrics = dp_grad_half(loss_fn, state, batches, accum_steps)
        _apply_all(tx, state, grads, ranks)
        return state, metrics

    return step


def make_sharded_multi_step(
    loss_fn: LossFn,
    tx: Optimizer,
    mesh: Mesh,
    seq_sharded_batch: bool = False,
    accum_steps: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
) -> Callable[[DPTrainState, Batch], Tuple[DPTrainState, torch.Tensor]]:
    """N steps of ``make_sharded_train_step`` in one call: ``(state,
    stacked_batches) -> (state, per_step_losses)``, the leading axis of every
    host batch leaf the step index; each step's batch is split over the
    ranks as ``put_batch`` splits it. The losses stay on rank 0's device."""
    step = make_sharded_train_step(
        loss_fn, tx, mesh, seq_sharded_batch=seq_sharded_batch, accum_steps=accum_steps, zero1=zero1, fsdp=fsdp,
    )

    def multi(state: DPTrainState, batches: Batch) -> Tuple[DPTrainState, torch.Tensor]:
        n = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(n):
            state, metrics = step(state, put_batch({k: v[i] for k, v in batches.items()}, mesh))
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return multi


def make_sharded_grad_step(
    loss_fn: LossFn, mesh: Mesh, accum_steps: int = 1
) -> Callable[[DPTrainState, List[Batch]], Tuple[Any, Metrics, torch.Generator]]:
    """Gradient-averaging mode on the mesh, half 1: ``(state, batches) ->
    (grads, metrics, rng)``, the ranks' mean gradients on rank 0 as a tree
    shaped like the params (None at a leaf the loss does not reach), and
    rank 0's step generator."""
    dp_ranks(mesh)

    def grad_step(state: DPTrainState, batches: List[Batch]) -> Tuple[Any, Metrics, torch.Generator]:
        grads, metrics = dp_grad_half(loss_fn, state, batches, accum_steps)
        return tree_unflatten(tree_flatten(state.params)[1], grads), metrics, state.replicas[0].rng

    return grad_step


def make_sharded_apply_step(tx: Optimizer, mesh: Mesh) -> Callable[[DPTrainState, Any, torch.Generator], DPTrainState]:
    """Gradient-averaging mode on the mesh, half 2: every replica applies the
    (possibly swarm-averaged) gradients, a tree shaped like the params, in
    place. Each replica keeps its own step generator; ``rng`` is rank 0's."""
    ranks = dp_ranks(mesh)

    def apply_step(state: DPTrainState, grads: Any, rng: torch.Generator) -> DPTrainState:
        _apply_all(tx, state, tree_flatten(grads)[0], ranks)
        return state

    return apply_step
