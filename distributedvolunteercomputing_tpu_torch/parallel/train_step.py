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

Ranks may share a card (``parallel/mesh.py``); their steps then run one
after the other on it. ``fsdp``, ``zero1``, a sequence-sharded batch and any
``sp``/``tp``/``pp``/``ep`` axis above 1 raise "not ported yet".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

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
        if len(state.replicas) != len(ranks):
            raise ValueError(f"{len(state.replicas)} replicas for a mesh of dp={len(ranks)}")
        grads, metrics = dp_grad_half(loss_fn, state, batches, accum_steps)
        shares = [grads if dev == ranks[0] else [None if g is None else g.to(dev) for g in grads] for dev in ranks]
        for st, g in zip(state.replicas, shares):
            apply_half(tx, st, g)
        return state, metrics

    return step
