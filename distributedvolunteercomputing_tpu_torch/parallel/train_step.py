"""The sharded train step over a volunteer's mesh (ported from
``distributedvolunteercomputing_tpu/parallel/train_step.py``).

The reference compiles one GSPMD computation per slice from sharding
annotations. The port writes the placement and the collectives out:

- ``shard_train_state`` places every leaf by its rule spec
  (``parallel/sharding.py``): each rank holds exactly its slice, a leaf
  replicated over an axis is a full copy on each rank of it. Optimizer
  moments keep their values; with ``zero1`` they are also sharded over dp,
  with ``fsdp`` the params are too.
- The step runs each dp group's share of the batch (``put_batch``) through
  the model on a view of the params (``models/common.py``): tensor-parallel
  leaves as per-rank ``Slices``, stacked leaves gathered one layer at a time
  inside the checkpointed body (over dp under FSDP). A model whose loss
  couples the dp groups (``loss_fn.dp_coupled``: MoE's global capacity and
  aux loss) gets every group in one call. The loss is the mean over groups,
  and ONE backward pass through that graph gives each rank's copy of each
  slice its part of the gradient; the gradient of a slice is the sum over
  the ranks holding a copy (the reference's psum over dp, and the
  reduce-scatter back to FSDP's owners), added in rank order.
- The clip's global norm counts each distinct slice once. Each rank then
  applies the optimizer to its own slices: under ZeRO-1 to its dp slice of
  the params and moments, after which the updated slices are gathered back
  into every replica. Moments and FSDP params stay on their dp slices.

Gradient-averaging mode splits that step (``make_sharded_grad_step``: the
whole gradients assembled on rank 0, which the volunteer's round averages;
``make_sharded_apply_step``: every rank applies its slices of the result),
and ``make_sharded_multi_step`` runs several fused steps in one call.

Ranks may share a card (``parallel/mesh.py``); their work then runs one
after the other on it. Sequence parallelism (``sp`` > 1, a sequence-sharded
batch, ``sp_impl``) and the pipeline (``pp`` > 1) raise "not ported yet".
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.models.common import Slices, Stack
from distributedvolunteercomputing_tpu_torch.parallel.mesh import Mesh, mesh_shape
from distributedvolunteercomputing_tpu_torch.parallel.sharding import (
    Sharded,
    ShardedTensor,
    is_stacked,
    leaf_paths,
    make_fsdp_param_shardings,
    make_param_shardings,
    make_zero1_opt_shardings,
)
from distributedvolunteercomputing_tpu_torch.training.optim import Optimizer, global_norm
from distributedvolunteercomputing_tpu_torch.training.steps import Batch, LossFn, Metrics, TrainState
from distributedvolunteercomputing_tpu_torch.utils.pytree import tree_flatten, tree_map, tree_unflatten

PORTED_AXES = ("dp", "ep", "tp")


def check_mesh(mesh: Mesh) -> None:
    """Raises for the axes whose parallelism is not ported (sp, pp)."""
    other = {k: v for k, v in mesh_shape(mesh).items() if k not in PORTED_AXES and v > 1}
    if other:
        raise NotImplementedError(f"mesh axes {other} are not ported yet; ported: {', '.join(PORTED_AXES)}")


def check_sequence_options(seq_sharded: bool = False, sp_impl: str = "ring") -> None:
    if seq_sharded:
        raise NotImplementedError("seq_sharded (sequence parallelism) is not ported yet")
    if sp_impl != "ring":
        raise NotImplementedError(f"sp_impl={sp_impl!r} (sequence parallelism) is not ported yet")


class _Layout:
    """Rank bookkeeping of a (dp, 1, 1, ep, tp) mesh."""

    def __init__(self, mesh: Mesh):
        check_mesh(mesh)
        sizes = mesh_shape(mesh)
        self.dp, self.ep, self.tp = sizes["dp"], sizes["ep"], sizes["tp"]
        self.devices = mesh.flat()
        self.rank = {}
        for k, c in enumerate(np.ndindex(*mesh.devices.shape)):
            coords = dict(zip(mesh.axis_names, c))
            self.rank[(coords["dp"], coords["ep"], coords["tp"])] = k
        self.dp_of = {k: d for (d, _, _), k in self.rank.items()}

    def leader(self, g: int) -> int:
        return self.rank[(g, 0, 0)]


class ShardedTrainState:
    """The train state over the mesh: ``params`` a tree of ``ShardedTensor``,
    ``opt_state`` the optimizer's dict with a ``ShardedTensor`` (or None, a
    moment not made yet) per leaf, one step generator per rank."""

    def __init__(self, mesh: Mesh, params: Any, opt_state: Dict[str, Any], step: int,
                 rngs: List[torch.Generator], opt_shardings: List[Sharded], zero1: bool, fsdp: bool):
        self.mesh, self.params, self.opt_state, self.step = mesh, params, opt_state, step
        self.rngs, self.opt_shardings, self.zero1, self.fsdp = rngs, opt_shardings, zero1, fsdp
        self.layout = _Layout(mesh)

    @property
    def rng(self) -> torch.Generator:
        return self.rngs[0]

    def leaves(self) -> List[ShardedTensor]:
        return tree_flatten(self.params)[0]

    def moment_names(self) -> List[str]:
        return [k for k, v in self.opt_state.items() if isinstance(v, list)]

    def bytes_per_rank(self) -> Dict[str, List[int]]:
        """Resident bytes of each rank's param and moment slices."""
        n = len(self.layout.devices)
        params = [sum(leaf.nbytes_per_rank()[k] for leaf in self.leaves()) for k in range(n)]
        moments = [sum(m.nbytes_per_rank()[k] for name in self.moment_names() for m in self.opt_state[name]
                       if m is not None) for k in range(n)]
        return {"params": params, "moments": moments}

    def clone(self) -> "ShardedTrainState":
        def copy(x):
            return None if x is None else ShardedTensor(x.sharding, [s.clone() for s in x.shards])

        opt = {k: [copy(m) for m in v] if isinstance(v, list) else v for k, v in self.opt_state.items()}
        rngs = [torch.Generator(device=r.device).set_state(r.get_state()) for r in self.rngs]
        return ShardedTrainState(self.mesh, tree_map(copy, self.params), opt, self.step, rngs,
                                 self.opt_shardings, self.zero1, self.fsdp)


def shard_train_state(
    state: TrainState, mesh: Mesh, tx: Any = None, zero1: bool = False, fsdp: bool = False
) -> Tuple[ShardedTrainState, Any]:
    """Place a one-device ``TrainState`` onto the mesh: params by their rule
    specs (dp-sharded too with ``fsdp``), moments keeping their values (a
    warm or restored optimizer stays warm) placed like their params, or
    dp-sharded with ``zero1`` or ``fsdp``. ``tx`` is unused (the reference's
    call signature). Returns (state, param shardings)."""
    layout = _Layout(mesh)
    param_sh = make_fsdp_param_shardings(mesh, state.params) if fsdp else make_param_shardings(mesh, state.params)
    opt_sh = make_zero1_opt_shardings(mesh, state.params) if (zero1 or fsdp) else param_sh
    params = tree_map(lambda x, s: ShardedTensor.place(s, x), state.params, param_sh)
    opt_list = tree_flatten(opt_sh)[0]
    opt = {}
    for name, v in state.opt_state.items():
        if isinstance(v, list):
            opt[name] = [None if m is None else ShardedTensor.place(s, m) for m, s in zip(v, opt_list)]
        else:
            opt[name] = v
    seed = state.rng.initial_seed()
    rngs = [torch.Generator(device=dev).manual_seed(seed) for dev in layout.devices]
    return ShardedTrainState(mesh, params, opt, state.step, rngs, opt_list, zero1, fsdp), param_sh


def put_batch(batch: Dict[str, Any], mesh: Mesh, seq_sharded: bool = False) -> List[Batch]:
    """The batch's leading dimension split evenly over the dp groups, each
    share on its group's leader (tokens are replicated over ep and tp; the
    ranks that need them take them from there)."""
    check_sequence_options(seq_sharded)
    layout = _Layout(mesh)
    leaders = [layout.devices[layout.leader(g)] for g in range(layout.dp)]
    out: List[Batch] = [{} for _ in leaders]
    for key, value in batch.items():
        value = torch.as_tensor(value)
        if value.shape[0] % layout.dp:
            raise ValueError(f"batch dim {value.shape[0]} of {key!r} does not split over dp={layout.dp}")
        for share, part, dev in zip(out, value.chunk(layout.dp, dim=0), leaders):
            share[key] = part.to(dev, non_blocking=True)
    return out


# -- the group views ---------------------------------------------------------


def _padded(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def _dp_gather(shards: List[torch.Tensor], sh: Sharded, lay: _Layout, e: int, t: int, i: Optional[int], dev):
    """A dp-sharded leaf (layer ``i`` of it when stacked) gathered for a
    rank of column (e, t) from the ranks (k, e, t) that own its dp slices:
    under FSDP inside the checkpointed layer, so the gathered copy lives
    for one layer and the recompute gathers it again; its gradient flows
    back to the owners' slices."""
    d = _padded(sh.spec, len(sh.shape)).index("dp")
    srcs = [shards[lay.rank[(k, e, t)]] for k in range(lay.dp)]
    if i is not None and d == 0:  # the layer axis over dp: layer i's owner
        blk = sh.shape[0] // lay.dp
        k, j = divmod(i, blk)
        return srcs[k][j].to(dev)
    pieces = [(s if i is None else s[i]).to(dev) for s in srcs]
    return torch.cat(pieces, d if i is None else d - 1)


def _materialize(shards: List[torch.Tensor], sh: Sharded, lay: _Layout, g: int, i: Optional[int]):
    """Group g's view of a leaf (layer ``i`` when stacked): a tensor on the
    group's leader when the group holds it replicated, else ``Slices`` over
    the (ep, tp) ranks its spec splits it over."""
    spec = _padded(sh.spec, len(sh.shape))
    es = range(lay.ep) if "ep" in spec else (0,)
    ts = range(lay.tp) if "tp" in spec else (0,)
    parts, devs, ranks = [], [], []
    for e in es:
        for t in ts:
            r = lay.rank[(g, e, t)]
            dev = lay.devices[r]
            if "dp" in spec:
                parts.append(_dp_gather(shards, sh, lay, e, t, i, dev))
            else:
                parts.append(shards[r] if i is None else shards[r][i])
            devs.append(dev)
            ranks.append((e, t))
    if "ep" not in spec and "tp" not in spec:
        return parts[0]
    off = 0 if i is None else 1
    dims = {axis: (spec.index(axis) - off if axis in spec else None) for axis in ("ep", "tp")}
    return Slices(parts, devs, ranks, dims, {"ep": lay.ep, "tp": lay.tp}, lay.devices[lay.leader(g)])


def _group_view(treedef, paths: List[str], xs: List[List[torch.Tensor]], shardings: List[Sharded],
                lay: _Layout, g: int) -> Any:
    out = []
    for path, shards, sh in zip(paths, xs, shardings):
        if is_stacked(path):
            out.append(Stack(lambda i, shards=shards, sh=sh: _materialize(shards, sh, lay, g, i), sh.shape))
        else:
            out.append(_materialize(shards, sh, lay, g, None))
    return tree_unflatten(treedef, out)


def _mesh_loss(loss_fn: LossFn, state: ShardedTrainState, xs, batches: List[Batch]):
    """(loss of the whole batch on rank 0's device, metrics there) from the
    per-rank tensors ``xs`` (per leaf, per rank)."""
    lay = state.layout
    leaves, treedef = tree_flatten(state.params)
    paths = leaf_paths(state.params)
    shardings = [leaf.sharding for leaf in leaves]
    views = [_group_view(treedef, paths, xs, shardings, lay, g) for g in range(lay.dp)]
    if len(batches) != lay.dp:
        raise ValueError(f"{len(batches)} batch shares for dp={lay.dp}")
    if getattr(loss_fn, "dp_coupled", False):
        return loss_fn(views, batches, state.rngs[0])
    dev0 = lay.devices[0]
    outs = [loss_fn(v, b, state.rngs[lay.leader(g)]) for g, (v, b) in enumerate(zip(views, batches))]
    inv = 1.0 / len(outs)
    loss = torch.stack([l.to(dev0) for l, _ in outs]).sum(0) * inv
    metrics = {k: torch.stack([m[k].detach().to(dev0) for _, m in outs]).sum(0) * inv for k in outs[0][1]}
    return loss, metrics


def _rank_grads(loss_fn: LossFn, state: ShardedTrainState, batches: List[Batch]):
    """Per leaf, per rank: the gradient of that rank's copy (None where the
    copy took no part), and the metrics."""
    leaves = state.leaves()
    with torch.enable_grad():
        xs = [[s.detach().requires_grad_(True) for s in leaf.shards] for leaf in leaves]
        loss, metrics = _mesh_loss(loss_fn, state, xs, batches)
        flat = [t for row in xs for t in row]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    n = len(state.layout.devices)
    return [list(grads[i * n:(i + 1) * n]) for i in range(len(leaves))], {k: v.detach() for k, v in metrics.items()}


def _slice_grads(per_rank: List[Optional[torch.Tensor]], sh: Sharded) -> List[Optional[torch.Tensor]]:
    """Each rank's gradient of its slice: the sum, in rank order, of the
    gradients of every copy of that slice, on each holder's device."""
    out: List[Optional[torch.Tensor]] = [None] * len(per_rank)
    for holders in sh.holders().values():
        acc = None
        for r in holders:
            g = per_rank[r]
            if g is not None:
                acc = g.clone() if acc is None else acc.add_(g.to(acc.device))
        if acc is not None:
            for r in holders:
                out[r] = acc.to(sh.devices[r])
    return out


def _grad_half(loss_fn: LossFn, state: ShardedTrainState, batches: List[Batch], accum_steps: int = 1):
    """(per leaf, per rank slice gradients; metrics with ``grad_norm``)."""
    if accum_steps <= 1:
        per_rank, metrics = _rank_grads(loss_fn, state, batches)
    else:
        micro = [{k: v.chunk(accum_steps, dim=0) for k, v in b.items()} for b in batches]
        per_rank, metrics = None, None
        for i in range(accum_steps):
            g, m = _rank_grads(loss_fn, state, [{k: v[i] for k, v in mb.items()} for mb in micro])
            if per_rank is None:
                per_rank, metrics = g, m
            else:
                per_rank = [[b if a is None else a if b is None else a + b for a, b in zip(ra, rb)]
                            for ra, rb in zip(per_rank, g)]
                metrics = {k: metrics[k] + m[k] for k in m}
        inv = 1.0 / accum_steps
        per_rank = [[None if x is None else x * inv for x in row] for row in per_rank]
        metrics = {k: v * inv for k, v in metrics.items()}
    leaves = state.leaves()
    grads = [_slice_grads(g, leaf.sharding) for g, leaf in zip(per_rank, leaves)]
    metrics["grad_norm"] = _slice_norm(grads, leaves, state.layout.devices[0])
    return grads, metrics


def _slice_norm(grads, leaves, dev0) -> torch.Tensor:
    """The global norm over the whole tree: each distinct slice once."""
    norms = []
    for g, leaf in zip(grads, leaves):
        for holders in leaf.sharding.holders().values():
            x = g[holders[0]]
            if x is not None:
                norms.append(torch.linalg.vector_norm(x.float()).to(dev0))
    return torch.linalg.vector_norm(torch.stack(norms))


def _zero1_split(state: ShardedTrainState, i: int) -> Optional[Tuple[int, int]]:
    """(dim, block) of leaf i's dp slice under ZeRO-1 (its moments are
    dp-sharded where the param is not), else None."""
    p_spec = _padded(state.leaves()[i].sharding.spec, len(state.leaves()[i].shape))
    o_spec = _padded(state.opt_shardings[i].spec, len(state.leaves()[i].shape))
    for dim, (a, b) in enumerate(zip(p_spec, o_spec)):
        if b == "dp" and a != "dp":
            return dim, state.leaves()[i].shape[dim] // state.layout.dp
    return None


def _apply(tx: Optimizer, state: ShardedTrainState, grads: List[List[Optional[torch.Tensor]]],
           g_norm: torch.Tensor) -> None:
    """Every rank applies the update to its own slices, in place; ZeRO-1's
    updated dp slices are then gathered into every replica."""
    leaves = state.leaves()
    lay = state.layout
    names = state.moment_names()
    for i, leaf in enumerate(leaves):  # moments at a leaf's first gradient (training/optim.py)
        if any(g is not None for g in grads[i]):
            for name in names:
                if state.opt_state[name][i] is None:
                    sh = state.opt_shardings[i]
                    state.opt_state[name][i] = ShardedTensor(
                        sh, [torch.zeros(sh.local_shape(), dtype=leaf.dtype, device=d) for d in sh.devices])
    splits = [_zero1_split(state, i) if state.zero1 and not state.fsdp else None for i in range(len(leaves))]
    count = state.opt_state["count"]
    for k, dev in enumerate(lay.devices):
        a = lay.dp_of[k]
        ps, gs = [], []
        for i, leaf in enumerate(leaves):
            p, g = leaf.shards[k], grads[i][k]
            if splits[i] is not None:
                dim, blk = splits[i]
                p = p.narrow(dim, a * blk, blk)
                g = None if g is None else g.narrow(dim, a * blk, blk)
            ps.append(p)
            gs.append(g)
        st = {"count": count, **{n: [None if m is None else m.shards[k] for m in state.opt_state[n]] for n in names}}
        tx.apply_leaves(ps, gs, st, g_norm=g_norm.to(dev))
    state.opt_state["count"] = count + 1
    with torch.no_grad():
        for i, leaf in enumerate(leaves):
            if splits[i] is None or all(g is None for g in grads[i]):
                continue
            dim, blk = splits[i]
            for (d, e, t), k in lay.rank.items():
                for d2 in range(lay.dp):
                    if d2 != d:
                        src = leaf.shards[lay.rank[(d2, e, t)]]
                        leaf.shards[k].narrow(dim, d2 * blk, blk).copy_(src.narrow(dim, d2 * blk, blk))
    state.step += 1


def _check_layout(state: ShardedTrainState, zero1: bool, fsdp: bool) -> None:
    if (bool(state.zero1), bool(state.fsdp)) != (bool(zero1), bool(fsdp)):
        raise ValueError(f"state placed with zero1={state.zero1}, fsdp={state.fsdp}; "
                         f"step built with zero1={zero1}, fsdp={fsdp}")


def dp_grad_half(loss_fn: LossFn, state: ShardedTrainState, batches: List[Batch], accum_steps: int = 1):
    """The step's fwd/bwd over the mesh: (the whole gradients on rank 0, as
    leaves in tree order, None at a leaf the loss does not reach; metrics
    with ``grad_norm``)."""
    grads, metrics = _grad_half(loss_fn, state, batches, accum_steps)
    dev0 = state.layout.devices[0]
    return [leaf.sharding.assemble(g, dev0) for g, leaf in zip(grads, state.leaves())], metrics


def make_sharded_train_step(
    loss_fn: LossFn,
    tx: Optimizer,
    mesh: Mesh,
    donate: bool = True,
    seq_sharded_batch: bool = False,
    accum_steps: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
    sp_impl: str = "ring",
) -> Callable[[ShardedTrainState, List[Batch]], Tuple[ShardedTrainState, Metrics]]:
    """``(state, batches) -> (state, metrics)``: ``state`` from
    ``shard_train_state`` (with the same ``zero1`` / ``fsdp``), ``batches``
    from ``put_batch``. Updated in place (the reference donating its state);
    ``donate=False`` steps a copy and leaves the input as it was."""
    check_sequence_options(seq_sharded_batch, sp_impl)
    check_mesh(mesh)

    def step(state: ShardedTrainState, batches: List[Batch]) -> Tuple[ShardedTrainState, Metrics]:
        _check_layout(state, zero1, fsdp)
        if not donate:
            state = state.clone()
        grads, metrics = _grad_half(loss_fn, state, batches, accum_steps)
        _apply(tx, state, grads, metrics["grad_norm"])
        return state, metrics

    return step


def make_sharded_multi_step(
    loss_fn: LossFn,
    tx: Optimizer,
    mesh: Mesh,
    donate: bool = True,
    seq_sharded_batch: bool = False,
    accum_steps: int = 1,
    zero1: bool = False,
    fsdp: bool = False,
    sp_impl: str = "ring",
) -> Callable[[ShardedTrainState, Batch], Tuple[ShardedTrainState, torch.Tensor]]:
    """N steps of ``make_sharded_train_step`` in one call: ``(state,
    stacked_batches) -> (state, per_step_losses)``, the leading axis of every
    host batch leaf the step index; each step's batch is split as
    ``put_batch`` splits it. The losses stay on rank 0's device."""
    step = make_sharded_train_step(loss_fn, tx, mesh, donate=donate, seq_sharded_batch=seq_sharded_batch,
                                   accum_steps=accum_steps, zero1=zero1, fsdp=fsdp, sp_impl=sp_impl)

    def multi(state: ShardedTrainState, batches: Batch) -> Tuple[ShardedTrainState, torch.Tensor]:
        n = next(iter(batches.values())).shape[0]
        losses = []
        for i in range(n):
            state, metrics = step(state, put_batch({k: v[i] for k, v in batches.items()}, mesh))
            losses.append(metrics["loss"])
        return state, torch.stack(losses)

    return multi


def make_sharded_grad_step(
    loss_fn: LossFn, mesh: Mesh, accum_steps: int = 1
) -> Callable[[ShardedTrainState, List[Batch]], Tuple[Any, Metrics, torch.Generator]]:
    """Gradient-averaging mode on the mesh, half 1: ``(state, batches) ->
    (grads, metrics, rng)``, the whole gradients on rank 0 as a tree shaped
    like the params (None at a leaf the loss does not reach), and rank 0's
    step generator."""
    check_mesh(mesh)

    def grad_step(state: ShardedTrainState, batches: List[Batch]) -> Tuple[Any, Metrics, torch.Generator]:
        grads, metrics = dp_grad_half(loss_fn, state, batches, accum_steps)
        return tree_unflatten(tree_flatten(state.params)[1], grads), metrics, state.rng

    return grad_step


def make_sharded_apply_step(
    tx: Optimizer, mesh: Mesh
) -> Callable[[ShardedTrainState, Any, torch.Generator], ShardedTrainState]:
    """Gradient-averaging mode on the mesh, half 2: every rank applies its
    slices of the (possibly swarm-averaged) gradients, a tree shaped like the
    params, in place. Each rank keeps its own step generator."""
    check_mesh(mesh)

    def apply_step(state: ShardedTrainState, grads: Any, rng: torch.Generator) -> ShardedTrainState:
        full = tree_flatten(grads)[0]
        per = [[None] * len(leaf.shards) if g is None else leaf.sharding.shard(g, leaf.dtype)
               for g, leaf in zip(full, state.leaves())]
        _apply(tx, state, per, global_norm(full))
        return state

    return apply_step


def make_sharded_eval_step(loss_fn: LossFn, mesh: Mesh) -> Callable[[ShardedTrainState, Batch, Any], Metrics]:
    """``(state, host or device batch, rng) -> metrics`` on the mesh without
    touching the params (the batch split as ``put_batch`` splits it)."""
    check_mesh(mesh)

    @torch.no_grad()
    def ev(state: ShardedTrainState, batch: Batch, rng: Any = None) -> Metrics:
        xs = [leaf.shards for leaf in state.leaves()]
        return _mesh_loss(loss_fn, state, xs, put_batch(batch, mesh))[1]

    return ev


