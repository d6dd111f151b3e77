"""The volunteer train loop (ported from
``distributedvolunteercomputing_tpu/training/trainer.py``).

data -> device -> fwd/bwd -> local optimizer step, and at each averaging
point a params-mode round through an injected callback: every
``average_every`` steps, or, with ``average_interval_s``, each time the
wall clock crosses a multiple of the interval. Blocking (the round's result replaces the params) or overlapped
with the next steps (Moshpit merge ``averaged + (current - snapshot)``).
With a ``mesh`` (``parallel/mesh.py``) the step is sharded over its ranks
(``parallel/train_step.py``: dp, tp and ep, and ``fsdp``): the host copy
assembles each leaf from its slices, in sorted-key order, so the payload
and its schema hash are a one-rank trainer's, and a merge or an adoption
writes each rank's slice back in place.

Concurrent readers (the state-sync provider and the gossip publisher, off
the trainer thread) never touch ``state``: the step updates its tensors in
place. They read ``host_snapshot()``, a host copy taken between steps at
init, after an adoption or a restore, and at every averaging point (reusing
the round's own host copy of the payload).

Everything that crosses to the host is the bundle's ``avg_select`` subtree
only (LoRA's adapters, the whole tree elsewhere): the round's payload, the
snapshot, and what a merge or ``adopt_params`` writes back, in place, into
the live tensors of that subtree. The reference snapshots the whole tree;
its readers use only the subtree, which the port's snapshot holds. Llama-2-7B
ships 16.8 MB of f32 adapters per round this way, never its 27 GB base.

Gradient averaging (``average_what="grads"``, GradientAverager semantics)
splits the step: every step's gradients go through the averager between
the backward pass and the optimizer, synchronously by design, and a failed
round backs off ``average_every`` steps. ``steps_per_call > 1`` runs the
steps between cadence points as chunks of fused steps
(``steps.make_multi_step``): chunks end at every eval, log, averaging and
``chunk_cadences`` boundary, so ``on_step`` fires only on chunk-final steps.
``eval_every`` evaluates the mean loss of ``eval_batches`` held-out batches
without touching the params. ``outer_optimizer="nesterov"`` applies a
DiLoCo-style Nesterov step, on host numpy in payload space, to each
params-mode round's average. ``DVC_PROFILE_DIR`` traces a window of steps
with ``torch.profiler`` (a chrome trace). Sequence parallelism and the
pipeline (the mesh's sp and pp axes) come with a later slice; the sharded
step refuses them.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.models.registry import Batch, ModelBundle
from distributedvolunteercomputing_tpu_torch.parallel.sharding import ShardedTensor
from distributedvolunteercomputing_tpu_torch.training.metrics import MetricsWriter
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import (
    TrainState,
    make_apply_step,
    make_eval_step,
    make_grad_step,
    make_multi_step,
    make_train_step,
)
from distributedvolunteercomputing_tpu_torch.utils.logging import errstr, get_logger
from distributedvolunteercomputing_tpu_torch.utils.pytree import (
    torch_dtype,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from distributedvolunteercomputing_tpu_torch.utils.torchenv import DeviceLike, resolve_device

log = get_logger(__name__)

# Averager callback: takes the CURRENT host payload (the ``avg_select``
# subtree of the params, or of the gradients in grads mode; numpy leaves) and
# the step, returns the averaged host payload (or None to keep the local
# one, e.g. when no group formed).
AveragerFn = Callable[[Any, int], Optional[Any]]

# The held-out synthetic eval stream's seed is the volunteer seed with this
# folded in above its low 32 bits, so it differs from every training seed
# below 2**32 (the reference folds 0x5EED into its data key; torch cannot
# reproduce ``jax.random`` bits, and the eval batches need not match the
# reference's).
_EVAL_SEED_FOLD = 0x5EED << 32


class Trainer:
    def __init__(
        self,
        bundle: ModelBundle,
        batch_size: int = 32,
        optimizer: str = "adamw",
        lr: float = 1e-3,
        seed: int = 0,
        init_seed: int = 0,
        # Cast floating params to this dtype after init ("bfloat16" for bf16
        # training); None keeps the model's f32.
        param_dtype: Optional[str] = None,
        # Microbatches per optimizer step (gradient accumulation); must
        # divide batch_size. One big batch's semantics.
        accum_steps: int = 1,
        # Fused steps per call between cadence points (params mode): chunks
        # end at every eval, log and averaging boundary, so their semantics
        # are unchanged; the chunk's per-step losses still come back for
        # target detection. 1 = off.
        steps_per_call: int = 1,
        # Extra step cadences chunks must end at, beyond eval, log and
        # averaging: the volunteer passes its checkpoint_every, which lives
        # inside its on_step closure where _chunk_len cannot see it.
        chunk_cadences: Tuple[int, ...] = (),
        total_steps: Optional[int] = None,
        metrics_path: Optional[str] = None,
        volunteer_id: str = "local",
        data: Optional[Iterable[Batch]] = None,  # overrides the synthetic stream
        # The card unless "cpu" is asked for; raises when there is no card.
        device: DeviceLike = None,
        # params: local SGD, the host params go through ``averager`` every
        # ``average_every`` steps. grads: GradientAverager semantics, the
        # gradients go through it EVERY step (average_every then sets only
        # the snapshot cadence and the back-off after a failed round).
        averager: Optional[AveragerFn] = None,
        average_what: str = "params",
        average_every: int = 10,
        # Wall-clock cadence (0 = off, the step cadence above): a round is
        # due when the clock crosses a multiple of the interval, so
        # volunteers of different step speeds meet at the same boundary;
        # each contribution weighs by the steps behind it. Params mode.
        average_interval_s: float = 0.0,
        # The clock those boundaries are on: the volunteer passes its
        # ClockSync's consensus clock; time.time by default.
        wall_clock: Optional[Callable[[], float]] = None,
        # Overlap the round with the next local steps (params mode);
        # ``max_staleness`` bounds how many steps a result may lag before it
        # is dropped instead of merged (0 = no bound).
        overlap: bool = False,
        max_staleness: int = 0,
        # The volunteer's local mesh: the state sharded over its ranks by the
        # partition rules, the batch split over dp. None = one device.
        mesh: Optional[Any] = None,
        # ZeRO-3 over the mesh's dp axis: params, grads and moments at 1/dp
        # per rank (params mode only).
        fsdp: bool = False,
        # Called after each host-visible step on the trainer thread (the
        # volunteer's checkpoint cadence). With steps_per_call > 1 it fires
        # only on chunk-final steps: a cadence inside the callback must be
        # declared in chunk_cadences, or its steps inside chunks are skipped.
        on_step: Optional[Callable[["Trainer", int], None]] = None,
        # Held-out evaluation every ``eval_every`` steps (0 = off): the mean
        # loss over ``eval_batches`` batches, params untouched, recorded as
        # an "eval" event. Batches come from ``eval_data`` (an independently
        # shuffled stream over the same dataset), else from ``data`` (which
        # then loses those training batches), else from a held-out
        # synthetic stream of its own generator.
        eval_every: int = 0,
        eval_batches: int = 4,
        eval_data: Optional[Iterable[Batch]] = None,
        # DiLoCo-style outer optimizer over params-mode rounds: Nesterov
        # momentum on (anchor - average), the swarm's progress since the
        # last round, instead of adopting the plain mean. "none" = plain
        # averaging; lr 1 and momentum 0 reduce to it.
        outer_optimizer: str = "none",
        outer_lr: float = 0.7,
        outer_momentum: float = 0.9,
    ):
        if eval_every and eval_batches < 1:
            raise ValueError(f"eval_batches must be >= 1, got {eval_batches}")
        if average_what not in ("params", "grads"):
            raise ValueError(f"unknown average_what {average_what!r}")
        if average_interval_s < 0:
            raise ValueError(f"average_interval_s must be >= 0, got {average_interval_s}")
        if average_interval_s > 0 and average_what == "grads":
            # Gradient rounds are per step by definition: a wall-clock
            # cadence would let optimizer steps run on unmerged gradients.
            raise ValueError("average_interval_s requires average_what='params'")
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        if steps_per_call > 1 and averager is not None and average_what == "grads":
            # Gradients cross the averager between bwd and the optimizer
            # every step: there is no run of steps to fuse.
            raise ValueError("steps_per_call > 1 requires average_what='params'")
        if accum_steps < 1 or batch_size % accum_steps != 0:
            raise ValueError(
                f"accum_steps={accum_steps} must be >=1 and divide batch_size={batch_size}"
            )
        if average_every < 1:
            raise ValueError(f"average_every must be >= 1, got {average_every}")
        if outer_optimizer not in ("none", "nesterov"):
            raise ValueError(f"unknown outer_optimizer {outer_optimizer!r}")
        if outer_optimizer != "none" and averager is not None and average_what != "params":
            # The outer step works on parameter deltas between rounds; grads
            # mode has no per-round parameter anchor to difference against.
            raise ValueError("outer_optimizer requires average_what='params'")
        # The reference turns on a persistent XLA compilation cache here
        # (enable_compile_cache); nothing is JIT-compiled in the port, so
        # there is nothing to cache.
        if mesh is None and fsdp:
            raise ValueError("fsdp/seq_sharded require a mesh (--mesh dp=...,tp=...)")
        if fsdp and average_what == "grads":
            # The split grad/apply steps gather the whole gradients on rank 0:
            # per-step host grad averaging defeats ZeRO-3's purpose (the
            # reference's check).
            raise ValueError("fsdp is a params-mode feature; use average_what='params'")
        if mesh is not None:
            ranks = [resolve_device(d) for d in mesh.flat()]
            if device is not None and resolve_device(device).type != ranks[0].type:
                raise ValueError(f"device {device} differs from the mesh's first device {ranks[0]}")
            self.device = ranks[0]
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.fsdp = bool(fsdp)
        self.bundle = bundle
        self.batch_size = batch_size
        self.accum_steps = accum_steps
        # ``seed`` is per-volunteer (data order, step rng); ``init_seed`` is
        # task-constant, so every volunteer builds the same initial params.
        self.tx = make_optimizer(optimizer, lr=lr, total_steps=total_steps)
        # Each leaf is cast to ``param_dtype`` as the init makes it: a bf16
        # model never exists whole in f32 on the device.
        params = bundle.init(
            torch.Generator(device=self.device).manual_seed(init_seed),
            dtype=torch_dtype(param_dtype) if param_dtype else None,
        )
        # Kept for the checkpoint restore, which re-applies it.
        self.param_dtype = param_dtype
        step_rng = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState.create(params, self.tx, step_rng)
        self.average_what = average_what
        # Gradient mode splits the step so the gradients can cross the
        # averager between bwd and the optimizer; the fused step covers the
        # rest.
        self._grads_mode = averager is not None and average_what == "grads"
        self._step_fn = self._multi_fn = None
        self.steps_per_call = int(steps_per_call)
        self.chunk_cadences = tuple(int(c) for c in chunk_cadences if c)
        multi = self.steps_per_call > 1 and not self._grads_mode
        if mesh is not None:
            from distributedvolunteercomputing_tpu_torch.parallel import train_step as pts

            self.state, _ = pts.shard_train_state(self.state, mesh, fsdp=fsdp)
            del params
            if self._grads_mode:
                self._grad_fn = pts.make_sharded_grad_step(bundle.loss_fn, mesh, accum_steps=accum_steps)
                self._apply_fn = pts.make_sharded_apply_step(self.tx, mesh)
            else:
                self._step_fn = pts.make_sharded_train_step(bundle.loss_fn, self.tx, mesh, accum_steps=accum_steps,
                                                            fsdp=fsdp)
                if multi:
                    self._multi_fn = pts.make_sharded_multi_step(bundle.loss_fn, self.tx, mesh,
                                                                 accum_steps=accum_steps, fsdp=fsdp)
        elif self._grads_mode:
            self._grad_fn = make_grad_step(bundle.loss_fn, accum_steps=accum_steps)
            self._apply_fn = make_apply_step(self.tx)
        else:
            self._step_fn = make_train_step(bundle.loss_fn, self.tx, accum_steps=accum_steps)
            if multi:
                self._multi_fn = make_multi_step(bundle.loss_fn, self.tx, accum_steps=accum_steps)
        # EMA of seconds per step, measured per chunk: kept only under the
        # wall-clock cadence, where chunks must anticipate the next boundary.
        self._ema_step_s: Optional[float] = None
        # The synthetic stream is drawn on the host and moved to the device.
        self._data_gen = torch.Generator().manual_seed(seed)
        self._data = data
        self._it: Optional[Iterator[Batch]] = None  # run()'s iterator, shared with evaluate()
        self.eval_every = eval_every
        self.eval_batches = eval_batches
        self._eval_data = eval_data
        self._eval_it: Optional[Iterator[Batch]] = None
        self._eval_fn = None
        # The held-out synthetic stream (batches on the host, the loss's rng
        # on the device): generators of their own, so eval never draws from
        # a training stream.
        eval_seed = _EVAL_SEED_FOLD | (seed & 0xFFFFFFFF)
        self._eval_gen = torch.Generator().manual_seed(eval_seed)
        self._eval_rng = torch.Generator(device=self.device).manual_seed(eval_seed)
        self.metrics = MetricsWriter(metrics_path, volunteer_id)
        self.averager = averager
        self.average_every = average_every
        self.average_interval_s = float(average_interval_s)
        self._wall_clock = wall_clock or time.time
        # The next wall-clock boundary a round is due at; None until the
        # first _avg_due arms it.
        self._next_avg_t: Optional[float] = None
        # Local steps behind the NEXT contribution, read by the volunteer's
        # averager callback to weight it in samples: average_every on the
        # happy path, more after failed rounds; under the wall-clock cadence
        # whatever this volunteer managed in the window.
        self.steps_since_merge: int = average_every
        self._last_merge_step: Optional[int] = None
        self.overlap = bool(overlap) and averager is not None and not self._grads_mode
        self.max_staleness = max_staleness
        # One worker: rounds never overlap each other, only local compute.
        self._avg_pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="avg-round")
            if self.overlap
            else None
        )
        self._inflight: Optional[tuple] = None  # (launch_step, payload0, future)
        self.outer_optimizer = outer_optimizer
        self.outer_lr = float(outer_lr)
        self.outer_momentum = float(outer_momentum)
        # Host outer state in payload space: the anchor is the global params
        # the current inner phase started from; m accumulates the per-round
        # aggregate deltas.
        self._outer_anchor: Any = None
        self._outer_m: Any = None
        self.on_step = on_step
        # Bumped on every out-of-band params mutation (a merge, an adoption):
        # with the step it tells the checkpoint layer whether the state at
        # one step number still matches its last save.
        self.mutation_counter = 0
        # (step, host payload tree), self._snapshot: replaced whole, so a
        # reader on another thread always sees one consistent pair.
        self._take_snapshot(0)

    def data_iter(self) -> Iterator[Batch]:
        while True:
            yield self.bundle.make_batch(self._data_gen, self.batch_size)

    def _to_device(self, batch: Dict[str, Any]) -> Any:
        """The batch on the device, or split over the mesh's dp ranks."""
        if self.mesh is not None:
            from distributedvolunteercomputing_tpu_torch.parallel.train_step import put_batch

            return put_batch(batch, self.mesh)
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _stack_batches(self, batches: List[Dict[str, Any]]) -> Batch:
        """A chunk's batches stacked on a leading step axis: on the device in
        one copy per key, or on the host for a mesh (the multi-step puts each
        step's batch over the ranks)."""
        stacked = {k: torch.stack([torch.as_tensor(b[k]) for b in batches]) for k in batches[0]}
        if self.mesh is not None:
            return stacked
        return {k: v.to(self.device, non_blocking=True) for k, v in stacked.items()}

    def _record_target_crossed(
        self, cross_step: int, target_loss: float, t_start: float, wall_override: Optional[float] = None,
    ) -> Tuple[int, float]:
        """Log and record the first target crossing, for the per-step path
        and the chunk path alike. The chunk path sees a crossing only after
        its chunk ends, so it passes ``wall_override``: the crossing's time
        interpolated at the chunk's per-step rate."""
        wall = wall_override if wall_override is not None else time.monotonic() - t_start
        log.info("target loss %.4f reached at step %d (%.1fs)", target_loss, cross_step, wall)
        self.metrics.record_event(
            cross_step, "target_crossed", {"target_loss": target_loss, "wall_s": round(wall, 3)}
        )
        return (cross_step, wall)

    # -- averaging ----------------------------------------------------------

    @staticmethod
    def _host_tree(tree: Any) -> Any:
        """The tree as host f32 numpy leaves: one device-side concatenation
        and ONE device-to-host copy (not one per leaf), then views. A sharded
        leaf is assembled from its slices first."""
        leaves, treedef = tree_flatten(tree)
        leaves = [x.full() if isinstance(x, ShardedTensor) else x for x in leaves]
        flat = torch.cat([x.detach().reshape(-1).to(torch.float32) for x in leaves]).cpu().numpy()
        out, off = [], 0
        for x in leaves:
            out.append(flat[off : off + x.numel()].reshape(tuple(x.shape)))
            off += x.numel()
        return tree_unflatten(treedef, out)

    @staticmethod
    def _device_tree(host: Any, like: Any) -> Any:
        """A host tree as tensors shaped, typed and placed like ``like``'s
        leaves: one concatenation and ONE host-to-device copy, then views."""
        src, src_def = tree_flatten(host)
        dst, dst_def = tree_flatten(like)
        if src_def != dst_def:
            raise ValueError("averaged tree differs from the local payload's")
        flat = torch.from_numpy(np.concatenate([np.asarray(v, np.float32).reshape(-1) for v in src]))
        flat = flat.to(dst[0].device)
        out, off = [], 0
        for d in dst:
            out.append(flat[off : off + d.numel()].view(d.shape).to(d.dtype))
            off += d.numel()
        return tree_unflatten(dst_def, out)

    def _host_payload(self) -> Any:
        """The live ``avg_select`` subtree as host f32 numpy leaves."""
        return self._host_tree(self.bundle.avg_select(self.state.params))

    def _take_snapshot(self, step_no: int, host: Any = None) -> None:
        """Refresh the cross-thread snapshot, on the trainer thread between
        steps. ``host`` is a host copy of the live payload already made (a
        round's); without it, one device-to-host copy."""
        self._snapshot = (step_no, self._host_payload() if host is None else host)

    def host_snapshot(self) -> Tuple[int, Any]:
        """(step, host tree of the ``avg_select`` subtree, f32 numpy leaves);
        safe from any thread."""
        return self._snapshot

    def _write_params(self, payload: Any) -> None:
        """Copy a host tree of the ``avg_select`` subtree into the live
        tensors of that subtree, in place (each rank's slice of it under a
        mesh); the rest of the params and the optimizer's moments keep their
        tensors."""
        src, src_def = tree_flatten(payload)
        dst, dst_def = tree_flatten(self.bundle.avg_select(self.state.params))
        if dst_def != src_def:
            raise ValueError("payload tree differs from the params' averaged subtree")
        with torch.no_grad():
            for p, v in zip(dst, src):
                v = torch.from_numpy(np.ascontiguousarray(v, np.float32))
                if isinstance(p, ShardedTensor):
                    p.write(v)
                else:
                    p.copy_(v)

    def _swap_params(self, payload: Any, step_no: int) -> None:
        """A merged host payload becomes live state in every replica — the
        ONE place a merge lands, shared by the blocking and overlapped paths
        — and the snapshot. The merged tree is the snapshot itself when the
        payload is f32 (what the copy wrote is what it holds)."""
        self._write_params(payload)
        self.mutation_counter += 1
        exact = all(p.dtype == torch.float32 for p in tree_leaves(self.bundle.avg_select(self.state.params)))
        self._take_snapshot(step_no, payload if exact else None)

    def adopt_params(self, payload: Any, step: Optional[int] = None) -> None:
        """Replace the ``avg_select`` subtree of every replica in place with
        a host tree (the state-sync pull), and optionally the step counter.
        The optimizer's moments are kept: at adoption they are either cold
        or restored, and the averaging rounds re-sync them either way."""
        self._write_params(payload)
        if step is not None:
            self.state.step = int(step)
        self.mutation_counter += 1
        # The adopted params did not come from this trainer's anchor: the
        # outer optimizer's next round re-seeds (its first-round semantics).
        self._outer_anchor = None
        self._outer_m = None
        self._take_snapshot(int(self.state.step))

    def evaluate(self, n_batches: Optional[int] = None) -> float:
        """Mean held-out loss over ``n_batches`` (default ``eval_batches``)
        without updating the params, sharded as the step is under a mesh;
        ``accum_steps`` microbatches a batch as the step does. NaN when a
        finite stream ran out before the first batch."""
        if self._eval_fn is None:
            if self.mesh is not None:
                from distributedvolunteercomputing_tpu_torch.parallel.train_step import make_sharded_eval_step

                self._eval_fn = make_sharded_eval_step(self.bundle.loss_fn, self.mesh)
            else:
                self._eval_fn = make_eval_step(self.bundle.loss_fn)
        n = self.eval_batches if n_batches is None else n_batches
        if n < 1:
            raise ValueError(f"evaluate() needs n_batches >= 1, got {n}")
        params = self.state if self.mesh is not None else self.state.params
        total = 0.0
        done = 0
        for _ in range(n):
            if self._eval_data is not None:
                # The dedicated held-out stream: the training order is
                # untouched by eval.
                if self._eval_it is None:
                    self._eval_it = iter(self._eval_data)
                try:
                    batch = next(self._eval_it)
                except StopIteration:
                    break  # a finite eval set ran out
            elif self._data is not None:
                if self._it is None:  # standalone use before run()
                    self._it = iter(self._data)
                try:
                    batch = next(self._it)
                except StopIteration:
                    break  # evaluate on what there was
            else:
                batch = self.bundle.make_batch(self._eval_gen, self.batch_size)
            if self.mesh is None:
                batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}
            else:
                batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            if self.accum_steps > 1:
                micro = {k: v.chunk(self.accum_steps, dim=0) for k, v in batch.items()}
                losses = [
                    float(self._eval_fn(params, {k: v[i] for k, v in micro.items()}, self._eval_rng)["loss"])
                    for i in range(self.accum_steps)
                ]
                total += sum(losses) / len(losses)
            else:
                total += float(self._eval_fn(params, batch, self._eval_rng)["loss"])
            done += 1
        return total / done if done else float("nan")

    def _outer_transform(self, averaged: Any) -> Any:
        """The outer optimizer on one round's aggregate (payload space, host
        numpy); the plain average when it is off.

        Nesterov over the round delta: with anchor a (the global params this
        inner phase started from) and the round's average v,
            g  = a - v                    (aggregate outer gradient)
            m  = mu * m + g
            a' = a - lr * (mu * m + g)    (lookahead step)
        a' becomes the next anchor; lr 1 and mu 0 give a' = v. The first
        successful round (or the first after an adoption) has no anchor: it
        adopts the plain average and seeds the anchor there."""
        if self.outer_optimizer == "none":
            return averaged
        if self._outer_anchor is None or tree_flatten(self._outer_anchor)[1] != tree_flatten(averaged)[1]:
            self._outer_anchor = tree_map(lambda v: np.asarray(v, np.float32).copy(), averaged)
            self._outer_m = tree_map(np.zeros_like, self._outer_anchor)
            return averaged
        lr, mu = self.outer_lr, self.outer_momentum

        def step(a: np.ndarray, m: np.ndarray, v: Any) -> np.ndarray:
            # The reference's f32 expressions, rounded op by op as it rounds
            # them, in place where the array is this trainer's own: m is,
            # the old anchor may be the cross-thread snapshot.
            g = a - np.asarray(v, np.float32)
            m *= mu
            m += g
            t = m * mu
            t += g
            t *= lr
            return a - t

        self._outer_anchor = tree_map(step, self._outer_anchor, self._outer_m, averaged)
        return self._outer_anchor

    def _avg_due(self, step_no: int) -> bool:
        """Is a round due at this step? Every ``average_every`` steps, or,
        with ``average_interval_s``, when the wall clock has crossed the
        armed boundary: boundaries are absolute multiples of the interval on
        ``wall_clock``, so peers on one consensus clock fire together. The
        first call only arms the next boundary (a joiner's first round is
        the swarm's next one), and a slow step that skips several boundaries
        still yields one round."""
        if self.average_interval_s > 0:
            now = self._wall_clock()
            if self._next_avg_t is None:
                self._arm_next_boundary(now)
                return False
            if now >= self._next_avg_t:
                self._arm_next_boundary(now)
                return True
            return False
        return step_no % self.average_every == 0

    def _arm_next_boundary(self, now: float) -> None:
        self._next_avg_t = (int(now // self.average_interval_s) + 1) * self.average_interval_s

    def _chunk_len(self, next_step: int, remaining: int, log_every: int) -> int:
        """Steps a chunk may cover from ``next_step`` without straddling a
        cadence boundary: every metrics, eval, averaging or snapshot action
        happens on a chunk's LAST step, so a chunk ends at the first
        boundary it meets."""
        n = min(self.steps_per_call, remaining)
        cadences = [
            self.eval_every,
            self.average_every if self.averager else 0,
            log_every,
            *self.chunk_cadences,
        ]
        for c in cadences:
            if c:
                n = min(n, c - ((next_step - 1) % c))
        if self.averager is not None and self.average_interval_s > 0:
            # A wall-clock boundary maps to a step count only through a
            # step-time estimate: size the chunk to end just past the next
            # boundary. Until the EMA exists, chunks of 2 bootstrap it.
            if self._ema_step_s is None:
                n = min(n, 2)
            elif self._next_avg_t is not None:
                until = max(self._next_avg_t - self._wall_clock(), 0.0)
                n = min(n, max(1, int(until / self._ema_step_s) + 1))
        return max(1, n)

    def _note_window_progress(self, step_no: int) -> None:
        if self._last_merge_step is not None:
            self.steps_since_merge = max(1, step_no - self._last_merge_step)

    def _run_average_round(self, step_no: int) -> Tuple[Any, Optional[Any]]:
        """One blocking params round: (the host payload it shipped, the
        merged payload after the outer step, or None when no group formed /
        the round failed)."""
        payload = self._host_payload()
        self._note_window_progress(step_no)
        t_avg = time.monotonic()
        averaged = self.averager(payload, step_no)
        self.metrics.record_event(
            step_no, "avg_round",
            {"avg_s": time.monotonic() - t_avg, "ok": averaged is not None, "what": "params"},
        )
        if averaged is None:
            return payload, None
        return payload, self._outer_transform(tree_map(np.asarray, averaged))

    def _run_grad_round(self, grads: Any, step_no: int) -> Optional[Any]:
        """One gradient round: the host payload of ``avg_select(grads)``
        through the averager; returns the grads tree with the averaged
        subtree on the device, or None when the round failed. A leaf of the
        subtree the loss did not reach ships as zeros, the reference's
        gradient there."""
        sel = tree_map(
            lambda g, p: torch.zeros(p.shape, dtype=p.dtype, device=self.device) if g is None else g,
            self.bundle.avg_select(grads), self.bundle.avg_select(self.state.params),
        )
        payload = self._host_tree(sel)
        t_avg = time.monotonic()
        averaged = self.averager(payload, step_no)
        self.metrics.record_event(
            step_no, "avg_round",
            {"avg_s": time.monotonic() - t_avg, "ok": averaged is not None, "what": "grads"},
        )
        if averaged is None:
            return None
        return self.bundle.avg_merge(grads, self._device_tree(averaged, sel))

    def _launch_overlap_round(self, step_no: int) -> None:
        """Copy the payload to the host and run the round on the pool while
        the next steps run (the train step updates the params in place, so
        the pool must never read them). The same host copy is the
        cross-thread snapshot."""
        payload0 = self._host_payload()
        self._take_snapshot(step_no, payload0)
        self._note_window_progress(step_no)
        t0 = time.monotonic()
        fut = self._avg_pool.submit(lambda: (self.averager(payload0, step_no), time.monotonic() - t0))
        self._inflight = (step_no, payload0, fut)

    def _finish_overlap_round(self, step_no: int, wait: bool = False) -> None:
        """Merge a completed round: new = outer(averaged) + (current -
        snapshot), keeping the steps taken while the round was in flight."""
        if self._inflight is None:
            return
        launch_step, payload0, fut = self._inflight
        if not wait and not fut.done():
            return
        self._inflight = None
        try:
            averaged, avg_s = fut.result(timeout=600.0 if wait else 0.0)
        except Exception as e:  # noqa: BLE001 — a failed round never kills training
            log.warning("overlapped averaging launched at step %d failed: %s", launch_step, errstr(e))
            self.metrics.record_event(step_no, "avg_round", {"ok": False, "what": "params", "overlap": True})
            return
        staleness = step_no - launch_step
        ok = averaged is not None
        if ok and self.max_staleness and staleness > self.max_staleness:
            log.warning("dropping averaging result: staleness %d > bound %d", staleness, self.max_staleness)
            ok = False
        self.metrics.record_event(
            step_no, "avg_round",
            {"avg_s": avg_s, "ok": ok, "what": "params", "overlap": True, "staleness": staleness},
        )
        if not ok:
            return
        # The outer step first, the local progress on top: the contraction
        # happens on the snapshot term, the in-flight steps are kept.
        averaged = self._outer_transform(averaged)
        merged = tree_map(
            lambda avg, cur, p0: np.asarray(avg, np.float32) + (cur - p0),
            averaged, self._host_payload(), payload0,
        )
        self._swap_params(merged, step_no)
        # Progress up to the LAUNCH step entered the average.
        self._last_merge_step = launch_step

    # -- the trace hook ------------------------------------------------------

    def _start_profile(self) -> Any:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof: Any, profile_dir: str, step_no: int) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"trace_{self.metrics.volunteer_id}_step{step_no}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)

    def run(
        self,
        steps: int,
        target_loss: Optional[float] = None,
        target_mode: str = "stop",
        log_every: int = 50,
        stop_flag: Optional[Callable[[], bool]] = None,
    ) -> Dict[str, Any]:
        """Train for ``steps``; returns the reference trainer's summary keys.

        ``target_loss`` with ``target_mode="stop"`` ends the run at the first
        crossing; with ``"record"`` the run goes on and the summary reports
        when the target was first crossed."""
        if target_mode not in ("stop", "record"):
            raise ValueError(f"unknown target_mode {target_mode!r}")
        it = iter(self._data) if self._data is not None else self.data_iter()
        self._it = it  # evaluate() draws from the same iterator for custom data
        # Trace hook: DVC_PROFILE_DIR=<dir> writes a torch.profiler chrome
        # trace of steps [DVC_PROFILE_START, +DVC_PROFILE_STEPS), past the
        # warm-up. Multi-step chunks are off while it is set (the hook is
        # per step).
        profile_dir = os.environ.get("DVC_PROFILE_DIR")
        profile_start = int(os.environ.get("DVC_PROFILE_START", "10"))
        profile_steps = int(os.environ.get("DVC_PROFILE_STEPS", "10"))
        prof = None
        # Grads mode averages every step; after a FAILED round (no group:
        # e.g. the only partner left) it skips averaging for average_every
        # steps instead of paying a matchmaking timeout per step.
        avg_skip_until = 0
        # Reading the loss synchronises with the device; only pay for it
        # when something consumes the value.
        sync_every_step = target_loss is not None or self.metrics.has_sink
        m = None
        last_loss = float("nan")
        start_step = self.state.step
        if self._last_merge_step is None:
            self._last_merge_step = start_step
        t_start = time.monotonic()
        ran_steps = 0
        target_crossed: Optional[Tuple[int, float]] = None
        for i in range(steps):
            if ran_steps >= steps:
                break  # chunks below may take several steps per iteration
            if stop_flag is not None and stop_flag():
                log.info("stop flag set; exiting train loop at step %d", self.state.step)
                break
            # Multi-step fast path: the first n - 1 steps of a chunk in one
            # call, then the chunk's last step through the per-step path
            # below, so records, eval, rounds and snapshots keep their
            # cadences (chunks end at every boundary: _chunk_len).
            if self._multi_fn is not None and not profile_dir:
                n = self._chunk_len(start_step + ran_steps + 1, steps - ran_steps, log_every)
                if n > 1:
                    stacked = self._stack_batches([next(it) for _ in range(n - 1)])
                    t_chunk = time.perf_counter()
                    self.state, losses = self._multi_fn(self.state, stacked)
                    ran_steps += n - 1
                    if self.averager is not None and self.average_interval_s > 0:
                        # One sync per chunk: its real duration feeds the
                        # EMA that sizes chunks around wall boundaries.
                        float(losses[-1])
                        per_step = (time.perf_counter() - t_chunk) / (n - 1)
                        self._ema_step_s = (
                            per_step if self._ema_step_s is None else 0.5 * self._ema_step_s + 0.5 * per_step
                        )
                    if sync_every_step:
                        host_losses = losses.float().cpu().numpy()
                        first = start_step + ran_steps - (n - 1) + 1
                        for k, lv in enumerate(host_losses):
                            self.metrics.record(first + k, {"loss": float(lv)}, n_samples=self.batch_size)
                        last_loss = float(host_losses[-1])
                        if target_loss is not None and target_crossed is None:
                            hit = np.nonzero(host_losses <= target_loss)[0]
                            if hit.size:
                                # Back out the steps that ran after the
                                # crossing at this chunk's per-step rate.
                                per_step = (time.perf_counter() - t_chunk) / (n - 1)
                                wall_est = time.monotonic() - t_start - (n - 2 - int(hit[0])) * per_step
                                target_crossed = self._record_target_crossed(
                                    first + int(hit[0]), target_loss, t_start, wall_override=wall_est
                                )
                                if target_mode == "stop":
                                    # The end-of-run read takes this chunk's
                                    # last loss, not an earlier step's.
                                    m = {"loss": host_losses[-1]}
                                    break
                    else:
                        self.metrics.count_samples(self.batch_size * (n - 1))
            batch = self._to_device(next(it))
            step_no = start_step + ran_steps + 1
            if profile_dir and prof is None and i == profile_start:
                prof = self._start_profile()
            if self._grads_mode:
                # GradientAverager semantics are per step: every local
                # gradient is averaged before the optimizer sees it.
                grads, m, rng = self._grad_fn(self.state, batch)
                if step_no >= avg_skip_until:
                    merged = self._run_grad_round(grads, step_no)
                    if merged is not None:
                        grads = merged
                    else:
                        avg_skip_until = step_no + self.average_every
                self.state = self._apply_fn(self.state, grads, rng)
                if step_no % self.average_every == 0:
                    self._take_snapshot(step_no)
            else:
                self.state, m = self._step_fn(self.state, batch)
            ran_steps += 1
            at_log_point = bool(log_every) and step_no % log_every == 0
            if sync_every_step or at_log_point:
                last_loss = float(m["loss"])
                self.metrics.record(step_no, m, n_samples=self.batch_size)
            else:
                self.metrics.count_samples(self.batch_size)
            if self.eval_every and step_no % self.eval_every == 0:
                ev = self.evaluate()
                if ev == ev:  # NaN: a finite dataset ran out, nothing to record
                    self.metrics.record_event(step_no, "eval", {"eval_loss": ev, "n_batches": self.eval_batches})
                    log.info("step %d eval_loss %.4f", step_no, ev)
            if self.averager is not None and not self._grads_mode:
                if self.overlap:
                    # Merge a round that completed since the last step, then
                    # (at the cadence, none in flight) launch the next one.
                    self._finish_overlap_round(step_no)
                    if self._avg_due(step_no):
                        if self._inflight is None:
                            self._launch_overlap_round(step_no)
                        else:
                            # At the cadence whether or not a round runs:
                            # state sync serves current weights.
                            self._take_snapshot(step_no)
                elif self._avg_due(step_no):
                    payload, averaged = self._run_average_round(step_no)
                    if averaged is not None:
                        self._swap_params(averaged, step_no)
                        self._last_merge_step = step_no
                    else:
                        self._take_snapshot(step_no, payload)
                if self.average_interval_s > 0 and step_no % self.average_every == 0:
                    # Wall-clock rounds can be far apart: keep the state-sync
                    # snapshot fresh on the step cadence all the same.
                    self._take_snapshot(step_no)
            if prof is not None and i + 1 >= profile_start + profile_steps:
                self._stop_profile(prof, profile_dir, step_no)
                prof = None
            if self.on_step is not None:
                self.on_step(self, step_no)
            if at_log_point:
                log.info(
                    "step %d loss %.4f (%.1f samples/s)",
                    step_no, last_loss, self.metrics.samples_per_sec(),
                )
            if target_loss is not None and last_loss <= target_loss:
                if target_crossed is None:
                    target_crossed = self._record_target_crossed(step_no, target_loss, t_start)
                if target_mode == "stop":
                    break
        if prof is not None:  # the loop ended inside the trace window
            self._stop_profile(prof, profile_dir, start_step + ran_steps)
        # Drain an in-flight round so the returned params are contracted and
        # a partner mid-round is not abandoned by our exit.
        if self.overlap:
            self._finish_overlap_round(start_step + ran_steps, wait=True)
        if m is not None:
            last_loss = float(m["loss"])  # sync once at the end regardless
        wall = time.monotonic() - t_start
        summary: Dict[str, Any] = {
            "final_loss": last_loss,
            "steps": int(self.state.step),
            "wall_time_s": wall,
            "samples_per_sec": ran_steps * self.batch_size / wall if wall > 0 else 0.0,
        }
        if target_loss is not None:
            summary["target_loss"] = target_loss
            summary["target_crossed_step"] = target_crossed[0] if target_crossed else None
            summary["target_crossed_s"] = round(target_crossed[1], 3) if target_crossed else None
        return summary
