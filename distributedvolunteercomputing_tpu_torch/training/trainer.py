"""The volunteer train loop (ported from
``distributedvolunteercomputing_tpu/training/trainer.py``).

data -> device -> fwd/bwd -> local optimizer step, and at each averaging
point a params-mode round through an injected callback: every
``average_every`` steps, or, with ``average_interval_s``, each time the
wall clock crosses a multiple of the interval. Blocking (the round's result replaces the params) or overlapped
with the next steps (Moshpit merge ``averaged + (current - snapshot)``).
With a ``mesh`` (``parallel/mesh.py``) the step is data-parallel over its dp
ranks (``parallel/train_step.py``): the averager reads rank 0's params, and a
merge writes the averaged params back to every rank.

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

Gradient averaging, the outer optimizer, FSDP and the other mesh axes,
multi-step calls and eval come with later slices of the port; the
constructor does not accept them yet.
"""

from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from distributedvolunteercomputing_tpu_torch.models.registry import Batch, ModelBundle
from distributedvolunteercomputing_tpu_torch.training.metrics import MetricsWriter
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_train_step
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
# subtree, numpy leaves) and the step, returns the averaged host payload (or
# None to keep local params, e.g. when no group formed).
AveragerFn = Callable[[Any, int], Optional[Any]]


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
        total_steps: Optional[int] = None,
        metrics_path: Optional[str] = None,
        volunteer_id: str = "local",
        data: Optional[Iterable[Batch]] = None,  # overrides the synthetic stream
        # The card unless "cpu" is asked for; raises when there is no card.
        device: DeviceLike = None,
        # Params-mode averaging (local SGD): every ``average_every`` steps the
        # host params go through ``averager``.
        averager: Optional[AveragerFn] = None,
        average_every: int = 10,
        # Wall-clock cadence (0 = off, the step cadence above): a round is
        # due when the clock crosses a multiple of the interval, so
        # volunteers of different step speeds meet at the same boundary;
        # each contribution weighs by the steps behind it.
        average_interval_s: float = 0.0,
        # The clock those boundaries are on: the volunteer passes its
        # ClockSync's consensus clock; time.time by default.
        wall_clock: Optional[Callable[[], float]] = None,
        # Overlap the round with the next local steps; ``max_staleness``
        # bounds how many steps a result may lag before it is dropped
        # instead of merged (0 = no bound).
        overlap: bool = False,
        max_staleness: int = 0,
        # The volunteer's local mesh (dp only): a full replica on each rank,
        # the batch split over them. None = one device.
        mesh: Optional[Any] = None,
        # Called after each step on the trainer thread (the volunteer's
        # checkpoint cadence).
        on_step: Optional[Callable[["Trainer", int], None]] = None,
    ):
        if accum_steps < 1 or batch_size % accum_steps != 0:
            raise ValueError(
                f"accum_steps={accum_steps} must be >=1 and divide batch_size={batch_size}"
            )
        if average_every < 1:
            raise ValueError(f"average_every must be >= 1, got {average_every}")
        if average_interval_s < 0:
            raise ValueError(f"average_interval_s must be >= 0, got {average_interval_s}")
        if mesh is not None:
            ranks = [resolve_device(d) for d in mesh.flat()]
            if device is not None and resolve_device(device).type != ranks[0].type:
                raise ValueError(f"device {device} differs from the mesh's first device {ranks[0]}")
            self.device = ranks[0]
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.bundle = bundle
        self.batch_size = batch_size
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
        # Every replica the params live in (one without a mesh).
        self._replicas = [self.state]
        if mesh is not None:
            from distributedvolunteercomputing_tpu_torch.parallel.train_step import (
                make_sharded_train_step,
                shard_train_state,
            )

            self.state, _ = shard_train_state(self.state, mesh)
            self._replicas = self.state.replicas
            self._step_fn = make_sharded_train_step(bundle.loss_fn, self.tx, mesh, accum_steps=accum_steps)
        else:
            self._step_fn = make_train_step(bundle.loss_fn, self.tx, accum_steps=accum_steps)
        # The synthetic stream is drawn on the host and moved to the device.
        self._data_gen = torch.Generator().manual_seed(seed)
        self._data = data
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
        self.overlap = bool(overlap) and averager is not None
        self.max_staleness = max_staleness
        # One worker: rounds never overlap each other, only local compute.
        self._avg_pool = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="avg-round")
            if self.overlap
            else None
        )
        self._inflight: Optional[tuple] = None  # (launch_step, payload0, future)
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

    def _record_target_crossed(self, cross_step: int, target_loss: float, t_start: float) -> Tuple[int, float]:
        wall = time.monotonic() - t_start
        log.info("target loss %.4f reached at step %d (%.1fs)", target_loss, cross_step, wall)
        self.metrics.record_event(
            cross_step, "target_crossed", {"target_loss": target_loss, "wall_s": round(wall, 3)}
        )
        return (cross_step, wall)

    # -- averaging (params mode) --------------------------------------------

    @staticmethod
    def _host_tree(tree: Any) -> Any:
        """The tree as host f32 numpy leaves: one device-side concatenation
        and ONE device-to-host copy (not one per leaf), then views."""
        leaves, treedef = tree_flatten(tree)
        flat = torch.cat([x.detach().reshape(-1).to(torch.float32) for x in leaves]).cpu().numpy()
        out, off = [], 0
        for x in leaves:
            out.append(flat[off : off + x.numel()].reshape(tuple(x.shape)))
            off += x.numel()
        return tree_unflatten(treedef, out)

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
        tensors of that subtree, in every replica, in place; the rest of the
        params and the optimizer's moments keep their tensors."""
        src_leaves, src_def = tree_flatten(payload)
        with torch.no_grad():
            src = [torch.from_numpy(np.ascontiguousarray(v, np.float32)) for v in src_leaves]
            for replica in self._replicas:
                dst, dst_def = tree_flatten(self.bundle.avg_select(replica.params))
                if dst_def != src_def:
                    raise ValueError("payload tree differs from the params' averaged subtree")
                for p, v in zip(dst, src):
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
            for replica in self._replicas:
                replica.step = int(step)
        self.mutation_counter += 1
        self._take_snapshot(int(self.state.step))

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

    def _note_window_progress(self, step_no: int) -> None:
        if self._last_merge_step is not None:
            self.steps_since_merge = max(1, step_no - self._last_merge_step)

    def _run_average_round(self, step_no: int) -> Tuple[Any, Optional[Any]]:
        """One blocking round: (the host payload it shipped, the averaged
        payload or None when no group formed / the round failed)."""
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
        return payload, tree_map(np.asarray, averaged)

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
        """Merge a completed round: new = averaged + (current - snapshot),
        keeping the steps taken while the round was in flight."""
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
        merged = tree_map(
            lambda avg, cur, p0: np.asarray(avg, np.float32) + (cur - p0),
            averaged, self._host_payload(), payload0,
        )
        self._swap_params(merged, step_no)
        # Progress up to the LAUNCH step entered the average.
        self._last_merge_step = launch_step

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
        for _ in range(steps):
            if stop_flag is not None and stop_flag():
                log.info("stop flag set; exiting train loop at step %d", self.state.step)
                break
            batch = self._to_device(next(it))
            step_no = start_step + ran_steps + 1
            self.state, m = self._step_fn(self.state, batch)
            ran_steps += 1
            at_log_point = bool(log_every) and step_no % log_every == 0
            if sync_every_step or at_log_point:
                last_loss = float(m["loss"])
                self.metrics.record(step_no, m, n_samples=self.batch_size)
            else:
                self.metrics.count_samples(self.batch_size)
            if self.averager is not None:
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
