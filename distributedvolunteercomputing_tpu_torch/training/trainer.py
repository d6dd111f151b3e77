"""The volunteer train loop, local half (ported from
``distributedvolunteercomputing_tpu/training/trainer.py``).

data -> device -> fwd/bwd -> local optimizer step, for one volunteer with no
averaging: the reference's config 1 (``averager=None``). Averaging rounds,
overlap, meshes, multi-step calls, eval and the outer optimizer come with
later slices of the port; the constructor does not accept them yet.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

from distributedvolunteercomputing_tpu_torch.models.registry import Batch, ModelBundle
from distributedvolunteercomputing_tpu_torch.training.metrics import MetricsWriter
from distributedvolunteercomputing_tpu_torch.training.optim import make_optimizer
from distributedvolunteercomputing_tpu_torch.training.steps import TrainState, make_train_step
from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger
from distributedvolunteercomputing_tpu_torch.utils.pytree import cast_floating
from distributedvolunteercomputing_tpu_torch.utils.torchenv import DeviceLike, resolve_device

log = get_logger(__name__)


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
    ):
        if accum_steps < 1 or batch_size % accum_steps != 0:
            raise ValueError(
                f"accum_steps={accum_steps} must be >=1 and divide batch_size={batch_size}"
            )
        self.device = resolve_device(device)
        self.bundle = bundle
        self.batch_size = batch_size
        # ``seed`` is per-volunteer (data order, step rng); ``init_seed`` is
        # task-constant, so every volunteer builds the same initial params.
        self.tx = make_optimizer(optimizer, lr=lr, total_steps=total_steps)
        params = bundle.init(torch.Generator(device=self.device).manual_seed(init_seed))
        if param_dtype:
            params = cast_floating(params, param_dtype)
        step_rng = torch.Generator(device=self.device).manual_seed(seed)
        self.state = TrainState.create(params, self.tx, step_rng)
        self._step_fn = make_train_step(bundle.loss_fn, self.tx, accum_steps=accum_steps)
        # The synthetic stream is drawn on the host and moved to the device.
        self._data_gen = torch.Generator().manual_seed(seed)
        self._data = data
        self.metrics = MetricsWriter(metrics_path, volunteer_id)

    def data_iter(self) -> Iterator[Batch]:
        while True:
            yield self.bundle.make_batch(self._data_gen, self.batch_size)

    def _to_device(self, batch: Dict[str, Any]) -> Batch:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True) for k, v in batch.items()}

    def _record_target_crossed(self, cross_step: int, target_loss: float, t_start: float) -> Tuple[int, float]:
        wall = time.monotonic() - t_start
        log.info("target loss %.4f reached at step %d (%.1fs)", target_loss, cross_step, wall)
        self.metrics.record_event(
            cross_step, "target_crossed", {"target_loss": target_loss, "wall_s": round(wall, 3)}
        )
        return (cross_step, wall)

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
