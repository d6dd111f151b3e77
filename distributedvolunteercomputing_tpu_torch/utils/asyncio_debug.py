"""Asyncio-level race/stall detection (SURVEY.md §5 "race detection").

The swarm tier is one event loop per process running DHT RPCs, heartbeats,
averaging rounds, and state serving concurrently. The failure mode that
breaks it is not a data race (single-threaded loop) but a BLOCKED LOOP: a
handler doing param-sized numpy work (or a cross-thread call sneaking a
synchronous device transfer in) freezes every timer, so heartbeats miss
their TTL and live peers get evicted as dead — which then looks exactly
like network churn and gets debugged in the wrong layer.

Two complementary detectors:

- ``LoopHealthMonitor`` measures scheduling latency directly: a sentinel
  task sleeps a short interval and records how late it wakes. Catches ANY
  blockage — including native code that asyncio's own debug instrumentation
  can't attribute — and keeps a bounded stall history tests can assert on.
- ``enable_debug`` additionally flips asyncio's built-in debug mode
  (``loop.slow_callback_duration``), which NAMES the offending callback in
  the log — attribution when the monitor says something stalled.

Production entrypoints call ``maybe_enable_from_env()``: set
``DVC_ASYNC_DEBUG=1`` to arm both on a live volunteer/coordinator. The
chaos tests arm the monitor directly and assert on ``stalls``.
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional, Tuple

from distributedvolunteercomputing_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class LoopHealthMonitor:
    """Sentinel task measuring event-loop scheduling latency.

    ``stalls`` holds (loop_time, lag_seconds) for every wakeup that was more
    than ``stall_threshold`` late — i.e. some callback/coroutine held the
    loop for at least that long. Bounded to the most recent ``max_records``.
    """

    def __init__(
        self,
        interval: float = 0.05,
        stall_threshold: float = 0.25,
        max_records: int = 256,
    ):
        self.interval = interval
        self.stall_threshold = stall_threshold
        self.max_records = max_records
        self.stalls: List[Tuple[float, float]] = []
        self.total_lag: float = 0.0
        self._task: Optional[asyncio.Task] = None

    def start(self) -> "LoopHealthMonitor":
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        last = loop.time()
        while True:
            await asyncio.sleep(self.interval)
            now = loop.time()
            lag = now - last - self.interval
            last = now
            if lag > self.stall_threshold:
                self.total_lag += lag
                self.stalls.append((now, lag))
                del self.stalls[: -self.max_records]
                log.warning(
                    "asyncio loop stalled %.3fs (threshold %.3fs): a handler is "
                    "doing blocking work on the loop — heartbeats/timeouts were "
                    "frozen for the duration",
                    lag,
                    self.stall_threshold,
                )


def enable_debug(
    slow_callback_s: float = 0.2,
    stall_threshold: float = 0.25,
) -> LoopHealthMonitor:
    """Arm both detectors on the RUNNING loop; returns the monitor."""
    loop = asyncio.get_running_loop()
    loop.set_debug(True)
    loop.slow_callback_duration = slow_callback_s
    return LoopHealthMonitor(stall_threshold=stall_threshold).start()


def maybe_enable_from_env() -> Optional[LoopHealthMonitor]:
    """Arm detectors iff DVC_ASYNC_DEBUG is set (entrypoint hook)."""
    if os.environ.get("DVC_ASYNC_DEBUG", "") not in ("", "0"):
        return enable_debug()
    return None
