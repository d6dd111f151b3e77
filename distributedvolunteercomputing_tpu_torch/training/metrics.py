"""Per-volunteer metrics: JSONL records + samples/sec/chip.

The headline metric is samples/sec/volunteer-chip and time-to-target-loss
(BASELINE.json:2). Each volunteer writes one JSONL stream; the coordinator
aggregates swarm-level numbers (SURVEY.md §5).
"""

from __future__ import annotations

import json
import threading
import time
from typing import IO, Any, Dict, Optional


class MetricsWriter:
    def __init__(self, path: Optional[str] = None, volunteer_id: str = "local"):
        self.volunteer_id = volunteer_id
        self._fh: Optional[IO[str]] = open(path, "a") if path else None
        # Events also come from the checkpoint writer thread: one line each.
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._samples = 0
        self._last_rate_t = self._t0
        self._last_rate_samples = 0

    @property
    def has_sink(self) -> bool:
        return self._fh is not None

    def count_samples(self, n: int) -> None:
        """Cheap path: bump the sample counter without touching metric values."""
        self._samples += n

    def _emit(self, step: int, fields: Dict[str, Any]) -> None:
        if self._fh is not None:
            rec = {
                "t": round(time.monotonic() - self._t0, 4),
                "volunteer": self.volunteer_id,
                "step": step,
                **fields,
            }
            line = json.dumps(rec) + "\n"
            with self._lock:
                self._fh.write(line)
                self._fh.flush()

    def record(self, step: int, metrics: Dict[str, Any], n_samples: int = 0) -> None:
        self._samples += n_samples
        self._emit(step, {k: float(v) for k, v in metrics.items()})

    def record_event(self, step: int, event: str, fields: Dict[str, Any]) -> None:
        """Non-metric timeline record (e.g. one averaging round's wall-clock
        and outcome); same JSONL stream, tagged by ``event``."""
        self._emit(step, {"event": event, **fields})

    def samples_per_sec(self) -> float:
        """Rate since the previous call (windowed, not lifetime)."""
        now = time.monotonic()
        dt = now - self._last_rate_t
        ds = self._samples - self._last_rate_samples
        self._last_rate_t, self._last_rate_samples = now, self._samples
        return ds / dt if dt > 0 else 0.0

    @property
    def total_samples(self) -> int:
        return self._samples

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
