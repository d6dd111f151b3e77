"""Per-volunteer structured logging.

Swarm-level metric aggregation happens at the coordinator (SURVEY.md §5);
each process logs human-readable lines to stderr by default, or — with
``DVC_LOG_JSON=1`` — machine-readable JSONL carrying the ambient swarm
context (peer id, round key, hierarchy level, zone) so a fleet's stderr
can be shipped to a log store and joined against traces without regex
archaeology. Every swarm module routes through :func:`get_logger`, so the
mode and the context fields apply uniformly.

Context comes from two layers:

- **static fields** (:func:`set_log_fields`): per-process identity —
  peer id, zone — set once at volunteer startup;
- **ambient context** (:func:`log_context`): a contextvar bound around a
  round (round key / trace, level, group) by the averaging tier; it
  follows asyncio tasks the way contextvars do, so concurrent rounds
  don't smear each other's fields.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import sys
from typing import Any, Dict, Iterator

_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"

# Process-static fields (peer id, zone, role) merged into every JSONL line.
_STATIC_FIELDS: Dict[str, Any] = {}

# Ambient per-task fields (round_key/trace, level, group) — bound by the
# averaging tier around a round via log_context().
_LOG_CTX: contextvars.ContextVar[Dict[str, Any]] = contextvars.ContextVar(
    "dvc_log_ctx", default={}
)


def set_log_fields(**fields: Any) -> None:
    """Set process-static structured-log fields (e.g. peer=, zone=).
    Only meaningful in JSONL mode; a no-op cost otherwise."""
    for k, v in fields.items():
        if v is None:
            _STATIC_FIELDS.pop(k, None)
        else:
            _STATIC_FIELDS[k] = v


@contextlib.contextmanager
def log_context(**fields: Any) -> Iterator[None]:
    """Bind ambient structured-log fields for the enclosed (async) scope.
    Nested scopes overlay; fields with value None are dropped."""
    cur = dict(_LOG_CTX.get())
    for k, v in fields.items():
        if v is None:
            cur.pop(k, None)
        else:
            cur[k] = v
    token = _LOG_CTX.set(cur)
    try:
        yield
    finally:
        try:
            _LOG_CTX.reset(token)
        except ValueError:
            pass


def current_log_context() -> Dict[str, Any]:
    """The merged static + ambient fields (for tests and custom sinks)."""
    return {**_STATIC_FIELDS, **_LOG_CTX.get()}


class JsonFormatter(logging.Formatter):
    """One JSON object per line: ts, level, logger, msg, plus the merged
    static + ambient context fields. Non-serializable context values are
    stringified rather than killing the log call."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info and record.exc_info[1] is not None:
            out["exc"] = errstr(record.exc_info[1])
        core = set(out)
        for k, v in {**_STATIC_FIELDS, **_LOG_CTX.get()}.items():
            # Core record fields win: a context field named "level" must
            # not overwrite the severity (it lands prefixed instead).
            out[f"ctx_{k}" if k in core else k] = v
        try:
            return json.dumps(out, separators=(",", ":"))
        except (TypeError, ValueError):
            return json.dumps(
                {k: str(v) for k, v in out.items()}, separators=(",", ":")
            )


def json_mode_enabled() -> bool:
    return os.environ.get("DVC_LOG_JSON", "") not in ("", "0")


def errstr(e: BaseException) -> str:
    """``TypeName: message`` for log lines.

    Logging the bare exception renders common failures invisibly:
    ``str(asyncio.TimeoutError())`` and ``str(CancelledError())`` are "",
    which produced real ``averaging at step 90 failed: `` lines during the
    round-4 hardware overlap run — the one context (a wedged chip, a timed-
    out round) where the TYPE is the whole diagnosis."""
    msg = str(e)
    name = type(e).__name__
    return f"{name}: {msg}" if msg else name


def _make_formatter() -> logging.Formatter:
    if json_mode_enabled():
        return JsonFormatter()
    return logging.Formatter(_FORMAT, datefmt="%H:%M:%S")


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(_make_formatter())
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("DVC_LOGLEVEL", "INFO").upper())
        logger.propagate = False
    return logger


__all__ = [
    "errstr",
    "get_logger",
    "log_context",
    "set_log_fields",
    "current_log_context",
    "json_mode_enabled",
    "JsonFormatter",
]
