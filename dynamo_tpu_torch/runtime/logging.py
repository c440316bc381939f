"""Structured logging init, a copy of ``dynamo_tpu/runtime/logging.py``:
env-driven level filter (``DYN_LOG``), optional JSONL mode
(``DYN_LOGGING_JSONL``) for machine-ingestible logs. Every record is
stamped with the current request id (dyntrace contextvar) so JSONL logs
are joinable with traces and client-side X-Request-Id records."""

from __future__ import annotations

import json
import logging
import sys
import time

from . import tracing
from .config import env_bool, env_str


class RequestIdFilter(logging.Filter):
    """Stamps ``record.request_id`` from the ambient request context —
    bound by the HTTP frontend, endpoint handlers and the prefill worker
    — independent of trace sampling (log joins work at sample=0)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = tracing.current_request_id() or ""
        return True


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        rid = getattr(record, "request_id", "")
        if rid:
            out["request_id"] = rid
        if record.exc_info:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


class TextFormatter(logging.Formatter):
    """Default human format, with ``[rid]`` appended when a request id is
    bound (kept out of the format string so records without the filter —
    e.g. other libraries' handlers — still render)."""

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        rid = getattr(record, "request_id", "")
        return f"{base} [{rid}]" if rid else base


_initialized = False


def init(level: str | None = None, jsonl: bool | None = None) -> None:
    global _initialized
    if _initialized:
        return
    _initialized = True
    level = (level or env_str("DYN_LOG")).upper()
    if jsonl is None:
        jsonl = env_bool("DYN_LOGGING_JSONL")
    handler = logging.StreamHandler(sys.stderr)
    handler.addFilter(RequestIdFilter())
    if jsonl:
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(TextFormatter(
            "%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S"))
    root = logging.getLogger()
    root.addHandler(handler)
    try:
        root.setLevel(level)
    except ValueError:
        root.setLevel(logging.INFO)
