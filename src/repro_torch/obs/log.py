"""Structured JSON-lines logging for the serving stack (copy of
``repro.obs.log`` under the ``repro_torch`` logger root).

Loggers live under the ``"repro_torch"`` hierarchy
(``repro_torch.serving.engine``, ...). ``setup_logging`` configures that
*parent* once — handler, level, text vs JSON — so library modules just
``get_logger(__name__)`` and emit; nothing is configured at import
time, and the root logger is never touched (embedding apps keep their
own logging).

JSON mode emits one object per line with a stable core
(``ts``/``level``/``logger``/``msg``) plus any context fields passed
via ``extra=`` — the serving stack uses ``uid``, ``engine``, ``gang``,
and ``trace_id`` so log lines join against trace exports and metrics
by the same identifiers.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

# Context keys the serving stack attaches via ``extra=``; anything
# else non-standard on the record is passed through too.
_CORE = ("ts", "level", "logger", "msg")
_STD_ATTRS = frozenset(logging.LogRecord(
    "", 0, "", 0, "", (), None).__dict__) | {
        "message", "asctime", "taskName"}


class JsonFormatter(logging.Formatter):
    """One JSON object per record; ``extra=`` fields ride along."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for k, v in record.__dict__.items():
            if k not in _STD_ATTRS and k not in _CORE:
                doc[k] = v
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc, default=str)


class TextFormatter(logging.Formatter):
    """Human-oriented single line, context fields appended as k=v."""

    def format(self, record: logging.LogRecord) -> str:
        base = (f"{time.strftime('%H:%M:%S', time.localtime(record.created))}"
                f" {record.levelname:<7} {record.name}: "
                f"{record.getMessage()}")
        ctx = " ".join(f"{k}={v}" for k, v in record.__dict__.items()
                       if k not in _STD_ATTRS and k not in _CORE)
        if ctx:
            base = f"{base} [{ctx}]"
        if record.exc_info:
            base = f"{base}\n{self.formatException(record.exc_info)}"
        return base


def setup_logging(level: str = "info", json_mode: bool = False,
                  stream=None) -> logging.Logger:
    """(Re)configure the ``repro_torch`` parent logger. Idempotent: replaces
    any handler a previous call installed rather than stacking."""
    root = logging.getLogger("repro_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    fmt: logging.Formatter = JsonFormatter() if json_mode \
        else TextFormatter()
    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(fmt)
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.propagate = False
    return root


def get_logger(name: Optional[str] = None) -> logging.Logger:
    """Logger under the ``repro_torch`` hierarchy. Module callers pass
    ``__name__`` (already ``repro_torch.*``); bare names are nested."""
    if not name:
        return logging.getLogger("repro_torch")
    if name == "repro_torch" or name.startswith("repro_torch."):
        return logging.getLogger(name)
    return logging.getLogger(f"repro_torch.{name}")
