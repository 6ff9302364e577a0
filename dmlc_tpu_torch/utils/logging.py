"""Logging and check layer (the port of ``dmlc_tpu/utils/logging.py``):
``DMLCError``, the ``check`` family raising it, the log levels over the
stdlib logger or a sink installed with :func:`set_log_sink`, and
:class:`LogOncePer`."""

from __future__ import annotations

import logging as _pylogging
import os
import sys
import time
import traceback
from typing import Any, Callable, Optional

_LOGGER_NAME = "dmlc_tpu_torch"


class DMLCError(RuntimeError):
    """Error raised by failed checks and fatal logs (``dmlc::Error``). With
    ``DMLC_LOG_STACK_TRACE`` truthy (default on) the message carries the
    Python stack at the raise site."""

    def __init__(self, msg: str):
        if os.environ.get("DMLC_LOG_STACK_TRACE", "1").lower() not in (
                "0", "false", ""):
            tb = "".join(traceback.format_stack()[:-2])
            msg = f"{msg}\n\nStack trace:\n{tb}"
        super().__init__(msg)


def get_logger() -> _pylogging.Logger:
    """The package logger; lazily configured with a stderr handler."""
    logger = _pylogging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = _pylogging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _pylogging.Formatter(
                fmt="[%(asctime)s] %(levelname)s %(filename)s:%(lineno)d: "
                    "%(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(handler)
        level = os.environ.get("DMLC_LOG_LEVEL", "INFO").upper()
        logger.setLevel(getattr(_pylogging, level, _pylogging.INFO))
    return logger


# a sink(severity, message) that takes every log line instead of the stdlib
# logger (DMLC_LOG_CUSTOMIZE)
_custom_sink: Optional[Callable[[str, str], None]] = None


def set_log_sink(sink: Optional[Callable[[str, str], None]]) -> None:
    """Send every log line to ``sink(severity, message)``; None restores
    the stdlib logger."""
    global _custom_sink
    _custom_sink = sink


def _emit(severity: str, msg: str) -> None:
    if _custom_sink is not None:
        _custom_sink(severity, msg)
        return
    get_logger().log(getattr(_pylogging, severity, _pylogging.INFO), msg,
                     stacklevel=3)


def log_debug(msg: str, *args: Any) -> None:
    _emit("DEBUG", msg % args if args else msg)


def log_info(msg: str, *args: Any) -> None:
    _emit("INFO", msg % args if args else msg)


def log_warning(msg: str, *args: Any) -> None:
    _emit("WARNING", msg % args if args else msg)


def log_error(msg: str, *args: Any) -> None:
    _emit("ERROR", msg % args if args else msg)


def log_fatal(msg: str, *args: Any) -> None:
    """LOG(FATAL): log at ERROR, then raise DMLCError (the
    DMLC_LOG_FATAL_THROW=1 behaviour)."""
    text = msg % args if args else msg
    _emit("ERROR", text)
    raise DMLCError(text)


def check(cond: Any, msg: str = "", *args: Any) -> None:
    """CHECK(cond): raise DMLCError when cond is falsy."""
    if not cond:
        text = msg % args if args else msg
        raise DMLCError(f"Check failed: {text}" if text else "Check failed")


def _check_op(op_name: str, ok: bool, x: Any, y: Any, msg: str) -> None:
    if not ok:
        detail = f" {msg}" if msg else ""
        raise DMLCError(f"Check failed: {x!r} {op_name} {y!r}{detail}")


def check_eq(x: Any, y: Any, msg: str = "") -> None:
    _check_op("==", x == y, x, y, msg)


def check_ne(x: Any, y: Any, msg: str = "") -> None:
    _check_op("!=", x != y, x, y, msg)


def check_lt(x: Any, y: Any, msg: str = "") -> None:
    _check_op("<", x < y, x, y, msg)


def check_le(x: Any, y: Any, msg: str = "") -> None:
    _check_op("<=", x <= y, x, y, msg)


def check_gt(x: Any, y: Any, msg: str = "") -> None:
    _check_op(">", x > y, x, y, msg)


def check_ge(x: Any, y: Any, msg: str = "") -> None:
    _check_op(">=", x >= y, x, y, msg)


def check_notnull(x: Any, msg: str = "") -> Any:
    """CHECK_NOTNULL: raise if ``x`` is None, else return it."""
    if x is None:
        raise DMLCError(f"Check notnull failed: {msg}" if msg
                        else "Check notnull failed")
    return x


class LogOncePer:
    """Log at INFO at most once every ``period`` seconds; a call returns
    whether it logged."""

    def __init__(self, period: float = 10.0):
        self.period = period
        self._last = 0.0

    def __call__(self, msg: str, *args: Any) -> bool:
        now = time.monotonic()
        if now - self._last >= self.period:
            self._last = now
            log_info(msg, *args)
            return True
        return False
