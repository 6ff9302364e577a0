"""Logging and check layer (the subset of ``dmlc_tpu/utils/logging.py`` the
training path uses): ``DMLCError``, ``check``/``check_eq`` raising it, and
``log_info`` over the stdlib logger."""

from __future__ import annotations

import logging as _pylogging
import os
import sys
import traceback
from typing import Any

_LOGGER_NAME = "dmlc_tpu_torch"


class DMLCError(RuntimeError):
    """Error raised by failed checks (``dmlc::Error``). With
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


def log_info(msg: str, *args: Any) -> None:
    get_logger().info(msg % args if args else msg, stacklevel=2)


def log_warning(msg: str, *args: Any) -> None:
    get_logger().warning(msg % args if args else msg, stacklevel=2)


def check(cond: Any, msg: str = "", *args: Any) -> None:
    """CHECK(cond): raise DMLCError when cond is falsy."""
    if not cond:
        text = msg % args if args else msg
        raise DMLCError(f"Check failed: {text}" if text else "Check failed")


def check_eq(x: Any, y: Any, msg: str = "") -> None:
    if not x == y:
        detail = f" {msg}" if msg else ""
        raise DMLCError(f"Check failed: {x!r} == {y!r}{detail}")
