"""Typed environment-variable reads (``get_env`` of
``dmlc_tpu/params/env.py``; reference GetEnv, parameter.h:1035-1063): how
the observability layer reads its settings."""

from __future__ import annotations

import os
from typing import Optional, Type, TypeVar

from dmlc_tpu_torch.params.parameter import FieldInfo

T = TypeVar("T")


def get_env(key: str, default: T, ftype: Optional[Type[T]] = None) -> T:
    """Read env var ``key`` parsed as the type of ``default``, with the
    Parameter fields' string parsing (bool accepts true/false/1/0). A
    missing variable returns ``default``."""
    raw = os.environ.get(key)
    if raw is None:
        return default
    info = FieldInfo(ftype or type(default), default)
    info.name = key
    return info.parse(raw)  # type: ignore[return-value]

