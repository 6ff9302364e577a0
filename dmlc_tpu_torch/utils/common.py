"""Small shared helpers (``include/dmlc/common.h``; the port of
``dmlc_tpu/utils/common.py``)."""

from __future__ import annotations

from typing import List


def split_string(s: str, delim: str) -> List[str]:
    """Split on a one-character delimiter and drop empty fields, as
    ``dmlc::Split`` (``std::getline`` over a stringstream) does."""
    return [part for part in s.split(delim) if part != ""]


def hash_combine(seed: int, value: int) -> int:
    """Boost's hash combine, wrapped to 64 bits."""
    mask = (1 << 64) - 1
    return (seed ^ (value + 0x9E3779B9 + ((seed << 6) & mask)
                    + (seed >> 2))) & mask
