"""Collectives over a sequence-parallel process group (``parallel.axis``):
the counterpart of the ``jax.lax`` axis primitives that
``ops/sequence_parallel.py`` uses inside ``shard_map``."""

from dmlc_tpu_torch.parallel.axis import (
    all_to_all,
    axis_index,
    axis_size,
    ppermute,
)

__all__ = ["all_to_all", "axis_index", "axis_size", "ppermute"]
