"""Collectives over a process group (``parallel.axis``): the counterpart of
the ``jax.lax`` axis primitives that ``ops/sequence_parallel.py``,
``ops/moe.py`` and ``ops/pipeline_parallel.py`` use inside ``shard_map``;
and the multi-process bootstrap (``parallel.distributed``)."""

from dmlc_tpu_torch.parallel.axis import (
    all_to_all,
    axis_index,
    axis_size,
    keep_in_graph,
    pmean,
    ppermute,
    psum,
    pvary,
)

__all__ = ["all_to_all", "axis_index", "axis_size", "keep_in_graph",
           "pmean", "ppermute", "psum", "pvary"]
