"""DeviceFeed: host parse → fixed-shape batch → device tensors.

The single-device port of ``dmlc_tpu/device/feed.py``. The parser's
RowBlocks are re-batched as the reference's device-resident producer does
(``batch_size`` rows a batch, collected as zero-copy slices in a
``RowBlockContainer``, the tail kept for the next chunk, a short last
batch unless ``drop_remainder``), then padded into static shapes
(device/csr.py): a csr batch straight from the container into its staging
arrays (``emit_to_bucket``, one copy), a dense batch through
``block_to_dense``.

On a CUDA feed the padding writes straight into pinned host staging, the
copies are ``non_blocking``, and a staging buffer is handed out again only
after a CUDA event recorded behind its copy has completed (:class:`PinnedPool`,
the counterpart of the reference's ``FixedShapePool`` guarded by
``_transfer_done``). On a CPU feed the numpy arrays become tensors without a
copy.

Batch dicts carry the reference's keys: dense ``x``/``label``/``weight``,
csr ``label``/``weight``/``indices``/``values``/``offsets`` (CSR offsets,
not per-entry row ids: the step expands them on the device), plus the
``num_rows`` (and csr ``num_nonzero``) ints.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from dmlc_tpu_torch.data.parsers import Parser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlockContainer
from dmlc_tpu_torch.device.csr import block_to_dense, emit_to_bucket
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import check

_TORCH_DTYPE = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
}


@dataclass
class BatchSpec:
    """Static-shape contract for one feed."""

    batch_size: int
    layout: str = "dense"  # "dense" | "csr"
    num_features: int = 0  # required for dense; bounds csr feature ids
    drop_remainder: bool = False


class PinnedPool:
    """Pinned host staging arrays keyed by (shape, dtype), reused across
    batches. ``acquire`` returns a numpy view of a pinned tensor;
    ``retire(arrays, event)`` offers a batch's arrays back, and they are
    handed out again only once ``event`` (recorded on the stream behind
    their copies) has completed — never blocking: a buffer still being
    read is left retired and a fresh one allocated, so the pool grows to
    the in-flight depth and then stops allocating."""

    def __init__(self):
        self._free: Dict[tuple, list] = {}
        self._retired: deque = deque()  # (arrays, event)
        self._owner: Dict[int, tuple] = {}  # id(array) -> (array, tensor)
        self.allocated = 0
        self.reused = 0

    @staticmethod
    def _key(shape, dtype) -> tuple:
        if isinstance(shape, int):
            shape = (shape,)
        return tuple(shape), np.dtype(dtype).str

    def acquire(self, shape, dtype) -> np.ndarray:
        key = self._key(shape, dtype)
        self._drain()
        free = self._free.get(key)
        if free:
            self.reused += 1
            return free.pop()
        tensor = torch.empty(key[0], dtype=_TORCH_DTYPE[np.dtype(dtype)],
                             pin_memory=True)
        arr = tensor.numpy()
        self._owner[id(arr)] = (arr, tensor)
        self.allocated += 1
        return arr

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        """The pinned tensor behind an array this pool handed out."""
        return self._owner[id(arr)][1]

    def retire(self, arrays, event: torch.cuda.Event) -> None:
        self._retired.append((list(arrays), event))

    def _drain(self) -> None:
        # oldest first: copies on one stream complete in order
        while self._retired and self._retired[0][1].query():
            arrays, _ = self._retired.popleft()
            for arr in arrays:
                self._free.setdefault(
                    self._key(arr.shape, arr.dtype), []).append(arr)


class DeviceFeed:
    """Iterate fixed-shape device batches from a parser or a uri; a uri
    gets ``create_parser`` on the feed's device, so its libsvm chunks
    tokenize there too."""

    def __init__(self, source, spec: BatchSpec, device=None,
                 part_index: int = 0, num_parts: int = 1):
        check(spec.layout in ("dense", "csr"), "layout must be dense or csr")
        if spec.layout == "dense":
            check(spec.num_features > 0, "dense layout requires num_features")
        self.device = resolve_device(device)
        if isinstance(source, str):
            source = create_parser(source, part_index, num_parts,
                                   device=self.device)
        self._parser: Parser = source
        self.spec = spec
        self.pool = PinnedPool() if self.device.type == "cuda" else None

    # ---- host side: re-batch parser blocks into fixed-size batches ------
    def _host_batches(self) -> Iterator[RowBlockContainer]:
        """Containers of ``batch_size`` rows (the last one shorter unless
        ``drop_remainder``), each holding slices of the parser's blocks."""
        bs = self.spec.batch_size
        pending = RowBlockContainer()
        for block in self._parser:
            start = 0
            while start < len(block):
                take = min(bs - len(pending), len(block) - start)
                pending.push_block(block.slice(start, start + take))
                start += take
                if len(pending) == bs:
                    yield pending
                    pending = RowBlockContainer()
        if len(pending) and not self.spec.drop_remainder:
            yield pending

    # ---- device side ---------------------------------------------------
    def _put(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self.pool is None:
            return {k: torch.from_numpy(v) for k, v in arrays.items()}
        out = {
            k: self.pool.tensor(v).to(self.device, non_blocking=True)
            for k, v in arrays.items()
        }
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.pool.retire(arrays.values(), event)
        return out

    def _to_device(self, rows: RowBlockContainer) -> dict:
        spec = self.spec
        if spec.layout == "dense":
            x, labels, weights = block_to_dense(
                rows.to_block(), spec.batch_size, spec.num_features,
                pool=self.pool)
            out = self._put({"x": x, "label": labels, "weight": weights})
            out["num_rows"] = len(rows)
            return out
        # an out-of-range feature id would index past w on the device
        check(spec.num_features <= 0 or rows.num_nonzero == 0
              or rows.max_index < spec.num_features,
              "feature id %d out of range for num_features %d",
              rows.max_index, spec.num_features)
        batch = emit_to_bucket(rows, spec.batch_size, pool=self.pool)
        out = self._put({
            "label": batch.labels,
            "weight": batch.weights,
            "indices": batch.indices,
            "values": batch.values,
            "offsets": batch.offsets,
        })
        out["num_rows"] = batch.num_rows
        out["num_nonzero"] = batch.num_nonzero
        return out

    def __iter__(self):
        for rows in self._host_batches():
            yield self._to_device(rows)

    def before_first(self) -> None:
        self._parser.before_first()

    @property
    def bytes_read(self) -> int:
        return self._parser.bytes_read

    def close(self) -> None:
        self._parser.close()
