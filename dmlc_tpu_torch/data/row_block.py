"""CSR row batches: ``Row``, ``RowBlock`` and its growable builder
``RowBlockContainer`` (include/dmlc/data.h, src/data/row_block.h) — the
parts the parsers, the row iterators and the device feed use, copied from
``dmlc_tpu/data/row_block.py``.

A missing ``value`` means "all ones" and a missing ``weight`` means "all
1.0", like the reference's NULL pointers. Arrays are numpy; the device feed
pads them into static-shape tensors. ``RowBlockContainer.save`` / ``load``
are the cache-file page format, byte for byte the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from dmlc_tpu_torch.io.serializer import load_obj, save_obj
from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import check, check_eq

# data.h: real_t = float, index_t = unsigned
REAL_DTYPE = np.float32
INDEX_DTYPE = np.uint32


@dataclass
class Row:
    """One sparse row view (data.h:70-158)."""

    label: float
    index: np.ndarray
    value: Optional[np.ndarray] = None
    weight: float = 1.0
    qid: Optional[int] = None
    field: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.index)

    def get_value(self, i: int) -> float:
        """value == NULL means 1 (data.h:146-151)."""
        return 1.0 if self.value is None else float(self.value[i])

    def sdot(self, weight: np.ndarray) -> float:
        """Sparse dot with a dense vector (data.h:152-158)."""
        if self.value is None:
            return float(weight[self.index].sum())
        return float(weight[self.index] @ self.value)


class RowBlock:
    """Immutable CSR batch (data.h:170-230)."""

    def __init__(
        self,
        offset: np.ndarray,
        label: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
    ):
        self.offset = np.asarray(offset, dtype=np.int64)
        self.label = np.asarray(label, dtype=REAL_DTYPE)
        self.index = np.asarray(index)
        self.value = (None if value is None
                      else np.asarray(value, dtype=REAL_DTYPE))
        self.weight = (None if weight is None
                       else np.asarray(weight, dtype=REAL_DTYPE))
        self.qid = None if qid is None else np.asarray(qid, dtype=np.int64)
        self.field = None if field is None else np.asarray(field)
        check_eq(len(self.offset), len(self.label) + 1,
                 "offset/label mismatch")
        if len(self.offset):
            check_eq(int(self.offset[-1]), len(self.index),
                     "offset/index mismatch")

    def __len__(self) -> int:
        return len(self.label)

    @property
    def size(self) -> int:
        return len(self.label)

    @property
    def num_nonzero(self) -> int:
        return len(self.index)

    def __getitem__(self, i: int) -> Row:
        """Zero-copy row view (data.h:354-383)."""
        lo, hi = int(self.offset[i]), int(self.offset[i + 1])
        return Row(
            label=float(self.label[i]),
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=1.0 if self.weight is None else float(self.weight[i]),
            qid=None if self.qid is None else int(self.qid[i]),
            field=None if self.field is None else self.field[lo:hi],
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Sub-range view sharing data (data.h:210-230)."""
        check(0 <= begin <= end <= len(self), "bad slice range")
        lo, hi = int(self.offset[begin]), int(self.offset[end])
        return RowBlock(
            offset=self.offset[begin: end + 1] - lo,
            label=self.label[begin:end],
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=None if self.weight is None else self.weight[begin:end],
            qid=None if self.qid is None else self.qid[begin:end],
            field=None if self.field is None else self.field[lo:hi],
        )

    def mem_cost_bytes(self) -> int:
        """Bytes of the arrays (data.h MemCostBytes:194-208)."""
        cost = self.offset.nbytes + self.label.nbytes + self.index.nbytes
        for arr in (self.value, self.weight, self.qid, self.field):
            if arr is not None:
                cost += arr.nbytes
        return cost

    def num_col(self) -> int:
        """max feature index + 1 (basic_row_iter.h:46)."""
        return int(self.index.max()) + 1 if len(self.index) else 0

    def audit_arrays(self):
        """Canonical field-major array stream for the determinism-audit
        digest (obs/audit.py): ``[(tag, [array, ...]), ...]``, the JAX
        package's stream byte for byte.

        Defined over the block's *logical* content — per-row lengths
        instead of cumulative offsets (slice-rebase invariant), and the
        reference's NULL-pointer defaults materialized (missing
        value/weight → ones, missing qid → zeros, data.h:120-158) — so a
        :class:`RowBlockContainer` hashes byte-identically to the
        ``to_block()`` it would produce, and two pipelines that deliver
        the same rows digest equal however the rows were chunked or
        sliced."""
        n = len(self.label)
        nnz = len(self.index)
        out = [
            (b"label", [self.label]),
            (b"counts", [np.diff(self.offset)]),
            (b"index", [self.index]),
            (b"value", [np.ones(nnz, dtype=REAL_DTYPE)
                        if self.value is None else self.value]),
            (b"weight", [np.ones(n, dtype=REAL_DTYPE)
                         if self.weight is None else self.weight]),
            (b"qid", [np.zeros(n, dtype=np.int64)
                      if self.qid is None else self.qid]),
        ]
        if self.field is not None:
            out.append((b"field", [self.field]))
        return out

    def to_dense(self, num_col: Optional[int] = None) -> np.ndarray:
        """A dense [rows, num_col] f32 copy (for tests and small data)."""
        ncol = num_col if num_col is not None else self.num_col()
        out = np.zeros((len(self), ncol), dtype=REAL_DTYPE)
        values = (np.ones(len(self.index), dtype=REAL_DTYPE)
                  if self.value is None else self.value)
        rows = np.repeat(np.arange(len(self)), np.diff(self.offset))
        out[rows, self.index] = values
        return out


class RowBlockContainer:
    """Growable CSR builder (src/data/row_block.h:26-215).

    Internals are lists of numpy array parts concatenated once at
    ``to_block``. weight/qid/value follow an any-present policy: parts
    that omitted them get neutral defaults (1.0 / 0 / ones).
    """

    def __init__(self, index_dtype=INDEX_DTYPE):
        self.index_dtype = index_dtype
        self.clear()

    def clear(self) -> None:
        self._count_parts: List[np.ndarray] = []
        self._label_parts: List[np.ndarray] = []
        self._weight_parts: List[Optional[np.ndarray]] = []
        self._qid_parts: List[Optional[np.ndarray]] = []
        self._index_parts: List[np.ndarray] = []
        self._value_parts: List[Optional[np.ndarray]] = []
        self._field_parts: List[Optional[np.ndarray]] = []
        self._any_weight = False
        self._any_qid = False
        self._any_value = False
        self.max_index = 0
        self._nrows = 0
        self._nnz = 0

    @property
    def size(self) -> int:
        return self._nrows

    def __len__(self) -> int:
        return self._nrows

    @property
    def num_nonzero(self) -> int:
        return self._nnz

    def push_row(
        self,
        label: float,
        index: Sequence[int],
        value: Optional[Sequence[float]] = None,
        weight: Optional[float] = None,
        qid: Optional[int] = None,
        field: Optional[Sequence[int]] = None,
    ) -> None:
        self.push_arrays(
            np.asarray([label], dtype=REAL_DTYPE),
            np.asarray([len(index)], dtype=np.int64),
            np.asarray(index, dtype=self.index_dtype),
            value=(None if value is None
                   else np.asarray(value, dtype=REAL_DTYPE)),
            weight=(None if weight is None
                    else np.asarray([weight], dtype=REAL_DTYPE)),
            qid=None if qid is None else np.asarray([qid], dtype=np.int64),
            field=None if field is None else np.asarray(field),
        )

    def push_arrays(
        self,
        labels: np.ndarray,
        counts: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
    ) -> None:
        """Bulk append many rows at once (the vectorized parser path)."""
        check_eq(len(labels), len(counts), "labels/counts mismatch")
        if weight is not None:
            check_eq(len(weight), len(labels), "weight/labels mismatch")
            self._any_weight = True
        if qid is not None:
            check_eq(len(qid), len(labels), "qid/labels mismatch")
            self._any_qid = True
        self._any_value = self._any_value or value is not None
        self._label_parts.append(np.asarray(labels, dtype=REAL_DTYPE))
        self._count_parts.append(np.asarray(counts, dtype=np.int64))
        self._weight_parts.append(weight)
        self._qid_parts.append(qid)
        idx = np.asarray(index, dtype=self.index_dtype)
        if len(idx):
            self.max_index = max(self.max_index, int(idx.max()))
        self._index_parts.append(idx)
        self._value_parts.append(
            None if value is None else np.asarray(value, dtype=REAL_DTYPE))
        self._field_parts.append(None if field is None else np.asarray(field))
        self._nrows += len(labels)
        self._nnz += len(idx)

    def push_block(self, block: RowBlock) -> None:
        """Append a whole RowBlock (row_block.h Push(RowBlock))."""
        self.push_arrays(
            block.label,
            np.diff(block.offset),
            block.index,
            value=block.value,
            weight=block.weight,
            qid=block.qid,
            field=block.field,
        )

    def audit_arrays(self):
        """The container twin of :meth:`RowBlock.audit_arrays`: the same
        canonical stream walked part by part, *without* ``to_block``'s
        concatenation — field-major over parts, neutral defaults filled
        per part. Parts hash back to back within a field, so this is
        byte-identical to ``self.to_block().audit_arrays()``."""
        out = [
            (b"label", list(self._label_parts)),
            (b"counts", list(self._count_parts)),
            (b"index", list(self._index_parts)),
            (b"value", [
                np.ones(len(idx), dtype=REAL_DTYPE) if v is None else v
                for v, idx in zip(self._value_parts, self._index_parts)
            ]),
            (b"weight", [
                np.ones(len(lbl), dtype=REAL_DTYPE) if w is None else w
                for w, lbl in zip(self._weight_parts, self._label_parts)
            ]),
            (b"qid", [
                np.zeros(len(lbl), dtype=np.int64) if q is None else q
                for q, lbl in zip(self._qid_parts, self._label_parts)
            ]),
        ]
        fields_present = [f for f in self._field_parts if f is not None]
        if fields_present:
            out.append((b"field", fields_present))
        return out

    @staticmethod
    def _cat(parts, empty_dtype):
        """Concatenate parts; a lone part is handed over without a copy
        (parts are append-only and never mutated after push)."""
        if len(parts) == 1:
            return parts[0]
        if not parts:
            return np.empty(0, dtype=empty_dtype)
        return np.concatenate(parts)

    def to_block(self) -> RowBlock:
        """Finalize into a RowBlock (row_block.h GetBlock)."""
        nrows = self._nrows
        counts = self._cat(self._count_parts, np.int64)
        offset = np.zeros(nrows + 1, dtype=np.int64)
        np.cumsum(counts, out=offset[1:])
        index = self._cat(self._index_parts, self.index_dtype)
        label = self._cat(self._label_parts, REAL_DTYPE)
        value = None
        if self._any_value:
            value = self._cat(
                [np.ones(len(idx), dtype=REAL_DTYPE) if v is None else v
                 for v, idx in zip(self._value_parts, self._index_parts)],
                REAL_DTYPE,
            )
        fields_present = [f for f in self._field_parts if f is not None]
        field = (self._cat(fields_present, INDEX_DTYPE)
                 if fields_present else None)
        weight = None
        if self._any_weight and nrows:
            weight = self._cat(
                [np.ones(len(lbl), dtype=REAL_DTYPE) if w is None else w
                 for w, lbl in zip(self._weight_parts, self._label_parts)],
                REAL_DTYPE,
            )
        qid = None
        if self._any_qid and nrows:
            qid = self._cat(
                [np.zeros(len(lbl), dtype=np.int64) if q is None else q
                 for q, lbl in zip(self._qid_parts, self._label_parts)],
                np.int64,
            )
        return RowBlock(offset=offset, label=label, index=index, value=value,
                        weight=weight, qid=qid, field=field)

    def emit_csr_into(
        self,
        labels: np.ndarray,
        weights: np.ndarray,
        indices: np.ndarray,
        values: np.ndarray,
        offsets: np.ndarray,
    ) -> tuple:
        """Write the accumulated rows straight into caller-provided CSR
        staging arrays, skipping ``to_block``'s concatenation: each pushed
        part lands once, in order, where the device copy reads.
        ``offsets`` needs room for ``size + 1`` entries and is written
        from 0; parts without weights or values emit 1.0. Returns
        ``(nrows, nnz)`` written; the caller zeroes any pad tail. qid and
        field do not ride the device batch and are not emitted."""
        check(len(labels) >= self._nrows, "labels staging too small")
        check(len(offsets) >= self._nrows + 1, "offsets staging too small")
        check(len(indices) >= self._nnz, "indices staging too small")
        row = 0
        ent = 0
        offsets[0] = 0
        for i, lbl in enumerate(self._label_parts):
            n = len(lbl)
            idx = self._index_parts[i]
            m = len(idx)
            labels[row:row + n] = lbl
            w = self._weight_parts[i]
            weights[row:row + n] = 1.0 if w is None else w
            if n:
                offsets[row + 1:row + n + 1] = ent + np.cumsum(
                    self._count_parts[i])
            indices[ent:ent + m] = idx
            v = self._value_parts[i]
            values[ent:ent + m] = 1.0 if v is None else v
            row += n
            ent += m
        check_eq(row, self._nrows, "emit_csr_into row count drift")
        check_eq(ent, self._nnz, "emit_csr_into nnz drift")
        return row, ent

    # ---- binary page format (row_block.h:189-215) ----------------------
    def save(self, stream: Stream) -> None:
        block = self.to_block()
        save_obj(stream, {
            "offset": block.offset,
            "label": block.label,
            "index": block.index,
            "value": block.value,
            "weight": block.weight,
            "qid": block.qid,
            "field": block.field,
            "max_index": self.max_index,
        })

    @classmethod
    def load(cls, stream: Stream) -> "RowBlockContainer":
        """One page from ``stream``; EOFError at the end of the stream."""
        payload = load_obj(stream)
        out = cls()
        out.push_block(RowBlock(
            offset=payload["offset"],
            label=payload["label"],
            index=payload["index"],
            value=payload["value"],
            weight=payload["weight"],
            qid=payload["qid"],
            field=payload["field"],
        ))
        out.max_index = int(payload["max_index"])
        return out

    def mem_cost_bytes(self) -> int:
        """Size of the finalized block, computed from the counts alone
        (data.h MemCostBytes:194-208)."""
        nrows = self._nrows
        idx_item = np.dtype(self.index_dtype).itemsize
        cost = (nrows + 1) * 8 + nrows * 4 + self._nnz * idx_item
        if self._any_value:
            cost += self._nnz * 4
        if self._any_weight:
            cost += nrows * 4
        if self._any_qid:
            cost += nrows * 8
        if any(f is not None for f in self._field_parts):
            cost += self._nnz * idx_item
        return cost
