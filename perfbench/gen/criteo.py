"""Seeded Criteo-shaped rows and their libfm text, with no per-row Python.

A row has one entry in each of its 39 fields, each field with its own
range of ids in [1, num_ids], laid out in field order, so the ids of a row
are sorted and never repeat, and entry j is written with field j. Field j
takes ``field_values[j]`` distinct values, its value of rank r (0 the
commonest) with the chance of ``floor((c + 1) ** u) - 1 == r`` for uniform
u: a power law, ~1 / (r + 1). As in the preprocessing that LIBSVM's
``criteo`` comes from, values expected fewer than ``rare_below`` times in
the published rows fold into one token of their field, and the values are
hashed into the ``num_ids`` ids: here each field's kept values and token
share a range (:func:`field_ranges`), value r at id ``1 + start + r mod
size``.
Values are k / 10000 for a uniform integer k in [0, 10000), written with
four decimals, so the text holds them exactly. The text is libfm
(``field:id:value``) or libsvm (``id:value``), which row-group RecordIO is
converted from, since its records carry no fields. Labels 0/1 come from a
planted sparse linear rule with noise: a row's score is the sum of its
values times a seeded weight of each id, plus 0.5 N(0, 1), and the
rows with the top 25.6 % of scores (the Kaggle set's click rate) are
clicks. Everything is drawn from ``seed``
in blocks, so the same seed gives the same rows and the same bytes.
"""

from __future__ import annotations

import functools
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

BLOCK_ROWS = 1 << 16


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one named stream of one seed. Any whole number is a
    seed: it is taken modulo 2**64."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


@dataclass
class CriteoRows:
    """Rows as arrays: labels [N] f32, ids [N, fields] int32 (sorted in
    each row), values [N, fields] f32, and the integer k of each value
    [N, fields] int16 (value = k / 10000)."""

    labels: np.ndarray
    ids: np.ndarray
    values: np.ndarray
    value_k: np.ndarray

    @property
    def num_rows(self) -> int:
        return int(self.labels.shape[0])


@functools.lru_cache(maxsize=8)
def field_ranges(field_values: tuple, num_ids: int, published_rows: int,
                 rare_below: int) -> tuple:
    """(values, starts, sizes), int64 [fields] each: the values each field
    keeps (those expected at least ``rare_below`` times in
    ``published_rows`` rows under the power law, plus the one token the
    rest fold into), and the range of ids each field's values are hashed
    into: every field gets as many ids as it keeps values, capped at the
    one size that lets the ranges fill ``num_ids``."""
    c = np.asarray(field_values, np.int64)
    if len(c) > num_ids:
        raise ValueError("fewer ids than fields")
    # rank r's chance is log((r + 2) / (r + 1)) / log(c + 1)
    last = np.floor(1.0 / np.expm1(rare_below * np.log1p(c)
                                   / published_rows)).astype(np.int64)
    values = np.where(last < c, last + 1, c)
    lo, hi = 1, int(values.max())
    while lo < hi:
        cap = (lo + hi + 1) // 2
        if np.minimum(values, cap).sum() <= num_ids:
            lo = cap
        else:
            hi = cap - 1
    sizes = np.minimum(values, lo)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return values, starts, sizes


def _row_block(seed: int, block: int, n: int, true_w: np.ndarray,
               ranges: tuple, field_values: np.ndarray):
    values, starts, sizes = ranges
    rng = rng_for(seed, 2 + block)
    u = rng.random((n, len(values)))
    rank = np.floor(np.exp(u * np.log1p(field_values))).astype(np.int64) - 1
    rank = np.minimum(np.minimum(rank, field_values - 1), values - 1)
    ids = 1 + starts + rank % sizes
    k = rng.integers(0, 10000, (n, len(values)))
    score = (k / 10000.0 * true_w[ids]).sum(axis=1) \
        + 0.5 * rng.standard_normal(n)
    return score, ids, k


def criteo_rows(rows: int, seed: int, field_values, num_ids: int,
                published_rows: int, rare_below: int,
                positive_share: float = 0.256,
                threads: int = 4) -> CriteoRows:
    """``rows`` seeded rows (module docstring), made in blocks of
    :data:`BLOCK_ROWS`, each from its own stream of the seed, on
    ``threads`` threads; the ``positive_share`` of rows with the highest
    scores are labelled 1."""
    field_values = tuple(int(c) for c in field_values)
    ranges = field_ranges(field_values, num_ids, published_rows, rare_below)
    fields = len(field_values)
    counts = np.asarray(field_values, np.int64)
    true_w = rng_for(seed, 1).standard_normal(num_ids + 1)
    score = np.empty(rows, dtype=np.float64)
    ids = np.empty((rows, fields), dtype=np.int32)
    value_k = np.empty((rows, fields), dtype=np.int16)

    def fill(block):
        start = block * BLOCK_ROWS
        n = min(BLOCK_ROWS, rows - start)
        sc, idx, k = _row_block(seed, block, n, true_w, ranges, counts)
        score[start:start + n] = sc
        ids[start:start + n] = idx
        value_k[start:start + n] = k

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(fill, range(-(-rows // BLOCK_ROWS))))
    cut = np.quantile(score, 1.0 - positive_share) if rows else 0.0
    labels = (score > cut).astype(np.float32)
    values = (value_k / 10000.0).astype(np.float32)
    return CriteoRows(labels, ids, values, value_k)


def _digits(a: np.ndarray, width: int) -> np.ndarray:
    """Right-aligned ASCII digits of the non-negative ints ``a`` in
    ``width`` bytes, the leading zeros as NUL bytes (one digit is always
    kept)."""
    pows = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    a = a.astype(np.int64)[..., None]
    out = (a // pows % 10 + 48).astype(np.uint8)
    out[(a < pows) & (pows > 1)] = 0
    return out


def _words(tokens: np.ndarray) -> np.ndarray:
    """Byte tokens [T, w] (w <= 8) as uint64 words, right-aligned in 8
    bytes behind NUL padding, in file byte order."""
    padded = np.zeros((tokens.shape[0], 8), dtype=np.uint8)
    padded[:, 8 - tokens.shape[1]:] = tokens
    return padded.view(np.uint64)[:, 0]


@functools.lru_cache(maxsize=4)
def _tables(max_id: int, fields: int):
    """uint64 word tables, each token right-aligned behind NUL bytes:
    ``j:`` for each field, ``id:`` for every id up to ``max_id`` (at most
    7 digits), ``0.kkkk`` and a space for every k, and ``L `` for the
    labels 0 and 1."""
    def colon(digits):
        return np.concatenate(
            [digits, np.full((len(digits), 1), ord(":"), np.uint8)], 1)

    field = _words(colon(_digits(np.arange(fields), len(str(fields - 1)))))
    ids = _words(colon(_digits(np.arange(max_id + 1), len(str(max_id)))))
    value = _words(np.concatenate([
        np.broadcast_to(np.frombuffer(b"0.", np.uint8), (10000, 2)),
        _digits(np.arange(10000), 4) | np.uint8(ord("0")),
        np.full((10000, 1), ord(" "), np.uint8)], 1))
    label = _words(np.array([[ord("0"), ord(" ")], [ord("1"), ord(" ")]],
                            np.uint8))
    return field, ids, value, label


def text_bytes(rows: CriteoRows, start: int = 0, stop=None,
               fields_in_text: bool = True) -> bytes:
    """Rows [start, stop) as text, one line a row: libfm
    (``label field:id:0.kkkk ...``) or, without ``fields_in_text``,
    libsvm (``label id:0.kkkk ...``). Each token is gathered as one 8-byte
    word from a table, right-aligned behind NUL bytes, which are then
    dropped."""
    stop = rows.num_rows if stop is None else stop
    n = stop - start
    fields = rows.ids.shape[1]
    top = int(rows.ids.max()) if rows.num_rows else 1
    if top >= 10 ** 7:
        raise ValueError("ids past 7 digits do not fit a token word")
    field_t, id_t, value_t, label_t = _tables(max(1, top), fields)
    words = 3 if fields_in_text else 2
    line = np.empty((n, 1 + words * fields), dtype=np.uint64)
    line[:, 0] = label_t[rows.labels[start:stop].astype(np.intp)]
    entry = line[:, 1:].reshape(n, fields, words)
    if fields_in_text:
        entry[:, :, 0] = field_t
    entry[:, :, -2] = id_t[rows.ids[start:stop]]
    entry[:, :, -1] = value_t[rows.value_k[start:stop]]
    flat = line.view(np.uint8).reshape(n, -1)
    flat[:, -1] = ord("\n")  # the last value's space ends the line
    flat = flat.ravel()
    return flat[flat != 0].tobytes()


def write_text(path: str, rows: CriteoRows, fields_in_text: bool = True,
               threads: int = 4) -> int:
    """Write every row to ``path`` as libfm (or libsvm) text, blocks
    formatted on ``threads`` threads and written in order; returns the
    bytes written."""
    total = 0
    starts = range(0, rows.num_rows, BLOCK_ROWS)
    with open(path, "wb") as fh, ThreadPoolExecutor(threads) as pool:
        for data in pool.map(lambda s: text_bytes(
                rows, s, min(rows.num_rows, s + BLOCK_ROWS),
                fields_in_text), starts):
            fh.write(data)
            total += len(data)
    return total


def batch_stats(rows: CriteoRows, batch: int) -> np.ndarray:
    """[batches, 2] int64: each batch's entries and distinct ids, in file
    order (the last batch may be short)."""
    out = []
    for start in range(0, rows.num_rows, batch):
        ids = rows.ids[start:start + batch]
        out.append((ids.size, np.unique(ids).size))
    return np.asarray(out, dtype=np.int64)
