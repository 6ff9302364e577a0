"""Vectorized text parse: whole-chunk byte tokenization, columnar output.

A copy of ``dmlc_tpu/data/vparse.py`` (host numpy code, copied rather than
imported so that this package loads nothing of ``dmlc_tpu``):

1. **Tokenize the whole chunk at once.** The libsvm token start/end masks
   are per-byte compares with a neighbour; :func:`parse_libsvm_vector`
   takes them precomputed (the parsers make them on their device with the
   ``tokenize_boundaries`` kernel, :func:`kernel_token_masks`) or makes
   them on the host with the kernel's plain version
   (:func:`token_boundary_masks`). Token offsets fall out of the masks.
2. **Convert grouped by width.** Tokens of equal byte length gather into an
   exact-width ``(n, l)`` matrix; digits become an exact float64 mantissa
   and one correctly-rounded divide by 10^decimals lands the value —
   bit-identical to strtod while the mantissa is below 2^53. Exponents,
   inf/nan and over-long tokens go through numpy's bytes→float64 ``astype``.
3. **Assemble columnar.** Token roles (label / weight / index / value) are
   masks from "is the byte after the token a ':'" plus adjacency; the
   columns go to ``RowBlockContainer.push_arrays`` in whole runs.

Rows outside the vectorized grammar (``qid:`` groups, ``1:2:3`` shapes,
over-long tokens) are re-parsed by the scalar line parser
:func:`parse_libsvm_line`, the single source of truth, in order.
:func:`parse_libsvm_scalar` is the oracle the vector path is held to. The
csv half (:func:`parse_csv_vector_table`, its oracle
:func:`parse_csv_scalar_table`) is host code only, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from dmlc_tpu_torch.data.row_block import (
    INDEX_DTYPE,
    REAL_DTYPE,
    RowBlockContainer,
)
from dmlc_tpu_torch.ops import kernels
from dmlc_tpu_torch.utils.device import resolve_device

_NL = 0x0A
_CR = 0x0D
_COLON = 0x3A

# tokens longer than this route their row to the scalar parser: the gather
# matrix is (ntok, l) bytes, so l must stay bounded for pathological input
# (float() handles thousand-digit literals; the matrix should not)
_MAX_TOKEN = 48

# fast mantissa/divide conversion needs every 10^k involved exact in
# float64 (true up to 10^22); wider tokens convert via astype
_MAX_FAST_LEN = 17

_POW10 = 10.0 ** np.arange(_MAX_FAST_LEN + 1)
_TWO53 = float(1 << 53)


# ---------------------------------------------------------------------------
# token → float64 conversion
# ---------------------------------------------------------------------------


def _astype_convert(mat: np.ndarray, out: np.ndarray,
                    ix: np.ndarray) -> None:
    """Per-token conversion through numpy's bytes→float64 astype — the
    same parsing (and ValueError behavior) as ``float()``."""
    out[ix] = (
        np.ascontiguousarray(mat).view("S%d" % mat.shape[1])
        .ravel().astype(np.float64)
    )


def _convert_group_general(mat: np.ndarray, out: np.ndarray,
                           ix: np.ndarray) -> None:
    """Per-token fast/slow split for width groups with mixed byte layouts
    (adversarial corpora; real datasets take the uniform-column path).

    Builds per-token validity and dot position from (n, l) matrices, then
    converts valid tokens per dot-position subgroup with the same exact
    mantissa/divide scheme as the uniform path.
    """
    n, l = mat.shape
    if l > _MAX_FAST_LEN:
        _astype_convert(mat, out, ix)
        return
    F = mat.astype(np.float64)
    D = F - 48.0
    isd = (D >= 0.0) & (D <= 9.0)
    isdot = D == -2.0
    c0 = mat[:, 0]
    neg = c0 == 0x2D
    sgn = neg | (c0 == 0x2B)
    ones = np.ones(l)
    nbad = (~(isd | isdot)).astype(np.float64) @ ones
    If = isdot.astype(np.float64)
    ndot = If @ ones
    psum = If @ np.arange(l, dtype=np.float64)
    valid = (nbad - sgn <= 0.0) & (ndot <= 1.0) & (ndot + nbad < l)
    done = np.zeros(n, dtype=bool)
    if valid.any():
        Dd = np.where(isd, D, 0.0)
        p = np.where(ndot == 1.0, psum, -1.0)
        for pv in np.unique(p[valid]):
            pvi = int(pv)
            e = l - 1 - np.arange(l)
            if pvi >= 0:
                e = e - (np.arange(l) < pvi)
            sub = valid & (p == pv)
            mant = Dd[sub] @ _POW10[e]
            ok = mant < _TWO53
            d = l - 1 - pvi if pvi >= 0 else 0
            val = mant / _POW10[d] if d > 0 else mant
            nsub = neg[sub]
            val[nsub] = -val[nsub]
            six = np.flatnonzero(sub)[ok]
            out[ix[six]] = val[ok]
            done[six] = True
    slow = np.flatnonzero(~done)
    if slow.size:
        _astype_convert(mat[slow], out, ix[slow])


def _convert_group(mat: np.ndarray, out: np.ndarray, ix: np.ndarray) -> None:
    """Convert one equal-width (n, l) byte matrix of tokens into out[ix].

    Fast path: classify COLUMNS, not tokens. Fixed-format numeric data
    ("0.655750", 6-digit ids) puts the dot/sign/digit layout in the same
    byte position for every token of a given width, so a handful of tiny
    per-column ``.all()`` checks prove the whole group well-formed and
    the mantissa accumulates column-by-column — never materializing an
    (n, l) float64 matrix (the memory traffic that sinks the per-token
    variant). Digits weight 10^(l-1-j), one power less left of the dot;
    mantissa and 10^decimals are both exact in float64 (mantissa checked
    < 2^53, powers exact to 10^22; partial sums are nonnegative integers
    bounded by the final mantissa, so any accumulation order is exact),
    and the single correctly-rounded divide reproduces strtod
    bit-for-bit. Groups with mixed layouts fall back per-token.
    """
    n, l = mat.shape
    if l > _MAX_FAST_LEN:
        _astype_convert(mat, out, ix)
        return
    du = mat - np.uint8(48)  # digit→0..9, '.'→254, '-'→253, '+'→251
    cls = []
    for j in range(l):
        cj = du[:, j]
        if bool((cj < 10).all()):
            cls.append("d")
            continue
        if bool((cj == 254).all()):
            cls.append(".")
            continue
        if j == 0 and bool((cj == 253).all()):
            cls.append("-")
            continue
        if j == 0 and bool((cj == 251).all()):
            cls.append("+")
            continue
        cls = None
        break
    if cls is None or cls.count(".") > 1 or "d" not in cls:
        _convert_group_general(mat, out, ix)
        return
    p = cls.index(".") if "." in cls else -1
    mant = np.zeros(n, dtype=np.float64)
    for j, c in enumerate(cls):
        if c != "d":
            continue
        e = l - 1 - j - (1 if 0 <= p and j < p else 0)
        mant += du[:, j].astype(np.float64) * _POW10[e]
    d = l - 1 - p if p >= 0 else 0
    val = mant / _POW10[d] if d > 0 else mant
    if cls[0] == "-":
        val = -val
    exact = mant < _TWO53
    if exact.all():
        out[ix] = val
        return
    out[ix[exact]] = val[exact]
    rest = ~exact
    _astype_convert(mat[rest], out, ix[rest])


def _gather_floats(a: np.ndarray, starts: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
    """Convert the given token spans to float64, vectorized.

    Tokens group by length so each group gathers an exact-width (n, l)
    byte matrix — a row take on a sliding-window view, no index matrix,
    no masking — and converts via :func:`_convert_group`. Raises
    ValueError on non-numeric tokens, exactly like ``float()`` would.
    """
    n = len(starts)
    out = np.empty(n, dtype=np.float64)
    if n == 0:
        return out
    lmax = int(lens.max())
    counts = np.bincount(lens, minlength=lmax + 1)
    for l in np.flatnonzero(counts):
        l = int(l)
        if l == 0:
            continue
        ix = np.flatnonzero(lens == l) if counts[l] != n else np.arange(n)
        mat = sliding_window_view(a, l)[starts[ix]]
        _convert_group(mat, out, ix)
    return out


# ---------------------------------------------------------------------------
# libsvm: scalar line oracle
# ---------------------------------------------------------------------------


def parse_libsvm_line(line: bytes, out: RowBlockContainer) -> None:
    """One ``label[:weight] [qid:n] idx[:val]...`` line → ``out``.

    The single scalar source of truth: the vectorized path defers
    flagged rows to it, so both paths agree byte-for-byte.
    """
    toks = line.split()
    if not toks:
        return
    head = toks[0].split(b":")
    label = float(head[0])
    weight = float(head[1]) if len(head) > 1 else None
    qid = None
    feats_idx = []
    feats_val = []
    has_vals = False
    for tok in toks[1:]:
        if tok.startswith(b"qid:"):
            qid = int(tok[4:])
            continue
        pair = tok.split(b":")
        feats_idx.append(float(pair[0]))
        if len(pair) > 1:
            feats_val.append(float(pair[1]))
            has_vals = True
        else:
            feats_val.append(1.0)
    out.push_row(
        label,
        np.asarray(feats_idx, dtype=np.float64).astype(INDEX_DTYPE),
        value=(
            np.asarray(feats_val, dtype=REAL_DTYPE) if has_vals else None
        ),
        weight=weight,
        qid=qid,
    )


def parse_libsvm_scalar(chunk: bytes, out: RowBlockContainer) -> None:
    """Scalar chunk parse: one :func:`parse_libsvm_line` per line (the
    oracle the vectorized parse is held to)."""
    for line in chunk.splitlines():
        parse_libsvm_line(line, out)


# ---------------------------------------------------------------------------
# libsvm: vectorized chunk parse
# ---------------------------------------------------------------------------


def parse_libsvm_vector(chunk: bytes, out: RowBlockContainer,
                        masks: Optional[Tuple[np.ndarray, np.ndarray]] = None
                        ) -> None:
    """Vectorized libsvm chunk parse, bit-identical to the scalar path.

    ``masks`` are the chunk's token (starts_mask, ends_mask) as bool
    arrays, made on a device by :func:`kernel_token_masks`; None makes
    them here with :func:`token_boundary_masks`. Columnar outputs are
    pushed as whole-array runs; rows outside the vectorized grammar are
    re-parsed by :func:`parse_libsvm_line` at their in-order position.
    """
    a = np.frombuffer(chunk, dtype=np.uint8)
    if a.size == 0:
        return

    # --- tokenize: boundary masks (the rest of the parse reads the line
    # breaks and the colons as well) ---
    is_eol = (a == _NL) | (a == _CR)
    c58 = a == _COLON
    sm, em = token_boundary_masks(a) if masks is None else masks
    starts = np.flatnonzero(sm)
    ends = np.flatnonzero(em) + 1
    n = starts.size
    if n == 0:
        # all-separator chunk: whitespace-only is empty, but str.split()
        # keeps ':' (not whitespace to it) — a lone colon line raises in
        # the scalar path, so defer to it
        if c58.any():
            parse_libsvm_scalar(chunk, out)
        return
    lens = ends - starts

    # --- rows: first-token flags via reverse searchsorted ---
    nlpos = np.flatnonzero(is_eol)
    first = np.zeros(n + 1, dtype=bool)
    first[np.searchsorted(starts, nlpos)] = True
    first = first[:n]
    first[0] = True
    row_start_tok = np.flatnonzero(first)
    nrows = row_start_tok.size
    row_bnd = np.append(row_start_tok, n)

    # --- roles from colon-follow + adjacency ---
    fc = np.zeros(n, dtype=bool)
    inb = ends < a.size
    fc[inb] = c58[ends[inb]]
    # orphan colon (separator or chunk start before it): invisible to the
    # boundary masks, but the scalar path materializes a b":" token and
    # raises — impossible in well-formed data, so punt the whole chunk.
    # Every non-orphan colon sits right after exactly one token end, so
    # orphans exist iff the counts disagree.
    if int(c58.sum()) != int(fc.sum()):
        parse_libsvm_scalar(chunk, out)
        return
    adj = np.zeros(n, dtype=bool)
    adj[:-1] = starts[1:] == ends[:-1] + 1  # bridged by exactly the ':'
    wcand = first & fc & adj  # label token with adjacent weight
    is_weight = np.zeros(n, dtype=bool)
    is_weight[1:] = wcand[:-1]
    rest = ~first & ~is_weight
    idx_cand = rest & fc
    is_val = np.zeros(n, dtype=bool)
    is_val[1:] = (idx_cand & adj)[:-1]
    idx_cand &= ~is_val  # a value can't open a pair ("i:v:x" flags below)
    feat = idx_cand | (rest & ~fc & ~is_val)

    # --- rows the vector grammar can't express → scalar fallback ---
    bad_tok = (
        (first & fc & ~adj)  # "1: 2" / "1:" at end of line
        | (is_weight & fc)  # "1:2:3" as the head token
        | (idx_cand & ~adj)  # "3: 4" / "3:" at end of line
        | (is_val & fc)  # "i:v:extra" feature shapes
        | (lens > _MAX_TOKEN)  # bound the gather matrix width
    )
    qm = np.flatnonzero((lens == 3) & fc)  # qid: groups stay scalar
    if qm.size:
        qs = starts[qm]
        bad_tok[qm[(a[qs] == 0x71) & (a[qs + 1] == 0x69)
                   & (a[qs + 2] == 0x64)]] = True

    bad_ix = np.flatnonzero(bad_tok)
    good_tok = None
    bad = None
    if bad_ix.size:
        bad = np.zeros(nrows, dtype=bool)
        bad[np.searchsorted(row_start_tok, bad_ix, side="right") - 1] = True
        good_tok = np.ones(n, dtype=bool)
        for r in np.flatnonzero(bad):
            good_tok[row_bnd[r]:row_bnd[r + 1]] = False

    # --- one-shot convert (good rows' tokens are exhaustively classed) ---
    v = np.empty(n, dtype=np.float64)
    if good_tok is None:
        v = _gather_floats(a, starts, lens)
    else:
        gix = np.flatnonzero(good_tok)
        v[gix] = _gather_floats(a, starts[gix], lens[gix])

    # --- columnar assembly, row-ordered by construction ---
    labels = v[row_start_tok]
    has_w = wcand[row_start_tok]
    weights = None
    if has_w.any():
        weights = np.ones(nrows, dtype=np.float64)
        wr = np.flatnonzero(has_w)
        weights[wr] = v[row_start_tok[wr] + 1]
    feat_ix = np.flatnonzero(feat if good_tok is None else feat & good_tok)
    feat_off = np.searchsorted(feat_ix, row_bnd)
    index = v[feat_ix]
    has_v = idx_cand[feat_ix]  # bare features read 1.0
    values = None
    if has_v.any():
        values = np.ones(feat_ix.size, dtype=np.float64)
        hv = np.flatnonzero(has_v)
        values[hv] = v[feat_ix[hv] + 1]

    def push_run(r0: int, r1: int) -> None:
        f0, f1 = int(feat_off[r0]), int(feat_off[r1])
        w = weights
        if w is not None and not bool(has_w[r0:r1].any()):
            w = None
        val = values
        if val is not None and not bool(has_v[f0:f1].any()):
            val = None
        out.push_arrays(
            labels[r0:r1].astype(REAL_DTYPE),
            np.diff(feat_off[r0:r1 + 1]),
            index[f0:f1].astype(INDEX_DTYPE),
            value=None if val is None else val[f0:f1].astype(REAL_DTYPE),
            weight=None if w is None else w[r0:r1].astype(REAL_DTYPE),
        )

    if bad is None:
        push_run(0, nrows)
        return

    # splice: columnar runs between scalar-parsed rows, in order
    r = 0
    while r < nrows:
        if bad[r]:
            s0 = int(starts[row_bnd[r]])
            k = int(np.searchsorted(nlpos, s0))
            lo = int(nlpos[k - 1]) + 1 if k > 0 else 0
            hi = int(nlpos[k]) if k < nlpos.size else a.size
            parse_libsvm_line(chunk[lo:hi], out)
            r += 1
            continue
        r1 = r
        while r1 < nrows and not bad[r1]:
            r1 += 1
        push_run(r, r1)
        r = r1


# ---------------------------------------------------------------------------
# csv
# ---------------------------------------------------------------------------


def _csv_line_spans(a: np.ndarray):
    """splitlines-equivalent (start, end) spans: ``\\r\\n`` is one break,
    lone ``\\r`` and ``\\n`` each break, no phantom final line."""
    brk = np.flatnonzero((a == _CR) | (a == _NL))
    if brk.size:
        # a '\n' directly after a '\r' belongs to the same break
        drop = (a[brk] == _NL) & (brk > 0)
        drop[drop] &= a[brk[drop] - 1] == _CR
        ends = brk[~drop]
        two = (a[ends] == _CR) & (ends + 1 < a.size)
        if two.any():
            two[two] &= a[ends[two] + 1] == _NL
        starts = np.concatenate(([0], ends + 1 + two))
        ends = np.concatenate((ends, [a.size]))
    else:
        starts = np.zeros(1, dtype=np.int64)
        ends = np.full(1, a.size, dtype=np.int64)
    keep = starts < ends  # a chunk ending in a newline has no final line
    return starts[keep], ends[keep]


def parse_csv_scalar_table(chunk: bytes) -> np.ndarray:
    """Scalar csv parse → dense float64 table (the oracle).

    Blank / whitespace-only lines are skipped; empty cells — a blank last
    column from a trailing comma too — read 0.0 (strtof on empty); ragged
    rows right-pad with 0.0 to the widest; anything non-numeric (quoted
    cells too) raises ValueError, as ``float()`` does.
    """
    rows = [
        [float(c or b"0") for c in ln.split(b",")]
        for ln in chunk.splitlines()
        if ln.strip()
    ]
    if not rows:
        return np.zeros((0, 0), dtype=np.float64)
    width = max(len(r) for r in rows)
    table = np.zeros((len(rows), width), dtype=np.float64)
    for i, r in enumerate(rows):
        table[i, : len(r)] = r
    return table


def parse_csv_vector_table(chunk: bytes) -> np.ndarray:
    """Vectorized csv parse → dense float64 table, bit-identical to
    :func:`parse_csv_scalar_table`: cell spans come straight from
    comma/newline offset arrays."""
    a = np.frombuffer(chunk, dtype=np.uint8)
    if a.size == 0:
        return np.zeros((0, 0), dtype=np.float64)
    ls, le = _csv_line_spans(a)
    if ls.size == 0:
        return np.zeros((0, 0), dtype=np.float64)
    # keep lines with any comma or any non-whitespace byte (the scalar
    # path's `if ln.strip()` keeps b",,": commas are not whitespace)
    cm = np.flatnonzero(a == 0x2C)
    nonws = ~((a == 0x20) | (a == 0x09) | (a == _CR) | (a == _NL)
              | (a == 0x0B) | (a == 0x0C))
    nwpos = np.flatnonzero(nonws)
    ncomma = (np.searchsorted(cm, le) - np.searchsorted(cm, ls))
    has_text = (np.searchsorted(nwpos, le) - np.searchsorted(nwpos, ls)) > 0
    keep = has_text | (ncomma > 0)
    ls, le, ncomma = ls[keep], le[keep], ncomma[keep]
    nrows = ls.size
    if nrows == 0:
        return np.zeros((0, 0), dtype=np.float64)
    cm = cm[np.searchsorted(cm, ls[0]):]

    # cells: line starts and comma+1 open, commas and line ends close;
    # scatter each into its global cell slot (row-major by construction)
    ncols = ncomma + 1
    row_first = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(ncols, out=row_first[1:])
    total = int(row_first[-1])
    cs = np.empty(total, dtype=np.int64)
    ce = np.empty(total, dtype=np.int64)
    cs[row_first[:-1]] = ls
    ce[row_first[1:] - 1] = le
    if cm.size:
        line_of_cm = np.searchsorted(le, cm, side="left")
        cslot = (
            row_first[line_of_cm]
            + (np.arange(cm.size) - np.searchsorted(cm, ls)[line_of_cm])
        )
        ce[cslot] = cm
        cs[cslot + 1] = cm + 1
    clen = ce - cs
    vals = np.empty(total, dtype=np.float64)
    ne = np.flatnonzero(clen)
    vals[np.flatnonzero(clen == 0)] = 0.0  # strtof on empty: a blank cell
    vals[ne] = _gather_floats(a, cs[ne], clen[ne])

    if int(ncols.min()) == int(ncols.max()):
        return vals.reshape(nrows, int(ncols[0]))
    # ragged: right-pad with 0.0 to the widest row
    cell_row = np.repeat(np.arange(nrows), ncols)
    col = np.arange(total, dtype=np.int64) - row_first[cell_row]
    table = np.zeros((nrows, int(ncols.max())), dtype=np.float64)
    table[cell_row, col] = vals
    return table


# ---------------------------------------------------------------------------
# token masks: numpy, and the tokenize_boundaries kernel
# ---------------------------------------------------------------------------


def token_boundary_masks(a: np.ndarray):
    """(starts_mask, ends_mask) bool numpy arrays for the libsvm tokens of
    the uint8 chunk ``a``: ``ops.kernels.tokenize_boundaries_plain`` on
    the host, the one CPU definition of the masks, which the device route
    (:func:`kernel_token_masks`) is held to."""
    a = np.asarray(a, dtype=np.uint8)
    if not a.flags.writeable:
        a = a.copy()  # torch.from_numpy wants a writeable array
    starts, ends = kernels.tokenize_boundaries_plain(torch.from_numpy(a))
    return starts.numpy(), ends.numpy()


def kernel_token_masks(a: np.ndarray, device=None):
    """(starts_mask, ends_mask) bool numpy arrays for the uint8 chunk
    ``a``, made by ``ops.kernels.tokenize_boundaries`` on ``device``
    (None means cuda): the bytes are copied into a tensor this function
    owns, moved to the device, tokenized there, and the masks copied
    back. On a CPU device the kernel's plain version makes them."""
    dev = resolve_device(device)
    cur = torch.from_numpy(np.array(a, dtype=np.uint8, copy=True))
    starts, ends = kernels.tokenize_boundaries(cur.to(dev))
    return starts.cpu().numpy(), ends.cpu().numpy()


def kernel_token_spans(a: np.ndarray, device=None):
    """(starts, ends) int64 token offsets of the uint8 chunk ``a`` from
    the tokenize_boundaries kernel on ``device`` (None means cuda): the
    counterpart of the JAX package's ``vparse.pallas_token_spans``, with
    no knob and no fallback — a device that cannot run the kernel raises.
    The offsets come from the masks on the host (``flatnonzero``)."""
    starts_mask, ends_mask = kernel_token_masks(a, device)
    return np.flatnonzero(starts_mask), np.flatnonzero(ends_mask) + 1
