"""Re-iterable RowBlock iterators: in memory and external memory, the port
of ``dmlc_tpu/data/row_iter.py`` (src/data/basic_row_iter.h,
disk_row_iter.h and the RowBlockIter::Create factory, src/data.cc:87-128).

- ``BasicRowIter``: the whole partition in one in-memory RowBlock.
- ``DiskRowIter``: on the first pass, 64 MB CSR pages spilled to a cache
  file (``RowBlockContainer.save``, the JAX package's page format, with
  ``num_col`` in ``<cache>.meta``); later passes, and later instances over
  a warm cache, stream the pages back through a prefetch thread and never
  build the parser.
- ``create_row_block_iter``: a ``#cachefile`` uri suffix selects
  ``DiskRowIter``, else ``BasicRowIter``. ``device`` (None means cuda) is
  where the parser's kernels run.
"""

from __future__ import annotations

import os
import time
from typing import Iterator, Optional

from dmlc_tpu_torch.data.parsers import Parser, create_parser
from dmlc_tpu_torch.data.row_block import RowBlock, RowBlockContainer
from dmlc_tpu_torch.io.filesystem import create_stream
from dmlc_tpu_torch.io.uri_spec import URISpec
from dmlc_tpu_torch.utils.device import resolve_device
from dmlc_tpu_torch.utils.logging import DMLCError, check, log_info
from dmlc_tpu_torch.utils.threaded_iter import ThreadedIter

# 64 MB page (disk_row_iter.h:32)
PAGE_BYTES = 64 << 20


class RowBlockIter:
    """Re-iterable data iterator interface (data.h:232-260)."""

    def before_first(self) -> None:
        raise NotImplementedError

    def next_block(self) -> Optional[RowBlock]:
        raise NotImplementedError

    def num_col(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __iter__(self) -> Iterator[RowBlock]:
        while True:
            block = self.next_block()
            if block is None:
                return
            yield block


class BasicRowIter(RowBlockIter):
    """Load the whole partition into memory once (basic_row_iter.h)."""

    def __init__(self, parser: Parser):
        start = time.perf_counter()
        container = RowBlockContainer()
        bytes_seen = 0
        last_log = 0
        try:
            for block in parser:
                container.push_block(block)
                bytes_seen = parser.bytes_read
                if bytes_seen - last_log >= (10 << 20):  # every 10 MB
                    elapsed = max(time.perf_counter() - start, 1e-9)
                    log_info("BasicRowIter: read %.1f MB at %.2f MB/sec",
                             bytes_seen / 1e6, bytes_seen / 1e6 / elapsed)
                    last_log = bytes_seen
        finally:
            parser.close()
        self._block = container.to_block()
        self._done = False
        log_info("BasicRowIter: loaded %d rows, %.1f MB in %.2f sec",
                 len(self._block), bytes_seen / 1e6,
                 time.perf_counter() - start)

    def before_first(self) -> None:
        self._done = False

    def next_block(self) -> Optional[RowBlock]:
        if self._done:
            return None
        self._done = True
        return self._block

    def num_col(self) -> int:
        return self._block.num_col()


class DiskRowIter(RowBlockIter):
    """External-memory iterator: spill 64 MB CSR pages to a cache file on
    the first pass, stream them back with prefetch on later epochs
    (disk_row_iter.h:95-141). Close it: its prefetch thread runs until
    then."""

    def __init__(self, parser, cache_file: str):
        """``parser`` is a Parser or a zero-argument callable returning
        one; the callable is not called when a cache file that exists makes
        the input pass unnecessary."""
        self._cache_file = cache_file
        self._num_col = 0
        if os.path.exists(cache_file):
            if not self._try_load_cache():
                raise DMLCError(f"invalid cache file {cache_file!r}")
        else:
            check(parser is not None, "parser required to build cache")
            if callable(parser):
                parser = parser()
            self._build_cache(parser)
            check(self._try_load_cache(), "cache build failed")
        self._iter = ThreadedIter(self._page_source, max_capacity=4,
                                  name="disk-row-iter")

    def _build_cache(self, parser: Parser) -> None:
        start = time.perf_counter()
        bytes_out = 0
        npages = 0
        try:
            with create_stream(self._cache_file + ".tmp", "w") as out:
                container = RowBlockContainer()
                for block in parser:
                    container.push_block(block)
                    self._num_col = max(self._num_col, block.num_col())
                    if container.mem_cost_bytes() >= PAGE_BYTES:
                        container.save(out)
                        npages += 1
                        bytes_out += container.mem_cost_bytes()
                        container.clear()
                if len(container):
                    container.save(out)
                    npages += 1
                    bytes_out += container.mem_cost_bytes()
        finally:
            parser.close()
        os.replace(self._cache_file + ".tmp", self._cache_file)
        with create_stream(self._cache_file + ".meta", "w") as meta:
            meta.write_uint64(self._num_col)
        log_info("DiskRowIter: cached %d pages (%.1f MB) in %.2f sec",
                 npages, bytes_out / 1e6, time.perf_counter() - start)

    def _try_load_cache(self) -> bool:
        if not os.path.exists(self._cache_file):
            return False
        meta_path = self._cache_file + ".meta"
        if os.path.exists(meta_path):
            with create_stream(meta_path, "r") as meta:
                self._num_col = meta.read_uint64()
        return True

    def _page_source(self) -> Iterator[RowBlock]:
        with create_stream(self._cache_file, "r") as stream:
            while True:
                try:
                    container = RowBlockContainer.load(stream)
                except EOFError:
                    return
                yield container.to_block()

    def before_first(self) -> None:
        self._iter.before_first()

    def next_block(self) -> Optional[RowBlock]:
        return self._iter.next()

    def num_col(self) -> int:
        return self._num_col

    def close(self) -> None:
        self._iter.close()


def create_row_block_iter(uri: str, part_index: int = 0, num_parts: int = 1,
                          data_format: str = "auto",
                          nthread: Optional[int] = None,
                          device=None, procs: int = 0) -> RowBlockIter:
    """RowBlockIter<I>::Create (src/data.cc:87-128): a ``#cachefile``
    suffix selects DiskRowIter (external memory), else BasicRowIter (in
    memory). ``nthread=None`` means the parser's default; ``device`` (None
    means cuda) is resolved here, so it raises without a card even when a
    warm cache needs no parser; ``procs`` goes to ``create_parser`` (its
    process parse pool)."""
    device = resolve_device(device)
    spec = URISpec(uri, part_index, num_parts)

    def make_parser():
        return create_parser(
            spec.uri if not spec.args else uri.split("#")[0],
            part_index, num_parts, data_format, nthread, device=device,
            procs=procs)

    if spec.cache_file:
        return DiskRowIter(make_parser, spec.cache_file)
    return BasicRowIter(make_parser())
