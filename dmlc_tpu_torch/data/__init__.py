"""Data layer: CSR RowBlocks, the text parsers (libsvm tokenized by the
``tokenize_boundaries`` kernel on the parser's device, libfm, csv), the
cross-chunk ``PipelinedParser``, the row iterators, and
``reshard_split`` for a new membership generation."""

from dmlc_tpu_torch.data.parsers import (
    PARSER_REGISTRY,
    CSVParser,
    LibFMParser,
    LibSVMParser,
    Parser,
    ThreadedParser,
    create_parser,
    register_parser,
)
from dmlc_tpu_torch.data.pipeline import PipelinedParser
from dmlc_tpu_torch.data.row_block import Row, RowBlock, RowBlockContainer
from dmlc_tpu_torch.data.service import reshard_count, reshard_split
from dmlc_tpu_torch.data.row_iter import (
    BasicRowIter,
    DiskRowIter,
    RowBlockIter,
    create_row_block_iter,
)

__all__ = [
    "Row", "RowBlock", "RowBlockContainer", "Parser", "LibSVMParser",
    "LibFMParser", "CSVParser", "ThreadedParser", "PipelinedParser",
    "create_parser",
    "register_parser", "PARSER_REGISTRY", "RowBlockIter", "BasicRowIter",
    "DiskRowIter", "create_row_block_iter", "reshard_count",
    "reshard_split",
]
