"""I/O layer: streams, the serializer, local files, URI parsing, RecordIO,
the InputSplits over local files (text, recordio, indexed recordio,
stdin, and the prefetch, cache and shuffle decorators), the ``.dtsh``
shards and the ordered thread-pool window."""

from dmlc_tpu_torch.io.filesystem import (
    atomic_write,
    create_stream,
    delete,
    exists,
    list_dir,
    makedirs,
)
from dmlc_tpu_torch.io.input_split import (
    CachedInputSplit,
    IndexedRecordIOSplitter,
    InputSplit,
    InputSplitBase,
    InputSplitShuffle,
    LineSplitter,
    RecordIOSplitter,
    SingleFileSplit,
    ThreadedInputSplit,
    create_input_split,
    list_split_files,
)
from dmlc_tpu_torch.io.readahead import OrderedWindow, fetch_ordered
from dmlc_tpu_torch.io.recordio import (
    RECORDIO_MAGIC,
    RecordIOChunkReader,
    RecordIOReader,
    RecordIOWriter,
    build_index,
)
from dmlc_tpu_torch.io.serializer import load_obj, save_obj
from dmlc_tpu_torch.io.stream import (
    FileObjStream,
    MemoryStream,
    SeekStream,
    Stream,
)
from dmlc_tpu_torch.io.uri_spec import URISpec

__all__ = [
    "Stream", "SeekStream", "FileObjStream", "MemoryStream", "save_obj",
    "load_obj",
    "create_stream", "InputSplit", "InputSplitBase", "LineSplitter",
    "RecordIOSplitter", "IndexedRecordIOSplitter", "SingleFileSplit",
    "ThreadedInputSplit", "CachedInputSplit", "InputSplitShuffle",
    "URISpec", "create_input_split", "list_split_files", "RECORDIO_MAGIC",
    "RecordIOWriter", "RecordIOReader", "RecordIOChunkReader",
    "build_index", "OrderedWindow", "fetch_ordered", "atomic_write",
    "delete", "exists", "list_dir", "makedirs",
]
