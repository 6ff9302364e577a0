"""I/O layer: streams, the serializer, the FileSystem registry (local
files, ``mem://``, ``http(s)://``, and at first use ``s3://``, ``gs://``,
``hdfs://``, ``azure://``), URI parsing, RecordIO, the InputSplits over
any of them (text, recordio, indexed recordio, stdin, and the prefetch,
cache and shuffle decorators), the ``.dtsh`` shards (local files), the
ordered thread-pool window and the remote partition reader."""

from dmlc_tpu_torch.io.filesystem import (
    URI,
    FileInfo,
    FileSystem,
    HTTPFileSystem,
    LocalFileSystem,
    MemoryFileSystem,
    atomic_write,
    create_stream,
    create_stream_for_read,
    delete,
    exists,
    expand_uri_patterns,
    get_filesystem,
    list_dir,
    makedirs,
    register_filesystem,
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
from dmlc_tpu_torch.io.readahead import (
    OrderedWindow,
    RemotePartitionReader,
    fetch_ordered,
)
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
    "delete", "exists", "list_dir", "makedirs", "URI", "FileInfo",
    "FileSystem", "LocalFileSystem", "MemoryFileSystem", "HTTPFileSystem",
    "register_filesystem", "get_filesystem", "create_stream_for_read",
    "expand_uri_patterns", "RemotePartitionReader",
]
