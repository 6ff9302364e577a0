"""I/O layer: streams, the serializer, local files, URI parsing, the
text InputSplit over local files and the ordered thread-pool window."""

from dmlc_tpu_torch.io.filesystem import (
    atomic_write,
    create_stream,
    delete,
    exists,
    list_dir,
    makedirs,
)
from dmlc_tpu_torch.io.input_split import (
    InputSplitBase,
    LineSplitter,
    create_input_split,
    list_split_files,
)
from dmlc_tpu_torch.io.readahead import OrderedWindow, fetch_ordered
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
    "load_obj", "create_stream", "InputSplitBase", "LineSplitter",
    "URISpec", "create_input_split", "list_split_files", "OrderedWindow",
    "fetch_ordered", "atomic_write", "delete", "exists", "list_dir",
    "makedirs",
]
