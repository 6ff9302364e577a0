"""HDFS over the WebHDFS REST API (``hdfs://``), the port of
``dmlc_tpu/io/webhdfs.py``. The reference wraps libhdfs over JNI
(src/io/hdfs_filesys.{h,cc}); the REST API every namenode serves needs
nothing beyond the standard library:

- ``hdfs://host:port/path`` → ``http://host:port/webhdfs/v1/path``: the
  URI's host names the namenode's HTTP address (port 9870 when none is
  given), or ``DMLC_WEBHDFS_ENDPOINT`` names the REST base;
- reads: ``op=OPEN&offset=N`` through the reconnecting
  ``RangedReadStream``, and ``offset`` + ``length`` bounded reads through
  ``read_range_with_retry`` (the reference's EINTR retry,
  hdfs_filesys.cc:31-49, generalized);
- writes: ``op=CREATE`` then ``op=APPEND`` a buffered part
  (``DMLC_HDFS_WRITE_BUFFER_MB``, default 64), each the two-step
  namenode 307 → datanode PUT/POST, with urllib following no redirect of
  a body;
- stat and listing: ``op=GETFILESTATUS`` / ``op=LISTSTATUS``;
- pseudo-authentication: ``user.name`` from ``HADOOP_USER_NAME``.
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional

from dmlc_tpu_torch.io.filesystem import (FILE_TYPE_DIR, FILE_TYPE_FILE,
                                          FileInfo, FileSystem,
                                          RangedReadStream, URI,
                                          read_range_with_retry,
                                          register_filesystem)
from dmlc_tpu_torch.io.object_store import ObjectWriteStream
from dmlc_tpu_torch.io.stream import SeekStream, Stream
from dmlc_tpu_torch.utils.logging import check

READ_MAX_RETRY = 50
READ_RETRY_SLEEP_S = 0.1
WRITE_MAX_RETRY = 3  # CREATE only (idempotent); APPEND is single-shot
DEFAULT_WRITE_BUFFER_MB = 64
DEFAULT_HTTP_PORT = 9870  # the namenode's web port, WebHDFS's default


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    """Surface 307s instead of following them: WebHDFS redirects a PUT or
    POST body to a datanode, and the client must send the body there."""

    def redirect_request(self, req, fp, code, msg, headers, newurl):
        return None


_no_redirect_opener = urllib.request.build_opener(_NoRedirect)


class WebHDFSFileSystem(FileSystem):
    """A FileSystem speaking WebHDFS (the module docstring)."""

    def __init__(self, uri: URI):
        endpoint = os.environ.get("DMLC_WEBHDFS_ENDPOINT", "")
        if endpoint:
            self._base = endpoint.rstrip("/")
        else:
            check(uri.host, "hdfs:// URI needs a namenode host")
            host = uri.host
            if ":" not in host:
                host = f"{host}:{DEFAULT_HTTP_PORT}"
            self._base = f"http://{host}/webhdfs/v1"
        self._user = os.environ.get("HADOOP_USER_NAME", "")
        self._part_bytes = int(os.environ.get(
            "DMLC_HDFS_WRITE_BUFFER_MB", DEFAULT_WRITE_BUFFER_MB)) << 20

    # ---- REST plumbing -----------------------------------------------------
    def _url(self, path: str, op: str, **params) -> str:
        query = {"op": op, **params}
        if self._user:
            query["user.name"] = self._user
        return (self._base + urllib.parse.quote(path) + "?"
                + urllib.parse.urlencode(query))

    def _json(self, method: str, path: str, op: str, **params) -> dict:
        req = urllib.request.Request(self._url(path, op, **params),
                                     method=method)
        with urllib.request.urlopen(req, timeout=60) as resp:
            body = resp.read()
        return json.loads(body) if body else {}

    def _two_step_write(self, method: str, path: str, op: str, data: bytes,
                        **params) -> None:
        """CREATE / APPEND: ask the namenode (no body), take its 307
        datanode location, send the payload there."""
        url = self._url(path, op, **params)
        location = None
        try:
            with _no_redirect_opener.open(
                    urllib.request.Request(url, method=method),
                    timeout=60) as resp:
                # a gateway may answer 200/201 at once, with no redirect
                location = resp.headers.get("Location")
        except urllib.error.HTTPError as err:
            if err.code not in (301, 302, 307):
                raise
            location = err.headers.get("Location")
            err.close()
        req = urllib.request.Request(
            location or url, data=data, method=method,
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=300):
            pass

    @staticmethod
    def _display(path: URI) -> str:
        return path.str_full()

    # ---- FileSystem ----------------------------------------------------------
    def _status(self, path: URI) -> Optional[dict]:
        try:
            out = self._json("GET", path.name or "/", "GETFILESTATUS")
        except urllib.error.HTTPError as err:
            if err.code == 404:
                err.close()
                return None
            raise
        return out.get("FileStatus")

    def get_path_info(self, path: URI) -> FileInfo:
        status = self._status(path)
        if status is None:
            raise FileNotFoundError(self._display(path))
        is_dir = status.get("type") == "DIRECTORY"
        return FileInfo(path=path,
                        size=0 if is_dir else int(status.get("length", 0)),
                        type=FILE_TYPE_DIR if is_dir else FILE_TYPE_FILE)

    def list_directory(self, path: URI) -> List[FileInfo]:
        out = self._json("GET", path.name or "/", "LISTSTATUS")
        entries = out.get("FileStatuses", {}).get("FileStatus", [])
        base = (path.name or "/").rstrip("/")
        infos: List[FileInfo] = []
        for st in entries:
            suffix = st.get("pathSuffix", "")
            sub_name = f"{base}/{suffix}" if suffix else (base or "/")
            is_dir = st.get("type") == "DIRECTORY"
            infos.append(FileInfo(
                path=URI(path.protocol, path.host, sub_name),
                size=0 if is_dir else int(st.get("length", 0)),
                type=FILE_TYPE_DIR if is_dir else FILE_TYPE_FILE))
        infos.sort(key=lambda fi: fi.path.name)
        return infos

    def open_for_read(self, path: URI,
                      allow_null: bool = False) -> Optional[SeekStream]:
        status = self._status(path)
        if status is None or status.get("type") == "DIRECTORY":
            if allow_null:
                return None
            raise FileNotFoundError(self._display(path))

        def open_ranged(start: int):
            # the namenode 307s an OPEN to a datanode; urllib follows GETs
            return urllib.request.urlopen(
                self._url(path.name, "OPEN", offset=start), timeout=60)

        return RangedReadStream(open_ranged, int(status.get("length", 0)),
                                self._display(path),
                                max_retry=READ_MAX_RETRY,
                                retry_sleep_s=READ_RETRY_SLEEP_S)

    def read_range(self, path: URI, offset: int, length: int,
                   cancelled=None) -> bytes:
        """One bounded OPEN a call (``offset`` + ``length``), with
        per-range retry as the object stores have."""

        def open_ranged(start: int, end: int):
            return urllib.request.urlopen(
                self._url(path.name, "OPEN", offset=start,
                          length=end - start), timeout=60)

        return read_range_with_retry(
            open_ranged, offset, length, self._display(path),
            max_retry=READ_MAX_RETRY, retry_sleep_s=READ_RETRY_SLEEP_S,
            cancelled=cancelled)

    def open(self, path: URI, flag: str) -> Stream:
        check(flag in ("r", "w"), "hdfs supports flags r/w, not %s", flag)
        if flag == "r":
            return self.open_for_read(path)
        return _WebHDFSWriteStream(self, path)


class _WebHDFSWriteStream(ObjectWriteStream):
    """Buffered CREATE-then-APPEND writer. CREATE with ``overwrite=true``
    replaces the whole file, so a resend after an unclear failure gives
    the same bytes: it retries under the policy. APPEND is not idempotent
    (a lost ack after the datanode kept the bytes would double them on a
    resend), so it is sent once and HDFS's own pipeline recovers it."""

    def __init__(self, fs: WebHDFSFileSystem, path: URI):
        super().__init__(fs._part_bytes)
        self._fs = fs
        self._path = path
        self._created = False

    def _upload_part(self, data: bytes, last: bool) -> None:
        from dmlc_tpu_torch.resilience import RetryPolicy

        if not self._created:
            RetryPolicy(max_attempts=WRITE_MAX_RETRY,
                        base_s=READ_RETRY_SLEEP_S).call(
                lambda: self._fs._two_step_write(
                    "PUT", self._path.name, "CREATE", data,
                    overwrite="true"),
                "io.hdfs.create",
                display=f"webhdfs CREATE {self._path.name}")
            self._created = True
        elif data:
            # once only: the class docstring
            self._fs._two_step_write("POST", self._path.name, "APPEND", data)

    def _finalize(self) -> None:
        pass  # every byte is durable once its CREATE / APPEND returned


def _factory(uri: URI) -> FileSystem:
    return WebHDFSFileSystem(uri)


register_filesystem("hdfs://", _factory)
