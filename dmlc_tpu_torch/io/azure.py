"""Azure Blob Storage, ``azure://container/blob``: the port of
``dmlc_tpu/io/azure.py``. The reference lists blobs through the Azure C++
SDK (src/io/azure_filesys.cc:32-92); this backend speaks the Blob REST
dialect through the object stores' machinery: stat, listing (with
prefixes and paging), ranged reads, block-committed writes (Put Blob
below one part, Put Block + Put Block List above it) and delete.

Environment, read when the backend is built:

- ``AZURE_STORAGE_ACCOUNT`` with ``AZURE_STORAGE_ACCESS_KEY`` (or
  ``AZURE_STORAGE_KEY``; base64): SharedKey-signed requests;
- ``AZURE_STORAGE_SAS_TOKEN``: a SAS appended to each request's query
  (no Authorization header);
- neither: anonymous requests (a public container, or a test server);
- ``AZURE_STORAGE_ENDPOINT`` replaces
  ``https://{account}.blob.core.windows.net``;
- ``DMLC_AZURE_WRITE_BUFFER_MB`` (else ``DMLC_S3_WRITE_BUFFER_MB``,
  default 64): the block size.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from email.utils import formatdate
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.io.filesystem import URI, register_filesystem
from dmlc_tpu_torch.io.object_store import (ObjectWriteStream,
                                            _http, _keepalive_get,
                                            _ObjectStoreBase,
                                            _write_buffer_bytes,
                                            _write_call)
from dmlc_tpu_torch.io.stream import Stream
from dmlc_tpu_torch.utils.logging import check

_API_VERSION = "2021-08-06"

# the standard headers of the SharedKey string-to-sign, in order
_SIGNED_STD_HEADERS = (
    "Content-Encoding", "Content-Language", "Content-Length", "Content-MD5",
    "Content-Type", "Date", "If-Modified-Since", "If-Match", "If-None-Match",
    "If-Unmodified-Since", "Range",
)


def _rfc1123_now() -> str:
    return formatdate(timeval=None, localtime=False, usegmt=True)


class AzureBlobFileSystem(_ObjectStoreBase):
    """``azure://container/blob`` over the Blob service's REST API."""

    def __init__(self):
        env = os.environ
        self.account = env.get("AZURE_STORAGE_ACCOUNT", "")
        self.key = env.get("AZURE_STORAGE_ACCESS_KEY",
                           env.get("AZURE_STORAGE_KEY", ""))
        self.sas = env.get("AZURE_STORAGE_SAS_TOKEN", "").lstrip("?")
        endpoint = env.get("AZURE_STORAGE_ENDPOINT")
        if not endpoint:
            check(bool(self.account),
                  "set AZURE_STORAGE_ACCOUNT (and ACCESS_KEY or SAS_TOKEN) "
                  "to use azure:// (azure_filesys.cc:32-39 contract)")
            endpoint = f"https://{self.account}.blob.core.windows.net"
        self.endpoint = endpoint.rstrip("/")
        self.part_bytes = _write_buffer_bytes("DMLC_AZURE_WRITE_BUFFER_MB",
                                              "DMLC_S3_WRITE_BUFFER_MB")

    # ---- requests ------------------------------------------------------------
    def _url(self, container: str, key: str, query: str = "") -> str:
        path = f"/{container}"
        if key:
            path += f"/{urllib.parse.quote(key)}"
        if self.sas:
            query = f"{query}&{self.sas}" if query else self.sas
        return self.endpoint + path + (f"?{query}" if query else "")

    def _auth_headers(self, method: str, url: str, headers: Dict[str, str],
                      content_length: int = 0) -> Dict[str, str]:
        """``x-ms-date`` / ``x-ms-version`` and the SharedKey
        Authorization header (none under a SAS or anonymous access)."""
        out = dict(headers)
        out.setdefault("x-ms-date", _rfc1123_now())
        out.setdefault("x-ms-version", _API_VERSION)
        if not (self.account and self.key) or self.sas:
            return out
        parsed = urllib.parse.urlsplit(url)
        canon_headers = "".join(f"{k.lower()}:{v.strip()}\n"
                                for k, v in sorted(out.items())
                                if k.lower().startswith("x-ms-"))
        # the canonicalized resource: /account/path, then the sorted query
        resource = f"/{self.account}{parsed.path}"
        params = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
        for name, value in sorted(params):
            resource += f"\n{name.lower()}:{value}"
        values = dict.fromkeys(_SIGNED_STD_HEADERS, "")
        values["Content-Length"] = str(content_length) if content_length \
            else ""
        for k, v in out.items():
            title = k.title()
            if title in values and not title.startswith("X-Ms-"):
                values[title] = v
        to_sign = (method + "\n"
                   + "\n".join(values[h] for h in _SIGNED_STD_HEADERS) + "\n"
                   + canon_headers + resource)
        sig = base64.b64encode(hmac.new(base64.b64decode(self.key),
                                        to_sign.encode("utf-8"),
                                        hashlib.sha256).digest()).decode()
        out["Authorization"] = f"SharedKey {self.account}:{sig}"
        return out

    def _request(self, method: str, url: str, payload: bytes = b"",
                 headers: Optional[Dict[str, str]] = None):
        hdrs = dict(headers or {})
        if payload:
            # urllib adds a Content-Type to a request with a body: name it
            # so the string-to-sign matches what is sent
            hdrs.setdefault("Content-Type", "application/octet-stream")
        hdrs = self._auth_headers(method, url, hdrs,
                                  content_length=len(payload))
        return _http(urllib.request.Request(
            url, data=payload if payload else None, headers=hdrs,
            method=method))

    # ---- reads -----------------------------------------------------------------
    def _open_ranged(self, path: URI, start: int, end: Optional[int] = None):
        url = self._url(*self._bucket_key(path))
        hdrs = self._auth_headers("GET", url,
                                  {"Range": self._range_header(start, end)})
        if end is not None:  # bounded: the body is drained, reuse is safe
            return _keepalive_get(url, hdrs)
        return _http(urllib.request.Request(url, headers=hdrs))

    def _stat_object(self, path: URI) -> Optional[int]:
        container, key = self._bucket_key(path)
        if not key:
            return None
        try:
            with self._request("HEAD", self._url(container, key)) as resp:
                return int(resp.headers.get("Content-Length", 0))
        except urllib.error.HTTPError as err:
            if err.code in (404, 403):
                return None
            raise

    def _list(self, container: str, prefix: str, delimiter: str):
        """List Blobs, with a delimiter for one level (the reference's
        ListDirectory, azure_filesys.cc:42-92), following NextMarker."""
        files: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        marker = None
        while True:
            q = [("restype", "container"), ("comp", "list")]
            if prefix:
                q.append(("prefix", prefix))
            if delimiter:
                q.append(("delimiter", delimiter))
            if marker:
                q.append(("marker", marker))
            url = self._url(container, "", urllib.parse.urlencode(q))
            with self._request("GET", url) as resp:
                tree = ET.fromstring(resp.read())
            blobs = tree.find("Blobs")
            if blobs is not None:
                for item in blobs.findall("Blob"):
                    files.append((item.findtext("Name"), int(item.findtext(
                        "Properties/Content-Length", "0"))))
                for item in blobs.findall("BlobPrefix"):
                    prefixes.append(item.findtext("Name"))
            marker = tree.findtext("NextMarker")
            if not marker:
                break
        return files, prefixes

    # ---- writes: Put Block + Put Block List --------------------------------------
    class _AzureWriteStream(ObjectWriteStream):
        def __init__(self, fs: "AzureBlobFileSystem", path: URI):
            super().__init__(fs.part_bytes)
            self._fs = fs
            self._path = path
            self._block_ids: Optional[List[str]] = []

        def _upload_part(self, data: bytes, last: bool) -> None:
            fs, (container, key) = self._fs, self._fs._bucket_key(self._path)
            if last and not self._block_ids:
                # one Put Blob (the common small object)
                url = fs._url(container, key)

                def put():
                    with fs._request("PUT", url, payload=data,
                                     headers={"x-ms-blob-type": "BlockBlob"}):
                        pass

                _write_call(put, "io.azure.write", f"azure Put Blob {key}")
                self._block_ids = None  # nothing to commit
                return
            if not data and last:
                return
            block_id = base64.b64encode(
                f"{len(self._block_ids):010d}".encode()).decode()
            url = fs._url(container, key, urllib.parse.urlencode(
                [("comp", "block"), ("blockid", block_id)]))

            def put_block():
                with fs._request("PUT", url, payload=data):
                    pass

            _write_call(put_block, "io.azure.write", f"azure Put Block {key}")
            self._block_ids.append(block_id)

        def _finalize(self) -> None:
            if self._block_ids is None:
                return  # the single Put Blob
            fs, (container, key) = self._fs, self._fs._bucket_key(self._path)
            body = ('<?xml version="1.0" encoding="utf-8"?><BlockList>'
                    + "".join(f"<Latest>{b}</Latest>"
                              for b in self._block_ids)
                    + "</BlockList>").encode()
            url = fs._url(container, key,
                          urllib.parse.urlencode([("comp", "blocklist")]))

            def commit():
                with fs._request("PUT", url, payload=body):
                    pass

            _write_call(commit, "io.azure.write",
                        f"azure Put Block List {key}")

    def _open_write(self, path: URI) -> Stream:
        return self._AzureWriteStream(self, path)

    def delete(self, path: URI) -> None:
        container, key = self._bucket_key(path)
        url = self._url(container, key)

        def call():
            with self._request("DELETE", url):
                pass

        # Delete Blob is idempotent: retried as the other backends' are
        _write_call(call, "io.azure.delete", f"azure Delete Blob {key}")


register_filesystem("azure://", lambda uri: AzureBlobFileSystem())
