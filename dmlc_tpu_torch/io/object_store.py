"""Object-store filesystems, ``s3://`` and ``gs://`` / ``gcs://``: the port
of ``dmlc_tpu/io/object_store.py``, in the shape of the reference's S3
client (src/io/s3_filesys.{h,cc}):

- reads: bounded ranged GETs on a per-thread keep-alive connection
  (:func:`_keepalive_get`) through ``read_range_with_retry``, and the
  lazy-seek reconnecting ``RangedReadStream`` (at most 50 retries in a
  row without progress, 100 ms backoff, s3_filesys.cc:319-342);
- writes: a buffered part-upload stream (:class:`ObjectWriteStream`): S3
  multipart upload (InitiateMultipartUpload, UploadPart + ETag,
  CompleteMultipartUpload, s3_filesys.cc:760-806; one PutObject when the
  object fits one part) and GCS resumable upload sessions (256 KiB
  aligned chunks); each mutating REST call retried at most 3 times under
  the ``io.write`` faultpoint (:func:`_write_call`); what is buffered is
  uploaded when the stream is closed, or destroyed, as dmlc-core's
  WriteStream does;
- listing: S3 ListObjectsV2 and GCS's JSON listing with prefix and
  delimiter (s3_filesys.cc:814-906);
- signing: AWS Signature V4 (:func:`_sigv4_headers`), a GCS bearer token.

Environment, read when a backend is built (``register_filesystem`` drops
the cached instance, so a changed value takes effect there):

- S3: ``S3_ENDPOINT`` or ``AWS_ENDPOINT_URL`` (default
  ``https://s3.{region}.amazonaws.com``), ``S3_ACCESS_KEY`` or
  ``AWS_ACCESS_KEY_ID``, ``S3_SECRET_KEY`` or ``AWS_SECRET_ACCESS_KEY``,
  ``S3_SESSION_TOKEN`` or ``AWS_SESSION_TOKEN``, ``S3_REGION`` or
  ``AWS_REGION`` (default us-east-1), ``S3_VERIFY_SSL`` (0 turns
  certificate checks off), ``DMLC_S3_WRITE_BUFFER_MB`` (part size,
  default 64); unsigned requests when no key is set;
- GCS: ``GCS_ENDPOINT_URL`` (default ``https://storage.googleapis.com``),
  ``GCS_OAUTH_TOKEN``, ``DMLC_GCS_WRITE_BUFFER_MB`` (default 64).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import hmac
import io
import json
import os
import threading
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from dmlc_tpu_torch.io.filesystem import (FILE_TYPE_DIR, FILE_TYPE_FILE,
                                          FileInfo, FileSystem,
                                          RangedReadStream, URI,
                                          read_range_with_retry,
                                          register_filesystem)
from dmlc_tpu_torch.io.stream import SeekStream, Stream
from dmlc_tpu_torch.utils.logging import DMLCError, check, log_warning

READ_MAX_RETRY = 50          # s3_filesys.cc:319-342
READ_RETRY_SLEEP_S = 0.1
WRITE_MAX_RETRY = 3          # s3_filesys.cc:577
DEFAULT_WRITE_BUFFER_MB = 64  # s3_filesys.cc:573-575


def _http(req: urllib.request.Request, timeout: float = 60,
          verify_ssl: bool = True):
    if not verify_ssl:
        import ssl

        ctx = ssl.create_default_context()
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
        return urllib.request.urlopen(req, timeout=timeout, context=ctx)
    return urllib.request.urlopen(req, timeout=timeout)


_keepalive_local = threading.local()


def _keepalive_get(url: str, headers: Dict[str, str], timeout: float = 60,
                   verify_ssl: bool = True, max_redirects: int = 5):
    """A bounded ranged GET over a persistent connection of this thread.

    urllib opens (and the server closes) a TCP connection a request: a
    handshake and a slow-start restart every range. Here connections are
    kept per (scheme, netloc) in thread-local storage, so each thread
    that fetches (a prefetch thread, a readahead worker) keeps its own. A
    stale kept-alive connection retries once on a fresh one; a 3xx
    follows Location; a status >= 400 raises urllib's HTTPError, so the
    range loop's status handling applies unchanged. Bounded ranges only
    (the body is always read to its end): an undrained open-ended body
    would poison the thread's next request. When a proxy applies to the
    URL's scheme, the request goes through urlopen (its ProxyHandler)
    instead."""
    import http.client
    import ssl

    if urllib.request.getproxies().get(urllib.parse.urlsplit(url).scheme):
        return _http(urllib.request.Request(url, headers=headers),
                     timeout=timeout, verify_ssl=verify_ssl)
    conns = getattr(_keepalive_local, "conns", None)
    if conns is None:
        conns = _keepalive_local.conns = {}
    last_err = None
    for _hop in range(max_redirects):
        parsed = urllib.parse.urlsplit(url)
        key = (parsed.scheme, parsed.netloc)
        path = parsed.path + (f"?{parsed.query}" if parsed.query else "")
        resp = None
        for _attempt in range(2):
            conn = conns.get(key)
            if conn is None:
                if parsed.scheme == "https":
                    ctx = ssl.create_default_context()
                    if not verify_ssl:
                        ctx.check_hostname = False
                        ctx.verify_mode = ssl.CERT_NONE
                    conn = http.client.HTTPSConnection(
                        parsed.netloc, timeout=timeout, context=ctx)
                else:
                    conn = http.client.HTTPConnection(parsed.netloc,
                                                      timeout=timeout)
                conns[key] = conn
            try:
                conn.request("GET", path, headers=headers)
                resp = conn.getresponse()
                break
            except (OSError, http.client.HTTPException) as err:
                # a stale keep-alive: drop it, retry once on a fresh one
                conn.close()
                conns.pop(key, None)
                last_err = err
        if resp is None:
            raise last_err
        if 300 <= resp.status < 400:
            location = resp.headers.get("Location")
            resp.read()
            resp.close()
            if not location:
                raise urllib.error.HTTPError(url, resp.status, resp.reason,
                                             resp.headers, None)
            url = urllib.parse.urljoin(url, location)
            continue
        if resp.status >= 400:
            body = resp.read()
            resp.close()
            raise urllib.error.HTTPError(url, resp.status, resp.reason,
                                         resp.headers, io.BytesIO(body))
        return resp
    raise DMLCError(f"too many redirects fetching {url}")


# ---------------------------------------------------------------------------
# AWS Signature V4
# ---------------------------------------------------------------------------


def _sigv4_headers(method: str, url: str, region: str, access_key: str,
                   secret_key: str, payload: bytes = b"",
                   session_token: Optional[str] = None,
                   now: Optional[_dt.datetime] = None) -> Dict[str, str]:
    """The AWS SigV4 headers of one S3 request (the public spec; the
    reference signed with V2, s3_filesys.cc:90-122)."""
    parsed = urllib.parse.urlsplit(url)
    now = now or _dt.datetime.now(_dt.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()
    headers = {"host": parsed.netloc, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amz_date}
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed_names = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k].strip()}\n"
                                for k in sorted(headers))
    # the canonical query: sorted by key, values percent-encoded
    query_pairs = urllib.parse.parse_qsl(parsed.query,
                                         keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(query_pairs))
    # the path is already percent-encoded as sent (the url helpers quote
    # the keys): quoting it again would break the signature of special keys
    canonical_request = "\n".join([
        method, parsed.path or "/", canonical_query, canonical_headers,
        signed_names, payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_signing = _hmac(_hmac(_hmac(_hmac(b"AWS4" + secret_key.encode(),
                                        datestamp), region), "s3"),
                      "aws4_request")
    signature = hmac.new(k_signing, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    headers["Authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed_names}, Signature={signature}")
    del headers["host"]  # urllib sets it
    return headers


# ---------------------------------------------------------------------------
# writes
# ---------------------------------------------------------------------------


class ObjectWriteStream(Stream):
    """Buffered part-upload writer (WriteStream, s3_filesys.cc:557-812):
    buffer to the part size, upload each part as it fills, finish on
    close. Subclasses implement ``_upload_part`` and ``_finalize``."""

    def __init__(self, part_bytes: int):
        self._buf = bytearray()
        self._part_bytes = part_bytes
        self._closed = False

    def read(self, nbytes: int) -> bytes:
        raise IOError("write-only stream")

    def write(self, data: bytes) -> None:
        check(not self._closed, "stream closed")
        self._buf.extend(data)
        while len(self._buf) >= self._part_bytes:
            part = bytes(self._buf[:self._part_bytes])
            del self._buf[:self._part_bytes]
            self._upload_part(part, last=False)

    def close(self) -> None:
        if self._closed:
            return
        # closed before the final upload: a failed close is not retried
        # from __del__
        self._closed = True
        self._upload_part(bytes(self._buf), last=True)
        self._buf.clear()
        self._finalize()

    def __del__(self):  # the reference's WriteStream uploads on destruction
        try:
            self.close()
        except Exception as err:  # noqa: BLE001 (nothing can raise here)
            # a failed upload at collection time leaves no object: say so
            log_warning("object upload lost in destructor: %s", err)

    def _upload_part(self, data: bytes, last: bool) -> None:
        raise NotImplementedError

    def _finalize(self) -> None:
        raise NotImplementedError


def _write_call(fn, site: str, what: str):
    """One mutating REST call (the s3_filesys.cc:712-751 shape) under the
    retry policy (at most 3 tries; 429/408 retry like 5xx), with the
    ``io.write`` faultpoint inside the retried region so an injected
    write fault takes the path a real one does."""
    from dmlc_tpu_torch.resilience import RetryPolicy, faultpoint

    def attempt():
        faultpoint("io.write")
        return fn()

    return RetryPolicy(max_attempts=WRITE_MAX_RETRY,
                       base_s=READ_RETRY_SLEEP_S).call(attempt, site,
                                                       display=what)


# ---------------------------------------------------------------------------
# the bucket/key plumbing S3, GCS and Azure share
# ---------------------------------------------------------------------------


class _ObjectStoreBase(FileSystem):
    def _bucket_key(self, path: URI) -> Tuple[str, str]:
        return path.host, path.name.lstrip("/")

    def _display(self, path: URI) -> str:
        return path.str_full()

    def _open_ranged(self, path: URI, start: int, end: Optional[int] = None):
        """A GET from ``start``; bounded to [start, end) when end is
        given."""
        raise NotImplementedError

    @staticmethod
    def _range_header(start: int, end: Optional[int]) -> str:
        return f"bytes={start}-" if end is None else f"bytes={start}-{end - 1}"

    def read_range(self, path: URI, offset: int, length: int,
                   cancelled=None, into=None):
        """One bounded ranged GET a call with per-range retry; with
        ``into`` (a writable memoryview) the body lands there and the
        byte count is returned."""
        return read_range_with_retry(
            lambda start, end: self._open_ranged(path, start, end),
            offset, length, self._display(path),
            max_retry=READ_MAX_RETRY, retry_sleep_s=READ_RETRY_SLEEP_S,
            cancelled=cancelled, into=into)

    def _stat_object(self, path: URI) -> Optional[int]:
        """The object's size, or None when there is no such object."""
        raise NotImplementedError

    def _list(self, bucket: str, prefix: str, delimiter: str):
        """(files: [(key, size)], prefixes: [str])."""
        raise NotImplementedError

    def get_path_info(self, path: URI) -> FileInfo:
        size = self._stat_object(path)
        if size is not None:
            return FileInfo(path=path, size=size, type=FILE_TYPE_FILE)
        # a directory: any key under the prefix (TryGetPathInfo,
        # s3_filesys.cc:970-989)
        bucket, key = self._bucket_key(path)
        prefix = key.rstrip("/") + "/" if key else ""
        files, prefixes = self._list(bucket, prefix, "/")
        if files or prefixes:
            return FileInfo(path=path, size=0, type=FILE_TYPE_DIR)
        raise FileNotFoundError(self._display(path))

    def list_directory(self, path: URI) -> List[FileInfo]:
        bucket, key = self._bucket_key(path)
        prefix = key.rstrip("/") + "/" if key else ""
        files, prefixes = self._list(bucket, prefix, "/")
        out: List[FileInfo] = []
        for sub_key, size in files:
            if sub_key == prefix:  # the directory marker object itself
                continue
            out.append(FileInfo(path=URI(path.protocol, path.host,
                                         "/" + sub_key),
                                size=size, type=FILE_TYPE_FILE))
        for p in prefixes:
            out.append(FileInfo(path=URI(path.protocol, path.host,
                                         "/" + p.rstrip("/")),
                                size=0, type=FILE_TYPE_DIR))
        out.sort(key=lambda fi: fi.path.name)
        return out

    def open_for_read(self, path: URI,
                      allow_null: bool = False) -> Optional[SeekStream]:
        size = self._stat_object(path)
        if size is None:
            if allow_null:
                return None
            raise FileNotFoundError(self._display(path))
        return RangedReadStream(
            lambda start: self._open_ranged(path, start), size,
            self._display(path), max_retry=READ_MAX_RETRY,
            retry_sleep_s=READ_RETRY_SLEEP_S)

    def open(self, path: URI, flag: str) -> Stream:
        check(flag in ("r", "w"), "object stores support flags r/w, not %s",
              flag)
        if flag == "r":
            return self.open_for_read(path)
        return self._open_write(path)

    def _open_write(self, path: URI) -> Stream:
        raise NotImplementedError


def _write_buffer_bytes(*names: str) -> int:
    """The part size in bytes from the first of ``names`` that is set, in
    MB (default :data:`DEFAULT_WRITE_BUFFER_MB`)."""
    for name in names:
        raw = os.environ.get(name)
        if raw is not None:
            return int(raw) << 20
    return DEFAULT_WRITE_BUFFER_MB << 20


# ---------------------------------------------------------------------------
# S3
# ---------------------------------------------------------------------------


class S3FileSystem(_ObjectStoreBase):
    """``s3://bucket/key`` over path-style REST, signed with SigV4."""

    def __init__(self):
        env = os.environ
        # the credential precedence of s3_filesys.cc:909-962
        self.access_key = (env.get("S3_ACCESS_KEY")
                           or env.get("AWS_ACCESS_KEY_ID"))
        self.secret_key = (env.get("S3_SECRET_KEY")
                           or env.get("AWS_SECRET_ACCESS_KEY"))
        self.session_token = (env.get("S3_SESSION_TOKEN")
                              or env.get("AWS_SESSION_TOKEN"))
        self.region = env.get("S3_REGION") or env.get("AWS_REGION",
                                                      "us-east-1")
        endpoint = env.get("S3_ENDPOINT") or env.get("AWS_ENDPOINT_URL")
        self.endpoint = (endpoint
                         or f"https://s3.{self.region}.amazonaws.com"
                         ).rstrip("/")
        self.verify_ssl = env.get("S3_VERIFY_SSL", "1") != "0"
        self.part_bytes = _write_buffer_bytes("DMLC_S3_WRITE_BUFFER_MB")

    def _url(self, bucket: str, key: str, query: str = "") -> str:
        path = f"/{bucket}/{urllib.parse.quote(key)}"
        return self.endpoint + path + (f"?{query}" if query else "")

    def _signed(self, method: str, url: str, payload: bytes = b"",
                headers: Optional[Dict[str, str]] = None) -> Dict[str, str]:
        hdrs = dict(headers or {})
        if self.access_key and self.secret_key:
            hdrs.update(_sigv4_headers(method, url, self.region,
                                       self.access_key, self.secret_key,
                                       payload, self.session_token))
        return hdrs

    def _request(self, method: str, url: str, payload: bytes = b"",
                 headers: Optional[Dict[str, str]] = None,
                 timeout: float = 60):
        req = urllib.request.Request(
            url, data=payload if payload else None,
            headers=self._signed(method, url, payload, headers),
            method=method)
        return _http(req, timeout=timeout, verify_ssl=self.verify_ssl)

    # ---- reads -----------------------------------------------------------
    def _open_ranged(self, path: URI, start: int, end: Optional[int] = None):
        url = self._url(*self._bucket_key(path))
        hdrs = self._signed("GET", url, b"",
                            {"Range": self._range_header(start, end)})
        if end is not None:  # bounded: the body is drained, reuse is safe
            return _keepalive_get(url, hdrs, verify_ssl=self.verify_ssl)
        return _http(urllib.request.Request(url, headers=hdrs),
                     verify_ssl=self.verify_ssl)

    def _stat_object(self, path: URI) -> Optional[int]:
        bucket, key = self._bucket_key(path)
        if not key:
            return None
        try:
            with self._request("HEAD", self._url(bucket, key)) as resp:
                return int(resp.headers.get("Content-Length", 0))
        except urllib.error.HTTPError as err:
            if err.code in (404, 403):
                return None
            raise

    def _list(self, bucket: str, prefix: str, delimiter: str):
        files: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        token = None
        while True:
            q = [("list-type", "2"), ("prefix", prefix),
                 ("delimiter", delimiter)]
            if token:
                q.append(("continuation-token", token))
            url = f"{self.endpoint}/{bucket}?{urllib.parse.urlencode(q)}"
            with self._request("GET", url) as resp:
                tree = ET.fromstring(resp.read())
            ns = ""
            if tree.tag.startswith("{"):
                ns = tree.tag[:tree.tag.index("}") + 1]
            for item in tree.findall(f"{ns}Contents"):
                files.append((item.findtext(f"{ns}Key"),
                              int(item.findtext(f"{ns}Size", "0"))))
            for item in tree.findall(f"{ns}CommonPrefixes"):
                prefixes.append(item.findtext(f"{ns}Prefix"))
            token = tree.findtext(f"{ns}NextContinuationToken")
            if not token:
                break
        return files, prefixes

    # ---- writes: multipart upload (s3_filesys.cc:760-806) ----------------
    class _S3WriteStream(ObjectWriteStream):
        def __init__(self, fs: "S3FileSystem", path: URI):
            super().__init__(fs.part_bytes)
            self._fs = fs
            self._path = path
            self._upload_id: Optional[str] = None
            self._etags: List[str] = []
            self._part_no = 0

        def _init_upload(self) -> None:
            fs, (bucket, key) = self._fs, self._fs._bucket_key(self._path)
            url = fs._url(bucket, key, "uploads")

            def call():
                with fs._request("POST", url) as resp:
                    tree = ET.fromstring(resp.read())
                ns = (tree.tag[:tree.tag.index("}") + 1]
                      if tree.tag.startswith("{") else "")
                return tree.findtext(f"{ns}UploadId")

            self._upload_id = _write_call(call, "io.s3.write",
                                          "InitiateMultipartUpload")
            check(self._upload_id,
                  "no UploadId in InitiateMultipartUpload reply")

        def _upload_part(self, data: bytes, last: bool) -> None:
            fs, (bucket, key) = self._fs, self._fs._bucket_key(self._path)
            if self._upload_id is None and last and self._part_no == 0:
                # the whole object fits one buffer: one PutObject
                url = fs._url(bucket, key)

                def put():
                    with fs._request("PUT", url, payload=data):
                        pass

                _write_call(put, "io.s3.write", "PutObject")
                self._part_no = -1  # single-shot done
                return
            if self._upload_id is None:
                self._init_upload()
            self._part_no += 1
            n = self._part_no
            url = fs._url(bucket, key,
                          f"partNumber={n}&uploadId={self._upload_id}")

            def call():
                with fs._request("PUT", url, payload=data) as resp:
                    return resp.headers.get("ETag", "")

            self._etags.append(_write_call(call, "io.s3.write",
                                           f"UploadPart {n}"))

        def _finalize(self) -> None:
            if self._part_no <= 0:  # the single PutObject is done
                return
            fs, (bucket, key) = self._fs, self._fs._bucket_key(self._path)
            url = fs._url(bucket, key, f"uploadId={self._upload_id}")
            parts = "".join(
                f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{etag}</ETag>"
                f"</Part>" for i, etag in enumerate(self._etags))
            body = (f"<CompleteMultipartUpload>{parts}"
                    f"</CompleteMultipartUpload>").encode()

            def call():
                with fs._request("POST", url, payload=body):
                    pass

            _write_call(call, "io.s3.write", "CompleteMultipartUpload")

    def _open_write(self, path: URI) -> Stream:
        return self._S3WriteStream(self, path)

    def delete(self, path: URI) -> None:
        url = self._url(*self._bucket_key(path))

        def call():
            with self._request("DELETE", url):
                pass

        _write_call(call, "io.s3.delete", "DeleteObject")


# ---------------------------------------------------------------------------
# GCS
# ---------------------------------------------------------------------------


class GCSFileSystem(_ObjectStoreBase):
    """``gs://bucket/object``: the XML API for data, the JSON API for
    listing, resumable upload sessions for writes."""

    def __init__(self):
        env = os.environ
        self.endpoint = env.get("GCS_ENDPOINT_URL",
                                "https://storage.googleapis.com").rstrip("/")
        self.token = env.get("GCS_OAUTH_TOKEN")
        part = _write_buffer_bytes("DMLC_GCS_WRITE_BUFFER_MB")
        # resumable chunks are 256 KiB aligned (and not empty)
        self.part_bytes = max(256 << 10, part - part % (256 << 10))

    def _headers(self, extra: Optional[Dict[str, str]] = None
                 ) -> Dict[str, str]:
        hdrs = dict(extra or {})
        if self.token:
            hdrs["Authorization"] = f"Bearer {self.token}"
        return hdrs

    def _media_url(self, bucket: str, key: str) -> str:
        return f"{self.endpoint}/{bucket}/{urllib.parse.quote(key)}"

    def _open_ranged(self, path: URI, start: int, end: Optional[int] = None):
        url = self._media_url(*self._bucket_key(path))
        hdrs = self._headers({"Range": self._range_header(start, end)})
        if end is not None:  # bounded: the body is drained, reuse is safe
            return _keepalive_get(url, hdrs)
        return _http(urllib.request.Request(url, headers=hdrs))

    def _stat_object(self, path: URI) -> Optional[int]:
        bucket, key = self._bucket_key(path)
        if not key:
            return None
        req = urllib.request.Request(self._media_url(bucket, key),
                                     headers=self._headers(), method="HEAD")
        try:
            with _http(req) as resp:
                return int(resp.headers.get("Content-Length", 0))
        except urllib.error.HTTPError as err:
            if err.code in (404, 403):
                return None
            raise

    def delete(self, path: URI) -> None:
        url = self._media_url(*self._bucket_key(path))

        def call():
            req = urllib.request.Request(url, headers=self._headers(),
                                         method="DELETE")
            with _http(req):
                pass

        _write_call(call, "io.gcs.delete", "gcs DeleteObject")

    def _list(self, bucket: str, prefix: str, delimiter: str):
        files: List[Tuple[str, int]] = []
        prefixes: List[str] = []
        page_token = None
        while True:
            q = [("prefix", prefix), ("delimiter", delimiter)]
            if page_token:
                q.append(("pageToken", page_token))
            url = (f"{self.endpoint}/storage/v1/b/{bucket}/o?"
                   + urllib.parse.urlencode(q))
            with _http(urllib.request.Request(
                    url, headers=self._headers())) as resp:
                doc = json.loads(resp.read())
            for item in doc.get("items", []):
                files.append((item["name"], int(item.get("size", 0))))
            prefixes.extend(doc.get("prefixes", []))
            page_token = doc.get("nextPageToken")
            if not page_token:
                break
        return files, prefixes

    # ---- writes: a resumable upload session -------------------------------
    class _GCSWriteStream(ObjectWriteStream):
        def __init__(self, fs: "GCSFileSystem", path: URI):
            super().__init__(fs.part_bytes)
            self._fs = fs
            self._path = path
            self._session: Optional[str] = None
            self._offset = 0

        def _start_session(self) -> None:
            fs, (bucket, key) = self._fs, self._fs._bucket_key(self._path)
            url = (f"{fs.endpoint}/upload/storage/v1/b/{bucket}/o?"
                   + urllib.parse.urlencode([("uploadType", "resumable"),
                                             ("name", key)]))

            def call():
                req = urllib.request.Request(url, data=b"",
                                             headers=fs._headers(),
                                             method="POST")
                with _http(req) as resp:
                    return (resp.headers.get("Location")
                            or resp.headers.get("X-GUploader-UploadID"))

            self._session = _write_call(call, "io.gcs.write",
                                        "start resumable upload")
            check(self._session, "no session URI from resumable upload start")

        def _upload_part(self, data: bytes, last: bool) -> None:
            if self._session is None:
                self._start_session()
            start = self._offset
            total = str(start + len(data)) if last else "*"
            if data:
                content_range = f"bytes {start}-{start + len(data) - 1}/{total}"
            else:
                content_range = f"bytes */{total}"
            fs = self._fs

            def call():
                req = urllib.request.Request(
                    self._session, data=data,
                    headers=fs._headers({"Content-Range": content_range}),
                    method="PUT")
                try:
                    with _http(req):
                        pass
                except urllib.error.HTTPError as err:
                    if err.code != 308:  # 308: resume incomplete, expected
                        raise

            _write_call(call, "io.gcs.write", "resumable upload chunk")
            self._offset += len(data)

        def _finalize(self) -> None:
            pass  # the last chunk (a total, not "*") completes the session

    def _open_write(self, path: URI) -> Stream:
        return self._GCSWriteStream(self, path)


register_filesystem("s3://", lambda uri: S3FileSystem())
register_filesystem("gs://", lambda uri: GCSFileSystem())
register_filesystem("gcs://", lambda uri: GCSFileSystem())
