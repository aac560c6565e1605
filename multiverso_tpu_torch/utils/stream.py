"""URI-schemed stream IO.

Port of ``multiverso_tpu/utils/stream.py`` (host only, no torch).

Parity with the reference Stream layer (``include/multiverso/io/io.h:24-132``,
``src/io/io.cpp:8-21``): a factory keyed on URI scheme (``file://`` local,
``hdfs://`` behind a build flag there), binary streams consumed by table
Store/Load, and a buffered ``TextReader.get_line``.

The remote scheme is ``gs://`` (GCS) rather than HDFS. It is a registered
scheme gated on credentials (``_gcs_check_access``: an emulator address or
a token, else ``StreamError`` before any connection), the way HDFS was
compile-time gated in the reference.
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Callable, Dict, Optional, Tuple


class StreamError(IOError):
    pass


def _parse_uri(uri: str) -> Tuple[str, str]:
    if "://" in uri:
        scheme, _, path = uri.partition("://")
        return scheme.lower(), path
    return "file", uri


class _AtomicLocalStream(io.FileIO):
    """Durable local write stream: bytes land in a sibling temp file and
    only a CLEAN close publishes them — flush, ``fsync``, atomic
    ``os.replace``, then an fsync of the parent directory so the rename
    itself survives power loss. A crash (or an exception in the ``with``
    body, which aborts) leaves the previous file intact and at worst a
    stray ``.tmp-*`` — never a torn checkpoint/manifest at the final
    path. This is the write shape the ``non-atomic-durable-write`` lint
    enforces (docs/DURABILITY.md)."""

    def __init__(self, path: str):
        self._final = os.path.abspath(path)
        self._tmp = f"{self._final}.tmp-{os.getpid()}-{id(self):x}"
        self._aborted = False
        super().__init__(self._tmp, "wb")

    def abort(self) -> None:
        """Discard: close() unlinks the temp instead of publishing."""
        self._aborted = True

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        return super().__exit__(exc_type, exc, tb)

    def __del__(self) -> None:
        # GC finalization must NEVER publish: an abandoned stream (an
        # exception unwound past a with-less writer) holds a PARTIAL
        # payload, and IOBase's finalizer calls close() — which would
        # replace the intact previous file with the torn temp, the
        # exact outcome this class exists to prevent. Publication is
        # an explicit-close privilege.
        self._aborted = True
        try:
            super().__del__()
        except Exception:  # noqa: BLE001 - finalizers must not raise
            pass

    def close(self) -> None:
        if self.closed:
            return
        try:
            if not self._aborted:
                self.flush()
                os.fsync(self.fileno())
        finally:
            super().close()
        if self._aborted:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass
            return
        os.replace(self._tmp, self._final)
        dfd = os.open(os.path.dirname(self._final) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)


def _open_local(path: str, mode: str) -> BinaryIO:
    if "w" in mode or "a" in mode:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
    if "b" not in mode:
        mode += "b"
    if "w" in mode:
        # Checkpoints/manifests ride this path: publish atomically or
        # not at all (a torn meta.json would defeat the durability
        # marker latest_checkpoint selects on).
        return _AtomicLocalStream(path)
    return open(path, mode)


# -- gs:// — real GCS streams over the JSON API (stdlib urllib only) --------
# The reference's remote stream is HDFS behind a build flag
# (src/io/hdfs_stream.cpp, MULTIVERSO_USE_HDFS); the TPU-era remote store is
# GCS. No client library is required: reads GET `alt=media`, writes buffer
# locally and upload on close (uploadType=media). Endpoint resolution
# honors STORAGE_EMULATOR_HOST (the standard GCS emulator contract), so the
# scheme is fully testable offline; against real GCS a bearer token is taken
# from GCS_OAUTH_TOKEN. Without either, the gate stays graceful: a clear
# StreamError at open time, exactly like the reference's compile-time gate.

def _gcs_endpoint() -> str:
    host = os.environ.get("STORAGE_EMULATOR_HOST")
    if host:
        return host if "://" in host else f"http://{host}"
    return "https://storage.googleapis.com"


def _gcs_headers() -> Dict[str, str]:
    token = os.environ.get("GCS_OAUTH_TOKEN")
    return {"Authorization": f"Bearer {token}"} if token else {}


def _gcs_check_access() -> None:
    if (os.environ.get("STORAGE_EMULATOR_HOST")
            or os.environ.get("GCS_OAUTH_TOKEN")):
        return
    raise StreamError(
        "gs:// needs STORAGE_EMULATOR_HOST (emulator) or GCS_OAUTH_TOKEN "
        "(real GCS) — gated like the reference's MULTIVERSO_USE_HDFS flag "
        "(io/hdfs_stream.h). Use file:// or register_scheme() otherwise.")


def _split_bucket(path: str) -> Tuple[str, str]:
    bucket, _, obj = path.partition("/")
    if not bucket or not obj:
        raise StreamError(f"gs:// URI needs bucket/object, got '{path}'")
    return bucket, obj


class _GCSWriteStream(io.BytesIO):
    """Buffers locally; uploads the object on CLEAN close (single-shot
    media upload — checkpoint-sized payloads, matching HDFSStream's
    whole-file write usage in ServerTable::Store). If the ``with`` body
    raises, the upload is aborted so a half-written buffer never replaces
    the previous good object."""

    def __init__(self, bucket: str, obj: str):
        super().__init__()
        self._bucket, self._obj = bucket, obj
        self._uploaded = False
        self._aborted = False

    def abort(self) -> None:
        """Discard the buffer; close() becomes a no-op upload-wise."""
        self._aborted = True

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        return super().__exit__(exc_type, exc, tb)

    def close(self) -> None:
        if not self._uploaded and not self._aborted:
            self._uploaded = True
            import urllib.parse
            import urllib.request
            url = (f"{_gcs_endpoint()}/upload/storage/v1/b/{self._bucket}"
                   f"/o?uploadType=media&name="
                   f"{urllib.parse.quote(self._obj, safe='')}")
            req = urllib.request.Request(
                url, data=self.getvalue(), method="POST",
                headers={"Content-Type": "application/octet-stream",
                         **_gcs_headers()})
            try:
                with urllib.request.urlopen(req, timeout=60) as resp:
                    resp.read()
            except OSError as e:
                raise StreamError(f"gs:// upload failed: {e}") from e
        super().close()


def _gcs_object_url(bucket: str, obj: str, media: bool) -> str:
    import urllib.parse
    url = (f"{_gcs_endpoint()}/storage/v1/b/{bucket}/o/"
           f"{urllib.parse.quote(obj, safe='')}")
    return url + "?alt=media" if media else url


def _open_gcs(path: str, mode: str) -> BinaryIO:
    _gcs_check_access()
    bucket, obj = _split_bucket(path)
    if "w" in mode:
        return _GCSWriteStream(bucket, obj)
    if "a" in mode:
        raise StreamError("gs:// objects are immutable; append unsupported")
    import urllib.request
    req = urllib.request.Request(_gcs_object_url(bucket, obj, media=True),
                                 headers=_gcs_headers())
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return io.BytesIO(resp.read())
    except OSError as e:
        raise StreamError(f"gs:// read failed for {bucket}/{obj}: {e}") \
            from e


def _gcs_exists(path: str) -> bool:
    _gcs_check_access()
    bucket, obj = _split_bucket(path)
    import urllib.error
    import urllib.request
    req = urllib.request.Request(_gcs_object_url(bucket, obj, media=False),
                                 headers=_gcs_headers())
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            resp.read()
        return True
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return False
        raise StreamError(f"gs:// stat failed: {e}") from e
    except OSError as e:
        raise StreamError(f"gs:// stat failed: {e}") from e


_SCHEMES: Dict[str, Callable[[str, str], BinaryIO]] = {
    "file": _open_local,
    "gs": _open_gcs,
}


def register_scheme(name: str,
                    opener: Callable[[str, str], BinaryIO]) -> None:
    _SCHEMES[name.lower()] = opener


def open_stream(uri: str, mode: str = "r") -> BinaryIO:
    """Factory (ref src/io/io.cpp:8-21). mode: r|w|a (binary)."""
    scheme, path = _parse_uri(uri)
    opener = _SCHEMES.get(scheme)
    if opener is None:
        raise StreamError(f"unknown stream scheme '{scheme}'")
    return opener(path, mode)


def exists(uri: str) -> bool:
    scheme, path = _parse_uri(uri)
    if scheme == "file":
        return os.path.exists(path)
    if scheme == "gs":
        return _gcs_exists(path)
    raise StreamError(f"exists() unsupported for scheme '{scheme}'")


class TextReader:
    """Buffered line reader over a stream (ref src/io/io.cpp:25-60)."""

    def __init__(self, uri: str, buf_size: int = 1 << 16):
        self._stream = open_stream(uri, "r")
        self._reader = io.BufferedReader(self._stream, buffer_size=buf_size)

    def get_line(self) -> Optional[str]:
        """Next line without trailing newline; None at EOF."""
        raw = self._reader.readline()
        if not raw:
            return None
        return raw.decode("utf-8").rstrip("\n").rstrip("\r")

    def __iter__(self):
        while True:
            line = self.get_line()
            if line is None:
                return
            yield line

    def close(self) -> None:
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
