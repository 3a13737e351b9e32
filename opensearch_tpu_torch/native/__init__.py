"""Native runtime bindings: C++ hot paths loaded via ctypes.

The reference leans on JVM intrinsics + Lucene's native-speed codecs for
its WAL and postings paths (SURVEY.md §2 "TPU-build note" rows); here the
same two hot loops are C++ (native/tlog_codec.cpp) behind a C ABI — ctypes,
not pybind11 (not in this image). The library is built on first import with
g++ (cached next to the source); every entry point has a pure-Python
fallback so the engine still runs where no toolchain exists.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from pathlib import Path

_DIR = Path(__file__).parent
_SRC = _DIR / "tlog_codec.cpp"
_LIB = _DIR / f"libosnative-{sys.implementation.cache_tag}.so"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_attempted = False


def _build() -> bool:
    # compile to a temp path + atomic rename: a concurrent process must
    # never CDLL a half-written .so (it would silently fall back to Python)
    tmp = _LIB.with_suffix(f".tmp{os.getpid()}.so")
    try:
        result = subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(tmp)],
            capture_output=True, timeout=120,
        )
        if result.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> ctypes.CDLL | None:
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("OPENSEARCH_TPU_NO_NATIVE"):
            return None
        stale = (
            not _LIB.exists()
            or _LIB.stat().st_mtime < _SRC.stat().st_mtime
        )
        if stale and not _build():
            return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        lib.osn_crc32.restype = ctypes.c_uint32
        lib.osn_crc32.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.tlog_open.restype = ctypes.c_void_p
        lib.tlog_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.tlog_append.restype = ctypes.c_int64
        lib.tlog_append.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32
        ]
        lib.tlog_tell.restype = ctypes.c_uint64
        lib.tlog_tell.argtypes = [ctypes.c_void_p]
        lib.tlog_sync.restype = ctypes.c_int
        lib.tlog_sync.argtypes = [ctypes.c_void_p]
        lib.tlog_close.argtypes = [ctypes.c_void_p]
        lib.varint_encode.restype = ctypes.c_int64
        lib.varint_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64
        ]
        lib.varint_decode.restype = ctypes.c_int64
        lib.varint_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


# -- translog writer --------------------------------------------------------


class NativeTlogWriter:
    """C++ buffered CRC-framed appender; format-compatible with the Python
    Translog reader ([u32 len][u32 zlib-crc32][payload])."""

    def __init__(self, path: str | os.PathLike, offset: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.tlog_open(str(path).encode(), offset)
        if not self._handle:
            raise OSError(f"tlog_open failed for [{path}]")

    def append(self, payload: bytes) -> int:
        loc = self._lib.tlog_append(self._handle, payload, len(payload))
        if loc < 0:
            raise OSError("tlog_append failed")
        return loc

    def tell(self) -> int:
        return int(self._lib.tlog_tell(self._handle))

    def sync(self) -> None:
        if self._lib.tlog_sync(self._handle) != 0:
            raise OSError("tlog_sync failed")

    def close(self) -> None:
        if self._handle:
            self._lib.tlog_close(self._handle)
            self._handle = None


# -- varint codec (with numpy/python fallback) -------------------------------


_MAX_VARINT_BYTES = 5  # zigzag(int33 delta) fits in 5 x 7 bits


def varint_encode(values) -> bytes:
    """Zigzag-delta varint for an int32 array; native, else vectorized numpy
    (both on the segment save path, so the fallback must not be a per-
    element Python loop)."""
    import numpy as np

    arr = np.ascontiguousarray(values, dtype=np.int32)
    if arr.size == 0:
        return b""
    lib = _load()
    if lib is not None:
        cap = arr.size * 10 + 16
        out = ctypes.create_string_buffer(cap)
        n = lib.varint_encode(
            arr.ctypes.data_as(ctypes.c_void_p), arr.size, out, cap
        )
        if n >= 0:
            return out.raw[:n]
    # vectorized fallback: [n, 5] byte matrix + per-value length mask
    v64 = arr.astype(np.int64)
    deltas = np.diff(v64, prepend=np.int64(0))
    z = ((deltas << 1) ^ (deltas >> 63)).astype(np.uint64)
    chunks = np.empty((arr.size, _MAX_VARINT_BYTES), np.uint8)
    rest = z.copy()
    for k in range(_MAX_VARINT_BYTES):
        chunks[:, k] = (rest & np.uint64(0x7F)).astype(np.uint8)
        rest >>= np.uint64(7)
    # per-value byte count: 1 + number of nonzero higher 7-bit groups
    nbytes = np.ones(arr.size, np.int64)
    acc = z >> np.uint64(7)
    while acc.any():
        nbytes += (acc != 0)
        acc >>= np.uint64(7)
    cont_mask = np.arange(_MAX_VARINT_BYTES)[None, :] < (nbytes - 1)[:, None]
    chunks |= cont_mask.astype(np.uint8) << 7
    keep = np.arange(_MAX_VARINT_BYTES)[None, :] < nbytes[:, None]
    return chunks[keep].tobytes()


def varint_decode(data: bytes, count_hint: int | None = None):
    """Decode zigzag-delta varint bytes back to an int32 numpy array.
    `count_hint` is optional — the stream itself determines the count."""
    import numpy as np

    if not data:
        return np.zeros(0, np.int32)
    lib = _load()
    if lib is not None:
        cap = len(data)  # >= 1 byte per value: always sufficient
        out = np.empty(cap, np.int32)
        n = lib.varint_decode(
            data, len(data), out.ctypes.data_as(ctypes.c_void_p), cap
        )
        if n < 0:
            raise ValueError("varint_decode: malformed input")
        return out[:n].copy()
    # vectorized fallback: group 7-bit chunks between terminal bytes
    buf = np.frombuffer(data, np.uint8)
    terminal = (buf & 0x80) == 0
    if not terminal[-1]:
        raise ValueError("truncated varint stream")
    ends = np.nonzero(terminal)[0]
    starts = np.concatenate(([0], ends[:-1] + 1))
    lengths = ends - starts + 1
    if lengths.max() > 10:
        raise ValueError("varint_decode: malformed input")
    z = np.zeros(len(ends), np.uint64)
    payload = (buf & 0x7F).astype(np.uint64)
    for k in range(int(lengths.max())):
        mask = lengths > k
        z[mask] |= payload[starts[mask] + k] << np.uint64(7 * k)
    deltas = (z >> np.uint64(1)).astype(np.int64) ^ -(
        (z & np.uint64(1)).astype(np.int64)
    )
    return np.cumsum(deltas).astype(np.int32)
