"""ctypes bindings to the native ncio core (native/ncio/libncio.so).

Auto-builds with `make` on first use if a toolchain is present; every entry
point has a NumPy fallback, so the framework works (slower) without it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NCIO_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "ncio")
_LIB_PATH = os.path.join(_NCIO_DIR, "libncio.so")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH) and os.path.exists(
            os.path.join(_NCIO_DIR, "Makefile")):
        # Build under a name of this process's own and rename: processes
        # that start together (test workers) each build, and none can load
        # a library another one is still writing.
        tmp = f"{os.path.basename(_LIB_PATH)}.{os.getpid()}.tmp"
        try:
            subprocess.run(["make", "-C", _NCIO_DIR, f"TARGET={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(os.path.join(_NCIO_DIR, tmp), _LIB_PATH)
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.ncio_byteswap.restype = ctypes.c_int
    lib.ncio_byteswap.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_size_t, ctypes.c_int]
    lib.ncio_gather_records.restype = ctypes.c_int
    lib.ncio_gather_records.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_size_t, ctypes.c_int]
    lib.ncio_parse_table.restype = ctypes.c_longlong
    lib.ncio_parse_table.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
    if hasattr(lib, "ncio_file_sizes"):
        lib.ncio_file_sizes.restype = None
        lib.ncio_file_sizes.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.ncio_read_files.restype = None
        lib.ncio_read_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_be(buf: memoryview | bytes, dtype, count: int,
              offset: int = 0) -> np.ndarray:
    """Big-endian slice of `buf` -> native-endian array (native fast path)."""
    dt_be = np.dtype(dtype).newbyteorder(">")
    dt_native = dt_be.newbyteorder("=")
    lib = _load()
    if lib is None or dt_be.itemsize == 1:
        return np.frombuffer(buf, dt_be, count, offset).astype(dt_native)
    out = np.empty(count, dt_native)
    src = np.frombuffer(buf, np.uint8, count * dt_be.itemsize, offset)
    rc = lib.ncio_byteswap(
        out.ctypes.data_as(ctypes.c_void_p),
        src.ctypes.data_as(ctypes.c_void_p), count, dt_be.itemsize)
    if rc != 0:
        return np.frombuffer(buf, dt_be, count, offset).astype(dt_native)
    return out


def encode_be(arr: np.ndarray) -> np.ndarray:
    """Native-endian array -> big-endian byte buffer (uint8 view).

    The write-side mirror of `decode_be`: the OpenMP byteswap produces the
    on-disk big-endian bytes in ONE parallel pass, replacing numpy's
    single-threaded `astype('>f4').tobytes()` (which also costs an extra
    full copy).  At campaign scale the results file is ~400 MB, so the
    encode is a measurable slice of the forward stage.
    """
    a = np.ascontiguousarray(arr)
    dt = a.dtype
    if dt.itemsize == 1:
        return a.reshape(-1).view(np.uint8)
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(
            a.astype(dt.newbyteorder(">"))).reshape(-1).view(np.uint8)
    out = np.empty(a.size * dt.itemsize, np.uint8)
    rc = lib.ncio_byteswap(
        out.ctypes.data_as(ctypes.c_void_p),
        a.ctypes.data_as(ctypes.c_void_p), a.size, dt.itemsize)
    if rc != 0:
        return np.ascontiguousarray(
            a.astype(dt.newbyteorder(">"))).reshape(-1).view(np.uint8)
    return out


def gather_records_be(buf, dtype, numrecs: int, recsize: int, per_rec: int,
                      begin: int) -> np.ndarray:
    """Strided record-variable gather + byteswap in one native pass."""
    dt_be = np.dtype(dtype).newbyteorder(">")
    dt_native = dt_be.newbyteorder("=")
    lib = _load()
    if lib is None:
        parts = [np.frombuffer(buf, dt_be, per_rec, begin + r * recsize)
                 for r in range(numrecs)]
        return (np.stack(parts).astype(dt_native) if parts
                else np.empty((0, per_rec), dt_native))
    out = np.empty((numrecs, per_rec), dt_native)
    nbytes_needed = begin + (numrecs - 1) * recsize + per_rec * dt_be.itemsize \
        if numrecs else 0
    src = np.frombuffer(buf, np.uint8, max(nbytes_needed - begin, 0), begin)
    rc = lib.ncio_gather_records(
        out.ctypes.data_as(ctypes.c_void_p),
        src.ctypes.data_as(ctypes.c_void_p), numrecs, recsize, per_rec,
        dt_be.itemsize)
    if rc != 0:
        parts = [np.frombuffer(buf, dt_be, per_rec, begin + r * recsize)
                 for r in range(numrecs)]
        return np.stack(parts).astype(dt_native)
    return out


def parse_table(path: str, ncols: int, skip_header: int,
                skip_footer: int, max_rows: int = 1_000_000):
    """Native whitespace-table parse -> (rows, ncols) float64, or None if the
    native library is unavailable (caller falls back to Python parsing)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((max_rows, ncols), np.float64)
    n = lib.ncio_parse_table(
        path.encode(), ncols, skip_header, skip_footer,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_rows)
    if n < 0:
        return None
    return out[:n].copy()


def read_files(paths: list) -> list:
    """Read many files concurrently through the native OpenMP pool.

    Returns a list of `bytes` (None for unreadable paths).  Falls back to
    sequential Python reads when the native library is absent — same
    contract, just without the IO overlap.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "ncio_read_files"):
        out = []
        for p in paths:
            try:
                with open(p, "rb") as fh:
                    out.append(fh.read())
            except OSError:
                out.append(None)
        return out
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    sizes = np.empty(n, np.int64)
    lib.ncio_file_sizes(c_paths, n, sizes.ctypes.data_as(
        ctypes.POINTER(ctypes.c_longlong)))
    bufs = [np.empty(max(int(s), 0), np.uint8) for s in sizes]
    c_bufs = (ctypes.c_char_p * n)(*[
        ctypes.cast(b.ctypes.data, ctypes.c_char_p) for b in bufs])
    status = np.empty(n, np.int32)
    lib.ncio_read_files(c_paths, n, c_bufs,
                        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return [bufs[i].tobytes() if status[i] == 0 else None for i in range(n)]
