# The port's copy of weaviate_tpu/storage/lsm_native.py, its imports pointed at the port.
"""ctypes bridge to the native LSM point-get plane (native/lsm_get.cpp).

Batched replace-strategy point lookups over the mmap'd segment files in ONE
C call: the GIL is released for its duration (ctypes semantics), so
concurrent request hydrations overlap instead of serializing, and the
per-key cost drops from a Python bisect to a bytewise binary search.

Reference analog: the compiled lsmkv segment readers under the batched
hydration seam entities/storobj/storage_object.go:211.

Falls back cleanly: `multi_get` returns None whenever the library or a
segment handle is unavailable, and callers use the Python reader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

# the repo's native/*.cpp, built with the host compiler at first use into
# the checkout's git-ignored build/native/, under a name keyed by the
# source's content (an edited source rebuilds)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "build", "native")
_SRC_PATH = os.path.join(_REPO, "native", "lsm_get.cpp")

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def so_path(src_path: str, stem: str) -> str:
    """build/native/lib<stem>_<hash of the source>.so for native/<src>."""
    with open(src_path, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, f"lib{stem}_{key}.so")


def build_host_library(src_path: str, stem: str) -> str:
    """Build src_path with the host compiler into so_path(src_path, stem)
    unless it is there; -> its path. Raises when the build fails."""
    out = so_path(src_path, stem)
    if not os.path.exists(out):
        os.makedirs(_NATIVE_DIR, exist_ok=True)
        # a private temporary file renamed into place: concurrent first
        # builds never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                 "-fPIC", "-o", tmp, src_path],
                check=True, capture_output=True)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build_host_library(_SRC_PATH, "lsmget"))
            lib.lsm_seg_open.restype = ctypes.c_void_p
            lib.lsm_seg_open.argtypes = [ctypes.c_char_p]
            lib.lsm_seg_close.restype = None
            lib.lsm_seg_close.argtypes = [ctypes.c_void_p]
            lib.lsm_multi_get.restype = ctypes.c_int64
            lib.lsm_multi_get.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8),
            ]
            _lib = lib
        except Exception:  # noqa: BLE001 — native tier is best-effort
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def _as_u8_ptr(buf):
    """bytes or uint8 ndarray -> zero-copy c_ubyte pointer."""
    if isinstance(buf, np.ndarray):
        return buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_ubyte))


_open_lock = threading.Lock()


def seg_handle(segment) -> int:
    """Native handle for a Segment (cached on the object; 0 = unusable).
    Must be called while the segment is known-open (bucket lock or
    in-flight protection held by the caller). Opening is serialized: two
    concurrent first-touches would otherwise double-open and leak one
    mmap+fd per race."""
    h = getattr(segment, "_native_handle", None)
    if h is None:
        with _open_lock:
            h = getattr(segment, "_native_handle", None)
            if h is None:
                lib = _load()
                h = 0
                if lib is not None:
                    h = lib.lsm_seg_open(segment.path.encode()) or 0
                segment._native_handle = h
    return h


def seg_close(segment) -> None:
    h = getattr(segment, "_native_handle", None)
    if h:
        lib = _load()
        if lib is not None:
            lib.lsm_seg_close(h)
    segment._native_handle = None


def multi_get_packed(
    segments_newest_first: Sequence, key_buf: bytes, key_offs: np.ndarray
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Packed-buffer batched gets: keys at key_offs[i]..key_offs[i+1] in
    key_buf (zero-length = missing upstream). -> (value arena uint8 array,
    offsets int64 [n+1], flags int8 [n]), or None => Python fallback. The
    arena layout feeds the packed reply builder and call-chaining (one
    call's values are the next call's keys) without any per-value Python
    objects. Caller owns segment lifetime."""
    lib = _load()
    if lib is None:
        return None
    handles = []
    for s in segments_newest_first:
        h = seg_handle(s)
        if not h:
            return None
        handles.append(h)
    n = len(key_offs) - 1
    key_offs = np.ascontiguousarray(key_offs, dtype=np.int64)
    out_offs = np.empty(n + 1, dtype=np.int64)
    flags = np.empty(n, dtype=np.int8)
    seg_arr = (ctypes.c_void_p * len(handles))(*handles)
    cap = max(1 << 16, n * 1024)
    key_ptr = _as_u8_ptr(key_buf)
    for _ in range(2):
        out = np.empty(cap, dtype=np.uint8)
        need = lib.lsm_multi_get(
            seg_arr, len(handles), key_ptr,
            key_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), cap,
            out_offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        if need <= cap:
            break
        cap = int(need)
    return out, out_offs, flags


def multi_get(segments_newest_first: Sequence,
              keys: Sequence[Optional[bytes]]) -> Optional[list[Optional[bytes]]]:
    """Batched point gets over a snapshot of segments (NEWEST first).
    None keys stay None. -> values list, or None => caller uses the Python
    reader. Thin wrapper over multi_get_packed: builds the packed key
    buffer, slices the value arena into per-key bytes."""
    n = len(keys)
    key_buf = b"".join(k or b"" for k in keys)
    lens = np.fromiter((0 if k is None else len(k) for k in keys),
                       dtype=np.int64, count=n)
    key_offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=key_offs[1:])
    packed = multi_get_packed(segments_newest_first, key_buf, key_offs)
    if packed is None:
        return None
    out, out_offs, flags = packed
    res: list[Optional[bytes]] = [None] * n
    offs = out_offs.tolist()
    data = bytes(out[: offs[n]])
    for i, f in enumerate(flags.tolist()):
        if f:
            res[i] = data[offs[i]:offs[i + 1]]
    return res
