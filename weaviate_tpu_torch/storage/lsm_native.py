# The port's copy of weaviate_tpu/storage/lsm_native.py, its imports pointed at the port.
"""ctypes bridge to the port's native LSM point-get plane (csrc/lsm_get.cpp).

Batched replace-strategy point lookups over the mmap'd segment files in ONE
C call: the GIL is released for its duration (ctypes semantics), so
concurrent request hydrations overlap instead of serializing. The call
resolves every key once, by one hash probe a segment, sums the found
values' bytes and copies them into an arena of exactly that size, which it
allocates and this module frees with the arena's last view.

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
import weakref
from typing import Optional, Sequence

import numpy as np

# host C++ sources, built with the host compiler at first use into the
# checkout's git-ignored build/native/, under a name keyed by the source's
# content (an edited source rebuilds)
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "build", "native")
_SRC_PATH = os.path.join(_REPO, "weaviate_tpu_torch", "csrc", "lsm_get.cpp")

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def so_path(src_path: str, stem: str, flags: Sequence[str] = ()) -> str:
    """build/native/lib<stem>_<hash>.so for native/<src>, the hash over the
    source and the extra compiler flags (a library built with other flags,
    say without -fopenmp, is never reused)."""
    h = hashlib.sha256()
    with open(src_path, "rb") as f:
        h.update(f.read())
    for flag in flags:
        h.update(b"\0" + flag.encode())
    return os.path.join(_NATIVE_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def build_host_library(src_path: str, stem: str, flags: Sequence[str] = ()) -> str:
    """Build src_path with the host compiler, plus the extra `flags`, into
    so_path(src_path, stem, flags) unless it is there; -> its path. Raises
    when the build fails."""
    out = so_path(src_path, stem, flags)
    if not os.path.exists(out):
        os.makedirs(_NATIVE_DIR, exist_ok=True)
        # a private temporary file renamed into place: concurrent first
        # builds never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
        os.close(fd)
        try:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", *flags,
                 "-shared", "-fPIC", "-o", tmp, src_path],
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
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            lib.lsm_arena_free.restype = None
            lib.lsm_arena_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:  # noqa: BLE001 — native tier is best-effort
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


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


def new_stats() -> np.ndarray:
    """A counter array for `multi_get_packed(..., stats=)`, which adds to
    it what each call did: [segments searched over all keys, hash slots
    touched, arenas filled, calls]."""
    return np.zeros(4, dtype=np.int64)


def trace_facts(stats: np.ndarray) -> dict:
    """The trace facts of the calls counted in `stats`:
    `lsm_probes_per_key`, the slots touched per key per segment searched,
    and `lsm_arena_passes`, the arenas filled per call (1 when each call
    found a value and copied once); {} when no call ran."""
    searched, probes, fills, calls = (int(v) for v in stats)
    if not calls:
        return {}
    return {"lsm_probes_per_key": round(probes / max(searched, 1), 4),
            "lsm_arena_passes": round(fills / calls, 4)}


def _adopt(lib, addr: int, size: int) -> np.ndarray:
    """A uint8 array over the `size` bytes the plane allocated at `addr`,
    freed when the array's last view is."""
    if not size:
        return np.empty(0, dtype=np.uint8)
    buf = (ctypes.c_ubyte * size).from_address(addr)
    # not at exit: serving threads may still read views then
    weakref.finalize(buf, lib.lsm_arena_free, addr).atexit = False
    return np.frombuffer(buf, dtype=np.uint8)


def _handles(segments) -> Optional[list[int]]:
    handles = []
    for s in segments:
        h = seg_handle(s)
        if not h:
            return None
        handles.append(h)
    return handles


def multi_get_packed(
    segments_newest_first: Sequence, key_buf: bytes, key_offs: np.ndarray,
    then: Sequence = (), stats: Optional[np.ndarray] = None,
) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Packed-buffer batched gets: keys at key_offs[i]..key_offs[i+1] in
    key_buf (zero-length = missing upstream). -> (value arena uint8 array,
    offsets int64 [n+1], flags int8 [n]), or None => Python fallback. With
    `then`, a second segment list (newest first), each found value is
    looked up there as a key in the same call, and what that finds is the
    key's value (a doc id's uuid, then the uuid's object image). The arena
    holds exactly the found values and feeds the packed reply builder
    without any per-value Python objects. `stats` (`new_stats()`) gains
    the call's counts. Caller owns segment lifetime."""
    lib = _load()
    if lib is None:
        return None
    handles, handles2 = _handles(segments_newest_first), _handles(then)
    if handles is None or handles2 is None:
        return None
    n = len(key_offs) - 1
    key_offs = np.ascontiguousarray(key_offs, dtype=np.int64)
    key_bytes = key_buf.nbytes if isinstance(key_buf, np.ndarray) else len(key_buf)
    if n < 0 or key_offs[0] < 0 or key_offs[-1] > key_bytes or (np.diff(key_offs) < 0).any():
        raise ValueError("key offsets must rise within the key buffer")
    out_offs = np.empty(n + 1, dtype=np.int64)
    flags = np.empty(n, dtype=np.int8)
    if stats is None:
        stats = new_stats()
    assert stats.dtype == np.int64 and stats.shape == (4,) and stats.flags.c_contiguous
    arena = ctypes.c_void_p()
    key_ptr = key_buf.ctypes.data if isinstance(key_buf, np.ndarray) else key_buf
    need = lib.lsm_multi_get(
        (ctypes.c_void_p * len(handles))(*handles), len(handles),
        (ctypes.c_void_p * len(handles2))(*handles2), len(handles2),
        key_ptr, key_offs.ctypes.data, n, ctypes.byref(arena),
        out_offs.ctypes.data, flags.ctypes.data, stats.ctypes.data)
    if need < 0:
        raise MemoryError(f"native point-get arena of {int(out_offs[n])} bytes")
    return _adopt(lib, arena.value, need), out_offs, flags


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
