# The port's copy of weaviate_tpu/server/reply_native.py, its imports pointed at the port.
"""ctypes bridge to the native gRPC reply marshaller (native/reply.cpp).

Serializes a SearchReply's wire bytes straight from stored object images —
the per-result Python marshalling cost (~25us each: storobj decode, uuid
formatting, upb message construction) collapses to one C call per reply.
Reference analog: adapters/handlers/grpc/server.go marshals results in
compiled Go; this is the same tier for the Python runtime.

Falls back cleanly: `build_search_reply` returns None whenever the library
is unavailable or an image is rejected, and callers use the upb path.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence

from weaviate_tpu_torch.storage import lsm_native

# the repo's native/reply.cpp, built as storage/lsm_native.py builds its
# source: into the checkout's git-ignored build/native/ at first use
_SRC_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "reply.cpp")

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()

_NAN = float("nan")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(lsm_native.build_host_library(_SRC_PATH, "reply"))
            lib.build_search_reply.restype = ctypes.c_int64
            lib.build_search_reply.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_int64,
            ]
            lib.build_batch_reply.restype = ctypes.c_int64
            lib.build_batch_reply.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_int64,
            ]
            lib.build_batch_reply_packed.restype = ctypes.c_int64
            lib.build_batch_reply_packed.argtypes = [
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_ubyte),
                ctypes.c_int64,
            ]
            _lib = lib
        except Exception:  # noqa: BLE001 — native tier is best-effort
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def _marshal_inputs(raws, dists, certs, extra_cap: int):
    """Shared ctypes marshalling for both builders: pointer/length arrays,
    NaN substitution for absent distance/certainty, output buffer sized so
    the native side can never overrun (props are a subset of each image)."""
    n = len(raws)
    raw_arr = (ctypes.c_char_p * n)(*raws)
    len_arr = (ctypes.c_int64 * n)(*[len(r) for r in raws])
    d_arr = (ctypes.c_double * n)(*[
        _NAN if d is None else float(d) for d in dists])
    c_arr = (ctypes.c_double * n)(*[
        _NAN if c is None else float(c) for c in certs])
    cap = sum(len(r) for r in raws) + n * 128 + extra_cap + 16
    out = (ctypes.c_ubyte * cap)()
    return n, raw_arr, len_arr, d_arr, c_arr, out, cap


def build_search_reply(
    raws: Sequence[bytes],
    dists: Sequence[Optional[float]],
    certs: Sequence[Optional[float]],
    took_seconds: float,
) -> Optional[bytes]:
    """-> serialized SearchReply bytes, or None to use the upb marshaller."""
    lib = _load()
    if lib is None:
        return None
    n, raw_arr, len_arr, d_arr, c_arr, out, cap = _marshal_inputs(
        raws, dists, certs, 0)
    wrote = lib.build_search_reply(raw_arr, len_arr, d_arr, c_arr, n,
                                   float(took_seconds), out, cap)
    if wrote < 0:
        return None
    return ctypes.string_at(out, wrote)


def build_batch_reply(
    raws: Sequence[bytes],
    dists: Sequence[Optional[float]],
    certs: Sequence[Optional[float]],
    counts: Sequence[int],
    took_seconds: float,
) -> Optional[bytes]:
    """-> serialized BatchSearchReply bytes for len(counts) replies whose
    results are flat runs in raws/dists/certs, or None for the upb path."""
    lib = _load()
    if lib is None:
        return None
    n, raw_arr, len_arr, d_arr, c_arr, out, cap = _marshal_inputs(
        raws, dists, certs, len(counts) * 16)
    cnt_arr = (ctypes.c_int64 * len(counts))(*counts)
    wrote = lib.build_batch_reply(raw_arr, len_arr, d_arr, c_arr, cnt_arr,
                                  len(counts), float(took_seconds), out, cap)
    if wrote < 0:
        return None
    return ctypes.string_at(out, wrote)


def build_batch_reply_packed(val_buf, val_offs, flags, flat_dists, counts,
                             took_seconds: float) -> Optional[bytes]:
    """Raw-lane twin of build_batch_reply: object images live in ONE arena
    (numpy uint8) at val_offs[i]..val_offs[i+1] — the layout the native LSM
    point-get plane emits — so no per-result Python objects exist anywhere
    on the path. flags[i]==0 drops that (deleted) hit from its reply."""
    import numpy as np

    lib = _load()
    if lib is None:
        return None
    n = len(flags)
    offs = np.ascontiguousarray(val_offs, dtype=np.int64)
    fl = np.ascontiguousarray(flags, dtype=np.int8)
    ds = np.ascontiguousarray(flat_dists, dtype=np.float32)
    cnts = np.ascontiguousarray(counts, dtype=np.int64)
    cap = int(offs[n]) + n * 128 + len(cnts) * 16 + 16
    out = (ctypes.c_ubyte * cap)()
    wrote = lib.build_batch_reply_packed(
        val_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        fl.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        ds.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(cnts), float(took_seconds), out, cap)
    if wrote < 0:
        return None
    return ctypes.string_at(out, wrote)


def varint(v: int) -> bytes:
    """Protobuf varint (outer BatchSearchReply framing)."""
    b = bytearray()
    while v >= 0x80:
        b.append((v & 0x7F) | 0x80)
        v >>= 7
    b.append(v)
    return bytes(b)
