"""Property-based equivalence of the port's native LSM point-get plane
(weaviate_tpu_torch/csrc/lsm_get.cpp via storage/lsm_native.py: one hash
probe a segment, an arena sized before the copy) against the port's
pure-Python segment reader, under random operation sequences — puts,
overwrites, deletes, flush points, pair/full compactions. The packed path
is held to the same answers, and to the JAX package's plane over the same
segment files, byte for byte. The native reader serves the raw lane's
hydration with the GIL released; any divergence from the Python reader is
silent data corruption, so the property IS the contract."""

import shutil
import tempfile

import numpy as np
import pytest

pytest.importorskip("hypothesis", reason="optional dep not in this image")
from hypothesis import given, settings
from hypothesis import strategies as st

from weaviate_tpu.storage import lsm as jax_lsm
from weaviate_tpu.storage import lsm_native as jax_native
from weaviate_tpu_torch.storage import lsm_native
from weaviate_tpu_torch.storage.lsm import _TOMBSTONE, STRATEGY_REPLACE, Bucket

pytestmark = pytest.mark.skipif(
    not (lsm_native.available() and jax_native.available()),
    reason="a native lsm plane is unavailable")

_KEYS = st.integers(min_value=0, max_value=40)


def _key(i: int) -> bytes:
    # mixed-length keys, some the prefix of others
    return (b"k" * (1 + i % 3)) + str(i).encode()


# any value EXCEPT the reserved tombstone marker, which put() refuses
_values = st.binary(min_size=0, max_size=64).filter(lambda v: v != _TOMBSTONE)

_ops = st.lists(
    st.one_of(
        st.tuples(st.just("put"), _KEYS, _values),
        st.tuples(st.just("del"), _KEYS, st.just(b"")),
        st.tuples(st.just("flush"), st.just(0), st.just(b"")),
        st.tuples(st.just("compact_pair"), st.just(0), st.just(b"")),
        st.tuples(st.just("compact"), st.just(0), st.just(b"")),
    ),
    min_size=1, max_size=60,
)


@settings(max_examples=120, deadline=None)
@given(ops=_ops)
def test_native_multi_get_equals_python_reader(ops):
    d = tempfile.mkdtemp(prefix="proplsm")
    b = Bucket(d + "/b", STRATEGY_REPLACE)
    try:
        model: dict[bytes, bytes] = {}
        for op, i, v in ops:
            if op == "put":
                b.put(_key(i), v)
                model[_key(i)] = v
            elif op == "del":
                b.delete(_key(i))
                model.pop(_key(i), None)
            elif op == "flush":
                b.flush_memtable()
            elif op == "compact_pair":
                b.compact_pair()
            else:
                b.compact()
        # one final flush so the native plane (segments-only) can see
        # everything on the packed path too
        b.flush_memtable()
        probe = [_key(i) for i in range(45)] + [None, b"", b"missing"]
        got_native = b.multi_get(probe)
        # force the Python reader on the same bucket state
        orig = lsm_native._lib, lsm_native._lib_failed
        lsm_native._lib, lsm_native._lib_failed = None, True
        try:
            got_py = b.multi_get(probe)
        finally:
            lsm_native._lib, lsm_native._lib_failed = orig
        assert got_native == got_py
        # and both agree with the reference model
        for k, v_n in zip(probe, got_native):
            if k is None or k == b"" or k == b"missing":
                assert v_n is None
            else:
                assert v_n == model.get(k), k

        # the packed path over the same state: the same values, flags set
        # exactly where a value came back, one arena fill when any did
        keys = [k or b"" for k in probe]
        key_buf = b"".join(keys)
        key_offs = np.zeros(len(keys) + 1, dtype=np.int64)
        np.cumsum([len(k) for k in keys], out=key_offs[1:])
        stats = lsm_native.new_stats()
        packed = b.multi_get_packed(key_buf, key_offs, stats=stats)
        if not b._segments:
            assert packed is None
            return
        arena, offs, flags = packed
        assert arena.size == offs[-1]
        assert [bytes(arena[offs[j]:offs[j + 1]]) if flags[j] else None
                for j in range(len(keys))] == got_native
        assert stats[2:].tolist() == [int(any(got_native)), 1]
        # the JAX package's plane over the same segment files
        segs = [jax_lsm.Segment(s.path) for s in reversed(b._segments)]
        try:
            r_arena, r_offs, r_flags = jax_native.multi_get_packed(segs, key_buf, key_offs)
        finally:
            for s in segs:
                s.close()
        assert np.array_equal(offs, r_offs) and np.array_equal(flags, r_flags)
        assert arena.tobytes() == r_arena[: r_offs[-1]].tobytes()
    finally:
        b.shutdown()
        shutil.rmtree(d, ignore_errors=True)
