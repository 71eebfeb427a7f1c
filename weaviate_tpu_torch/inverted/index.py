# The port's copy of weaviate_tpu/inverted/index.py, its imports pointed at the port.
"""Per-property inverted buckets + write path.

Reference bucket layout (shard_write_inverted*.go, inverted/):
- filterable  -> RoaringSet bucket  property_<name>_filterable: token -> docID bitmap
- searchable  -> Map bucket         property_<name>_searchable: token -> {docID: tf}
- null        -> RoaringSet bucket  property_<name>__null: {0x00/0x01 -> docIDs}
- lengths     -> Map bucket         property_<name>__length (BM25 prop-length
                 tracker, proplengthtracker role)
- __all_docs  -> RoaringSet         live docID universe (for Not/complement)
"""

from __future__ import annotations

import os
import struct
from collections import Counter as PyCounter

from weaviate_tpu_torch.entities.schema import ClassDef, DataType
from weaviate_tpu_torch.inverted.analyzer import Analyzer
from weaviate_tpu_torch.storage.bitmap import Bitmap
from weaviate_tpu_torch.storage.lsm import (
    STRATEGY_MAP,
    STRATEGY_ROARINGSET,
    Store,
)

ALL_DOCS_KEY = b"__all__"
NULL_TRUE = b"\x01"
NULL_FALSE = b"\x00"


def filterable_bucket(prop: str) -> str:
    return f"property_{prop}_filterable"


def searchable_bucket(prop: str) -> str:
    return f"property_{prop}_searchable"


def null_bucket(prop: str) -> str:
    return f"property_{prop}__null"


def length_bucket(prop: str) -> str:
    return f"property_{prop}__length"


# Persisted marker for the searchable/length subkey byte order. Round 5
# switched new stores to big-endian doc-id subkeys (segment byte-lex order
# == numeric order -> the postings fast path skips its argsort); stores
# written before the marker existed keep little-endian and are pinned to it
# on first reopen, so old segments never get decoded with the wrong order
# or mixed with new-format writes.
SUBKEY_MARKER = ".searchable_subkeys"


class InvertedIndex:
    def __init__(self, store: Store, class_def: ClassDef):
        self.store = store
        self.class_def = class_def
        self.analyzer = Analyzer(class_def)
        self._all = store.create_or_load_bucket("_all_docs", STRATEGY_ROARINGSET)
        self._ensure_buckets()
        self.subkey_fmt = self._init_subkey_format()
        self.subkey_dtype = ">u8" if self.subkey_fmt == ">Q" else "<u8"

    def _init_subkey_format(self) -> str:
        """-> ">Q" (new stores) or "<Q" (legacy data without a marker)."""
        path = os.path.join(self.store.root, SUBKEY_MARKER)
        try:
            with open(path) as f:
                return ">Q" if f.read().strip() == "be" else "<Q"
        except FileNotFoundError:
            pass
        has_data = False
        for prop in self.class_def.properties:
            for bn in (searchable_bucket(prop.name), length_bucket(prop.name)):
                b = self.store.bucket(bn)
                if b is not None and (b.segment_count() or len(b._mem)):
                    has_data = True
                    break
            if has_data:
                break
        fmt = "<Q" if has_data else ">Q"
        # crash-atomic + durable: the marker decides how every fsynced
        # subkey byte on disk is decoded, so it must never be weaker than
        # the data it describes (temp file -> fsync -> rename -> dir fsync)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("le" if fmt == "<Q" else "be")
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
        dfd = os.open(self.store.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        return fmt

    def _ensure_buckets(self) -> None:
        for prop in self.class_def.properties:
            pt = prop.primitive_type()
            if pt is None or pt.base in (DataType.GEO_COORDINATES, DataType.BLOB):
                continue
            if prop.index_filterable:
                self.store.create_or_load_bucket(filterable_bucket(prop.name), STRATEGY_ROARINGSET)
                self.store.create_or_load_bucket(null_bucket(prop.name), STRATEGY_ROARINGSET)
            if prop.index_searchable and pt.base in (DataType.TEXT, DataType.STRING):
                self.store.create_or_load_bucket(searchable_bucket(prop.name), STRATEGY_MAP)
                self.store.create_or_load_bucket(length_bucket(prop.name), STRATEGY_MAP)

    def update_schema(self, class_def: ClassDef) -> None:
        """Pick up added properties (migrator AddProperty path)."""
        self.class_def = class_def
        self.analyzer = Analyzer(class_def)
        self._ensure_buckets()

    # -- write path ----------------------------------------------------------

    def add_object(self, doc_id: int, properties: dict) -> None:
        # single-object form of the batch writer — ONE posting code path
        errs = self.add_objects_batch([(doc_id, properties)])
        if doc_id in errs:
            raise errs[doc_id]

    def add_objects_batch(self, items) -> dict[int, Exception]:
        """Batch twin of add_object (shard_write_batch_objects.go analog):
        postings are grouped per term across the WHOLE batch, so each unique
        token costs one WAL record + one memtable update instead of one per
        containing object. items = [(doc_id, properties)];
        -> {doc_id: error} for objects whose analysis failed (they get no
        postings; callers keep per-object batch error isolation)."""
        analyzed: list[tuple[int, dict]] = []
        errs: dict[int, Exception] = {}
        for doc_id, props in items:
            try:
                analyzed.append((doc_id, self.analyzer.analyze(props)))
            except Exception as e:  # noqa: BLE001 — per-object isolation
                errs[doc_id] = e
        if not analyzed:
            return errs
        self._all.roaring_add_many(ALL_DOCS_KEY, [d for d, _ in analyzed])
        for prop in self.class_def.properties:
            pt = prop.primitive_type()
            if pt is None or pt.base in (DataType.GEO_COORDINATES, DataType.BLOB):
                continue
            name = prop.name
            if prop.index_filterable:
                nulls_t: list[int] = []
                nulls_f: list[int] = []
                by_tok: dict[bytes, list[int]] = {}
                for doc_id, tokens in analyzed:
                    toks = tokens.get(name)
                    (nulls_t if toks is None else nulls_f).append(doc_id)
                    if toks:
                        for t in set(toks):
                            by_tok.setdefault(t, []).append(doc_id)
                null_recs = []
                if nulls_t:
                    null_recs.append((NULL_TRUE, nulls_t))
                if nulls_f:
                    null_recs.append((NULL_FALSE, nulls_f))
                if null_recs:
                    self.store.bucket(null_bucket(name)).roaring_add_many_keys(null_recs)
                if by_tok:
                    self.store.bucket(filterable_bucket(name)).roaring_add_many_keys(
                        by_tok.items())
            if prop.index_searchable and pt.base in (DataType.TEXT, DataType.STRING):
                sput: list[tuple[bytes, bytes, bytes]] = []
                lput: list[tuple[bytes, bytes, bytes]] = []
                for doc_id, tokens in analyzed:
                    toks = tokens.get(name)
                    if not toks:
                        continue
                    # subkey byte order per the store's persisted marker
                    # (big-endian on new stores: segment byte-lex order ==
                    # numeric order, so the BM25 postings fast path decodes
                    # pre-sorted arrays — see lsm.map_get_arrays key_dtype)
                    did = struct.pack(self.subkey_fmt, doc_id)
                    for t, tf in PyCounter(toks).items():
                        sput.append((t, did, struct.pack("<f", float(tf))))
                    lput.append((b"len", did, struct.pack("<I", len(toks))))
                if sput:
                    self.store.bucket(searchable_bucket(name)).map_put_many(sput)
                if lput:
                    self.store.bucket(length_bucket(name)).map_put_many(lput)
        return errs

    def _filterable_indexed_docs(self, prop_name: str):
        """Bitmap of docs whose filterable postings exist for the prop: the
        null bucket gets exactly one entry (TRUE or FALSE) per doc when
        filterable indexing is active, so its union is the indexed set."""
        nb = self.store.bucket(null_bucket(prop_name))
        if nb is None:
            from weaviate_tpu_torch.storage.bitmap import Bitmap

            return Bitmap()
        return nb.roaring_get(NULL_TRUE).or_(nb.roaring_get(NULL_FALSE))

    def unindexed_filterable(self, doc_count: int) -> dict[str, object]:
        """{prop: bitmap of docs MISSING filterable postings} — incremental
        detection for the startup reindexer
        (inverted_reindexer_missing_text_filterable.go): a prop written both
        before and after its indexFilterable flip reports exactly the
        pre-flip docs, not all-or-nothing."""
        if doc_count == 0:
            return {}
        all_docs = self._all.roaring_get(ALL_DOCS_KEY)
        out: dict[str, object] = {}
        for prop in self.class_def.properties:
            pt = prop.primitive_type()
            if pt is None or pt.base in (DataType.GEO_COORDINATES, DataType.BLOB):
                continue
            if not prop.index_filterable:
                continue
            missing = all_docs.and_not(self._filterable_indexed_docs(prop.name))
            if len(missing):
                out[prop.name] = missing
        return out

    def backfill_filterable(self, missing: dict[str, object], rows) -> dict[str, int]:
        """Index the filterable + null postings for each prop's MISSING docs
        (missing = unindexed_filterable() result; rows = (doc_id, properties)
        over the union of missing docs — one hydration pass covers every
        prop, and already-indexed docs are left untouched).
        -> {prop: docs indexed}."""
        targets = [
            (name,
             self.store.bucket(filterable_bucket(name)),
             self.store.bucket(null_bucket(name)),
             bm)
            for name, bm in missing.items()
        ]
        counts = {name: 0 for name, _, _, _ in targets}
        for doc_id, properties in rows:
            toks_by_prop = self.analyzer.analyze(
                {name: properties.get(name) for name, _, _, _ in targets})
            for name, fb, nb, bm in targets:
                if not bm.contains(doc_id):
                    continue
                toks = toks_by_prop.get(name)
                nb.roaring_add_many(NULL_TRUE if toks is None else NULL_FALSE, [doc_id])
                if toks:
                    for t in set(toks):
                        fb.roaring_add_many(t, [doc_id])
                counts[name] += 1
        return counts

    def delete_object(self, doc_id: int, properties: dict) -> None:
        tokens_by_prop = self.analyzer.analyze(properties)
        self._all.roaring_remove_many(ALL_DOCS_KEY, [doc_id])
        did = struct.pack(self.subkey_fmt, doc_id)  # matches add_object
        for prop in self.class_def.properties:
            pt = prop.primitive_type()
            if pt is None or pt.base in (DataType.GEO_COORDINATES, DataType.BLOB):
                continue
            toks = tokens_by_prop.get(prop.name)
            if prop.index_filterable:
                nb = self.store.bucket(null_bucket(prop.name))
                nb.roaring_remove_many(NULL_TRUE if toks is None else NULL_FALSE, [doc_id])
                if toks:
                    fb = self.store.bucket(filterable_bucket(prop.name))
                    for t in set(toks):
                        fb.roaring_remove_many(t, [doc_id])
            if (
                prop.index_searchable
                and pt.base in (DataType.TEXT, DataType.STRING)
                and toks
            ):
                sb = self.store.bucket(searchable_bucket(prop.name))
                for t in set(toks):
                    sb.map_delete(t, did)
                lb = self.store.bucket(length_bucket(prop.name))
                lb.map_delete(b"len", did)

    def update_object(self, doc_id_old: int, props_old: dict, doc_id_new: int, props_new: dict) -> None:
        self.delete_object(doc_id_old, props_old)
        self.add_object(doc_id_new, props_new)

    # -- read helpers --------------------------------------------------------

    def all_doc_ids(self) -> Bitmap:
        return self._all.roaring_get(ALL_DOCS_KEY)

    def doc_count(self) -> int:
        return len(self.all_doc_ids())
