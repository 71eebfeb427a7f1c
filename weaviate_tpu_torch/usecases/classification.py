# The port's copy of weaviate_tpu/usecases/classification.py, its imports pointed at the port.
"""Classification: kNN + zero-shot + contextual, as async jobs.

Reference: usecases/classification/ — classifier_run_knn.go (kNN vote over
a training set: objects that already carry the target property), zero-shot
(assign the nearest object of the reference property's target class),
text2vec-contextionary-contextual (modules/text2vec-contextionary/
classification/classifier_run_contextual.go: per-word scoring against the
target set, TF-IDF + information-gain corpus selection, boosted-centroid
vectorization, closest target wins), run as background jobs polled via
GET /v1/classifications/{id} (classifier.go Schedule + status persistence).

TPU-first restructuring: the reference classifies source-by-source, each
doing its own vector search (and, for contextual, one vectorizer round trip
per word per item). Here the whole run is batched — all source vectors
against the training matrix in chunked numpy/BLAS matmuls, and contextual
word scoring is computed ONCE per vocabulary word per target set ([V, T]
distance matrix) instead of per item.
"""

from __future__ import annotations

import math
import re
import threading
import time
import uuid as uuidlib
from typing import Optional

import numpy as np

from weaviate_tpu_torch.entities.filters import LocalFilter

STATUS_RUNNING = "running"
STATUS_COMPLETED = "completed"
STATUS_FAILED = "failed"

TYPE_KNN = "knn"
TYPE_ZEROSHOT = "zeroshot"
TYPE_CONTEXTUAL = "text2vec-contextionary-contextual"

_MAX_TRAINING = 100_000
_CHUNK = 4096

_WORD_RE = re.compile(r"[a-zA-Z]+")


def _split_words(text: str) -> list[str]:
    """Lowercased word split (splitter.go: letters only)."""
    return [w.lower() for w in _WORD_RE.findall(text or "")]


class TfIdf:
    """Per-run TF-IDF over the source corpus (tf_idf.go): relative term
    frequency per doc x log10(N / docs-containing-term)."""

    def __init__(self, docs: list[str]):
        self.n = len(docs)
        self.doc_terms: list[dict[str, int]] = []
        contained: dict[str, int] = {}
        for d in docs:
            counts: dict[str, int] = {}
            for w in _split_words(d):
                counts[w] = counts.get(w, 0) + 1
            self.doc_terms.append(counts)
            for w in counts:
                contained[w] = contained.get(w, 0) + 1
        self.idf = {
            w: math.log10(self.n / c) if c else 0.0 for w, c in contained.items()
        }

    def top_terms(self, doc_index: int, percentile: int) -> set[str]:
        """Terms in the top `percentile`% of this doc by tf-idf
        (GetAllTerms + isInTfPercentile semantics)."""
        counts = self.doc_terms[doc_index]
        total = sum(counts.values()) or 1
        scored = sorted(
            ((c / total) * self.idf.get(w, 0.0), w) for w, c in counts.items()
        )[::-1]
        cutoff = max(1, int(len(scored) * percentile / 100))
        return {w for _, w in scored[:cutoff]}


class ClassificationError(ValueError):
    pass


class Classifier:
    def __init__(self, db, schema, modules=None):
        self.db = db
        self.schema = schema
        self.modules = modules  # vectorizer provider (contextual type)
        self._jobs: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- API (classifications REST handlers) ---------------------------------

    def schedule(self, body: dict) -> dict:
        class_name = body.get("class")
        if not class_name:
            raise ClassificationError("classification requires 'class'")
        resolved = self.schema.resolve_class_name(class_name)
        if resolved is None or self.db.get_index(resolved) is None:
            raise ClassificationError(f"class {class_name!r} not found")
        classify_props = body.get("classifyProperties") or []
        if not classify_props:
            raise ClassificationError("classifyProperties must not be empty")
        cd = self.schema.get_class(resolved)
        for p in classify_props:
            if cd.get_property(p) is None:
                raise ClassificationError(f"classifyProperty {p!r} not in schema")
        ctype = body.get("type") or TYPE_KNN
        if ctype not in (TYPE_KNN, TYPE_ZEROSHOT, TYPE_CONTEXTUAL):
            raise ClassificationError(f"unknown classification type {ctype!r}")
        settings = body.get("settings") or {}
        k = int(settings.get("k", 3))
        filters = body.get("filters") or {}
        if ctype == TYPE_CONTEXTUAL:
            based_on = body.get("basedOnProperties") or []
            if len(based_on) != 1:
                # validation.go: contextual supports exactly one basedOn prop
                raise ClassificationError(
                    "contextual classification requires exactly one "
                    "basedOnProperties entry")
            bprop = cd.get_property(based_on[0])
            if bprop is None:
                raise ClassificationError(
                    f"basedOnProperty {based_on[0]!r} not in schema")
            from weaviate_tpu_torch.entities.schema import DataType

            pt = bprop.primitive_type()
            if pt is None or pt.base not in (DataType.TEXT, DataType.STRING):
                raise ClassificationError(
                    f"basedOnProperty {based_on[0]!r} must be a text property")
            if self.modules is None:
                raise ClassificationError(
                    "contextual classification requires a vectorizer module")
            # ParamsContextual.SetDefaults (classifier_params.go:21)
            settings = {
                "minimumUsableWords": int(settings.get("minimumUsableWords", 3)),
                "informationGainCutoffPercentile": int(
                    settings.get("informationGainCutoffPercentile", 50)),
                "informationGainMaximumBoost": int(
                    settings.get("informationGainMaximumBoost", 3)),
                "tfidfCutoffPercentile": int(
                    settings.get("tfidfCutoffPercentile", 80)),
            }

        job_id = str(uuidlib.uuid4())
        job = {
            "id": job_id,
            "class": resolved,
            "classifyProperties": classify_props,
            "basedOnProperties": body.get("basedOnProperties") or [],
            "type": ctype,
            "settings": settings if ctype == TYPE_CONTEXTUAL else {"k": k},
            "status": STATUS_RUNNING,
            "meta": {"started": int(time.time() * 1000), "completed": 0,
                     "count": 0, "countSucceeded": 0, "countFailed": 0},
            "error": None,
        }
        with self._lock:
            self._jobs[job_id] = job
        t = threading.Thread(
            target=self._run, args=(job, ctype, resolved, classify_props, k, filters),
            daemon=True, name=f"classification-{job_id}",
        )
        t.start()
        return dict(job)

    def get(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(job_id)
            return dict(job) if job else None

    # -- job body ------------------------------------------------------------

    def _run(self, job, ctype, class_name, classify_props, k, filters) -> None:
        try:
            if ctype == TYPE_KNN:
                counts = self._run_knn(class_name, classify_props, k, filters, job)
            elif ctype == TYPE_CONTEXTUAL:
                counts = self._run_contextual(class_name, classify_props, filters, job)
            else:
                counts = self._run_zeroshot(class_name, classify_props, filters, job)
            with self._lock:
                job["meta"].update(
                    completed=int(time.time() * 1000),
                    count=counts[0], countSucceeded=counts[1],
                    countFailed=counts[0] - counts[1],
                )
                job["status"] = STATUS_COMPLETED
        except Exception as e:  # noqa: BLE001 — job error -> failed status
            with self._lock:
                job["status"] = STATUS_FAILED
                job["error"] = str(e)

    @staticmethod
    def _prop_value_key(val) -> Optional[str]:
        """Normalize a property value to a vote key (beacon for refs)."""
        if val is None:
            return None
        if isinstance(val, list):
            if not val:
                return None
            first = val[0]
            if isinstance(first, dict):
                return first.get("beacon")
            return str(first)
        return str(val)

    def _fetch(self, idx, flt: Optional[LocalFilter], limit: int):
        return idx.object_search(limit=limit, flt=flt, include_vector=True)

    def _run_knn(self, class_name, classify_props, k, filters, job) -> tuple[int, int]:
        """classifier_run_knn.go semantics, batched: training set = objects
        whose classify property is already set; each unclassified source gets
        the majority vote of its k nearest training objects."""
        idx = self.db.get_index(class_name)
        train_flt = LocalFilter.from_dict(filters.get("trainingSetWhere"))
        source_flt = LocalFilter.from_dict(filters.get("sourceWhere"))

        rows = self._fetch(idx, train_flt, _MAX_TRAINING)
        train_vecs, train_vals = [], []
        for r in rows:
            key = self._prop_value_key(r.obj.properties.get(classify_props[0]))
            if key is not None and r.obj.vector is not None:
                train_vecs.append(np.asarray(r.obj.vector, np.float32))
                # values per prop: vote key tuple
                train_vals.append(tuple(
                    self._prop_value_key(r.obj.properties.get(p)) for p in classify_props
                ))
        if not train_vecs:
            raise ClassificationError(
                "no training data: no objects have the classify properties set"
            )
        train = np.stack(train_vecs)  # [T, D]
        kk = min(k, train.shape[0])

        sources = [
            r.obj for r in self._fetch(idx, source_flt, _MAX_TRAINING)
            if self._prop_value_key(r.obj.properties.get(classify_props[0])) is None
            and r.obj.vector is not None
        ]
        total = succeeded = 0
        for off in range(0, len(sources), _CHUNK):
            batch = sources[off : off + _CHUNK]
            q = np.stack([np.asarray(o.vector, np.float32) for o in batch])  # [B, D]
            # [B, T] squared L2 via the matmul identity (one BLAS call)
            d = (
                (q ** 2).sum(1, keepdims=True)
                - 2.0 * q @ train.T
                + (train ** 2).sum(1)[None, :]
            )
            nn = np.argpartition(d, kk - 1, axis=1)[:, :kk]  # [B, kk]
            for bi, obj in enumerate(batch):
                total += 1
                votes: dict[tuple, int] = {}
                for ti in nn[bi]:
                    votes[train_vals[ti]] = votes.get(train_vals[ti], 0) + 1
                winner = max(votes, key=votes.get)
                try:
                    self._assign(idx, obj, classify_props, winner, job)
                    succeeded += 1
                except Exception:  # noqa: BLE001 — per-object failure counted
                    pass
        return total, succeeded

    def _collect_targets(self, cd, classify_props, flt, normalize: bool,
                         kind: str) -> dict[str, tuple[np.ndarray, list[str]]]:
        """Per classify (reference) property: every target-class object with
        a vector -> ([T, D] matrix, beacons). Shared by zeroshot and
        contextual (findTargetsForProps, classifier_prepare_contextual.go)."""
        out: dict[str, tuple[np.ndarray, list[str]]] = {}
        for p in classify_props:
            prop = cd.get_property(p)
            if prop is None or prop.primitive_type() is not None:
                raise ClassificationError(
                    f"{kind} classifyProperty {p!r} must be a reference property")
            target_class = prop.data_type[0]
            tidx = self.db.get_index(target_class)
            if tidx is None:
                raise ClassificationError(f"target class {target_class!r} not found")
            vecs, beacons = [], []
            for r in self._fetch(tidx, flt, _MAX_TRAINING):
                if r.obj.vector is not None:
                    v = np.asarray(r.obj.vector, np.float32)
                    if normalize:
                        n = np.linalg.norm(v)
                        v = v / n if n > 0 else v
                    vecs.append(v)
                    beacons.append(
                        f"weaviate://localhost/{target_class}/{r.obj.uuid}")
            if not vecs:
                raise ClassificationError(
                    f"{kind}: target class {target_class!r} has no vectors")
            out[p] = (np.stack(vecs), beacons)
        return out

    def _run_zeroshot(self, class_name, classify_props, filters, job) -> tuple[int, int]:
        """Zero-shot: each classify property must be a reference; assign the
        vector-nearest object of the property's target class."""
        idx = self.db.get_index(class_name)
        cd = self.schema.get_class(class_name)
        source_flt = LocalFilter.from_dict(filters.get("sourceWhere"))
        targets_per_prop = self._collect_targets(
            cd, classify_props, None, normalize=False, kind="zeroshot")

        sources = [
            r.obj for r in self._fetch(idx, source_flt, _MAX_TRAINING)
            if self._prop_value_key(r.obj.properties.get(classify_props[0])) is None
            and r.obj.vector is not None
        ]
        total = succeeded = 0
        for off in range(0, len(sources), _CHUNK):
            batch = sources[off : off + _CHUNK]
            q = np.stack([np.asarray(o.vector, np.float32) for o in batch])
            winners_per_prop = {}
            for p, (tv, beacons) in targets_per_prop.items():
                d = (
                    (q ** 2).sum(1, keepdims=True)
                    - 2.0 * q @ tv.T
                    + (tv ** 2).sum(1)[None, :]
                )
                winners_per_prop[p] = [beacons[i] for i in np.argmin(d, axis=1)]
            for bi, obj in enumerate(batch):
                total += 1
                try:
                    props = {
                        p: [{"beacon": winners_per_prop[p][bi]}]
                        for p in classify_props
                    }
                    idx.merge_object(obj.uuid, props,
                                     meta=self._class_meta(job, sorted(props)))
                    succeeded += 1
                except Exception:  # noqa: BLE001
                    pass
        return total, succeeded

    def _run_contextual(self, class_name, classify_props, filters, job) -> tuple[int, int]:
        """text2vec-contextionary-contextual (classifier_run_contextual.go):
        no training data — each source's basedOn text is reduced to its most
        discriminative words (TF-IDF within the corpus x information gain
        against the target set), the surviving words form a boosted centroid,
        and the cosine-closest target object wins.

        Batched: one vectorizer call for the whole run's vocabulary and one
        [V, T] distance matrix per classify property (the reference pays a
        vectorizer round trip per word per item)."""
        idx = self.db.get_index(class_name)
        cd = self.schema.get_class(class_name)
        s = job["settings"]
        based_on = job["basedOnProperties"][0]
        source_flt = LocalFilter.from_dict(filters.get("sourceWhere"))
        target_flt = LocalFilter.from_dict(filters.get("targetWhere"))
        targets_per_prop = self._collect_targets(
            cd, classify_props, target_flt, normalize=True, kind="contextual")

        sources = [
            r.obj for r in self._fetch(idx, source_flt, _MAX_TRAINING)
            if self._prop_value_key(r.obj.properties.get(classify_props[0])) is None
        ]
        docs = [str(o.properties.get(based_on) or "") for o in sources]
        tfidf = TfIdf(docs)

        # run-wide vocabulary -> one vectorizer pass per TARGET class (word
        # vectors must live in the target vectors' space; the source class
        # may have no vectorizer at all) + one unit-row matrix each
        vocab = sorted({w for d in docs for w in _split_words(d)})
        if not vocab:
            return len(sources), 0
        vocab_pos = {w: i for i, w in enumerate(vocab)}
        wv_by_class: dict[str, np.ndarray] = {}
        wv_per_prop: dict[str, np.ndarray] = {}
        for p in classify_props:
            target_class = cd.get_property(p).data_type[0]
            if target_class not in wv_by_class:
                tcd = self.schema.get_class(target_class)
                blocks = [
                    np.asarray(self.modules.vectorize_texts(
                        tcd, vocab[off : off + _CHUNK]), np.float32)
                    for off in range(0, len(vocab), _CHUNK)
                ]
                wv = np.concatenate(blocks) if len(blocks) > 1 else blocks[0]
                norms = np.linalg.norm(wv, axis=1, keepdims=True)
                norms[norms == 0] = 1.0
                wv_by_class[target_class] = wv / norms
            wv_per_prop[p] = wv_by_class[target_class]

        # per prop: [V, T] cosine distances -> per-word information gain
        # (avg - min, scoreWord in classifier_run_contextual.go)
        word_ig: dict[str, np.ndarray] = {}
        for p, (tv, _) in targets_per_prop.items():
            d = 1.0 - wv_per_prop[p] @ tv.T  # [V, T]
            word_ig[p] = d.mean(axis=1) - d.min(axis=1)

        ig_pctile = s["informationGainCutoffPercentile"]
        tf_pctile = s["tfidfCutoffPercentile"]
        max_boost = float(s["informationGainMaximumBoost"])
        min_words = s["minimumUsableWords"]
        total = succeeded = 0
        for si, obj in enumerate(sources):
            total += 1
            words = _split_words(docs[si])
            uniq = list(dict.fromkeys(words))
            if not uniq:
                continue
            try:
                props = {}
                for p, (tv, beacons) in targets_per_prop.items():
                    ig = word_ig[p]
                    # rank the item's words by information gain (desc)
                    ranked = sorted(
                        uniq, key=lambda w: -float(ig[vocab_pos[w]]))
                    ig_cut = max(1, int(len(ranked) * ig_pctile / 100))
                    ig_top = set(ranked[:ig_cut])
                    tf_top = tfidf.top_terms(si, tf_pctile)
                    corpus = [w for w in words if w in ig_top and w in tf_top]
                    if len(set(corpus)) < min_words:
                        # getTopNWords parity: caps at the words that exist,
                        # so a 1-word source still classifies from that word
                        corpus = ranked[:min_words]
                    # boost by IG rank (buildBoostedCorpus: 1 - log(i/cutoff),
                    # capped), then weighted centroid of the corpus words
                    boosts = {}
                    for i, w in enumerate(ranked[:ig_cut]):
                        b = 1.0 - math.log(i / ig_cut) if i > 0 else max_boost
                        boosts[w] = min(b, max_boost)
                    weights = np.asarray(
                        [boosts.get(w, 1.0) for w in corpus], np.float32)
                    pwv = wv_per_prop[p]
                    cv = (weights[:, None] * pwv[[vocab_pos[w] for w in corpus]]
                          ).sum(0) / weights.sum()
                    n = np.linalg.norm(cv)
                    cv = cv / n if n > 0 else cv
                    dists = 1.0 - tv @ cv
                    win = int(np.argmin(dists))
                    props[p] = [{"beacon": beacons[win]}]
                idx.merge_object(obj.uuid, props,
                                 meta=self._class_meta(job, sorted(props)))
                succeeded += 1
            except Exception:  # noqa: BLE001 — per-object failure counted
                pass
        return total, succeeded

    @staticmethod
    def _class_meta(job, fields: list[str]) -> dict:
        """The _additional.classification payload stamped on each classified
        object (entities/additional/classification.go shape; completed is an
        RFC3339 timestamp like the reference's strfmt.DateTime)."""
        from datetime import datetime, timezone

        return {"classification": {
            "id": job["id"],
            "scope": job["classifyProperties"],
            "classifiedFields": fields,
            "basedOn": job["basedOnProperties"] or None,
            "completed": datetime.now(timezone.utc).isoformat(
                timespec="milliseconds").replace("+00:00", "Z"),
        }}

    def _assign(self, idx, obj, classify_props, winner: tuple, job) -> None:
        cd = self.schema.get_class(idx.class_name)
        props = {}
        for p, val in zip(classify_props, winner):
            if val is None:
                continue
            prop = cd.get_property(p)
            if prop is not None and prop.primitive_type() is None:
                props[p] = [{"beacon": val}]
            else:
                props[p] = val
        if props:
            idx.merge_object(obj.uuid, props,
                             meta=self._class_meta(job, sorted(props)))
