"""Inverted index: analyzer, per-property buckets, filters -> AllowList, BM25.

Reference: adapters/repos/db/inverted/ — Searcher.DocIDs (searcher.go:157),
docBitmap merges (searcher_doc_bitmap.go:25-109), BM25F
(bm25_searcher.go:77), analyzer.go, prop-length tracker.
"""

from weaviate_tpu_torch.inverted.analyzer import Analyzer, tokenize
from weaviate_tpu_torch.inverted.index import InvertedIndex
from weaviate_tpu_torch.inverted.searcher import FilterSearcher
from weaviate_tpu_torch.inverted.bm25 import BM25Searcher

__all__ = ["Analyzer", "tokenize", "InvertedIndex", "FilterSearcher", "BM25Searcher"]
