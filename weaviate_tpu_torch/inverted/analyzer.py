# The port's copy of weaviate_tpu/inverted/analyzer.py, its imports pointed at the port.
"""Text analysis + sortable value encodings for the inverted index.

Reference: inverted/analyzer.go (tokenization + countable values);
tokenization modes from entities/models/property.go:88-98:
- word:       split on non-alphanumeric, lowercase
- lowercase:  split on whitespace, lowercase
- whitespace: split on whitespace, case-sensitive
- field:      trim, single token

Numeric/date/bool values are encoded as byte-sortable keys so range
operators become lexicographic key-range scans over the LSM bucket (the
reference uses the same trick with its own LexicographicallySortable*
helpers in entities/filters and inverted/).
"""

from __future__ import annotations

import re
import struct
from datetime import datetime, timezone
from typing import Any

from weaviate_tpu_torch.entities.schema import DataType, Tokenization

_WORD_SPLIT = re.compile(r"[^0-9A-Za-z]+")
_WS_SPLIT = re.compile(r"\s+")


def tokenize(tokenization: str, value: str) -> list[str]:
    if tokenization == Tokenization.WORD:
        return [t.lower() for t in _WORD_SPLIT.split(value) if t]
    if tokenization == Tokenization.LOWERCASE:
        return [t.lower() for t in _WS_SPLIT.split(value) if t]
    if tokenization == Tokenization.WHITESPACE:
        return [t for t in _WS_SPLIT.split(value) if t]
    if tokenization == Tokenization.FIELD:
        v = value.strip()
        return [v] if v else []
    raise ValueError(f"unknown tokenization {tokenization!r}")


# -- byte-sortable encodings -------------------------------------------------


def encode_int(v: int) -> bytes:
    """Sign-flipped big-endian: lexicographic order == numeric order."""
    return struct.pack(">Q", (v + (1 << 63)) & 0xFFFFFFFFFFFFFFFF)


def encode_float(v: float) -> bytes:
    """IEEE-754 total-order trick: flip all bits for negatives, sign for
    positives."""
    (bits,) = struct.unpack(">Q", struct.pack(">d", float(v)))
    if bits & (1 << 63):
        bits = ~bits & 0xFFFFFFFFFFFFFFFF
    else:
        bits |= 1 << 63
    return struct.pack(">Q", bits)


def encode_bool(v: bool) -> bytes:
    return b"\x01" if v else b"\x00"


def parse_date(v: str | datetime) -> datetime:
    if isinstance(v, datetime):
        return v if v.tzinfo else v.replace(tzinfo=timezone.utc)
    s = v.strip()
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    dt = datetime.fromisoformat(s)
    return dt if dt.tzinfo else dt.replace(tzinfo=timezone.utc)


def encode_date(v: str | datetime) -> bytes:
    dt = parse_date(v)
    nanos = int(dt.timestamp() * 1e9)
    return encode_int(nanos)


def value_tokens(data_type: DataType, tokenization: str, value: Any) -> list[bytes]:
    """All index tokens for one property value (array types flatten)."""
    base = data_type.base
    raw_values = value if data_type.is_array and isinstance(value, list) else [value]
    out: list[bytes] = []
    for v in raw_values:
        if v is None:
            continue
        if base in (DataType.TEXT, DataType.STRING):
            out.extend(t.encode("utf-8") for t in tokenize(tokenization, str(v)))
        elif base is DataType.UUID:
            out.append(str(v).lower().encode("utf-8"))
        elif base is DataType.INT:
            out.append(encode_int(int(v)))
        elif base is DataType.NUMBER:
            out.append(encode_float(float(v)))
        elif base is DataType.BOOLEAN:
            out.append(encode_bool(bool(v)))
        elif base is DataType.DATE:
            out.append(encode_date(v))
        elif base is DataType.PHONE_NUMBER:
            if isinstance(v, dict):
                for kk in ("input", "internationalFormatted", "national", "nationalFormatted"):
                    s = v.get(kk)
                    if s:
                        out.append(re.sub(r"[^0-9]", "", str(s)).encode("utf-8"))
            else:
                out.append(re.sub(r"[^0-9]", "", str(v)).encode("utf-8"))
        # geoCoordinates and blob are not inverted-indexed (geo has its own
        # index, propertyspecific/; blob is unindexable)
    return out


def filter_value_token(data_type: DataType, tokenization: str, value: Any) -> bytes:
    """Single comparison token for a filter value (Equal/range operators)."""
    base = data_type.base
    if base in (DataType.TEXT, DataType.STRING):
        toks = tokenize(tokenization, str(value))
        return toks[0].encode("utf-8") if toks else b""
    if base is DataType.UUID:
        return str(value).lower().encode("utf-8")
    if base is DataType.INT:
        return encode_int(int(value))
    if base is DataType.NUMBER:
        return encode_float(float(value))
    if base is DataType.BOOLEAN:
        return encode_bool(bool(value))
    if base is DataType.DATE:
        return encode_date(value)
    raise ValueError(f"cannot build filter token for {data_type}")


class Analyzer:
    """Object -> per-property index tokens (analyzer.go Analyze)."""

    def __init__(self, class_def):
        self.class_def = class_def

    def analyze(self, properties: dict) -> dict[str, list[bytes]]:
        """-> {prop_name: [tokens]}; missing/None props are absent (used for
        the null index)."""
        out: dict[str, list[bytes]] = {}
        for prop in self.class_def.properties:
            pt = prop.primitive_type()
            if pt is None or pt.base in (DataType.GEO_COORDINATES, DataType.BLOB):
                continue
            v = properties.get(prop.name)
            if v is None:
                continue
            out[prop.name] = value_tokens(pt, prop.tokenization, v)
        return out
