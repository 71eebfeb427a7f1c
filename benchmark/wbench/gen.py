"""Seeded inputs: the rows a configuration holds, the queries its traffic
sends and the objects an import sends, all made from `--seed`.

The generator is chip_smoke.py's (`make_data`, `queries`): a mixture of
gaussian clusters, with queries drawn near stored rows. Every seed makes
the same sizes; the seed changes only which numbers fill them.
"""

from __future__ import annotations

import uuid

import numpy as np

# the decimal text the clients send holds this many digits after the point
DECIMALS = 7
_SCALE = 10 ** DECIMALS


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """One independent stream of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def centers(data: dict, seed: int) -> np.ndarray:
    """The configuration's cluster centres for this seed."""
    rng = rng_for(seed, 1)
    return rng.standard_normal((data["clusters"], data["dim"]), dtype=np.float32) \
        * np.float32(data["center_scale"])


def _normalized(x: np.ndarray) -> np.ndarray:
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x


def dataset(data: dict, seed: int, n: int, n_queries: int = 0):
    """-> (rows [n, dim] f32, queries [n_queries, dim] f32). Rows are
    cluster centres plus gaussian spread; each query is a random stored
    row's pre-normalisation value plus `query_noise`. Both are unit rows
    when the configuration normalises."""
    c = centers(data, seed)
    rng = rng_for(seed, 2)
    x = c[rng.integers(0, len(c), n)]
    x += np.float32(data["spread"]) * rng.standard_normal(x.shape, dtype=np.float32)
    q = np.empty((0, data["dim"]), np.float32)
    if n_queries:
        rq = rng_for(seed, 3)
        q = x[rq.integers(0, n, n_queries)]
        q += np.float32(data["query_noise"]) * rq.standard_normal(q.shape, dtype=np.float32)
    if data["normalize"]:
        _normalized(x)
        if n_queries:
            _normalized(q)
    return x, q


def import_batch(data: dict, seed: int, batch: int, size: int, c=None) -> np.ndarray:
    """The vectors of import batch `batch` ([size, dim] f32, before the
    decimal text): rows drawn like `dataset`'s from a stream of their own;
    `c`, the seed's centres, saves drawing them again."""
    c = centers(data, seed) if c is None else c
    rng = rng_for(seed, 4, batch)
    x = c[rng.integers(0, len(c), size)]
    x += np.float32(data["spread"]) * rng.standard_normal(x.shape, dtype=np.float32)
    return _normalized(x) if data["normalize"] else x


def object_uuid(i: int) -> str:
    """Object i's id (the benchmark's own): the uuid whose integer is i + 1."""
    return str(uuid.UUID(int=i + 1))


def uuid_index(text: str) -> int:
    """object_uuid's inverse; -1 for a string that is no uuid."""
    try:
        return uuid.UUID(text).int - 1
    except (ValueError, AttributeError, TypeError):
        return -1


def decimal_rows(v: np.ndarray) -> tuple[list[bytes], np.ndarray]:
    """Each row of v ([m, d], every |value| < 10) as JSON number text with
    DECIMALS digits after the point, ", "-separated without brackets, and
    the f32 values a server that parses the text gets: (texts, [m, d] f32).
    Fixed width and built with array arithmetic, so the client's encoding
    costs microseconds, not the milliseconds of json.dumps."""
    k = np.rint(v.astype(np.float64) * _SCALE).astype(np.int64)
    a = np.abs(k)
    if a.size and a.max() >= 10 * _SCALE:
        raise ValueError("decimal_rows takes values below 10 in magnitude")
    m, d = a.shape
    width = 3 + DECIMALS + 1  # sign or space, digit, point, decimals, comma
    buf = np.empty((m, d, width), np.uint8)
    buf[..., 0] = np.where(k < 0, ord("-"), ord(" "))
    buf[..., 1] = ord("0") + a // _SCALE
    buf[..., 2] = ord(".")
    for j in range(DECIMALS):
        buf[..., 3 + j] = ord("0") + (a // 10 ** (DECIMALS - 1 - j)) % 10
    buf[..., -1] = ord(",")
    rows = buf.reshape(m, d * width)[:, :-1]
    exact = (k.astype(np.float64) / _SCALE).astype(np.float32)
    return [r.tobytes() for r in rows], exact


def import_body(data: dict, seed: int, class_name: str, batch: int, size: int,
                c=None) -> bytes:
    """POST /v1/batch/objects body of import batch `batch`: its `size`
    objects, object b * size + i with row i of `import_batch`, sent as
    decimal text."""
    texts, _ = decimal_rows(import_batch(data, seed, batch, size, c))
    cls = class_name.encode()
    objs = [b'{"class":"%s","id":"%s","vector":[%s]}'
            % (cls, object_uuid(batch * size + i).encode(), t) for i, t in enumerate(texts)]
    return b'{"objects":[' + b",".join(objs) + b"]}"
