"""Product quantization: codebooks, encoders and the LUT helpers (twin of
`weaviate_tpu/compress/pq.py`).

Reference: vector/ssdhelpers/product_quantization.go. A quantizer splits
the D dims into M segments of ds = D/M dims and keeps C centroids per
segment; a row's code is the nearest centroid of each segment. The
codebook is fit by per-segment Lloyd k-means (kmeans.go) or, with the
tile encoder, by placing centroids at the quantiles of a (log-)normal fit
per dimension (tile_encoder.go). `rotation` 'opq' fits an orthogonal
rotation first (OPQ-NP): the codebook, the codes and every ADC distance
then live in the rotated space, which the matmul metrics do not see.

Port notes. Fit and encode run on the quantizer's device in float32: the
Lloyd loop is batched over segments with a one-hot matmul for the
centroid sums (as the reference's), and encoding is one argmin per
segment, chunked as the reference chunks it. On the card both need TF32
off, which is torch's default (`distances.require_full_f32` raises
otherwise). Random choices (the fit sample, the k-means init) come from
the same numpy generator calls as the reference's, so both packages fit
from the same rows. The OPQ alternation and the tile encoder's fit run
on the host in numpy, as in the reference. `save`/`load` read and write
the reference's `pq.npz` layout, so a compressed shard restarts in either
package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from weaviate_tpu_torch.device import resolve_device
from weaviate_tpu_torch.entities import vectorindex as vi
from weaviate_tpu_torch.ops.distances import require_full_f32

_FIT_SAMPLE_MAX = 16384   # rows used to fit codebooks (kmeans.go samples too)
_KMEANS_ITERS = 10
_OPQ_ITERS = 6            # outer Procrustes alternations (OPQ-NP)
_OPQ_INNER_ITERS = 4      # k-means depth per alternation (full depth at the end)
_ENCODE_CHUNK = 65536
# elements of the largest [segments, rows, centroids] block a fit or an
# encode step holds at once (1 GiB of f32)
_BLOCK_ELEMS = 1 << 28


def _segment_groups(m: int, rows: int, c: int):
    """Ranges of segments processed together so one [group, rows, C] f32
    block stays under _BLOCK_ELEMS."""
    per = max(1, _BLOCK_ELEMS // max(rows * c, 1))
    return [(s, min(s + per, m)) for s in range(0, m, per)]


def _kmeans_fit(data_seg: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations for every segment. data_seg [M, N, ds], init
    [M, C, ds] -> codebook [M, C, ds] f32. Empty clusters keep their
    previous centroid; ties go to the lowest centroid index."""
    m, n, _ = data_seg.shape
    c = init.shape[1]
    out = init.clone()
    for lo, hi in _segment_groups(m, n, c):
        data = data_seg[lo:hi]
        cent = out[lo:hi]
        x_sq = torch.sum(data ** 2, dim=2, keepdim=True)
        for _ in range(iters):
            xc = torch.bmm(data, cent.transpose(1, 2))             # [g, N, C]
            d = x_sq - 2.0 * xc + torch.sum(cent ** 2, dim=2)[:, None, :]
            assign = torch.argmin(d, dim=2)
            del xc, d
            onehot = torch.nn.functional.one_hot(assign, c).to(torch.float32)
            counts = onehot.sum(dim=1)                              # [g, C]
            sums = torch.bmm(onehot.transpose(1, 2), data)          # [g, C, ds]
            del onehot
            new = sums / torch.clamp(counts, min=1.0)[:, :, None]
            cent = torch.where(counts[:, :, None] > 0, new, cent)
        out[lo:hi] = cent
    return out


def _encode_block(blk: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """blk [M, rows, ds] x codebook [M, C, ds] -> codes [rows, M] int64:
    the nearest centroid per segment (||x||^2 is constant per row, so only
    the cross term and the centroid norms decide the argmin)."""
    m, rows, _ = blk.shape
    c = cent.shape[1]
    out = torch.empty((rows, m), dtype=torch.int64, device=blk.device)
    for lo, hi in _segment_groups(m, rows, c):
        cb = cent[lo:hi]
        xc = torch.bmm(blk[lo:hi], cb.transpose(1, 2))
        d = -2.0 * xc + torch.sum(cb ** 2, dim=2)[:, None, :]
        out[:, lo:hi] = torch.argmin(d, dim=2).T
    return out


# -- LUT -----------------------------------------------------------------------

def build_lut(q: torch.Tensor, codebook: torch.Tensor, metric: str) -> torch.Tensor:
    """[B, D] queries x [M, C, ds] codebook -> LUT [B, M, C] f32, the
    additive decomposition per metric (product_quantization.go LookUp):
      l2:        ||q_m - c||^2
      dot:       -(q_m . c)
      cosine:    -(q_m . c)     (+1 applied by the caller)
      manhattan: sum |q_m - c|"""
    b, _ = q.shape
    m, c, ds = codebook.shape
    qs = q.reshape(b, m, ds).float()
    cb = codebook.float()
    if metric == vi.DISTANCE_MANHATTAN:
        return torch.sum(torch.abs(qs[:, :, None, :] - cb[None, :, :, :]), dim=-1)
    qc = torch.einsum("bmd,mcd->bmc", qs, cb)
    if metric in (vi.DISTANCE_DOT, vi.DISTANCE_COSINE):
        return -qc
    if metric == vi.DISTANCE_L2:
        qn = torch.sum(qs ** 2, dim=-1)[:, :, None]
        cn = torch.sum(cb ** 2, dim=-1)[None, :, :]
        return torch.clamp(qn - 2.0 * qc + cn, min=0.0)
    raise ValueError(f"metric {metric!r} has no additive PQ decomposition")


def lut_scan_block(codes_block: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """codes_block [chunk, M] x LUT [B, M, C] -> distances [B, chunk]: per
    segment, gather each row's LUT column and accumulate, segments in
    order (the reference's fori_loop order)."""
    b = lut.shape[0]
    chunk, m = codes_block.shape
    acc = torch.zeros((b, chunk), dtype=torch.float32, device=lut.device)
    cols = codes_block.long()
    for i in range(m):
        acc = acc + lut[:, i, :][:, cols[:, i]]
    return acc


# -- 4-bit code packing ----------------------------------------------------------

def pack_codes4(codes: torch.Tensor) -> torch.Tensor:
    """[N, M] 4-bit codes (0..15) -> [N, M/2] uint8: byte j carries segment
    j in the LOW nibble and segment M/2 + j in the HIGH nibble."""
    n, m = codes.shape
    if m % 2:
        raise ValueError("pack_codes4 requires an even segment count")
    if codes.numel() and int(codes.max()) > 15:
        raise ValueError("pack_codes4 requires 4-bit codes (centroids <= 16)")
    mb = m // 2
    lo = codes[:, :mb].to(torch.uint8)
    hi = codes[:, mb:].to(torch.uint8)
    return lo | (hi << 4)


def unpack_codes4(packed: torch.Tensor) -> torch.Tensor:
    """[N, M/2] packed uint8 -> [N, M] 4-bit codes (pack_codes4 inverse)."""
    packed = packed.to(torch.uint8)
    return torch.cat([packed & 0xF, packed >> 4], dim=1)


# -- the quantizer ---------------------------------------------------------------

class ProductQuantizer:
    """Codebook container + fit/encode (ProductQuantizer, ssdhelpers). The
    codebook and rotation are numpy f32 (what `save` writes); their device
    copies are built on first use and dropped by every re-fit."""

    def __init__(self, dim: int, segments: int, centroids: int, metric: str,
                 encoder: str = vi.PQ_ENCODER_KMEANS,
                 distribution: str = vi.PQ_DISTRIBUTION_LOG_NORMAL,
                 rotation: str = vi.PQ_ROTATION_NONE, device=None):
        if segments <= 0:
            segments = dim  # auto (= dims), pq_config.go default
        if dim % segments != 0:
            raise vi.ConfigValidationError(
                f"pq.segments ({segments}) must divide vector dims ({dim})")
        if centroids > 65536:
            raise vi.ConfigValidationError("pq.centroids must be <= 65536")
        if metric == vi.DISTANCE_HAMMING:
            # centroids are means: exact-equality distance to a mean counts
            # nearly every dim a mismatch
            raise vi.ConfigValidationError("pq does not support hamming")
        if encoder == vi.PQ_ENCODER_TILE and dim != segments:
            raise vi.ConfigValidationError("tile encoder requires segments == dims")
        if rotation not in (vi.PQ_ROTATION_NONE, vi.PQ_ROTATION_OPQ):
            raise vi.ConfigValidationError(
                f"pq.rotation must be 'none' or 'opq', got {rotation!r}")
        if rotation == vi.PQ_ROTATION_OPQ:
            if metric == vi.DISTANCE_MANHATTAN:
                raise vi.ConfigValidationError(
                    "pq.rotation 'opq' requires an l2/dot/cosine distance")
            if encoder == vi.PQ_ENCODER_TILE:
                raise vi.ConfigValidationError(
                    "pq.rotation 'opq' requires the kmeans encoder")
        self.dim = dim
        self.segments = segments
        self.centroids = centroids
        self.ds = dim // segments
        self.metric = metric
        self.encoder = encoder
        self.distribution = distribution
        self.rotation = rotation
        self.device = resolve_device(device)
        self.rotation_matrix: Optional[np.ndarray] = None  # [D, D] orthogonal
        self.code_dtype = torch.uint8 if centroids <= 256 else torch.int32
        self.codebook: Optional[np.ndarray] = None          # [M, C, ds] f32
        self._dev: dict = {}

    # device copies ---------------------------------------------------------

    def _cached(self, key, make):
        t = self._dev.get(key)
        if t is None:
            t = make()
            self._dev[key] = t
        return t

    def codebook_dev(self) -> torch.Tensor:
        """[M, C, ds] f32 codebook on the device."""
        return self._cached("f32", lambda: torch.from_numpy(self.codebook).to(self.device))

    def codebook_bf16(self) -> torch.Tensor:
        """[M, C, ds] codebook rounded to bf16 (round to nearest even): the
        operand the scan kernels reconstruct from."""
        return self._cached("bf16", lambda: self.codebook_dev().to(torch.bfloat16).contiguous())

    def rotation_dev(self) -> Optional[torch.Tensor]:
        """[D, D] f32 rotation on the device, or None when none is fitted."""
        if self.rotation_matrix is None:
            return None
        return self._cached("rot", lambda: torch.from_numpy(self.rotation_matrix).to(self.device))

    def _as_dev(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)

    # fit -------------------------------------------------------------------

    def fit(self, vectors, seed: int = 0,
            rotation_matrix: Optional[np.ndarray] = None) -> None:
        """Fit the codebook (and the OPQ rotation when configured) on up to
        16384 rows sampled with numpy's generator seeded by `seed`.
        `rotation_matrix` pins a pre-fitted orthogonal rotation instead of
        learning one (the 4-bit funnel quantizer reuses the 8-bit one's)."""
        require_full_f32(self.device)
        n = vectors.shape[0]
        if n > _FIT_SAMPLE_MAX:
            sel = np.random.default_rng(seed).choice(n, _FIT_SAMPLE_MAX, replace=False)
            if isinstance(vectors, torch.Tensor):
                vectors = vectors[torch.from_numpy(sel).to(vectors.device)]
            else:
                vectors = np.asarray(vectors)[sel]
        self._dev = {}  # a re-fit replaces the codebook and the rotation
        if rotation_matrix is not None:
            if self.encoder == vi.PQ_ENCODER_TILE:
                raise vi.ConfigValidationError("a preset rotation requires the kmeans encoder")
            self.rotation_matrix = np.asarray(rotation_matrix, np.float32)
            self.codebook = self._fit_kmeans(self._as_dev(vectors) @ self.rotation_dev(), seed)
        elif self.encoder == vi.PQ_ENCODER_TILE:
            self.codebook = self._fit_tile(self._host(vectors))
        elif self.rotation == vi.PQ_ROTATION_OPQ:
            self._fit_opq(self._host(vectors), seed)
        else:
            self.codebook = self._fit_kmeans(self._as_dev(vectors), seed)
        self._dev = {}

    @staticmethod
    def _host(x) -> np.ndarray:
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", torch.float32).numpy()
        return np.asarray(x, dtype=np.float32)

    def _fit_kmeans(self, vectors: torch.Tensor, seed: int,
                    iters: int = _KMEANS_ITERS) -> np.ndarray:
        n = vectors.shape[0]
        m, c, ds = self.segments, self.centroids, self.ds
        data_seg = vectors.reshape(n, m, ds).transpose(0, 1).contiguous()  # [M, N, ds]
        rng = np.random.default_rng(seed)
        # init from distinct sample rows per segment (kmeans.go random init)
        picks = [torch.from_numpy(rng.choice(n, min(c, n), replace=False)).to(vectors.device)
                 for _ in range(m)]
        init = torch.stack([data_seg[s][picks[s]] for s in range(m)])
        if init.shape[1] < c:  # fewer samples than centroids: tile them
            reps = -(-c // init.shape[1])
            init = init.repeat(1, reps, 1)[:, :c]
        return _kmeans_fit(data_seg, init.contiguous(), iters).cpu().numpy()

    def _fit_opq(self, x: np.ndarray, seed: int) -> None:
        """OPQ-NP (Ge et al. 2013): alternate per-segment k-means in the
        rotated space with a Procrustes update R = U V^T from
        svd(X^T recon), in numpy on the host as in the reference."""
        r = np.eye(self.dim, dtype=np.float32)
        for _ in range(_OPQ_ITERS):
            xr = x @ r
            self.codebook = self._fit_kmeans(self._as_dev(xr), seed, iters=_OPQ_INNER_ITERS)
            self._dev = {}
            recon = self.decode_rotated(self.encode_rotated(xr)).cpu().numpy()
            u, _s, vt = np.linalg.svd(x.T @ recon)
            r = (u @ vt).astype(np.float32)
        self.rotation_matrix = r
        self.codebook = self._fit_kmeans(self._as_dev(x @ r), seed)

    def _fit_tile(self, x: np.ndarray) -> np.ndarray:
        """Distribution-based scalar quantile encoder (tile_encoder.go): per
        dimension, fit a (log-)normal and place the centroids at
        equal-probability quantile centers. erfinv runs in f32, as the
        reference's does."""
        c = self.centroids
        if self.distribution == vi.PQ_DISTRIBUTION_LOG_NORMAL:
            shift = np.minimum(x.min(axis=0), 0.0) - 1e-6
            y = np.log(x - shift[None, :])
        else:
            shift = None
            y = x
        mu = y.mean(axis=0)
        sigma = np.maximum(y.std(axis=0), 1e-9)
        p = (np.arange(c, dtype=np.float64) + 0.5) / c
        z = torch.special.erfinv(torch.from_numpy((2.0 * p - 1.0).astype(np.float32))).numpy()
        z = z * np.sqrt(2.0)
        cent = mu[:, None] + sigma[:, None] * z[None, :]  # [D, C]
        if shift is not None:
            cent = np.exp(cent) + shift[:, None]
        return cent[:, :, None].astype(np.float32)  # [M=D, C, ds=1]

    # encode / decode -----------------------------------------------------------

    def encode(self, vectors) -> torch.Tensor:
        """[N, D] f32 (numpy or tensor) -> [N, M] codes on the device;
        rotates into the quantizer's space first when a rotation is
        fitted."""
        x = self._as_dev(vectors)
        rot = self.rotation_dev()
        if rot is not None:
            x = x @ rot
        return self.encode_rotated(x)

    def encode_rotated(self, vectors) -> torch.Tensor:
        """[N, D] already-rotated f32 -> [N, M] codes (Encode), in chunks
        that bound the per-segment [chunk, C] assignment block."""
        require_full_f32(self.device)
        x = self._as_dev(vectors)
        n = x.shape[0]
        m, ds = self.segments, self.ds
        cb = self.codebook_dev()
        out = torch.empty((n, m), dtype=self.code_dtype, device=self.device)
        step = min(_ENCODE_CHUNK, max(4096, (1 << 28) // max(self.centroids, 1)))
        for off in range(0, n, step):
            end = min(off + step, n)
            blk = x[off:end].reshape(end - off, m, ds).transpose(0, 1)
            out[off:end] = _encode_block(blk, cb).to(self.code_dtype)
        return out

    def recon_sq_norms(self, codes: torch.Tensor) -> torch.Tensor:
        """||recon(code)||^2 per row, summed in f64 and rounded to f32:
        segments occupy disjoint dims, so it is the sum of the chosen
        centroids' square norms (the l2 bias of the ADC scans)."""
        cent_sq = (self.codebook_dev().double() ** 2).sum(-1)  # [M, C]
        rows = codes.long()
        seg = torch.arange(self.segments, device=rows.device)[None, :]
        return cent_sq[seg, rows].sum(1).float()

    def decode_rotated(self, codes: torch.Tensor) -> torch.Tensor:
        """[N, M] codes -> [N, D] f32 reconstruction in the quantizer's
        (rotated) space."""
        n, m = codes.shape
        seg = torch.arange(m, device=codes.device)[None, :]
        return self.codebook_dev()[seg, codes.long()].reshape(n, self.dim)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """[N, M] codes -> [N, D] f32 reconstruction in the ORIGINAL space
        (the rotation is orthogonal: its inverse is its transpose)."""
        recon = self.decode_rotated(codes)
        rot = self.rotation_dev()
        return recon if rot is None else recon @ rot.T

    # persistence ---------------------------------------------------------------

    def save(self, path: str) -> None:
        extra = {}
        if self.rotation_matrix is not None:
            extra["rotation_matrix"] = self.rotation_matrix
        np.savez(path, codebook=self.codebook, dim=self.dim, segments=self.segments,
                 centroids=self.centroids, metric=self.metric, encoder=self.encoder,
                 distribution=self.distribution, rotation=self.rotation, **extra)

    @classmethod
    def load(cls, path: str, device=None) -> "ProductQuantizer":
        z = np.load(path, allow_pickle=False)
        pq = cls(dim=int(z["dim"]), segments=int(z["segments"]),
                 centroids=int(z["centroids"]), metric=str(z["metric"]),
                 encoder=str(z["encoder"]), distribution=str(z["distribution"]),
                 rotation=str(z["rotation"]) if "rotation" in z else vi.PQ_ROTATION_NONE,
                 device=device)
        pq.codebook = z["codebook"].astype(np.float32)
        if "rotation_matrix" in z:
            pq.rotation_matrix = z["rotation_matrix"].astype(np.float32)
        return pq
