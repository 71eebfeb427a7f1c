// Group-min scan over PQ codes for Hopper (sm_90a): the CUDA port of two
// Pallas kernels,
//   K2 weaviate_tpu/ops/pq_gmin.py:_pq_gmin_kernel (8-bit codes, called
//      through pq_group_min_scores, pq_gmin.py:192-218), and
//   K3 weaviate_tpu/ops/pq4.py:_pq4_kernel (nibble-packed 4-bit codes,
//      called through pq4_group_min_scores, pq4.py:203-228).
// Both score queries against a store rebuilt from codes:
//
//     recon[g, c] = concat_m bf16(codebook)[m, code(g, c, m)]       [D]
//     out[b, c]   = min_{g < ag} ( bias[g, c] + alpha * <bf16(q_b), recon[g, c]> )
//
// with the codebook rounded to bf16 round-to-nearest-even by the caller
// (as the reference's `astype(jnp.bfloat16)`), the products accumulated in
// f32. l2: bias = ||recon||^2 from the f32 codebook (the caller's
// recon_sq_norms), alpha = -2; dot/cosine: bias 0, alpha = -1; dead slots
// +inf. 8-bit codes: codes [16, ncols, M] uint8, C <= 256. 4-bit codes:
// packed [16, ncols, M/2] uint8, byte j holding segment j in its low nibble
// and segment M/2 + j in its high nibble (compress/pq.py pack_codes4), C =
// 16. The segment width ds = D / M may be any divisor of D.
//
// Bound on this card at the main-path shape (B = 16384, ncols = 65536, ag
// = 16, D = 768, M = 96): 2 * B * ag * ncols * D = 2.6e13 operations ->
// 26.7 ms at the 989 TFLOP/s bf16 peak, against ~4.4 GB of bytes (codes
// 96 MiB or 48 MiB, the [B, ncols] f32 output 4 GiB) -> 1.3 ms at 3.35
// TB/s: bound by the tensor cores. Beside them, every block streams the
// whole bf16 query matrix (25 MB at the main shape) from L2, ~206 GB in
// all; halving that stream (two-block clusters sharing each query tile by
// TMA multicast) and a deeper ring of smaller stages were both slower on
// the card than this design, so neither the L2 stream nor the load latency
// is what holds it at about half the tensor-core rate (PERF.md).
//
// Design: the resident-tile scan of gmin_resident.cuh, with a filler that
// decodes the block's store tile from codes once. The decode is a lookup,
// not the TPU's one-hot product: one 16-byte centroid load per 8 elements
// when ds % 8 == 0, element by element otherwise; it reads the codebook
// through L1/L2 (384 KB at M = 96, C = 256) once per element of the tile,
// not once per query tile.

#include "gmin_resident.cuh"

namespace {

// code of segment s in a row of codes. BITS = 8: one byte per segment;
// BITS = 4: byte s mod (M/2), high nibble iff s >= M/2.
template <int BITS>
__device__ __forceinline__ int code_at(const uint8_t* row, int s, int M) {
  if (BITS == 8) return row[s];
  const int mb = M >> 1;
  const int byte = row[s < mb ? s : s - mb];
  return s < mb ? (byte & 15) : (byte >> 4);
}

// The store tile decoded from codes: row n = g * scg + c of the tile is
// slot (g, c0 + c). vec: the codebook's base is 16-byte aligned and ds % 8
// == 0, so each 8-element step lies inside one segment and one aligned
// 16-byte centroid load serves it.
template <int BITS>
struct CodeTile : RowBias {
  const uint8_t* codes;
  const __nv_bfloat16* cb;
  int64_t ncols;
  int D, M, C, ds;
  bool vec;

  template <int N>
  __device__ void fill(unsigned char* tile, int64_t c0, int scg, int ag, int Dp, int tid,
                       int nthreads) const {
    const int rb = BITS == 8 ? M : M / 2;
    const int lg = __ffs(scg) - 1;
    if (vec) {
      const int k8n = Dp >> 3;
      for (int idx = tid; idx < N * k8n; idx += nthreads) {
        const int n = idx / k8n;
        const int d = (idx - n * k8n) << 3;
        const int g = n >> lg;
        const int64_t col = c0 + (n & (scg - 1));
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (g < ag && col < ncols && d < D) {
          const int s = d / ds;
          const int code = code_at<BITS>(codes + (int64_t(g) * ncols + col) * rb, s, M);
          v = *reinterpret_cast<const uint4*>(cb + (int64_t(s) * C + code) * ds + (d - s * ds));
        }
        *reinterpret_cast<uint4*>(tile + swz(n, d, N)) = v;
      }
    } else {
      for (int idx = tid; idx < N * Dp; idx += nthreads) {
        const int n = idx / Dp;
        const int d = idx - n * Dp;
        const int g = n >> lg;
        const int64_t col = c0 + (n & (scg - 1));
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (g < ag && col < ncols && d < D) {
          const int s = d / ds;
          const int code = code_at<BITS>(codes + (int64_t(g) * ncols + col) * rb, s, M);
          v = cb[(int64_t(s) * C + code) * ds + (d - s * ds)];
        }
        *reinterpret_cast<__nv_bfloat16*>(tile + swz(n, d, N)) = v;
      }
    }
  }
};

template <int BITS>
int launch_codes(const void* q, const void* codes, const void* bias, const void* cb, void* qbf,
                 void* out, long long B, long long ncols, long long D, int M, int C, int ag,
                 float alpha, int scg, int qvec4, int cbvec, void* stream) {
  if (D <= 0 || D > (1 << 20) || M <= 0 || D % M != 0 || C <= 0 || ag < 1 || ag > G || scg < 1)
    return int(cudaErrorInvalidValue);
  if ((BITS == 8 && C > 256) || (BITS == 4 && (C > 16 || M % 2 != 0)))
    return int(cudaErrorInvalidValue);
  const int ds = int(D / M);
  const CodeTile<BITS> tile{{}, static_cast<const uint8_t*>(codes),
                            static_cast<const __nv_bfloat16*>(cb), ncols, int(D), M, C, ds,
                            cbvec != 0 && ds % 8 == 0};
  return launch_resident(tile, q, bias, qbf, out, B, ncols, D, ag, alpha, scg, qvec4 != 0,
                         stream);
}

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, codes [16, ncols, M]
// uint8 (pq8) or [16, ncols, M/2] uint8 (pq4), bias [16, ncols] f32,
// codebook [M, C, D/M] bf16, qbf a [roundup(B, 128), roundup(D, 64)] bf16
// scratch, out [B, ncols] f32: contiguous device buffers. scg is the
// wrapper's plan (ops/gmin_scan.resident_plan, through
// ops/pq_gmin.codes_plan); a plan whose tile does not fit is refused.
// Launches the query rounding and the scan (one block per scg group
// columns) on `stream`, allocates nothing, does not synchronise; returns
// the CUDA error of the launches (0 = launched). qvec4: q rows 16-byte
// aligned with D % 4 == 0; cbvec: the codebook's base is 16-byte aligned.
extern "C" int pq8_gmin_launch(const void* q, const void* codes, const void* bias, const void* cb,
                               void* qbf, void* out, long long B, long long ncols, long long D,
                               int M, int C, int ag, float alpha, int scg, int qvec4,
                               int cbvec, void* stream) {
  return launch_codes<8>(q, codes, bias, cb, qbf, out, B, ncols, D, M, C, ag, alpha, scg,
                         qvec4, cbvec, stream);
}

extern "C" int pq4_gmin_launch(const void* q, const void* codes, const void* bias, const void* cb,
                               void* qbf, void* out, long long B, long long ncols, long long D,
                               int M, int C, int ag, float alpha, int scg, int qvec4,
                               int cbvec, void* stream) {
  return launch_codes<4>(q, codes, bias, cb, qbf, out, B, ncols, D, M, C, ag, alpha, scg,
                         qvec4, cbvec, stream);
}

// The name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* pq_gmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
