// Group-min scan over PQ codes for Hopper (sm_90a): the CUDA port of two
// Pallas kernels,
//   K2 weaviate_tpu/ops/pq_gmin.py:_pq_gmin_kernel (8-bit codes, called
//      through pq_group_min_scores, pq_gmin.py:192-218), and
//   K3 weaviate_tpu/ops/pq4.py:_pq4_kernel (nibble-packed 4-bit codes,
//      called through pq4_group_min_scores, pq4.py:203-228).
// Both are K1's score (gmin_scan.cu) over a store rebuilt from codes:
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
// Design. The Pallas kernels rebuild each store tile as a one-hot times a
// block-diagonal codebook, which is how a TPU reaches its matrix unit. On
// Hopper the rebuild is a lookup: each block stages the codes of its
// column tile stage by stage and writes the bf16 centroid values straight
// into the shared-memory operand tile, and K1's tile loop (gmin_tile.cuh)
// runs unchanged. When ds % 8 == 0 (and the codebook is 16-byte aligned)
// each 8-element step of a row lies inside one segment and is one 16-byte
// load of a centroid row; otherwise the rebuild goes element by element,
// which also covers segments that straddle a DK stage and ds = 1 (the tile
// encoder). The codebook is read through L1/L2 rather than staged in
// shared memory: at M = 96, C = 256, ds = 8 it is 384 KB in bf16, more
// than a block may hold, and any block reads only the DK/ds segments of
// its current stage.
//
// Bound on this card at the main-path shape (B = 16384, ncols = 65536, ag
// = 16, D = 768, M = 96): 2 * B * ag * ncols * D = 2.6e13 operations ->
// 26.7 ms at the 989 TFLOP/s bf16 peak, against ~4.4 GB of bytes (codes
// 96 MiB or 48 MiB, the [B, ncols] f32 output 4 GiB) -> 1.3 ms at 3.35
// TB/s: bound by the tensor cores, as K1. The rebuild is repeated for
// every query tile (B / 64 times per column tile); it costs loads and
// shared-memory stores, not tensor-core time.

#include "gmin_tile.cuh"

namespace {

using gmin::BC;
using gmin::LDS;
using gmin::THREADS;

// codes of slice g: [ncols, row_bytes] uint8. BITS = 8: one byte per
// segment; BITS = 4: byte s mod (M/2), high nibble iff s >= M/2.
template <int BITS>
struct CodeStore {
  const uint8_t* codes;
  const __nv_bfloat16* cb;  // [M, C, ds] bf16
  int64_t ncols;
  int M;
  int C;
  int ds;
  bool vec;  // ds % 8 == 0 and cb 16-byte aligned

  __device__ __forceinline__ int row_bytes() const { return BITS == 8 ? M : M / 2; }

  __device__ __forceinline__ int code(const uint8_t* row, int s) const {
    if (BITS == 8) return row[s];
    const int mb = M / 2;
    const int byte = row[s < mb ? s : s - mb];
    return s < mb ? (byte & 15) : (byte >> 4);
  }

  __device__ __forceinline__ void stage(__nv_bfloat16* dst, int g, int64_t c0, int64_t D,
                                        int64_t d0, int dk, int dkp) const {
    const int rb = row_bytes();
    const uint8_t* cg = codes + int64_t(g) * ncols * rb;
    if (vec) {
      const int o8 = dkp >> 3;
      for (int idx = threadIdx.x; idx < BC * o8; idx += THREADS) {
        const int r = idx / o8;
        const int k = (idx - r * o8) << 3;
        const int64_t col = c0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (col < ncols && k < dk) {
          const int d = int(d0) + k;
          const int s = d / ds;
          const int c = code(cg + col * rb, s);
          v = *reinterpret_cast<const uint4*>(cb + (int64_t(s) * C + c) * ds + (d - s * ds));
        }
        *reinterpret_cast<uint4*>(dst + r * LDS + k) = v;
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int idx = threadIdx.x; idx < BC * dkp; idx += THREADS) {
        const int r = idx / dkp;
        const int k = idx - r * dkp;
        const int64_t col = c0 + r;
        __nv_bfloat16 v = zero;
        if (col < ncols && k < dk) {
          const int d = int(d0) + k;
          const int s = d / ds;
          const int c = code(cg + col * rb, s);
          v = cb[(int64_t(s) * C + c) * ds + (d - s * ds)];
        }
        dst[r * LDS + k] = v;
      }
    }
  }
};

template <int BITS>
__global__ void __launch_bounds__(THREADS)
pq_gmin_kernel(CodeStore<BITS> xs, const float* __restrict__ q, const float* __restrict__ bias,
               float* __restrict__ out, int64_t B, int64_t ncols, int64_t D, int ag, float alpha,
               bool qvec4) {
  gmin::gmin_tile(xs, q, bias, out, B, ncols, D, ag, alpha, qvec4);
}

template <int BITS>
int launch_codes(const void* q, const void* codes, const void* bias, const void* cb, void* out,
                 long long B, long long ncols, long long D, int M, int C, int ag, float alpha,
                 int qvec4, int cbvec, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || M <= 0 || D % M != 0 || C <= 0 || ag < 1 ||
      ag > gmin::G || D > (1 << 30))
    return int(cudaErrorInvalidValue);
  if ((BITS == 8 && C > 256) || (BITS == 4 && (C > 16 || M % 2 != 0)))
    return int(cudaErrorInvalidValue);
  const int ds = int(D / M);
  const CodeStore<BITS> xs{static_cast<const uint8_t*>(codes),
                           static_cast<const __nv_bfloat16*>(cb),
                           int64_t(ncols), M, C, ds, cbvec != 0 && ds % 8 == 0};
  return gmin::launch(pq_gmin_kernel<BITS>, B, ncols, stream, xs, static_cast<const float*>(q),
                      static_cast<const float*>(bias), static_cast<float*>(out), int64_t(B),
                      int64_t(ncols), int64_t(D), ag, alpha, qvec4 != 0);
}

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, codes [16, ncols, M]
// uint8 (pq8) or [16, ncols, M/2] uint8 (pq4), bias [16, ncols] f32,
// codebook [M, C, D/M] bf16, out [B, ncols] f32: contiguous device
// buffers. Launches on `stream`, allocates nothing, does not synchronise;
// returns the CUDA error of the launch (0 = launched). qvec4: q rows
// 16-byte aligned with D % 4 == 0; cbvec: the codebook's base is 16-byte
// aligned.
extern "C" int pq8_gmin_launch(const void* q, const void* codes, const void* bias, const void* cb,
                               void* out, long long B, long long ncols, long long D, int M, int C,
                               int ag, float alpha, int qvec4, int cbvec, void* stream) {
  return launch_codes<8>(q, codes, bias, cb, out, B, ncols, D, M, C, ag, alpha, qvec4, cbvec,
                         stream);
}

extern "C" int pq4_gmin_launch(const void* q, const void* codes, const void* bias, const void* cb,
                               void* out, long long B, long long ncols, long long D, int M, int C,
                               int ag, float alpha, int qvec4, int cbvec, void* stream) {
  return launch_codes<4>(q, codes, bias, cb, out, B, ncols, D, M, C, ag, alpha, qvec4, cbvec,
                         stream);
}

// The name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* pq_gmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
