// Group-min fast scan for Hopper (sm_90a): the CUDA port of the Pallas
// kernel weaviate_tpu/ops/gmin_scan.py:_gmin_kernel (called through
// group_min_scores, gmin_scan.py:174-201), over an f32 store (K1, the
// uncompressed index) or a bf16 one (K1-bf16, the rescore copy of the
// PQ-compressed index, pq.rescore=true). Both run the resident-tile scan of
// gmin_resident.cuh, which K2 and K3 (pq_gmin.cu) and K4 and K5
// (gmin_layouts.cu) share; this file holds their two tile fillers and
// their entry points.
//
// What it computes, for queries q [B, D] f32, the store viewed as
// x [16, ncols, D] (slot g*ncols + c is member g of group c) and a bias
// [16, ncols] f32:
//
//     out[b, c] = min_{g < ag} ( bias[g, c] + alpha * <bf16(q_b), bf16(x[g, c])> )
//
// with both operands rounded to bf16 round-to-nearest-even (what
// `astype(jnp.bfloat16)` does; a bf16 store is already rounded and is
// copied as it is) and the products accumulated in f32. l2: bias =
// ||x||^2, alpha = -2; dot/cosine: bias = 0, alpha = -1; dead slots
// (tombstoned, past n, filtered out) carry bias = +inf.
//
// Bound on this card at the main-path shapes (capacity 2^20 -> ncols =
// 65536, ag = 16, B = 16384 queries):
//   f32 store, D = 128: 2 * B * ag * ncols * D = 4.4e12 operations -> 4.4 ms
//     at the 989 TFLOP/s bf16 tensor-core peak, against ~4.8 GB (store
//     512 MiB + the [B, ncols] f32 output 4 GiB) -> 1.4 ms at 3.35 TB/s;
//   bf16 store, D = 768: 2.6e13 operations -> 26.7 ms, against ~6.1 GB
//     (store 1.5 GiB + output 4 GiB) -> 1.8 ms.
// So the tensor cores bound both, and the design keeps the [B, 16*ncols]
// score matrix out of device memory: only the [B, ncols] minima are
// written. Each block reads its store tile from device memory once; what
// it streams many times is the bf16 query matrix, from L2: at D = 128 each
// block reads all 4 MB of it for a 64 KB tile, ~17 GB per batch at N = 256
// (SCG 16), twice that at N = 128, against the 4.4 ms of products. The
// widest tile (N = 256, wgmma m64n256k16) halves that stream.
//
// The fillers. The f32 store is loaded and rounded (two 16-byte loads and
// one 16-byte shared store per 8 elements when D % 4 == 0 and the base is
// aligned, element by element otherwise); the bf16 store is copied (one
// 16-byte load per 8 elements when D % 8 == 0 and the base is aligned,
// element by element otherwise). A TMA copy of the bf16 tile ([S, SCG, 64]
// boxes of the store viewed as [16, ncols, D], swizzled on the way) would
// serve only D % 8 == 0 (TMA's strides are multiples of 16 bytes), so the
// element path would stay beside it; the copy is once per block, and the
// plain loads serve both stores alike. Each thread keeps one 8-element
// chunk column while it walks down the tile's rows, so a row's slice,
// column and address are computed once per row, not once per element, and
// it loads four rows before it stores them, so four loads are in flight.

#include "gmin_resident.cuh"

namespace {

// Fill the tile's rows n (store row order) and 8-element chunks d with
// load(n, d), the chunk as 8 packed bf16 (zeros for rows past N, dead slots
// and depth past D). Each thread keeps one chunk column while it walks down
// the rows (when a row has no more chunks than there are threads, several
// rows at a time, one chunk of each per thread; the threads past the last
// whole row fill nothing), so load computes a row's address once, and it
// loads U rows before it stores them, so U loads are in flight.
template <int N, class Load>
__device__ __forceinline__ void fill_rows(unsigned char* tile, int Dp, int tid, int nthreads,
                                          const Load& load) {
  constexpr int U = 4;
  const int k8n = Dp >> 3;
  const bool rows_at_a_time = k8n <= nthreads;
  const int cstep = rows_at_a_time ? k8n : nthreads;
  const int rstep = rows_at_a_time ? nthreads / k8n : 1;
  const int j0 = rows_at_a_time ? tid % k8n : tid;
  const int r0 = rows_at_a_time ? tid / k8n : 0;
  if (r0 >= rstep) return;
  for (int j = j0; j < k8n; j += cstep)
    for (int n0 = r0; n0 < N; n0 += U * rstep) {
      uint4 p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) p[u] = load(n0 + u * rstep, j << 3);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (n0 + u * rstep < N)
          *reinterpret_cast<uint4*>(tile + swz(n0 + u * rstep, j << 3, N)) = p[u];
    }
}

// f32 store [16, ncols, D], rounded to bf16 as it is filled. vec: D % 4 ==
// 0 and a 16-byte aligned base, so every row and every 4-element step of
// it is aligned.
struct F32Tile : RowBias {
  const float* x;
  int64_t ncols;
  int D;
  bool vec;

  template <int N>
  __device__ void fill(unsigned char* tile, int64_t c0, int scg, int ag, int Dp, int tid,
                       int nthreads) const {
    const int lg = __ffs(scg) - 1;
    fill_rows<N>(tile, Dp, tid, nthreads, [&](int n, int d) {
      const int g = n >> lg;
      const int64_t col = c0 + (n & (scg - 1));
      float v[8] = {};
      if (n < N && g < ag && col < ncols && d < D) {
        const float* __restrict__ row = x + (int64_t(g) * ncols + col) * D;
        if (vec) {  // D % 4 == 0: the chunk is one or two whole float4
          const float4 lo = *reinterpret_cast<const float4*>(row + d);
          v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
          if (d + 8 <= D) {
            const float4 hi = *reinterpret_cast<const float4*>(row + d + 4);
            v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (d + e < D) v[e] = row[d + e];
        }
      }
      uint4 p;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&p);
#pragma unroll
      for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      return p;
    });
  }
};

// bf16 store [16, ncols, D], copied. vec: D % 8 == 0 and a 16-byte aligned
// base, so every row and every 8-element step of it is aligned.
struct BF16Tile : RowBias {
  const __nv_bfloat16* x;
  int64_t ncols;
  int D;
  bool vec;

  template <int N>
  __device__ void fill(unsigned char* tile, int64_t c0, int scg, int ag, int Dp, int tid,
                       int nthreads) const {
    const int lg = __ffs(scg) - 1;
    fill_rows<N>(tile, Dp, tid, nthreads, [&](int n, int d) {
      const int g = n >> lg;
      const int64_t col = c0 + (n & (scg - 1));
      uint4 p = make_uint4(0u, 0u, 0u, 0u);
      if (n < N && g < ag && col < ncols && d < D) {
        const __nv_bfloat16* __restrict__ row = x + (int64_t(g) * ncols + col) * D;
        if (vec) {
          p = *reinterpret_cast<const uint4*>(row + d);
        } else {
          __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&p);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (d + e < D) h[e] = row[d + e];
        }
      }
      return p;
    });
  }
};

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, store [16, ncols, D] (f32
// or, for gmin_scan_bf16_launch, bf16), bias [16, ncols] f32, qbf a
// [roundup(B, 128), roundup(D, 64)] bf16 scratch, out [B, ncols] f32:
// contiguous device buffers. scg is the wrapper's plan
// (ops/gmin_scan.resident_plan): scg group columns per block, so the tile
// holds S * scg rows for S the least power of two >= ag; a plan whose tile
// does not fit is refused. Launches the query rounding and the scan on
// `stream`, allocates nothing, does not synchronise; returns the CUDA error
// of the launches (0 = launched). qvec4: q rows 16-byte aligned with D % 4
// == 0; svec: the store's vector condition (f32: D % 4 == 0, bf16: D % 8 ==
// 0, and a 16-byte aligned base).
extern "C" int gmin_scan_launch(const void* q, const void* store, const void* bias, void* qbf,
                                void* out, long long B, long long ncols, long long D, int ag,
                                float alpha, int scg, int qvec4, int svec, void* stream) {
  const F32Tile tile{{}, static_cast<const float*>(store), ncols, int(D), svec != 0};
  return launch_resident(tile, q, bias, qbf, out, B, ncols, D, ag, alpha, scg, qvec4 != 0,
                         stream);
}

extern "C" int gmin_scan_bf16_launch(const void* q, const void* store, const void* bias,
                                     void* qbf, void* out, long long B, long long ncols,
                                     long long D, int ag, float alpha, int scg, int qvec4,
                                     int svec, void* stream) {
  const BF16Tile tile{{}, static_cast<const __nv_bfloat16*>(store), ncols, int(D),
                       svec != 0};
  return launch_resident(tile, q, bias, qbf, out, B, ncols, D, ag, alpha, scg, qvec4 != 0,
                         stream);
}

// The name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* gmin_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
