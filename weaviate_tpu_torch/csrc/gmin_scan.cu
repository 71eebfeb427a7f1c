// Group-min fast scan for Hopper (sm_90a): the CUDA port of the Pallas
// kernel weaviate_tpu/ops/gmin_scan.py:_gmin_kernel (called through
// group_min_scores, gmin_scan.py:174-201). Two instantiations of one tile
// loop (gmin_tile.cuh): the store is f32 (the uncompressed index) or bf16
// (the rescore copy of the PQ-compressed index, pq.rescore=true).
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
// written. The bf16 store halves the bytes each block stages and skips
// the rounding; the tile loop is otherwise the same.

#include "gmin_tile.cuh"

namespace {

using gmin::BC;
using gmin::LDS;
using gmin::THREADS;

// f32 store: rounded to bf16 at staging (float4 loads when vec is set:
// D % 4 == 0 and 16-byte aligned rows)
struct F32Store {
  const float* x;
  int64_t ncols;
  bool vec;
  __device__ __forceinline__ void stage(__nv_bfloat16* dst, int g, int64_t c0, int64_t D,
                                        int64_t d0, int dk, int dkp) const {
    gmin::stage_f32<BC>(dst, x + int64_t(g) * ncols * D, c0, ncols, D, d0, dk, dkp, vec);
  }
};

// bf16 store: a copy, 16 bytes (8 elements) per thread-step when vec is
// set (D % 8 == 0 and a 16-byte aligned base, so every row and every
// 8-element step of it is aligned), element by element otherwise
struct BF16Store {
  const __nv_bfloat16* x;
  int64_t ncols;
  bool vec;
  __device__ __forceinline__ void stage(__nv_bfloat16* dst, int g, int64_t c0, int64_t D,
                                        int64_t d0, int dk, int dkp) const {
    const __nv_bfloat16* xg = x + int64_t(g) * ncols * D;
    if (vec) {
      const int o8 = dkp >> 3;
      for (int idx = threadIdx.x; idx < BC * o8; idx += THREADS) {
        const int r = idx / o8;
        const int k = (idx - r * o8) << 3;
        const int64_t row = c0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < ncols && k < dk) v = *reinterpret_cast<const uint4*>(xg + row * D + d0 + k);
        *reinterpret_cast<uint4*>(dst + r * LDS + k) = v;
      }
    } else {
      const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
      for (int idx = threadIdx.x; idx < BC * dkp; idx += THREADS) {
        const int r = idx / dkp;
        const int k = idx - r * dkp;
        const int64_t row = c0 + r;
        dst[r * LDS + k] = (row < ncols && k < dk) ? xg[row * D + d0 + k] : zero;
      }
    }
  }
};

template <class Store>
__global__ void __launch_bounds__(THREADS)
gmin_kernel(Store xs, const float* __restrict__ q, const float* __restrict__ bias,
            float* __restrict__ out, int64_t B, int64_t ncols, int64_t D, int ag, float alpha,
            bool qvec4) {
  gmin::gmin_tile(xs, q, bias, out, B, ncols, D, ag, alpha, qvec4);
}

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, store [16, ncols, D] (f32
// or, for gmin_scan_bf16_launch, bf16), bias [16, ncols] f32, out [B,
// ncols] f32: contiguous device buffers. Launches on `stream`, allocates
// nothing, does not synchronise; returns the CUDA error of the launch (0 =
// launched). qvec4: q rows 16-byte aligned with D % 4 == 0; svec: the
// store's vector condition (f32: as qvec4; bf16: D % 8 == 0 and a 16-byte
// aligned base).
extern "C" int gmin_scan_launch(const void* q, const void* store, const void* bias, void* out,
                                long long B, long long ncols, long long D, int ag, float alpha,
                                int qvec4, int svec, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || ag < 1 || ag > gmin::G) return int(cudaErrorInvalidValue);
  const F32Store xs{static_cast<const float*>(store), ncols, svec != 0};
  return gmin::launch(gmin_kernel<F32Store>, B, ncols, stream, xs, static_cast<const float*>(q),
                      static_cast<const float*>(bias), static_cast<float*>(out), int64_t(B),
                      int64_t(ncols), int64_t(D), ag, alpha, qvec4 != 0);
}

extern "C" int gmin_scan_bf16_launch(const void* q, const void* store, const void* bias, void* out,
                                     long long B, long long ncols, long long D, int ag,
                                     float alpha, int qvec4, int svec, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || ag < 1 || ag > gmin::G) return int(cudaErrorInvalidValue);
  const BF16Store xs{static_cast<const __nv_bfloat16*>(store), ncols, svec != 0};
  return gmin::launch(gmin_kernel<BF16Store>, B, ncols, stream, xs, static_cast<const float*>(q),
                      static_cast<const float*>(bias), static_cast<float*>(out), int64_t(B),
                      int64_t(ncols), int64_t(D), ag, alpha, qvec4 != 0);
}

// The name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* gmin_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
