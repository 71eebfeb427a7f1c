// Group-min scan over the stage profiler's two store layouts, for Hopper
// (sm_90a): the CUDA port of two Pallas kernels of tools/profile_gmin.py,
//   K4 _nt_kernel (called through nt_scores, :130-144): the store
//      pre-transposed to [G, D, ncols], so the product needs no transpose;
//   K5 _c4_kernel (called through c4_scores, :166-181): gc groups side by
//      side, the store [G/gc, D, gc*ncols] in a tile-wise interleave.
// Both compute K1's function (gmin_scan.cu) over every slice (no live-slice
// cut, as the reference):
//
//     out[b, c] = min_g ( bias[g, c] + alpha * <bf16(q_b), bf16(x[g, c])> )
//
// with both operands rounded to bf16 round-to-nearest-even and the products
// accumulated in f32. K5's interleave (profile_gmin.interleave): member t of
// slice si is group g = si*gc + t, and its column c lies at physical column
//
//     (c / scg) * gc * scg + t * scg + (c % scg)
//
// of store4[si] and of bias4[si], for an interleave width scg that divides
// ncols. The reference runs each slice as one [qb, D] @ [D, gc*scg] product
// and a min across the gc column blocks; here each member's columns are a
// sub-tile staged and folded into the running min in turn, which computes
// the same scores (each is one dot product, summed in another order).
//
// Design: the tile loop of gmin_tile.cuh with its depth-major store tile:
// the stager copies runs of a [D, ncols] row into a [DK x BC] shared tile
// (float4 loads when every run is 16-byte aligned) and the products read it
// as a row_major B operand. So K4 keeps its layout's point, no transpose on
// the way in; K5 is the same stager with the interleave's column map. Ragged
// query and column edges are masked in the loop; offsets are 64-bit.
//
// Bound on this card at the profiler's shape (B = 16384, n = 2^20 so ncols
// = 65536, G = 16, D = 128): 2 * B * G * ncols * D = 4.4e12 operations ->
// 4.447 ms at the 989 TFLOP/s bf16 peak, against ~4.5 GB (store 512 MiB,
// the [B, ncols] f32 output 4 GiB) -> 1.35 ms at 3.35 TB/s: bound by the
// tensor cores, as K1.

#include "gmin_tile.cuh"

namespace {

using gmin::BC;
using gmin::LDX;
using gmin::THREADS;

// Stage depth rows d0 .. d0+dkp of a row-major [D, width] f32 slice, output
// columns c0 .. c0+BC, into dst [DK x LDX] as bf16. Column c of the output
// reads physical column map(c); rows past the live dk and columns past
// ncols read as zero. vec: every 4-column run starting at a multiple of 4
// is 4 contiguous, 16-byte aligned floats. Each thread keeps one column (or
// 4-column run) and steps down the depth, so the column map is computed
// once per call, not once per element.
template <class ColMap>
__device__ __forceinline__ void stage_depth_major(__nv_bfloat16* dst, const float* __restrict__ src,
                                                  int64_t width, int64_t ncols, int64_t c0,
                                                  int64_t d0, int dk, int dkp, bool vec,
                                                  const ColMap& map) {
  if (vec) {
    constexpr int C4 = BC / 4;
    static_assert(THREADS % C4 == 0, "a thread's 4-column run is the same at every depth");
    const int c = (threadIdx.x % C4) << 2;
    const bool live = c0 + c < ncols;
    const float* col = src + d0 * width + (live ? map(c0 + c) : 0);
    for (int k = threadIdx.x / C4; k < dkp; k += THREADS / C4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < dk && live) v = *reinterpret_cast<const float4*>(col + k * width);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(dst + k * LDX + c);
      p[0] = __floats2bfloat162_rn(v.x, v.y);
      p[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    static_assert(THREADS % BC == 0, "a thread's column is the same at every depth");
    const int c = threadIdx.x % BC;
    const bool live = c0 + c < ncols;
    const float* col = src + d0 * width + (live ? map(c0 + c) : 0);
    for (int k = threadIdx.x / BC; k < dkp; k += THREADS / BC)
      dst[k * LDX + c] = __float2bfloat16_rn((k < dk && live) ? col[k * width] : 0.f);
  }
}

struct Identity {
  __device__ __forceinline__ int64_t operator()(int64_t col) const { return col; }
};

// K4: store3t [G, D, ncols] f32
struct TransposedStore {
  const float* x;
  int64_t ncols;
  bool vec;  // ncols % 4 == 0 and a 16-byte aligned base
  __device__ __forceinline__ void stage(__nv_bfloat16* dst, int g, int64_t c0, int64_t D,
                                        int64_t d0, int dk, int dkp) const {
    stage_depth_major(dst, x + int64_t(g) * D * ncols, ncols, ncols, c0, d0, dk, dkp, vec,
                      Identity{});
  }
};

// member t's column map of K5's interleave
struct Interleave {
  int64_t scg;
  int gc;
  int t;
  __device__ __forceinline__ int64_t operator()(int64_t col) const {
    const int64_t tile = col / scg;
    return (tile * gc + t) * scg + (col - tile * scg);
  }
};

// K5: store4 [G/gc, D, gc*ncols] f32; the loop's group g is member g % gc
// of slice g / gc
struct InterleavedStore {
  const float* x;
  int64_t ncols;
  int64_t scg;
  int gc;
  bool vec;  // ncols % 4 == 0, scg % 4 == 0 and a 16-byte aligned base
  __device__ __forceinline__ void stage(__nv_bfloat16* dst, int g, int64_t c0, int64_t D,
                                        int64_t d0, int dk, int dkp) const {
    const int64_t width = int64_t(gc) * ncols;
    stage_depth_major(dst, x + int64_t(g / gc) * D * width, width, ncols, c0, d0, dk, dkp, vec,
                      Interleave{scg, gc, g % gc});
  }
};

// bias4 [G/gc, gc*ncols] in the store's interleave
__device__ __forceinline__ int64_t bias_offset(const InterleavedStore& xs, int g, int64_t col,
                                               int64_t) {
  return int64_t(g / xs.gc) * xs.gc * xs.ncols + Interleave{xs.scg, xs.gc, g % xs.gc}(col);
}

template <class Store>
__global__ void __launch_bounds__(THREADS)
layout_kernel(Store xs, const float* __restrict__ q, const float* __restrict__ bias,
              float* __restrict__ out, int64_t B, int64_t ncols, int64_t D, int g, float alpha,
              bool qvec4) {
  gmin::gmin_tile<Store>(xs, q, bias, out, B, ncols, D, g, alpha, qvec4);
}

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, out [B, ncols] f32, and
// K4: store3t [g, D, ncols] f32, bias2 [g, ncols] f32;
// K5: store4 [g/gc, D, gc*ncols] f32, bias4 [g/gc, gc*ncols] f32, scg | ncols;
// all contiguous device buffers. Launches on `stream`, allocates nothing,
// does not synchronise; returns the CUDA error of the launch (0 =
// launched). qvec4: q rows 16-byte aligned with D % 4 == 0; svec: the
// store's 16-byte aligned base.
extern "C" int nt_scores_launch(const void* q, const void* store3t, const void* bias2, void* out,
                                long long B, long long ncols, long long D, int g, float alpha,
                                int qvec4, int svec, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || g < 1 || g > gmin::G) return int(cudaErrorInvalidValue);
  const TransposedStore xs{static_cast<const float*>(store3t), int64_t(ncols),
                           svec != 0 && ncols % 4 == 0};
  return gmin::launch(layout_kernel<TransposedStore>, B, ncols, stream, xs,
                      static_cast<const float*>(q), static_cast<const float*>(bias2),
                      static_cast<float*>(out), int64_t(B), int64_t(ncols), int64_t(D), g, alpha,
                      qvec4 != 0);
}

extern "C" int c4_scores_launch(const void* q, const void* store4, const void* bias4, void* out,
                                long long B, long long ncols, long long D, int nslice, int gc,
                                long long scg, float alpha, int qvec4, int svec, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || nslice < 1 || gc < 1 || nslice * gc > gmin::G ||
      scg <= 0 || ncols % scg != 0)
    return int(cudaErrorInvalidValue);
  const InterleavedStore xs{static_cast<const float*>(store4), int64_t(ncols), int64_t(scg), gc,
                            svec != 0 && ncols % 4 == 0 && scg % 4 == 0};
  return gmin::launch(layout_kernel<InterleavedStore>, B, ncols, stream, xs,
                      static_cast<const float*>(q), static_cast<const float*>(bias4),
                      static_cast<float*>(out), int64_t(B), int64_t(ncols), int64_t(D),
                      nslice * gc, alpha, qvec4 != 0);
}

// The name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* gmin_layouts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
