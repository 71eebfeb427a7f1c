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
//     (c / iw) * gc * iw + t * iw + (c % iw)
//
// of store4[si] and of bias4[si], for an interleave width iw that divides
// ncols.
//
// Design: the resident-tile scan of gmin_resident.cuh, the one K1-K3 run,
// with a depth-major filler. A block fills its tile of S slices x SCG
// group columns once, as bf16 rows n = g * SCG + c in the 128B-swizzled
// K-major layout, and streams every query past it; so K4 and K5 do K1's
// products on K1's tile in wgmma's order, and only the fill's addresses
// differ. The store lies the other way round from the tile (columns
// contiguous, depth strided), so the filler transposes in registers: a
// thread keeps one run of 4 neighbouring columns of one slice, loads it as
// a float4 at 8 depths in a row (a warp's lanes read neighbouring runs, so
// the loads coalesce), packs the 8 x 4 values into four 16-byte chunks of
// 8 bf16 (one per column) and stores each at its row. It keeps two such
// depth chunks' loads in flight, and computes its column's address (for
// K5, through the interleave's map) once, not once per element. Where a
// run is not four aligned floats (ncols % 4 != 0, an unaligned base, an
// interleave width off 4, or SCG < 4) a thread keeps one column instead
// and loads it element by element, four depth chunks in flight. K5's bias
// stays in its interleaved layout: the filler's bias_index maps it, so no
// torch op reorders it in front of the launch. The tile plan is K1's
// (ops/gmin_scan.resident_plan, for the store's slice count): none past D
// = 6208, where the wrappers raise.
//
// Bound on this card at the profiler's shape (B = 16384, n = 2^20 so ncols
// = 65536, G = 16, D = 128): 2 * B * G * ncols * D = 4.4e12 operations ->
// 4.447 ms at the 989 TFLOP/s bf16 peak, against ~4.5 GB (store 512 MiB,
// the [B, ncols] f32 output 4 GiB) -> 1.35 ms at 3.35 TB/s: bound by the
// tensor cores, as K1.

#include "gmin_resident.cuh"

namespace {

// K4's columns: group column c of slice g is column c of store slice g.
struct Columns {
  __device__ __forceinline__ int slice(int g) const { return g; }
  __device__ __forceinline__ int64_t col(int, int64_t c) const { return c; }
};

// K5's interleave: group g is member g % gc of store slice g / gc, and its
// column c lies at (c / iw) * gc * iw + (g % gc) * iw + c % iw.
struct Interleave {
  int64_t iw;
  int gc;
  __device__ __forceinline__ int slice(int g) const { return g / gc; }
  __device__ __forceinline__ int64_t col(int g, int64_t c) const {
    const int64_t blk = c / iw;
    return (blk * gc + g % gc) * iw + (c - blk * iw);
  }
};

__device__ __forceinline__ float component(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 8 depths of 4 columns, packed as one 16-byte chunk of 8 bf16 per column
struct Chunks4 {
  uint4 c[4];
};

// Walk depth chunks j0, j0 + jstep, .. < k8n, U at a time: load all U,
// then store each, so U chunks' loads are in flight. load(j) past k8n
// reads no memory (its depth is past D) and is not stored.
template <int U, class Load, class Store>
__device__ __forceinline__ void walk_depth(int j0, int jstep, int k8n, const Load& load,
                                           const Store& store) {
  for (int j = j0; j < k8n; j += U * jstep) {
    decltype(load(0)) v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = load(j + u * jstep);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (j + u * jstep < k8n) store(j + u * jstep, v[u]);
  }
}

// A depth-major f32 store: slice g's depth row d holds group column c at
// x + (map.slice(g) * D + d) * width + map.col(g, c), and its bias at
// map.slice(g) * width + map.col(g, c). vec: 4-column runs starting at a
// multiple of 4 are contiguous, 16-byte aligned floats (the base aligned,
// width and the map's runs multiples of 4).
template <class Map>
struct DepthMajorTile {
  const float* x;
  int64_t ncols;
  int64_t width;  // floats in a depth row: ncols (K4), gc * ncols (K5)
  int D;
  bool vec;
  Map map;

  __device__ __forceinline__ int64_t bias_index(int g, int64_t col, int64_t) const {
    return int64_t(map.slice(g)) * width + map.col(g, col);
  }

  template <int N>
  __device__ void fill(unsigned char* tile, int64_t c0, int scg, int ag, int Dp, int tid,
                       int nthreads) const {
    const int lg = __ffs(scg) - 1;
    const int k8n = Dp >> 3;
    // nthreads (256) is a multiple of N (at most 256) and of N / 4
    if (vec && scg >= 4) {
      constexpr int R = N / 4;  // 4-column runs in the tile
      const int n0 = (tid & (R - 1)) << 2;
      const int g = n0 >> lg;
      const int64_t col = c0 + (n0 & (scg - 1));
      const bool live = g < ag && col < ncols;  // the whole run: ncols % 4 == 0
      const float* __restrict__ src =
          x + (live ? (int64_t(map.slice(g)) * D) * width + map.col(g, col) : 0);
      const auto load = [&](int j) {
        const int d = j << 3;
        float4 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && d + e < D) v[e] = *reinterpret_cast<const float4*>(src + (d + e) * width);
        }
        Chunks4 p;  // the transposition: chunk i holds column n0 + i's 8 depths
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&p.c[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            h[e] = __floats2bfloat162_rn(component(v[2 * e], i), component(v[2 * e + 1], i));
        }
        return p;
      };
      const auto store = [&](int j, const Chunks4& p) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<uint4*>(tile + swz(n0 + i, j << 3, N)) = p.c[i];
      };
      walk_depth<2>(tid / R, nthreads / R, k8n, load, store);
    } else {
      const int n = tid & (N - 1);
      const int g = n >> lg;
      const int64_t col = c0 + (n & (scg - 1));
      const bool live = g < ag && col < ncols;
      const float* __restrict__ src =
          x + (live ? (int64_t(map.slice(g)) * D) * width + map.col(g, col) : 0);
      const auto load = [&](int j) {
        const int d = j << 3;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = (live && d + e < D) ? src[(d + e) * width] : 0.f;
        uint4 p;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&p);
#pragma unroll
        for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
        return p;
      };
      const auto store = [&](int j, const uint4& p) {
        *reinterpret_cast<uint4*>(tile + swz(n, j << 3, N)) = p;
      };
      walk_depth<4>(tid / N, nthreads / N, k8n, load, store);
    }
  }
};

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, out [B, ncols] f32, qbf a
// [roundup(B, 128), roundup(D, 64)] bf16 scratch, and
// K4: store3t [g, D, ncols] f32, bias2 [g, ncols] f32;
// K5: store4 [nslice, D, gc*ncols] f32, bias4 [nslice, gc*ncols] f32 in the
//     interleave of width iw, iw | ncols;
// all contiguous device buffers. scg is the wrapper's plan
// (ops/gmin_scan.resident_plan for g, or nslice * gc, slices); a plan whose
// tile does not fit is refused. Launches the query rounding and the scan on
// `stream`, allocates nothing, does not synchronise; returns the CUDA error
// of the launches (0 = launched). qvec4: q rows 16-byte aligned with D % 4
// == 0; svec: the store's 16-byte aligned base.
extern "C" int nt_scores_launch(const void* q, const void* store3t, const void* bias2, void* qbf,
                                void* out, long long B, long long ncols, long long D, int g,
                                float alpha, int scg, int qvec4, int svec, void* stream) {
  const DepthMajorTile<Columns> tile{static_cast<const float*>(store3t), ncols, ncols, int(D),
                                     svec != 0 && ncols % 4 == 0, Columns{}};
  return launch_resident(tile, q, bias2, qbf, out, B, ncols, D, g, alpha, scg, qvec4 != 0,
                         stream);
}

extern "C" int c4_scores_launch(const void* q, const void* store4, const void* bias4, void* qbf,
                                void* out, long long B, long long ncols, long long D, int nslice,
                                int gc, long long iw, float alpha, int scg, int qvec4, int svec,
                                void* stream) {
  if (nslice < 1 || gc < 1 || nslice > G || gc > G || iw <= 0 || ncols <= 0 || ncols % iw != 0)
    return int(cudaErrorInvalidValue);
  const DepthMajorTile<Interleave> tile{static_cast<const float*>(store4), ncols, gc * ncols,
                                        int(D), svec != 0 && ncols % 4 == 0 && iw % 4 == 0,
                                        Interleave{iw, gc}};
  return launch_resident(tile, q, bias4, qbf, out, B, ncols, D, nslice * gc, alpha, scg,
                         qvec4 != 0, stream);
}

// The name of a CUDA error code, for the wrapper's exception message.
extern "C" const char* gmin_layouts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
