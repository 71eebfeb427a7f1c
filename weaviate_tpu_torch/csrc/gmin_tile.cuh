// The group-min tile loop of the profiler's layout kernels, K4 and K5 in
// gmin_layouts.cu (K1, K1-bf16, K2 and K3 run the resident-tile scan of
// gmin_resident.cuh). The two differ only in how they stage the store
// operand, a store laid out depth-major in both. The staging is a
// `Stager` object with one method,
//
//   __device__ void stage(__nv_bfloat16* dst, int g, int64_t c0, int64_t D,
//                         int64_t d0, int dk, int dkp) const;
//
// which fills dst with bf16 values of store slice g, columns c0 .. c0+BC,
// depth d0 .. d0+dkp, and zeros past ncols or past the live depth dk (zeros
// add nothing to a dot product). dst is laid out [DK depth x LDX pitch],
// one depth's run of columns per row, read as a row_major B operand (the
// layout of a [D, ncols] store, so a stager copies contiguous runs and
// transposes nothing).
//
// The bias of the loop's slice g and output column col is read at
// bias_offset(stager, g, col, ncols): row g of a [ag, ncols] bias by
// default. A stager whose columns lie elsewhere (K5's interleave) declares
// its own bias_offset overload beside it, found by argument-dependent
// lookup.
//
// What the loop computes, for queries q [B, D] f32 and a bias [16, ncols]
// f32 (slot g*ncols + c is member g of group c):
//
//     out[b, c] = min_{g < ag} ( bias[g, c] + alpha * <bf16(q_b), x[g, c]> )
//
// with the products accumulated in f32 on the tensor cores. Dead slots
// carry bias = +inf, which survives the sum and the min. Only the ag live
// slices are read.
//
// Design (simple first; wgmma, TMA and a persistent grid are later work):
// each block owns a [BQ x BC] output tile (BQ queries x BC group columns),
// 8 warps of 32 x 32 each. It loops over the ag member slices and, inside,
// over D in DK-wide stages held in shared memory as bf16; products run
// through nvcuda::wmma bf16 16x16x16 with f32 accumulators. After each
// slice the accumulators fold into a running min kept in registers: the
// slice's bias is staged as a 16-row tile (every row the same) and loaded
// into a fragment of the accumulator's own type, so bias, product and min
// line up element for element whatever the fragment layout. Query tiles
// vary fastest in the grid, so the blocks in flight at once share one
// column tile of the store and read it from L2. Ragged query and column
// edges are masked here (zero operands, +inf bias, no store), so callers
// never pad. Offsets are 64-bit: B * ncols reaches 2^30 at the main shape.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gmin {

using namespace nvcuda;

constexpr int G = 16;             // store slices (group size)
constexpr int BQ = 64;            // query rows per block
constexpr int BC = 128;           // group columns per block
constexpr int DK = 128;           // depth staged in shared memory per pass
constexpr int WARPS_Q = 2;
constexpr int WARPS_C = 4;
constexpr int WQ = BQ / WARPS_Q;  // 32 query rows per warp
constexpr int WC = BC / WARPS_C;  // 32 columns per warp
constexpr int FQ = WQ / 16;
constexpr int FC = WC / 16;
constexpr int THREADS = 32 * WARPS_Q * WARPS_C;
constexpr int LDS = DK + 8;       // bf16 row pitch of the operand tiles (wmma: multiple of 8)
constexpr int LDX = BC + 8;       // bf16 row pitch of the depth-major store tile
constexpr int LDB = BC + 4;       // f32 row pitch of the bias / output tiles (wmma: multiple of 4)

constexpr size_t Q_TILE_BYTES = size_t(BQ) * LDS * sizeof(__nv_bfloat16);
constexpr size_t X_TILE_BYTES = size_t(BC) * LDS * sizeof(__nv_bfloat16);
constexpr size_t BIAS_TILE_BYTES = size_t(16) * LDB * sizeof(float);
constexpr size_t SMEM_BYTES = Q_TILE_BYTES + X_TILE_BYTES + BIAS_TILE_BYTES;
static_assert(size_t(BQ) * LDB * sizeof(float) <= Q_TILE_BYTES + X_TILE_BYTES,
              "the output tile reuses the operand tiles' shared memory");
static_assert(Q_TILE_BYTES % 128 == 0 && X_TILE_BYTES % 128 == 0, "tile alignment");
static_assert((LDS * sizeof(__nv_bfloat16)) % 16 == 0, "16-byte aligned operand rows");
static_assert(size_t(DK) * LDX * sizeof(__nv_bfloat16) <= X_TILE_BYTES,
              "a depth-major store tile fits the store tile's shared memory");
static_assert((LDX * sizeof(__nv_bfloat16)) % 16 == 0, "16-byte aligned depth-major rows");

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// Stage rows [row0, row0 + ROWS) x depth [d0, d0 + dkp) of a row-major
// [nrows, D] f32 matrix into shared memory as bf16 (round to nearest
// even). Rows past nrows and depth past the live dk read as zero.
template <int ROWS>
__device__ __forceinline__ void stage_f32(__nv_bfloat16* dst, const float* __restrict__ src,
                                          int64_t row0, int64_t nrows, int64_t D, int64_t d0,
                                          int dk, int dkp, bool vec4) {
  if (vec4) {  // D % 4 == 0 and 16-byte aligned rows: one float4 per thread-step
    const int q4 = dkp >> 2;
    for (int idx = threadIdx.x; idx < ROWS * q4; idx += THREADS) {
      const int r = idx / q4;
      const int k = (idx - r * q4) << 2;
      const int64_t row = row0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < nrows && k < dk) v = *reinterpret_cast<const float4*>(src + row * D + d0 + k);
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(dst + r * LDS + k);
      p[0] = __floats2bfloat162_rn(v.x, v.y);
      p[1] = __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * dkp; idx += THREADS) {
      const int r = idx / dkp;
      const int k = idx - r * dkp;
      const int64_t row = row0 + r;
      const float v = (row < nrows && k < dk) ? src[row * D + d0 + k] : 0.f;
      dst[r * LDS + k] = __float2bfloat16_rn(v);
    }
  }
}

template <class Stager>
__device__ __forceinline__ int64_t bias_offset(const Stager&, int g, int64_t col, int64_t ncols) {
  return int64_t(g) * ncols + col;
}

template <class Stager>
__device__ __forceinline__ void gmin_tile(const Stager& xs, const float* __restrict__ q,
                                          const float* __restrict__ bias, float* __restrict__ out,
                                          int64_t B, int64_t ncols, int64_t D, int ag, float alpha,
                                          bool qvec4) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem + Q_TILE_BYTES);
  float* sb = reinterpret_cast<float*>(smem + Q_TILE_BYTES + X_TILE_BYTES);

  const int64_t b0 = int64_t(blockIdx.x) * BQ;
  const int64_t c0 = int64_t(blockIdx.y) * BC;
  const int warp = threadIdx.x >> 5;
  const int wq = warp / WARPS_C;
  const int wc = warp % WARPS_C;
  const int nstages = int((D + DK - 1) / DK);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FQ][FC];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> mn[FQ][FC];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> bfrag;
#pragma unroll
  for (int i = 0; i < FQ; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j) wmma::fill_fragment(mn[i][j], f32_inf());

  for (int g = 0; g < ag; ++g) {
#pragma unroll
    for (int i = 0; i < FQ; ++i)
#pragma unroll
      for (int j = 0; j < FC; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int s = 0; s < nstages; ++s) {
      const int64_t d0 = int64_t(s) * DK;
      const int dk = int(D - d0 < DK ? D - d0 : DK);
      const int dkp = (dk + 15) & ~15;
      __syncthreads();  // every warp is done reading the previous stage
      if (g == 0 || nstages > 1) stage_f32<BQ>(sq, q, b0, B, D, d0, dk, dkp, qvec4);
      xs.stage(sx, g, c0, D, d0, dk, dkp);
      if (s == 0) {
        for (int c = threadIdx.x; c < BC; c += THREADS) {
          const int64_t col = c0 + c;
          const float v = col < ncols ? bias[bias_offset(xs, g, col, ncols)] : f32_inf();
#pragma unroll
          for (int r = 0; r < 16; ++r) sb[r * LDB + c] = v;
        }
      }
      __syncthreads();
      for (int kk = 0; kk < dkp; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FQ];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm[FC];
#pragma unroll
        for (int i = 0; i < FQ; ++i)
          wmma::load_matrix_sync(a[i], sq + (wq * WQ + i * 16) * LDS + kk, LDS);
#pragma unroll
        for (int j = 0; j < FC; ++j)  // row-major B = the depth-major x tile as it is
          wmma::load_matrix_sync(bm[j], sx + kk * LDX + wc * WC + j * 16, LDX);
#pragma unroll
        for (int i = 0; i < FQ; ++i)
#pragma unroll
          for (int j = 0; j < FC; ++j) wmma::mma_sync(acc[i][j], a[i], bm[j], acc[i][j]);
      }
    }
    // fold slice g into the running min: bias + alpha * qx (alpha is -1 or
    // -2, so the fused multiply-add rounds exactly like the separate ops)
#pragma unroll
    for (int j = 0; j < FC; ++j) {
      wmma::load_matrix_sync(bfrag, sb + wc * WC + j * 16, LDB, wmma::mem_row_major);
#pragma unroll
      for (int i = 0; i < FQ; ++i)
#pragma unroll
        for (int e = 0; e < bfrag.num_elements; ++e)
          mn[i][j].x[e] = fminf(mn[i][j].x[e], fmaf(alpha, acc[i][j].x[e], bfrag.x[e]));
    }
  }

  // stage the minima through shared memory for masked, coalesced stores
  __syncthreads();
  float* so = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FQ; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j)
      wmma::store_matrix_sync(so + (wq * WQ + i * 16) * LDB + wc * WC + j * 16, mn[i][j], LDB,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * BC; idx += THREADS) {
    const int r = idx / BC;
    const int c = idx - r * BC;
    const int64_t row = b0 + r;
    const int64_t col = c0 + c;
    if (row < B && col < ncols) out[row * ncols + col] = so[r * LDB + c];
  }
}

// Launch `kernel` (a __global__ wrapper of gmin_tile) over the output
// grid on `stream`; returns the CUDA error of the launch (0 = launched).
template <class Kernel, class... Args>
inline int launch(Kernel kernel, long long B, long long ncols, void* stream, Args... args) {
  const long long grid_y = (ncols + BC - 1) / BC;
  if (grid_y > 65535) return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(unsigned((B + BQ - 1) / BQ), unsigned(grid_y));
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(args...);
  return int(cudaGetLastError());
}

}  // namespace gmin
