// The resident-tile group-min scan for Hopper (sm_90a), shared by all of
// the port's kernels: K1 (f32 store) and K1-bf16 (the bf16 rescore copy)
// in gmin_scan.cu, K2 (8-bit PQ codes) and K3 (nibble-packed 4-bit codes)
// in pq_gmin.cu, K4 (a depth-major f32 store) and K5 (the same, groups
// interleaved) in gmin_layouts.cu. They differ only in how a block fills
// its store tile and where the store's bias lies, which each says through
// a *filler* object with two methods,
//
//   template <int N>
//   __device__ void fill(unsigned char* tile, int64_t c0, int scg, int ag,
//                        int Dp, int tid, int nthreads) const;
//   __device__ int64_t bias_index(int g, int64_t col, int64_t ncols) const;
//
// fill writes the bf16 rows n = g * scg + c (slice g < N / scg, group
// column c0 + c) at swz(n, d, N), depth 0 .. Dp, zeros for slices >= ag,
// columns >= ncols and depth >= D, with threads tid of nthreads;
// bias_index is the element of the bias that slice g, group column col
// reads: g * ncols + col for every filler but K5's (they inherit it from
// the empty struct RowBias). Both are resolved at compile time, so the
// plain fillers' bias reads compile to what the fixed index did.
//
// What every kernel computes, for queries q [B, D] f32, a store viewed as
// x [16, ncols, D] (slot g * ncols + c is member g of group c) and a bias
// [16, ncols] f32:
//
//     out[b, c] = min_{g < ag} ( bias[g, c] + alpha * <bf16(q_b), x[g, c]> )
//
// with the products of bf16 operands accumulated in f32. l2: bias = ||x||^2,
// alpha = -2; dot/cosine: bias 0, alpha = -1; dead slots (tombstoned, past
// n, filtered out) carry bias = +inf, which survives the sum and the min.
//
// Design. The Pallas kernels keep a store tile in VMEM and the query tiles
// innermost, so the tile is built once per store tile and amortised over
// the whole batch. On Hopper the blocks run in parallel and nothing carries
// over between them, so the query loop moves inside the block: each block
// owns SCG group columns across S store slices, fills that tile once into
// shared memory (bf16 rows n = g * SCG + c, the depth zero-padded to Dp =
// roundup(D, 64)), and streams every query of the batch past it.
//
// S is the least power of two >= ag (the live slices), at most 16, and SCG
// = N / S, where N, the number of tile rows, is the wgmma width the tile's
// depth allows (256 up to D = 384, 128 up to D = 768, down to 16 up to D =
// 6208). Slices past ag are never multiplied in bulk: at ag <= 8 a block
// covers twice the columns, so a half-full store costs half the products
// and streams the queries half as often (the reference's BlockSpec loads
// only the live slices, weaviate_tpu/ops/gmin_scan.py:174-184).
//
// The queries are rounded to bf16 once per call by a small conversion
// kernel into a [Bp, Dp] scratch (rows padded to 128, zeros past B and D),
// so every row is 16-byte aligned whatever D is. Warp 8 is a producer: one
// thread issues TMA loads of [64 rows x 64 depth] query tiles into a ring of
// four 8 KB shared-memory stages, completing on mbarriers, and starts while
// the other warps fill the store tile (a ring of 16 stages, which D = 128
// leaves room for, measured alike on the card and is not kept). Warps 0-7
// are two consumer warpgroups; each owns every other 64-row query tile and
// two of the stages, and multiplies the tile by all N store rows with wgmma
// m64nNk16, A (the queries) and B (the resident tile) both read from shared
// memory through descriptors. TMA's 128-byte swizzle writes the query
// stages, and the filler writes the store tile in the same swizzled K-major
// layout (128-byte rows, 16-byte chunk j of row n at j ^ (n % 8)), so the
// descriptors of both are the canonical 128B-swizzle ones. The filler's
// ordinary stores are made visible to wgmma's async proxy by
// fence.proxy.async.shared::cta before the consumers' barrier. Each
// consumer walks its query tiles in an outer loop and the 64-deep chunks in
// an inner one, keeping one wgmma group in flight, and waits for all of them
// only after the inner loop, where the accumulators are read.
//
// The min over slices needs no shared memory: a thread's accumulators hold
// columns 2 * (lane % 4) + {0, 1} of every 8-wide chunk of the N store rows,
// and with rows g * SCG + c and SCG >= 8, chunk g * SCG / 8 + b holds slice
// g of the columns 8 b .., so min_g(bias + alpha * acc) is an in-register
// fminf over the chunks of one b; each halving of SCG below 8 adds one
// __shfl_xor. The epilogue is compiled for each S (a switch per query
// tile), so its indices and folds are constants (one that folded for a
// run-time SCG measured slower on the card), and it stores each column
// block's minima as soon as they are folded: the accumulators stay live
// into the next tile's wgmma, and at N = 256 they leave no room for more
// (minima held for all the blocks spilled, and ran slower at ag 8; folding
// in place into the accumulators ran slower at ag 16). The block's bias is
// read once: into registers (+inf for slices >= ag and columns >= ncols) up
// to N = 128; at N = 256 the 128 accumulators leave no room for it, and it
// is kept in shared memory. Each query tile stores its [rows x SCG] minima
// straight from registers, masked at the ragged edges (one 8-byte store
// per column pair measured slower on the card than two 4-byte stores).
//
// Shared memory: the tile N * Dp * 2 bytes, the 32 KB ring, the bias at N =
// 256 and 1 KB of barriers and alignment must fit the 227 KB a block may
// use.
// The wrappers compute the same plan (ops/gmin_scan.resident_plan), this
// side refuses a plan that does not fit, and the routers send the depths
// past it (D > 6208) to other scans (K4's and K5's wrappers raise there).
//
// The grid is one block per SCG group columns. A persistent grid of one
// block per SM walking the column tiles measured alike on the card (K2,
// K3) and is not kept.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int G = 16;              // store slices (group size)
constexpr int KC = 64;             // depth of one swizzled chunk (128 bytes of bf16)
constexpr int CHUNK_BYTES = KC * 2;
constexpr int QR = 64;             // query rows per tile: one wgmma M
constexpr int CONSUMERS = 2;       // consumer warpgroups, each with its own query tiles
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int STAGES = 2 * CONSUMERS;
constexpr int STAGE_BYTES = QR * CHUNK_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int SMEM_BIAS_WIDTH = 256;  // tiles this wide keep their bias in shared memory
constexpr int PAD_ROWS = 128;       // the scratch's rows are padded to a multiple of this
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may use on sm_90
constexpr int SMEM_RESERVE = 1024;  // barriers and the 1024-byte alignment of the tiles
static_assert(RING_BYTES == 32768 && STAGES == 4, "ops/gmin_scan.RING_BYTES, RING_STAGES");
static_assert(PAD_ROWS % (QR * CONSUMERS) == 0, "every consumer gets as many tiles");

// Shared memory of a tile of n rows at depth dp, with the ring.
__host__ __device__ constexpr long long smem_bytes(int n, long long dp) {
  return (long long)n * dp * 2 + RING_BYTES + (n >= SMEM_BIAS_WIDTH ? 4LL * n : 0) +
         SMEM_RESERVE;
}

// S: the least power of two >= ag.
inline int tile_slices(int ag) {
  int s = 1;
  while (s < ag) s *= 2;
  return s;
}

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (row n, depth d) in a swizzled tile of nrows
// rows: one [nrows x 128 B] block per 64-deep chunk, the 16-byte chunk j of
// row n stored at position j ^ (n % 8) (TMA's CU_TENSOR_MAP_SWIZZLE_128B).
__device__ __forceinline__ uint32_t swz(int n, int d, int nrows) {
  return uint32_t(d >> 6) * uint32_t(nrows * CHUNK_BYTES) + uint32_t(n) * CHUNK_BYTES +
         ((((d >> 3) & 7) ^ (n & 7)) << 4) + ((d & 7) << 1);
}

// The bias layout of every filler but K5's: row g of a [ag, ncols] bias.
struct RowBias {
  __device__ __forceinline__ int64_t bias_index(int g, int64_t col, int64_t ncols) const {
    return int64_t(g) * ncols + col;
  }
};

// The bias of tile row n: slice n / scg, group column c0 + n % scg (lg =
// log2 scg), at the filler's bias_index; +inf for slices >= ag and columns
// >= ncols.
template <class Filler>
__device__ __forceinline__ float row_bias(const Filler& filler, const float* __restrict__ bias,
                                          int n, int lg, int scg, int64_t c0, int64_t ncols,
                                          int ag) {
  const int g = n >> lg;
  const int64_t col = c0 + (n & (scg - 1));
  return (g < ag && col < ncols) ? bias[filler.bias_index(g, col, ncols)] : f32_inf();
}

// The block's bias in registers, once: accumulator 4 i + {0, 1} (and +
// {2, 3}, 8 rows down) is column 2 (lane % 4) + {0, 1} of chunk i, tile row
// n = 8 i + 2 (lane % 4) + jj.
template <int N, class Filler>
__device__ __forceinline__ void load_bias(float (&br)[N / 4], const Filler& filler,
                                          const float* __restrict__ bias, int lg, int scg,
                                          int64_t c0, int64_t ncols, int ag, int lane) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      br[2 * i + jj] =
          row_bias(filler, bias, 8 * i + 2 * (lane & 3) + jj, lg, scg, c0, ncols, ag);
}

// Fold one warp's 16 query rows x N accumulators (wgmma's layout:
// accumulator 4 i + 2 h + jj is query row lane / 4 + 8 h, tile row 8 i + 2
// (lane % 4) + jj) into [16 x SCG] minima and store them, one 8-column
// block at a time. With SCG >= 8,
// chunk i = g * SCG / 8 + b is slice g, columns 8 b .., so the min over
// slices is an in-register fminf over the chunks of one b; below 8 every
// chunk folds into one, and each halving of SCG adds one __shfl_xor. alpha
// is -1 or -2, so the fused multiply-add rounds exactly like the separate
// ops. The bias comes from br (registers) or, when SMEM_BIAS, from bias_s
// (shared memory, by tile row).
template <int N, int SCG, bool SMEM_BIAS>
__device__ __forceinline__ void store_minima(const float (&acc)[N / 2],
                                             const float (&br)[SMEM_BIAS ? 1 : N / 4],
                                             const float* bias_s, float alpha,
                                             float* __restrict__ out, int64_t row0, int64_t B,
                                             int64_t c0, int64_t ncols, int lane) {
  constexpr int NB = SCG >= 8 ? SCG / 8 : 1;  // output chunks
  constexpr int NG = N / 8 / NB;              // chunks folded into each
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float v[2][2] = {{f32_inf(), f32_inf()}, {f32_inf(), f32_inf()}};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int i = g * NB + b;
      float b0, b1;
      if constexpr (SMEM_BIAS) {
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + 8 * i + 2 * (lane & 3));
        b0 = bb.x;
        b1 = bb.y;
      } else {
        b0 = br[2 * i];
        b1 = br[2 * i + 1];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h][0] = fminf(v[h][0], fmaf(alpha, acc[4 * i + 2 * h], b0));
        v[h][1] = fminf(v[h][1], fmaf(alpha, acc[4 * i + 2 * h + 1], b1));
      }
    }
    // SCG < 8: rows r = 2 (lane % 4) + jj of chunk 0 are slice r / SCG,
    // column r % SCG; fold across the lanes of a quad, then the pair
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (SCG <= 4) v[h][jj] = fminf(v[h][jj], __shfl_xor_sync(0xffffffffu, v[h][jj], 2));
        if (SCG <= 2) v[h][jj] = fminf(v[h][jj], __shfl_xor_sync(0xffffffffu, v[h][jj], 1));
      }
    if (SCG == 1) {
      v[0][0] = fminf(v[0][0], v[0][1]);
      v[1][0] = fminf(v[1][0], v[1][1]);
    }
    // stored at once, so one column block's minima are live at a time
    const int c = 8 * b + 2 * (lane & 3);
    if (c >= SCG) continue;
    const int64_t col = c0 + c;
    const bool second = c + 1 < SCG && col + 1 < ncols;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t row = row0 + (lane >> 2) + 8 * h;
      if (row >= B || col >= ncols) continue;
      float* p = out + row * ncols + col;
      p[0] = v[h][0];
      if (second) p[1] = v[h][1];
    }
  }
}

// store_minima for the block's SCG = N / S, chosen at run time.
template <int N, bool SMEM_BIAS>
__device__ __forceinline__ void store_tile_minima(const float (&acc)[N / 2],
                                                  const float (&br)[SMEM_BIAS ? 1 : N / 4],
                                                  const float* bias_s, float alpha,
                                                  float* __restrict__ out, int64_t row0,
                                                  int64_t B, int64_t c0, int64_t ncols, int scg,
                                                  int lane) {
  switch (N / scg) {
    case 16:
      return store_minima<N, N / 16, SMEM_BIAS>(acc, br, bias_s, alpha, out, row0, B, c0, ncols,
                                                lane);
    case 8:
      return store_minima<N, N / 8, SMEM_BIAS>(acc, br, bias_s, alpha, out, row0, B, c0, ncols,
                                               lane);
    case 4:
      return store_minima<N, N / 4, SMEM_BIAS>(acc, br, bias_s, alpha, out, row0, B, c0, ncols,
                                               lane);
    case 2:
      return store_minima<N, N / 2, SMEM_BIAS>(acc, br, bias_s, alpha, out, row0, B, c0, ncols,
                                               lane);
    default:
      return store_minima<N, N, SMEM_BIAS>(acc, br, bias_s, alpha, out, row0, B, c0, ncols,
                                           lane);
  }
}

// -- mbarriers, TMA and wgmma (PTX) ------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// A stage is turned over in microseconds; one not released in this long
// means the ring's protocol is broken.
constexpr uint64_t WAIT_LIMIT_NS = 10'000'000'000ULL;

// mbar_wait that traps past WAIT_LIMIT_NS, so a ring that stops turning
// fails the launch instead of holding the card. Only the producer uses it:
// a ring that stops leaves the producer waiting for a free stage, and in
// the consumers the timer's registers cost the wide tiles a spill (16
// bytes at N 256) and 6-14% of their time (measured on the card).
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int x, int y,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: start address, leading offset 1 (unused for this layout),
// stride 1024 bytes between 8-row groups, swizzle mode 1 (128B). The tile
// starts 1024-byte aligned; a k16 step within it adds 32 bytes (2 units)
// to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float (&d)[128], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<16>(float (&d)[8], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keep the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma (a register-level fence, no instruction).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <class Filler, int N>
__global__ void __launch_bounds__(THREADS, 1)
resident_kernel(__grid_constant__ const CUtensorMap qmap, const Filler filler,
                const float* __restrict__ bias, float* __restrict__ out, int64_t B, int64_t Bp,
                int64_t ncols, int Dp, int ag, int scg, float alpha) {
  constexpr bool SMEM_BIAS = N >= SMEM_BIAS_WIDTH;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* tile = smem_raw + pad;
  unsigned char* ring = tile + size_t(N) * Dp * 2;
  float* bias_s = reinterpret_cast<float*>(ring + RING_BYTES);
  // the 2 * STAGES mbarriers: in the alignment pad when it has room, else
  // after the ring and the bias (SMEM_RESERVE covers either)
  const uint32_t full0 =
      smem_u32(pad >= 16 * STAGES ? static_cast<void*>(smem_raw)
                                  : static_cast<void*>(bias_s + (SMEM_BIAS ? N : 0)));
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t c0 = int64_t(blockIdx.x) * scg;
  const int lg = __ffs(scg) - 1;
  const int nkc = Dp / KC;
  const int ntl = int(Bp / (QR * CONSUMERS));  // query tiles per consumer

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // lane 0 of each warp of the consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Step u counts a consumer's (query tile, depth chunk) steps; consumer
  // w's step u uses stage w + 2 (u % 2).
  if (warp == 4 * CONSUMERS) {  // the producer
    if (lane == 0) {
      uint32_t u = 0;
      for (int tl = 0; tl < ntl; ++tl)
        for (int kc = 0; kc < nkc; ++kc, ++u)
          for (int w = 0; w < CONSUMERS; ++w) {
            const int s = w + CONSUMERS * (u & 1);
            mbar_wait_bounded(empty0 + 8 * s, ((u >> 1) & 1) ^ 1);
            mbar_expect_tx(full0 + 8 * s, STAGE_BYTES);
            tma_load_2d(smem_u32(ring + s * STAGE_BYTES), &qmap, kc * KC,
                        (tl * CONSUMERS + w) * QR, full0 + 8 * s);
          }
    }
    return;
  }

  // the consumers: fill the store tile once, then stream the queries past it
  filler.template fill<N>(tile, c0, scg, ag, Dp, threadIdx.x, 128 * CONSUMERS);
  if constexpr (SMEM_BIAS) {
    for (int n = threadIdx.x; n < N; n += 128 * CONSUMERS)
      bias_s[n] = row_bias(filler, bias, n, lg, scg, c0, ncols, ag);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
  float br[SMEM_BIAS ? 1 : N / 4];
  if constexpr (!SMEM_BIAS) load_bias<N>(br, filler, bias, lg, scg, c0, ncols, ag, lane);

  const int wg = warp >> 2;
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t tile_s = smem_u32(tile);
  float acc[N / 2] = {};
  uint32_t u = 0;
  for (int tl = 0; tl < ntl; ++tl) {
    for (int kc = 0; kc < nkc; ++kc, ++u) {
      const int s = wg + CONSUMERS * (u & 1);
      mbar_wait(full0 + 8 * s, (u >> 1) & 1);
      const uint64_t da = sw128_desc(ring_s + s * STAGE_BYTES);
      const uint64_t db = sw128_desc(tile_s + kc * (N * CHUNK_BYTES));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < KC / 16; ++k)
        wgmma_bf16<N>(acc, da + 2 * k, db + 2 * k, (kc | k) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the previous step's products are done: release its stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (kc > 0 && lane == 0) mbar_arrive(empty0 + 8 * (wg + CONSUMERS * ((u - 1) & 1)));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * (wg + CONSUMERS * ((u - 1) & 1)));
    store_tile_minima<N, SMEM_BIAS>(acc, br, bias_s, alpha, out,
                                    int64_t(tl * CONSUMERS + wg) * QR + (warp & 3) * 16, B,
                                    c0, ncols, scg, lane);
  }
}

// q [B, D] f32 -> qbf [Bp, Dp] bf16, round to nearest even, zeros past B
// and D. vec4: q rows 16-byte aligned with D % 4 == 0.
__global__ void round_queries(const float* __restrict__ q, __nv_bfloat16* __restrict__ qbf,
                              int64_t B, int64_t Bp, int D, int Dp, bool vec4) {
  const int k8n = Dp >> 3;
  const int64_t total = Bp * k8n;
  for (int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
       idx += int64_t(gridDim.x) * blockDim.x) {
    const int64_t r = idx / k8n;
    const int d = int(idx - r * k8n) << 3;
    float v[8];
    if (r < B && vec4 && d + 8 <= D) {
      const float4 lo = *reinterpret_cast<const float4*>(q + r * D + d);
      const float4 hi = *reinterpret_cast<const float4*>(q + r * D + d + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = (r < B && d + e < D) ? q[r * D + d + e] : 0.f;
    }
    uint4 w;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
    for (int e = 0; e < 4; ++e) p[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(qbf + r * Dp + d) = w;
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against libcuda); null if the driver does not offer it.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

template <class Filler, int N>
int launch_width(const CUtensorMap& qmap, const Filler& filler, const float* bias, float* out,
                 long long B, long long Bp, long long ncols, int Dp, int ag, int scg,
                 float alpha, cudaStream_t stream) {
  const int smem = int(smem_bytes(N, Dp));
  cudaError_t err = cudaFuncSetAttribute(resident_kernel<Filler, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const long long grid = (ncols + scg - 1) / scg;
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  resident_kernel<Filler, N><<<unsigned(grid), THREADS, smem, stream>>>(
      qmap, filler, bias, out, B, Bp, ncols, Dp, ag, scg, alpha);
  return int(cudaGetLastError());
}

// Round q into the scratch qbf and launch the scan of `filler`'s store on
// `stream` with the plan (scg group columns per block, so N = S * scg tile
// rows); a plan whose tile does not fit is refused.
// Allocates nothing, does not synchronise; returns the CUDA error of the
// launches (0 = launched).
template <class Filler>
int launch_resident(const Filler& filler, const void* q, const void* bias, void* qbf, void* out,
                    long long B, long long ncols, long long D, int ag, float alpha, int scg,
                    bool qvec4, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || ag < 1 || ag > G || D > (1 << 20) || B > (1LL << 30) ||
      scg < 1)
    return int(cudaErrorInvalidValue);
  const int n = tile_slices(ag) * scg;
  const int Dp = int((D + KC - 1) / KC * KC);
  if ((n != 16 && n != 32 && n != 64 && n != 128 && n != 256) || smem_bytes(n, Dp) > SMEM_LIMIT)
    return int(cudaErrorInvalidValue);
  const long long Bp = (B + PAD_ROWS - 1) / PAD_ROWS * PAD_ROWS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* qb = static_cast<__nv_bfloat16*>(qbf);

  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  CUtensorMap qmap;
  const cuuint64_t dims[2] = {cuuint64_t(Dp), cuuint64_t(Bp)};
  const cuuint64_t strides[1] = {cuuint64_t(Dp) * 2};
  const cuuint32_t box[2] = {KC, QR};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qbf, dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);

  const long long groups = Bp * (Dp / 8);
  const int rblocks = int(groups / 256 + 1 < 4096 ? groups / 256 + 1 : 4096);
  round_queries<<<rblocks, 256, 0, st>>>(static_cast<const float*>(q), qb, B, Bp, int(D), Dp,
                                         qvec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  switch (n) {
    case 256: return launch_width<Filler, 256>(qmap, filler, bs, o, B, Bp, ncols, Dp, ag, scg,
                                               alpha, st);
    case 128: return launch_width<Filler, 128>(qmap, filler, bs, o, B, Bp, ncols, Dp, ag, scg,
                                               alpha, st);
    case 64: return launch_width<Filler, 64>(qmap, filler, bs, o, B, Bp, ncols, Dp, ag, scg,
                                             alpha, st);
    case 32: return launch_width<Filler, 32>(qmap, filler, bs, o, B, Bp, ncols, Dp, ag, scg,
                                             alpha, st);
    default: return launch_width<Filler, 16>(qmap, filler, bs, o, B, Bp, ncols, Dp, ag, scg,
                                             alpha, st);
  }
}

}  // namespace
