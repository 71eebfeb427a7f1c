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
// Design. The Pallas kernels rebuild each store tile once into VMEM scratch
// and keep the query tiles innermost, so the rebuild amortises over the
// whole batch. On Hopper the blocks run in parallel and nothing carries
// over between them, so the query loop moves inside the block: each block
// owns SCG group columns across all 16 slices, decodes that store tile
// once into shared memory (bf16 rows n = g * SCG + c, the full depth
// zero-padded to Dp = roundup(D, 64)), and streams every query of the
// batch past it. The decode is a lookup, not the TPU's one-hot product:
// one 16-byte centroid load per 8 elements when ds % 8 == 0, element by
// element otherwise; it reads the codebook through L1/L2 (384 KB at M =
// 96, C = 256) once per element of the tile, not once per query tile.
//
// The queries are rounded to bf16 once per call by a small conversion
// kernel into a [Bp, Dp] scratch (rows padded to 128, zeros past B and D),
// so every row is 16-byte aligned whatever D is. Warp 8 is a producer: one
// thread issues TMA loads of [64 rows x 64 depth] query tiles into a ring
// of four shared-memory stages, completing on mbarriers, and starts while
// the other warps decode. Warps 0-7 are two consumer warpgroups; each owns
// every other 64-row query tile and two of the stages, and multiplies the
// tile by all N = 16 * SCG store rows with wgmma m64nNk16, A (the queries)
// and B (the resident tile) both read from shared memory through
// descriptors. TMA's 128-byte swizzle writes the query stages, and the
// decode writes the store tile in the same swizzled K-major layout (128-
// byte rows, 16-byte chunk j of row n at j ^ (n % 8)), so the descriptors
// of both are the canonical 128B-swizzle ones. The decode's ordinary
// stores are made visible to wgmma's async proxy by
// fence.proxy.async.shared::cta before the consumers' barrier. Each
// consumer walks its query tiles in an outer loop and the 64-deep chunks in
// an inner one, keeping one wgmma group in flight, and waits for all of
// them only after the inner loop, where the accumulators are read.
//
// The grid is one block per column tile. A persistent grid of one block
// per SM walking the column tiles measured alike on the card and is not
// kept.
//
// The min over slices needs no shared memory: a thread's accumulators hold
// columns 2 * (lane % 4) + {0, 1} of every 8-wide chunk of the N store
// rows, and with rows g * SCG + c and SCG = 8 chunk i is slice i, so
// min_g(bias + alpha * acc) is an in-register fminf over the chunks; each
// halving of SCG adds one __shfl_xor. The block's 16 * SCG bias values
// are loaded into registers once (+inf for slices >= ag and columns >=
// ncols), and each query tile stores its [rows x SCG] minima straight from
// registers, masked at the ragged edges.
//
// Shared memory: the tile 16 * SCG * Dp * 2 bytes plus the 32 KB ring must
// fit the 227 KB a block may use; SCG is the largest of 8, 4, 2, 1 that
// does (8 at D = 768: 192 KB; 1 up to D = 6208). The wrapper computes the
// same plan (ops/pq_gmin.codes_plan) and routes wider shapes elsewhere.

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
constexpr int PAD_ROWS = 128;       // the scratch's rows are padded to a multiple of this
constexpr int SMEM_LIMIT = 232448;  // shared memory one block may use on sm_90
constexpr int SMEM_RESERVE = 1024;  // barriers and the 1024-byte alignment of the tiles
static_assert(RING_BYTES == 32768 && STAGES == 4, "ops/pq_gmin.RING_BYTES, RING_STAGES");
static_assert(PAD_ROWS % (QR * CONSUMERS) == 0, "every consumer gets as many tiles");

__host__ __device__ constexpr long long tile_bytes(int scg, long long dp) {
  return (long long)(G) * scg * dp * 2;
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

// code of segment s in a row of codes. BITS = 8: one byte per segment;
// BITS = 4: byte s mod (M/2), high nibble iff s >= M/2.
template <int BITS>
__device__ __forceinline__ int code_at(const uint8_t* row, int s, int M) {
  if (BITS == 8) return row[s];
  const int mb = M >> 1;
  const int byte = row[s < mb ? s : s - mb];
  return s < mb ? (byte & 15) : (byte >> 4);
}

// Decode the block's store tile once, with threads tid of nthreads: rows n
// = g * SCG + c (slice g, group column c0 + c), depth 0 .. Dp, zeros for
// slices >= ag, columns >= ncols and depth >= D.
template <int BITS, int SCG>
__device__ void decode_tile(unsigned char* tile, const uint8_t* __restrict__ codes,
                            const __nv_bfloat16* __restrict__ cb, int64_t c0, int64_t ncols,
                            int D, int Dp, int M, int C, int ds, int ag, bool vec, int tid,
                            int nthreads) {
  constexpr int N = G * SCG;
  const int rb = BITS == 8 ? M : M / 2;
  if (vec) {  // ds % 8 == 0: each 8-element step lies inside one segment
    const int k8n = Dp >> 3;
    for (int idx = tid; idx < N * k8n; idx += nthreads) {
      const int n = idx / k8n;
      const int d = (idx - n * k8n) << 3;
      const int g = n / SCG;
      const int64_t col = c0 + (n % SCG);
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
      const int g = n / SCG;
      const int64_t col = c0 + (n % SCG);
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

// The block's bias, once: accumulator 4 i + {0, 1} (and + {2, 3}, 8 rows
// down) is column 2 (lane % 4) + {0, 1} of chunk i, store row n = 8 i +
// 2 (lane % 4) + jj: slice n / SCG, group column n % SCG.
template <int SCG>
__device__ __forceinline__ void load_bias(float (&br)[4 * SCG], const float* __restrict__ bias,
                                          int64_t c0, int64_t ncols, int ag, int lane) {
#pragma unroll
  for (int i = 0; i < 2 * SCG; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int n = 8 * i + 2 * (lane & 3) + jj;
      const int g = n / SCG;
      const int64_t col = c0 + n % SCG;
      br[2 * i + jj] = (g < ag && col < ncols) ? bias[int64_t(g) * ncols + col] : f32_inf();
    }
}

// Fold one warp's 16 query rows x N accumulators (wgmma's layout: rows
// lane / 4 and lane / 4 + 8) into [16 x SCG] minima and store them. alpha
// is -1 or -2, so the fused multiply-add rounds exactly like the separate
// ops.
template <int SCG>
__device__ __forceinline__ void store_minima(const float (&acc)[8 * SCG],
                                             const float (&br)[4 * SCG], float alpha,
                                             float* __restrict__ out, int64_t row0, int64_t B,
                                             int64_t c0, int64_t ncols, int lane) {
  float m[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      float v = f32_inf();
#pragma unroll
      for (int i = 0; i < 2 * SCG; ++i)
        v = fminf(v, fmaf(alpha, acc[4 * i + 2 * h + jj], br[2 * i + jj]));
      m[h][jj] = v;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (SCG == 1) m[h][0] = fminf(m[h][0], m[h][1]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      if (SCG <= 4) m[h][jj] = fminf(m[h][jj], __shfl_xor_sync(0xffffffffu, m[h][jj], 2));
      if (SCG <= 2) m[h][jj] = fminf(m[h][jj], __shfl_xor_sync(0xffffffffu, m[h][jj], 1));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row0 + (lane >> 2) + 8 * h;
    if (row >= B) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int c = 2 * (lane & 3) + jj;
      const int64_t col = c0 + c;
      if (c < SCG && col < ncols) out[row * ncols + col] = m[h][jj];
    }
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

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
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

template <int BITS, int SCG>
__global__ void __launch_bounds__(THREADS, 1)
pq_gmin_kernel(__grid_constant__ const CUtensorMap qmap, const uint8_t* __restrict__ codes,
               const float* __restrict__ bias, const __nv_bfloat16* __restrict__ cb,
               float* __restrict__ out, int64_t B, int64_t Bp, int64_t ncols, int D, int Dp,
               int M, int C, int ag, float alpha, bool cbvec) {
  constexpr int N = G * SCG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  unsigned char* tile = smem_raw + pad;
  unsigned char* ring = tile + tile_bytes(SCG, Dp);
  // the 2 * STAGES mbarriers: in the alignment pad when it has room, else
  // after the ring (SMEM_RESERVE covers either)
  const uint32_t full0 = smem_u32(pad >= 16 * STAGES ? smem_raw : ring + RING_BYTES);
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t c0 = int64_t(blockIdx.x) * SCG;
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
      for (uint32_t u = 0; u < uint32_t(ntl * nkc); ++u) {
        const int tl = u / nkc;
        const int kc = u - tl * nkc;
        for (int w = 0; w < CONSUMERS; ++w) {
          const int s = w + CONSUMERS * (u & 1);
          mbar_wait(empty0 + 8 * s, ((u >> 1) & 1) ^ 1);
          mbar_expect_tx(full0 + 8 * s, STAGE_BYTES);
          tma_load_2d(smem_u32(ring + s * STAGE_BYTES), &qmap, kc * KC,
                      (tl * CONSUMERS + w) * QR, full0 + 8 * s);
        }
      }
    }
    return;
  }

  // the consumers: decode the store tile once, then stream the queries past it
  decode_tile<BITS, SCG>(tile, codes, cb, c0, ncols, D, Dp, M, C, D / M, ag,
                         cbvec && (D / M) % 8 == 0, threadIdx.x, 128 * CONSUMERS);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory");
  float br[4 * SCG];
  load_bias<SCG>(br, bias, c0, ncols, ag, lane);

  const int wg = warp >> 2;
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t tile_s = smem_u32(tile);
  float acc[8 * SCG] = {};
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
    store_minima<SCG>(acc, br, alpha, out, int64_t(tl * CONSUMERS + wg) * QR + (warp & 3) * 16,
                      B, c0, ncols, lane);
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

template <int BITS, int SCG>
int launch_scg(const CUtensorMap& qmap, const uint8_t* codes, const float* bias,
               const __nv_bfloat16* cb, float* out, long long B, long long Bp, long long ncols,
               int D, int Dp, int M, int C, int ag, float alpha, bool cbvec,
               cudaStream_t stream) {
  const int smem = int(tile_bytes(SCG, Dp)) + RING_BYTES + SMEM_RESERVE;
  cudaError_t err = cudaFuncSetAttribute(pq_gmin_kernel<BITS, SCG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return int(err);
  const long long grid = (ncols + SCG - 1) / SCG;
  if (grid > 0x7fffffffLL) return int(cudaErrorInvalidValue);
  pq_gmin_kernel<BITS, SCG><<<unsigned(grid), THREADS, smem, stream>>>(
      qmap, codes, bias, cb, out, B, Bp, ncols, D, Dp, M, C, ag, alpha, cbvec);
  return int(cudaGetLastError());
}

template <int BITS>
int launch_codes(const void* q, const void* codes, const void* bias, const void* cb, void* qbf,
                 void* out, long long B, long long ncols, long long D, int M, int C, int ag,
                 float alpha, int scg, int qvec4, int cbvec, void* stream) {
  if (B <= 0 || ncols <= 0 || D <= 0 || M <= 0 || D % M != 0 || C <= 0 || ag < 1 || ag > G ||
      D > (1 << 20) || B > (1LL << 30))
    return int(cudaErrorInvalidValue);
  if ((BITS == 8 && C > 256) || (BITS == 4 && (C > 16 || M % 2 != 0)))
    return int(cudaErrorInvalidValue);
  const int Dp = int((D + KC - 1) / KC * KC);
  if ((scg != 1 && scg != 2 && scg != 4 && scg != 8) ||
      tile_bytes(scg, Dp) + RING_BYTES + SMEM_RESERVE > SMEM_LIMIT)
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
                                         qvec4 != 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const auto* cd = static_cast<const uint8_t*>(codes);
  const auto* bs = static_cast<const float*>(bias);
  const auto* cbb = static_cast<const __nv_bfloat16*>(cb);
  auto* o = static_cast<float*>(out);
  const bool vec = cbvec != 0;
  const int d = int(D);
  switch (scg) {
    case 8: return launch_scg<BITS, 8>(
          qmap, cd, bs, cbb, o, B, Bp, ncols, d, Dp, M, C, ag, alpha,
          vec, st);
    case 4: return launch_scg<BITS, 4>(
          qmap, cd, bs, cbb, o, B, Bp, ncols, d, Dp, M, C, ag, alpha,
          vec, st);
    case 2: return launch_scg<BITS, 2>(
          qmap, cd, bs, cbb, o, B, Bp, ncols, d, Dp, M, C, ag, alpha,
          vec, st);
    default: return launch_scg<BITS, 1>(
          qmap, cd, bs, cbb, o, B, Bp, ncols, d, Dp, M, C, ag, alpha,
          vec, st);
  }
}

}  // namespace

// C interface, loaded with ctypes. q [B, D] f32, codes [16, ncols, M]
// uint8 (pq8) or [16, ncols, M/2] uint8 (pq4), bias [16, ncols] f32,
// codebook [M, C, D/M] bf16, qbf a [roundup(B, 128), roundup(D, 64)] bf16
// scratch, out [B, ncols] f32: contiguous device buffers. scg is the
// wrapper's plan (ops/pq_gmin.codes_plan); a plan whose tile does not fit
// is refused. Launches the query rounding and the scan (one block per SCG
// group columns) on `stream`, allocates nothing, does not synchronise;
// returns the CUDA error of the launches (0 = launched). qvec4: q rows
// 16-byte aligned with D % 4 == 0; cbvec: the codebook's base is 16-byte
// aligned.
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
