// Weight-only int8 GEMM for Hopper (sm_90a): y = (x @ q^T) * s.
//
// x [M, K] activations (row-major), q [N, K] int8 weights (the
// checkpoint's [out, in] layout: each output channel's K weights are
// contiguous), s [N] float32 per-output-channel scales, y [M, N] in x's
// dtype. Sums in float32, the scale applied once in the epilogue, one
// rounding to y's dtype.
//
// What it stands for: QuantInt8.__rmatmul__ of the JAX package
// (dynamo_tpu/models/quant.py:87-92), `(x @ q.astype(x.dtype)) * s`, which
// XLA fuses into one dot whose weight operand is widened on chip, so the
// widened weights never exist in device memory. There is no Pallas kernel
// behind it. PyTorch has no such fusion: `x @ q.to(bf16)` writes a bf16
// copy of the weights and reads it back, more bytes than the bf16 path.
// Plain C entries return cudaGetLastError() (or the launch's own error)
// and are loaded with ctypes by dynamo_tpu_torch/ops/int8_gemm.py, which
// picks the route, the tile, the splits and the grid from the shape alone
// (int8_gemm_plan).
//
// What bounds it on an H100 SXM. Decode (M <= 64 rows) does 2M operations
// per weight byte: at most 128, below the ~295 operations per byte where
// 989 TF/s would bind, so it is bound by the bytes of q (K x N) at
// 3.35 TB/s. A prefill chunk of 512 or more rows is bound by the tensor
// cores (989 TF/s, which only wgmma reaches).
//
// Three routes. The two bf16 routes widen the weights to bf16 on chip, in
// registers, never in device memory: int8 -127..127 is exact in bf16. The widening
// (widen_i8x4) is a byte permute into the mantissa of 2^23 and a
// subtraction per value, and one byte permute per pair (cvt to bf16x2
// issues at a quarter of the integer rate).
// * small_m (route 0, bf16 x, decode rows), mma.sync m16n8k16 (bf16 in,
//   f32 accumulate): the contraction order within each 64-wide chunk of K
//   is permuted, the same way for both operands, so that every lane of a
//   quad loads its column's weights as one 16-byte load: lane (g, t)
//   holds k = 16t .. 16t + 15 of the chunk for column g, and in step j of
//   the chunk feeds k = 16t + 4j .. 16t + 4j + 3 where the fragment
//   layout names k' = 2t, 2t + 1, 2t + 8, 2t + 9. Its A fragment takes x
//   at the same k, which is again contiguous (8 bytes a row a step). No
//   shared memory and no shuffles stand between device memory and the
//   tensor cores. A block is four warps on 32 output columns; the warps
//   take interleaved 64-wide chunks of the block's share of K, each with
//   the next chunk's weights in flight while it computes the current
//   one. K is also split over the S <= 8 blocks of one thread-block
//   cluster, folded through distributed shared memory in a fixed order.
// * wgmma (route 1, bf16 x: prefill chunks, decode batches above the
//   measured crossover and the widest decode products): the product is
//   computed transposed, y^T = q x^T, so that the weights are wgmma's A
//   operand, from registers, and the tokens its N (16 .. 256). A block
//   is a producer warpgroup and two consumer warpgroups on a tile of 128
//   output channels (64 a warpgroup) by BT tokens; setmaxnreg moves the
//   producer's registers to the consumers (40 and 232 a thread), so the
//   256-token tile's 128 accumulators a thread do not spill. One
//   producer thread keeps a ring of stages in flight with TMA, each a
//   [BT, 64] bf16 tile of x (128-byte swizzle, the K-major B operand of
//   wgmma m64nBTk16) and a [128, 64] int8 tile of q (64-byte swizzle),
//   completion counted in bytes on the stage's full mbarrier; the
//   consumers release a stage on its empty mbarrier once its wgmmas have
//   completed. A consumer thread gathers its A fragment (k = 2t, 2t + 1,
//   2t + 8, 2t + 9 of rows g and g + 8 in each k16 step) with two 32-bit
//   shared loads and one byte permute a row and step (the swizzle makes
//   them conflict-free), widens it in registers, and issues the chunk's
//   four wgmmas while one (BT >= 128) or two (BT <= 64) earlier chunks'
//   are still running, each with its own A fragment registers. The grid
//   is persistent: each cluster walks the tiles tile = cluster + i *
//   clusters, tokens fastest (neighbouring tiles share their weights
//   through L2), as many clusters as the card holds at once. Where the
//   tiles are too few to fill the card, K is split over the S <= 8
//   blocks of one cluster: each block writes its partial sums to shared
//   memory and the blocks fold them through distributed shared memory in
//   rank order. No atomics and no global counters: a replayed CUDA graph
//   gives the eager call's bits.
// * simt (route 2, float32 and float16 x): an untuned tiled loop in
//   float32 FMAs, for the models that are not served in bf16 (the tiny
//   preset is float32).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- helpers

// mma.sync m16n8k16, bf16 in, f32 accumulate: d += a b
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// four int8 (one 32-bit word, lowest byte first) as two bf16 pairs: lo
// holds bytes 0, 1 and hi bytes 2, 3, the lower byte in the lower half.
// Each byte, offset to 0..255, becomes the low mantissa byte of 2^23;
// subtracting 2^23 + 128 gives the signed value exactly, and its upper
// 16 bits are that value in bf16 (exact: 8 significant bits at most), so
// a byte permute packs two of them (no conversion unit: cvt to bf16x2
// issues at a quarter of the integer and float rates).
__device__ __forceinline__ void widen_i8x4(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes of weights, read once: no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// the cluster's barrier (release/acquire: shared-memory writes before it
// are seen by reads after it, across the cluster's blocks), its relaxed
// form, and loads from a peer's shared memory
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n"
               "barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t dsmem_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_dsmem(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_dsmem_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void store_out(__nv_bfloat16* y, int M, int N,
                                          int m, int n, float v) {
  if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
}

// ------------------------------------------------------- route 0: small M

constexpr int SM_THREADS = 128;  // four warps
constexpr int SM_WARPS = SM_THREADS / 32;
constexpr int SM_TILE_N = 32;    // output columns a block (four n8 tiles)
constexpr int SM_NT = SM_TILE_N / 8;
constexpr int CHUNK_K = 64;
constexpr int SM_RED_LD = 36;    // floats a row of the warps' partials
constexpr int MAX_SPLITS = 8;    // one cluster: the portable maximum

// grid (ceil(N / 32), S), clusters (1, S, 1): the S blocks of a cluster
// split the 64-wide chunks of K of one 32-column tile, block r taking
// chunks [r * cps, (r + 1) * cps). MT m16 tiles cover rows 0 .. 16 MT - 1
// (rows >= M are zeros and never stored).
template <int MT>
__global__ void __launch_bounds__(SM_THREADS)
int8_gemm_small_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ y, int M, int N, int K,
                       int cps) {
  __shared__ __align__(16) float red[SM_WARPS][MT * 16][SM_RED_LD];
  __shared__ __align__(16) float part[MT * 16][SM_TILE_N];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * SM_TILE_N;
  const int C = (K + CHUNK_K - 1) / CHUNK_K;
  const int c_begin = blockIdx.y * cps;
  const int c_end = min(C, c_begin + cps);

  float acc[MT][SM_NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < SM_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // this lane's weight rows (output columns n0 + 8 nt + g) and x rows
  const int8_t* qrow[SM_NT];
  bool nok[SM_NT];
#pragma unroll
  for (int nt = 0; nt < SM_NT; ++nt) {
    const int n = n0 + nt * 8 + g;
    nok[nt] = n < N;
    qrow[nt] = q + (size_t)(nok[nt] ? n : 0) * K;
  }
  const __nv_bfloat16* xrow[MT][2];
  bool mok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = mt * 16 + g + 8 * r;
      mok[mt][r] = m < M;
      xrow[mt][r] = x + (size_t)(mok[mt][r] ? m : 0) * K;
    }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 bcur[SM_NT], bnext[SM_NT];
  int c = c_begin + warp;
  if (c < c_end) {
    const int k = c * CHUNK_K + 16 * t;
#pragma unroll
    for (int nt = 0; nt < SM_NT; ++nt)
      bcur[nt] = (nok[nt] && k < K) ? ld_stream(qrow[nt] + k) : zero;
  }
  for (; c < c_end; c += SM_WARPS) {
    const int k = c * CHUNK_K + 16 * t;
    const bool kok = k < K;
    const int kn = k + SM_WARPS * CHUNK_K;
    if (c + SM_WARPS < c_end) {
#pragma unroll
      for (int nt = 0; nt < SM_NT; ++nt)
        bnext[nt] = (nok[nt] && kn < K) ? ld_stream(qrow[nt] + kn) : zero;
    }
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      // x at k .. k + 15 of rows g and g + 8 of each m16 tile, 8 values
      // (two steps) at a time
      uint4 a[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          a[mt][r] = (mok[mt][r] && kok)
                         ? __ldg(reinterpret_cast<const uint4*>(
                               xrow[mt][r] + k + 8 * jp))
                         : zero;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * jp + jj;
        uint32_t b0[SM_NT], b1[SM_NT];
#pragma unroll
        for (int nt = 0; nt < SM_NT; ++nt)
          widen_i8x4(word(bcur[nt], j), b0[nt], b1[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t a0 = word(a[mt][0], 2 * jj);
          const uint32_t a1 = word(a[mt][1], 2 * jj);
          const uint32_t a2 = word(a[mt][0], 2 * jj + 1);
          const uint32_t a3 = word(a[mt][1], 2 * jj + 1);
#pragma unroll
          for (int nt = 0; nt < SM_NT; ++nt)
            mma16816(acc[mt][nt], a0, a1, a2, a3, b0[nt], b1[nt]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < SM_NT; ++nt) bcur[nt] = bnext[nt];
  }

  // the warps' partials: lane (g, t) holds rows g, g + 8 and columns
  // 2t, 2t + 1 of each n8 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < SM_NT; ++nt) {
      const int row = mt * 16 + g, col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(&red[warp][row][col]) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(&red[warp][row + 8][col]) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  __syncthreads();
  const int rows = min(M, MT * 16);
  const int S = gridDim.y;
  // the block's partial, warps summed in order
  for (int e = tid; e < rows * SM_TILE_N; e += SM_THREADS) {
    const int row = e / SM_TILE_N, col = e % SM_TILE_N;
    float v = red[0][row][col];
#pragma unroll
    for (int w = 1; w < SM_WARPS; ++w) v += red[w][row][col];
    if (S == 1) {
      const int n = n0 + col;
      store_out(y, M, N, row, n, n < N ? v * s[n] : 0.f);
    } else {
      part[row][col] = v;
    }
  }
  if (S == 1) return;
  // the cluster's partials, ranks summed in order; block r finishes the
  // elements r * 128 + tid, + S * 128, ...
  cluster_sync_acq_rel();
  const uint32_t rank = blockIdx.y;
  const uint32_t base = smem_u32(&part[0][0]);
  for (int e = rank * SM_THREADS + tid; e < rows * SM_TILE_N;
       e += S * SM_THREADS) {
    const uint32_t off = base + 4u * e;
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += ld_dsmem(dsmem_addr(off, r));
    const int row = e / SM_TILE_N, n = n0 + e % SM_TILE_N;
    store_out(y, M, N, row, n, n < N ? v * s[n] : 0.f);
  }
  // no block leaves while a peer may still read its shared memory
  cluster_sync_relaxed();
}

// ------------------------------------------------- route 1: TMA + wgmma

constexpr int WG_CONSUMER_WARPS = 8;  // two warpgroups, 64 channels each
constexpr int WG_CONSUMERS = 32 * WG_CONSUMER_WARPS;
// + the producer warpgroup, so that registers move between whole
// warpgroups (setmaxnreg): the producer keeps WG_PRODUCER_REGS a thread
// and the consumers take WG_CONSUMER_REGS (128 x 40 + 256 x 232 <= 64K)
constexpr int WG_THREADS = WG_CONSUMERS + 128;
constexpr int WG_PRODUCER_REGS = 40;
constexpr int WG_CONSUMER_REGS = 232;
constexpr int WG_BN = 128;  // output channels a tile
constexpr int WG_BK = 64;   // K a stage: 128 bytes of an x row, 64 of q's
constexpr int WG_Q_BYTES = WG_BN * WG_BK;
constexpr int WG_PART_LD = WG_BN + 4;  // floats a token row of the fold
                                       // buffer (conflict-free writes)

// Shared memory of a tile of BT tokens: STAGES ring stages, each the x
// tile [BT, 64] bf16 (rows of 128 bytes, 128-byte swizzle) then the q
// tile [128, 64] int8 (rows of 64 bytes, 64-byte swizzle), and a full
// and an empty mbarrier a stage. With K splits, the fold buffer [BT,
// WG_PART_LD] float32 takes the ring's place between a tile's last chunk
// and the next tile's first (the producer loads nothing then). 1024
// bytes of slack align the ring for the swizzles.
template <int BT> struct WgTile {
  static constexpr int X_BYTES = BT * 128;
  static constexpr int STAGE_BYTES = X_BYTES + WG_Q_BYTES;
  static constexpr int STAGES = BT == 256 ? 5 : 8;
  // chunks whose wgmmas a consumer warpgroup keeps in flight: three
  // where a chunk's products are short (their latency, not the tensor
  // cores, sets the pace), two at 128 tokens and more, where a third
  // would leave the producer too few stages to fill ahead
  static constexpr int DEPTH = BT <= 64 ? 3 : 2;
  static constexpr int PART_BYTES = BT * WG_PART_LD * 4;
  static_assert(PART_BYTES <= STAGES * STAGE_BYTES, "fold buffer > ring");
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// registers that an in-flight wgmma reads or writes stay where they are
// until this point (the compiler sees them used here)
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]),
                 "+r"(a[i][3]) :: "memory");
}
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// four sums (tokens m, channels n .. n + 3) scaled and rounded to bf16
__device__ __forceinline__ void store4(__nv_bfloat16* y, const float* s,
                                       int M, int N, int m, int n, float4 v) {
  if (m >= M) return;
  __nv_bfloat16* row = y + (size_t)m * N;
  if ((N & 3) == 0 && n + 3 < N) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * s[n], v.y * s[n + 1]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(v.z * s[n + 2], v.w * s[n + 3]);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(row + n) = packed;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N) row[n + i] = __float2bfloat16_rn(e[i] * s[n + i]);
}

// grid: clusters of `splits` blocks (1..8), as many clusters as the card
// holds at once (or fewer where the tiles are fewer). Cluster c walks the
// tiles c, c + clusters, ...; tile i covers tokens (i % TT) * BT .. + BT -
// 1 and channels (i / TT) * 128 .. + 127. Block r of a cluster takes the
// 64-wide chunks [r * cps, (r + 1) * cps) of K. Warps 0-7 are the
// consumers (warpgroup wg computes channels 64 wg .. + 63 of the
// block's 128, warp w its rows 16 (w % 4) + g and + 8), warps 8-11 the
// producer warpgroup (one thread issues the copies). x_map: x as [M, K]
// bf16, box [BT, 64], 128-byte swizzle; q_map: q as [N, K] uint8, box [128, 64],
// 64-byte swizzle (zeros past M, N and K).
template <int BT>
__global__ void __launch_bounds__(WG_THREADS, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ y, int M, int N, int K,
                       int splits, int cps) {
  using Tile = WgTile<BT>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* part = reinterpret_cast<float*>(smem);  // K splits: see WgTile
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + STAGES * Tile::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % splits, cluster = blockIdx.x / splits;
  const int clusters = gridDim.x / splits;
  const int TT = (M + BT - 1) / BT;
  const int tiles = TT * ((N + WG_BN - 1) / WG_BN);
  const int C = (K + WG_BK - 1) / WG_BK;
  const int c_begin = min(C, rank * cps), c_end = min(C, c_begin + cps);

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);                   // the producer + TMA bytes
      mbar_init(&empty[i], WG_CONSUMER_WARPS);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= WG_CONSUMER_WARPS) {
    // ---- producer: one thread keeps the ring full; with K splits the
    // whole warpgroup takes part in the fold's two cluster barriers a tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        WG_PRODUCER_REGS));
    if (splits == 1 && tid != WG_CONSUMERS) return;
    int it = 0;
    for (int tile = cluster; tile < tiles; tile += clusters) {
      if (tid == WG_CONSUMERS) {
        const int m0 = (tile % TT) * BT, n0 = (tile / TT) * WG_BN;
        for (int c = c_begin; c < c_end; ++c, ++it) {
          const int st = it % STAGES;
          mbar_wait(&empty[st], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[st], Tile::STAGE_BYTES);
          const uint32_t xs = smem_u32(smem + st * Tile::STAGE_BYTES);
          tma_load_2d(xs, &x_map, c * WG_BK, m0, &full[st]);
          tma_load_2d(xs + Tile::X_BYTES, &q_map, c * WG_BK, n0, &full[st]);
        }
      }
      if (splits > 1) {
        cluster_sync_relaxed();
        cluster_sync_relaxed();
      }
    }
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      WG_CONSUMER_REGS));
  const int g = lane >> 2, t = lane & 3;
  const int crow = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // q tile row
  // the byte permute that takes k = 2t, 2t + 1 from the word at t / 2
  // and k = 2t + 8, 2t + 9 from the word at t / 2 + 2 of a 16-byte chunk
  const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
  // byte offsets of those words in the q tile, chunk kk of row crow (row
  // crow + 8 is 512 bytes further and has the same swizzle): the 64-byte
  // swizzle stores chunk kk of row r at kk ^ ((r / 2) % 4)
  uint32_t qoff[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    qoff[kk] = crow * 64 + ((kk ^ ((crow >> 1) & 3)) << 4) + ((t >> 1) << 2);

  // the A fragments of the four k16 steps of the stage's q tile: a[kk] =
  // {row crow, k 16kk + 2t..; row crow + 8, same k; row crow, k 16kk + 8
  // + 2t..; row crow + 8, same k}, mma.sync's m16n8k16 A fragment
  auto load_a = [&](uint32_t qs, uint32_t (&a)[4][4]) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t addr = qs + qoff[kk] + h * 512;
        widen_i8x4(__byte_perm(lds32(addr), lds32(addr + 8), sel), a[kk][h],
                   a[kk][2 + h]);
      }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  float acc[BT / 2];
  constexpr int DEPTH = Tile::DEPTH;
  uint32_t afrag[DEPTH][4][4];  // one chunk's A fragments a buffer
  int it = 0;
  for (int tile = cluster; tile < tiles; tile += clusters) {
    const int m0 = (tile % TT) * BT, n0 = (tile / TT) * WG_BN;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    // chunk i of the tile: its A fragments into `a` (buffer i % DEPTH)
    // while the DEPTH - 1 chunks before it run, then its four wgmmas; once
    // they are issued, chunk i - DEPTH + 1's have completed: its stage is
    // released and its buffer `done` may be written again
    auto chunk = [&](uint32_t (&a)[4][4], uint32_t (&done)[4][4], int i) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const uint32_t xs = smem_u32(smem + st * Tile::STAGE_BYTES);
      load_a(xs + Tile::X_BYTES, a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<BT, 0>(acc, a[kk], wgmma_desc(xs + kk * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait<DEPTH - 1>();
      hold(done);
      if (i >= DEPTH - 1) release((it + STAGES - DEPTH + 1) % STAGES);
      ++it;
    };
    const int nc = c_end - c_begin;
    int i = 0;
    for (; i + DEPTH - 1 < nc; i += DEPTH) {
#pragma unroll
      for (int d = 0; d < DEPTH; ++d)
        chunk(afrag[d], afrag[(d + 1) % DEPTH], i + d);
    }
#pragma unroll
    for (int d = 0; d < DEPTH - 1; ++d)
      if (i + d < nc) chunk(afrag[d], afrag[(d + 1) % DEPTH], i + d);
    wgmma_wait<0>();
    hold(acc);
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) hold(afrag[d]);
    for (int j = max(nc - DEPTH + 1, 0); j < nc; ++j)
      release((it - nc + j) % STAGES);

    // accumulator d[4j + e]: channel crow + 8 (e / 2), token 8j + 2t +
    // (e % 2) of the tile
    if (splits == 1) {
      const int na = n0 + crow, nb = na + 8;
      const float sa = na < N ? s[na] : 0.f, sb = nb < N ? s[nb] : 0.f;
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 8 * j + 2 * t + (e & 1);
          const int n = e < 2 ? na : nb;
          if (m < M && n < N)
            y[(size_t)m * N + n] =
                __float2bfloat16_rn(acc[4 * j + e] * (e < 2 ? sa : sb));
        }
      continue;
    }
    {
      // K splits: the block's partial sums into its fold buffer [token]
      // [channel], over the ring once every consumer's wgmmas are done
      // (the producer waits at the cluster barriers); then block r
      // finishes float4 u = r * 256 + tid, + 256 S, ... of the tile, the
      // ranks' partials summed in rank order
      asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[(8 * j + 2 * t + (e & 1)) * WG_PART_LD + crow + 8 * (e >> 1)] =
              acc[4 * j + e];
      cluster_sync_acq_rel();
      const uint32_t base = smem_u32(part);
      for (int u = rank * WG_CONSUMERS + tid; u < BT * (WG_BN / 4);
           u += splits * WG_CONSUMERS) {
        const int tl = u / (WG_BN / 4), cl = (u % (WG_BN / 4)) * 4;
        const uint32_t off = base + 4u * (tl * WG_PART_LD + cl);
        float4 v = ld_dsmem_f4(dsmem_addr(off, 0));
        for (int r = 1; r < splits; ++r) {
          const float4 w = ld_dsmem_f4(dsmem_addr(off, r));
          v.x += w.x;
          v.y += w.y;
          v.z += w.z;
          v.w += w.w;
        }
        store4(y, s, M, N, m0 + tl, n0 + cl, v);
      }
      // the fold buffer's generic accesses before the next tile's copies
      // (the async proxy) into the ring; no block reloads its ring, or
      // leaves, while a peer may still read its fold buffer
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      cluster_sync_relaxed();
    }
  }
}

// ------------------------------------- route 2: float32 and float16 x

constexpr int ST_THREADS = 256;  // 32 x 8
constexpr int ST_TILE = 32;      // tokens and channels a block

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// grid (ceil(N / 32), ceil(M / 32)): a block computes 32 tokens x 32
// channels, thread (tx, ty) channel tx of tokens ty, ty + 8, ty + 16,
// ty + 24, over 32-wide chunks of K staged in shared memory as float32.
template <typename T>
__global__ void __launch_bounds__(ST_THREADS)
int8_gemm_simt_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ s, T* __restrict__ y, int M,
                      int N, int K) {
  __shared__ float xs[ST_TILE][ST_TILE + 1];
  __shared__ float qs[ST_TILE][ST_TILE + 1];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int n0 = blockIdx.x * ST_TILE, m0 = blockIdx.y * ST_TILE;
  float acc[ST_TILE / 8] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += ST_TILE) {
    const int k = k0 + tx;
    for (int i = ty; i < ST_TILE; i += 8) {
      const int m = m0 + i, n = n0 + i;
      xs[i][tx] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
      qs[i][tx] = (n < N && k < K) ? (float)q[(size_t)n * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < ST_TILE; ++kk) {
      const float w = qs[tx][kk];
#pragma unroll
      for (int i = 0; i < ST_TILE / 8; ++i)
        acc[i] = fmaf(xs[ty + 8 * i][kk], w, acc[i]);
    }
    __syncthreads();
  }
  const int n = n0 + tx;
  if (n >= N) return;
  const float sn = s[n];
#pragma unroll
  for (int i = 0; i < ST_TILE / 8; ++i) {
    const int m = m0 + ty + 8 * i;
    if (m < M) y[(size_t)m * N + n] = from_f32<T>(acc[i] * sn);
  }
}

template <int MT>
int launch_small(const __nv_bfloat16* x, const int8_t* q, const float* s,
                 __nv_bfloat16* y, int M, int N, int K, int splits,
                 cudaStream_t st) {
  const int C = (K + CHUNK_K - 1) / CHUNK_K;
  const int cps = (C + splits - 1) / splits;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + SM_TILE_N - 1) / SM_TILE_N, splits, 1);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_gemm_small_kernel<MT>, x, q, s, y, M, N, K, cps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}


cudaLaunchConfig_t wgmma_config(int splits, int grid, cudaStream_t st,
                                cudaLaunchAttribute* attr) {
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BT>
int launch_wgmma(const void* x, const void* q, const float* s,
                 __nv_bfloat16* y, int M, int N, int K, int splits, int grid,
                 cudaStream_t st) {
  using Tile = WgTile<BT>;
  if (splits < 1 || splits > MAX_SPLITS || grid < splits ||
      grid % splits != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, q_map;
  if (!tile_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                2ull * K, BT, WG_BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, K, WG_BN,
                WG_BK, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_wgmma_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int C = (K + WG_BK - 1) / WG_BK;
  const int cps = (C + splits - 1) / splits;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wgmma_config(splits, grid, st, attr);
  cfg.dynamicSmemBytes = Tile::SMEM;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_wgmma_kernel<BT>, x_map, q_map, s,
                           y, M, N, K, splits, cps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// clusters of `splits` blocks of the BT-token kernel the card holds at
// once (negative: a CUDA error)
template <int BT>
int wgmma_resident(int splits) {
  using Tile = WgTile<BT>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_wgmma_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wgmma_config(splits, splits, nullptr, attr);
  cfg.dynamicSmemBytes = Tile::SMEM;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, int8_gemm_wgmma_kernel<BT>, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

template <typename T>
int launch_simt(const void* x, const int8_t* q, const float* s, void* y,
                int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + ST_TILE - 1) / ST_TILE, (M + ST_TILE - 1) / ST_TILE);
  int8_gemm_simt_kernel<T><<<grid, ST_THREADS, 0, st>>>(
      static_cast<const T*>(x), q, s, static_cast<T*>(y), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// y [M, N] = (x [M, K] @ q [N, K]^T) * s [N]; dtype of x and y: 0
// bfloat16, 1 float16, 2 float32. route 0 (small_m, bfloat16): `tile` m16
// tiles (1, 2 or 4; M <= 16 tile) and `splits` blocks of K a cluster
// (1..8); route 1 (wgmma, bfloat16): `tile` tokens a tile (16, 32, 64,
// 128 or 256), `splits` blocks of K a cluster and
// `grid` blocks (a multiple of splits); route 2 (simt, float16 or
// float32): tile, splits and grid unused. K must be a multiple of 16 and
// x and q 16-byte aligned; the wrapper checks both, and the entry refuses
// what it does not take.
extern "C" int dyn_int8_gemm(const void* x, const void* q, const void* s,
                             void* y, int M, int N, int K, int route,
                             int tile, int splits, int grid, int dtype,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    if (dtype == 1) return launch_simt<__half>(x, qb, sb, y, M, N, K, st);
    if (dtype == 2) return launch_simt<float>(x, qb, sb, y, M, N, K, st);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (route == 0) {
    if (splits < 1 || splits > MAX_SPLITS || M > 16 * tile)
      return (int)cudaErrorInvalidValue;
    switch (tile) {
      case 1: return launch_small<1>(xb, qb, sb, yb, M, N, K, splits, st);
      case 2: return launch_small<2>(xb, qb, sb, yb, M, N, K, splits, st);
      case 4: return launch_small<4>(xb, qb, sb, yb, M, N, K, splits, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 16: return launch_wgmma<16>(x, q, sb, yb, M, N, K, splits, grid, st);
    case 32: return launch_wgmma<32>(x, q, sb, yb, M, N, K, splits, grid, st);
    case 64: return launch_wgmma<64>(x, q, sb, yb, M, N, K, splits, grid, st);
    case 128: return launch_wgmma<128>(x, q, sb, yb, M, N, K, splits, grid, st);
    case 256: return launch_wgmma<256>(x, q, sb, yb, M, N, K, splits, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

// How many clusters of `splits` blocks of the wgmma route's
// `tile`-token kernel the card holds at once (the persistent grid's
// size); a negative value is a CUDA error.
extern "C" int dyn_int8_gemm_resident(int tile, int splits) {
  if (splits < 1 || splits > MAX_SPLITS) return -(int)cudaErrorInvalidValue;
  switch (tile) {
    case 16: return wgmma_resident<16>(splits);
    case 32: return wgmma_resident<32>(splits);
    case 64: return wgmma_resident<64>(splits);
    case 128: return wgmma_resident<128>(splits);
    case 256: return wgmma_resident<256>(splits);
  }
  return -(int)cudaErrorInvalidValue;
}
