// Weight-only int8 GEMM for Hopper (sm_90a): y = (x @ q^T) * s.
//
// x [M, K] bfloat16 activations (row-major), q [N, K] int8 weights (the
// checkpoint's [out, in] layout: each output channel's K weights are
// contiguous), s [N] float32 per-output-channel scales, y [M, N] bfloat16.
// Sums in float32, the scale applied once in the epilogue, one rounding to
// bfloat16.
//
// What it stands for: QuantInt8.__rmatmul__ of the JAX package
// (dynamo_tpu/models/quant.py:87-92), `(x @ q.astype(x.dtype)) * s`, which
// XLA fuses into one dot whose weight operand is widened on chip, so the
// bfloat16 weights never exist in device memory. There is no Pallas kernel
// behind it. PyTorch has no such fusion: `x @ q.to(bf16)` writes a bf16
// copy of the weights and reads it back, more bytes than the bf16 path.
// Plain C entries return cudaGetLastError() (or the launch's own error)
// and are loaded with ctypes by dynamo_tpu_torch/ops/int8_gemm.py, which
// picks the route and the split from the shape alone.
//
// What bounds it on an H100 SXM. Decode (M <= 64 rows) does 2M operations
// per weight byte: at most 128, below the ~295 operations per byte where
// 989 TF/s would bind, so it is bound by the bytes of q (K x N) at
// 3.35 TB/s, once ~25 KB are in flight per SM. A prefill chunk of 512 or
// more rows is bound by the tensor cores (989 TF/s, which only wgmma
// reaches).
//
// The design.
// * Both routes widen the weights to bf16 on chip, in registers (small
//   M) or shared memory (large M), never in device memory: int8
//   -127..127 is exact in bf16. The widening is a byte permute into the
//   mantissa of 2^23 and a subtraction per value, and one byte permute
//   per pair (cvt to bf16x2 issues at a quarter of the integer rate).
// * Small M (route 0, M <= 64), mma.sync m16n8k16 (bf16 in, f32
//   accumulate): the contraction order within each 64-wide chunk of K is
//   permuted, the same way for both operands, so that every lane of a
//   quad loads its column's weights as one 16-byte load: lane (g, t)
//   holds k = 16t .. 16t + 15 of the chunk for column g, and in step j of
//   the chunk feeds k = 16t + 4j .. 16t + 4j + 3 where the fragment
//   layout names k' = 2t, 2t + 1, 2t + 8, 2t + 9. Its A fragment takes x
//   at the same k, which is again contiguous (8 bytes a row a step). No
//   shared memory and no shuffles stand between device memory and the
//   tensor cores. A block is four warps on 32 output columns; the warps
//   take interleaved 64-wide chunks of the block's share of K, each with
//   the next chunk's weights in flight while it computes the current
//   one. Few output tiles exist (N = 1024 gives 32), so K is also split
//   over the S <= 8 blocks of one thread-block cluster (the plan,
//   ops/int8_gemm.py int8_gemm_plan, fills ~4 blocks an SM). The warps'
//   partials sum through shared memory and the cluster's through
//   distributed shared memory, each in a fixed order: the result does not
//   depend on timing, so a replayed graph gives the eager call's bits. No
//   atomics, no scratch in device memory.
// * Large M (route 1), wgmma m64n128k16 (bf16 in, f32 accumulate, both
//   operands from shared memory, 128-byte swizzle): 128 x 128 output
//   tiles of two warpgroups, K in chunks of 64. The x tile comes by
//   cp.async one chunk ahead; each thread loads 32 of the q tile's
//   weights into registers two chunks ahead and widens them into the
//   next chunk's bf16 tile while the current chunk's wgmmas run, and a
//   warpgroup keeps one chunk's wgmmas in flight: one barrier a chunk.
//   Each weight is widened once a block (mma.sync fragments would widen
//   it once a warp that reads it). TMA, warp specialisation and a
//   persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ------------------------------------------------------- route 1: large M

constexpr int LG_THREADS = 256;   // two warpgroups, 64 rows each
constexpr int LG_BM = 128, LG_BN = 128;
// three x tiles and three widened q tiles: chunk kt's are read by its
// wgmmas, which stay in flight through chunk kt + 1, while chunk kt + 2's
// are written
constexpr int LG_STAGES = 3;
// a [128, 64] bf16 tile: rows of 128 bytes, 16-byte chunks XOR-swizzled
// by row % 8 (the layout a 128-byte-swizzle wgmma descriptor reads)
constexpr int LG_TILE = 128 * 128;
// 1024 bytes of slack to align the tiles, the x tiles, the q tiles
constexpr int LG_SMEM = 1024 + 2 * LG_STAGES * LG_TILE;  // 99,328

__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return (uint32_t)(r * 128 + (((c ^ r) & 7) << 4));
}

__device__ __forceinline__ void sts128(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// wgmma descriptor of a 128-byte swizzled, K-major operand at shared
// address addr (groups of 8 rows 1024 bytes apart)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma m64n128k16, bf16 in, f32 accumulators, A and B from shared
// memory, both K-major; d[4j + e]: row 16 (warp % 4) + lane / 4 (+ 8 for
// e >= 2), column 8j + 2 (lane % 4) + (e & 1), as mma.sync's m16n8
// fragment
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
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
      : "l"(da), "l"(db), "r"(1));
}

// grid (ceil(N / 128), ceil(M / 128)); warpgroup wg computes rows
// 64 wg .. + 63 and all 128 columns of the block's tile. Chunk kt of K
// (64 wide): its x tile is copied (cp.async) one chunk ahead; each thread
// holds 32 of the q tile's weights in registers, loaded two chunks ahead,
// and widens them into chunk kt + 1's bf16 tile while chunk kt's wgmmas
// run; a warpgroup keeps one chunk's wgmmas in flight (one barrier a
// chunk; the widening and the copies overlap the products).
__global__ void __launch_bounds__(LG_THREADS, 2)
int8_gemm_large_kernel(const __nv_bfloat16* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ s,
                       __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  extern __shared__ unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const int m0 = blockIdx.y * LG_BM, n0 = blockIdx.x * LG_BN;
  const int KT = (K + CHUNK_K - 1) / CHUNK_K;
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t w_base = base + LG_STAGES * LG_TILE;

  // one chunk of the x tile into stage st: 128 rows of 8 16-byte pieces,
  // 4 a thread
  auto load_x = [&](int st, int kt) {
    const uint32_t a_s = base + st * LG_TILE;
    const int k0 = kt * CHUNK_K;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * LG_THREADS;
      const int row = id >> 3, piece = id & 7;
      const int m = m0 + row, k = k0 + piece * 8;
      const bool ok = m < M && k < K;
      cp_async16(a_s + swz128(row, piece),
                 ok ? (const void*)(x + (size_t)m * K + k) : (const void*)x,
                 ok);
    }
  };
  // this thread's 32 weights of a chunk: row wrow of the q tile, k =
  // 32 wh .. + 31 (two 16-byte pieces; zeros past N or K)
  const int wrow = tid >> 1, wh = tid & 1;
  const bool wok = n0 + wrow < N;
  const int8_t* wsrc = q + (size_t)(wok ? n0 + wrow : 0) * K + 32 * wh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  auto load_w = [&](int kt, uint4 (&r)[2]) {
    const int k = kt * CHUNK_K + 32 * wh;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r[h] = (wok && kt < KT && k + 16 * h < K)
                 ? ld_stream(wsrc + (size_t)kt * CHUNK_K + 16 * h)
                 : zero;
  };
  auto widen_w = [&](int buf, const uint4 (&r)[2]) {
    const uint32_t dst = w_base + buf * LG_TILE;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) widen_i8x4(word(r[h], i), o[2 * i], o[2 * i + 1]);
      const int c = 4 * wh + 2 * h;  // 16-byte chunk: 8 bf16 of k
      sts128(dst + swz128(wrow, c), o[0], o[1], o[2], o[3]);
      sts128(dst + swz128(wrow, c + 1), o[4], o[5], o[6], o[7]);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  load_x(0, 0);
  cp_async_commit();
  uint4 wreg[2];
  load_w(0, wreg);
  widen_w(0, wreg);
  load_w(1, wreg);
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<0>();
    // this thread's copies and stores of chunk kt made visible to the
    // wgmmas (the async proxy); after the barrier, every thread's, and
    // every warpgroup is done with chunk kt - 2 (its x and q tiles are
    // chunk kt + 1's)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (kt + 1 < KT) load_x((kt + 1) % LG_STAGES, kt + 1);
    cp_async_commit();

    const uint32_t a_s = base + (kt % LG_STAGES) * LG_TILE + wg * 64 * 128;
    const uint32_t b_s = w_base + (kt % LG_STAGES) * LG_TILE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < CHUNK_K / 16; ++kk)
      wgmma_ss_n128(acc, wgmma_desc(a_s + kk * 32),
                    wgmma_desc(b_s + kk * 32));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (kt + 1 < KT) {
      // the next chunk's weights into its tile, then the weights of the
      // chunk after it into the registers
      widen_w((kt + 1) % LG_STAGES, wreg);
      load_w(kt + 2, wreg);
    }
    // chunk kt - 1's wgmmas done; chunk kt's stay in flight
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  cp_async_wait<0>();

  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = n0 + j * 8 + 2 * t;
    const float s0 = n < N ? s[n] : 0.f;
    const float s1 = n + 1 < N ? s[n + 1] : 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = r0 + 8 * r;
      if (m >= M) continue;
      const float v0 = acc[4 * j + 2 * r] * s0;
      const float v1 = acc[4 * j + 2 * r + 1] * s1;
      if (n + 1 < N && (N & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        store_out(y, M, N, m, n, v0);
        store_out(y, M, N, m, n + 1, v1);
      }
    }
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

}  // namespace

// y [M, N] = (x [M, K] @ q [N, K]^T) * s [N]. route 0: the small-M kernel
// with `mt` m16 tiles (1, 2 or 4; M <= 16 mt) and `splits` blocks of K a
// cluster (1..8); route 1: the large-M kernel (mt and splits unused). K
// must be a multiple of 16 and x and q 16-byte aligned; the wrapper
// checks both, and the entry refuses what it does not take.
extern "C" int dyn_int8_gemm(const void* x, const void* q, const void* s,
                             void* y, int M, int N, int K, int route, int mt,
                             int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (splits < 1 || splits > MAX_SPLITS || M > 16 * mt)
      return (int)cudaErrorInvalidValue;
    switch (mt) {
      case 1: return launch_small<1>(xb, qb, sb, yb, M, N, K, splits, st);
      case 2: return launch_small<2>(xb, qb, sb, yb, M, N, K, splits, st);
      case 4: return launch_small<4>(xb, qb, sb, yb, M, N, K, splits, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      LG_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + LG_BN - 1) / LG_BN, (M + LG_BM - 1) / LG_BM);
  int8_gemm_large_kernel<<<grid, LG_THREADS, LG_SMEM, st>>>(xb, qb, sb, yb, M,
                                                            N, K);
  return (int)cudaGetLastError();
}
