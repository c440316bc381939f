// Chunked-prefill paged GQA attention for Hopper (sm_90a).
//
// Replaces the TPU kernel _prefill_kernel, reached through
// paged_attention_prefill (dynamo_tpu/ops/paged_attention.py:336,466).
// One C entry, dyn_paged_attention_prefill, returns cudaGetLastError()
// after its launch and is loaded with ctypes by
// dynamo_tpu_torch/ops/paged_attention.py, which picks the route from the
// shape (prefill_route; never retried). Three kernels behind it:
//
//   route 1  paged_prefill_bf16_kernel<hd, ps>  bfloat16 at head_dim
//            64/128/256, page 16-128, GQA groups 1-8 (the serving path)
//   route 3  paged_prefill_bf16_kernel<hd, ps,  its float16 form, at the
//            __half>                            same shapes
//   route 2  paged_prefill_f32_kernel<hd, kb>   float32 at head_dim
//            16/32/64/128/256, page 8-128, GQA groups 1-8 (3xTF32 on the
//            tensor cores: the tiny, 1b and llama3_8b presets in float32)
//   route 0  paged_prefill_generic_kernel      every other shape, in
//            <T, hdp>                           float32, bfloat16 and
//            float16: any page size and GQA group, head_dim up to 256 (a
//            multiple of 8 in 16 bits); mma.sync tensor-core products
//            from a cp.async ring
//
// Pool layout: [N, KV, ps, hd] for one layer (a view of the stacked pool),
// contiguous; a page of one kv head is one contiguous [ps, hd] tile.
//
// What bounds it on an H100 SXM: a chunk of T queries does 4 * H * hd
// operations for every visible (query, key) pair. A 512-token chunk from
// position 0 needs 2.15 GFLOP (2.2 us at 989 TF/s bf16) and moves 10.5 MB
// of Q, output and K/V (3.1 us at 3.35 TB/s); the fourth chunk of a
// 2048-token prompt needs 15.0 GFLOP (15.2 us): prefill is bound by the
// tensor cores as soon as the chunk sits deeper than its own length.
//
// What the bf16 design does about it:
// * Work split. A block owns 64 (query, head) rows of one (row, kv head):
//   64 / G queries times the G heads that share the kv head (rows past
//   (64 / G) * G are padding). Every K/V page it reads serves all 64 rows.
//   The grid is (B * KV, query tiles) with the tile index reversed, so the
//   tiles that walk the most pages of a causal chunk start first. One
//   consumer warpgroup and one producer warp: at head_dim 128, page 64 a
//   block takes 82 KB of shared memory and 146 registers a thread, so two
//   blocks share an SM and a 512-token chunk of Llama-3-8B (256 blocks) is
//   one wave on 132 SMs.
// * Page ring. One thread of the producer warp reads the page table and
//   keeps a ring of PF_STAGES K/V stages (KB = min(ps, 64) keys each) in
//   flight with TMA: a tensor map over the layer's pool seen as a 2-D
//   [N * KV * ps, hd] array, boxes of [KB, 64] with the 128-byte swizzle,
//   completion counted in bytes on the stage's "full" mbarrier. The
//   consumers release a stage on its "empty" mbarrier. There is no
//   block-wide barrier inside the page loop. The tensor map comes from
//   cuTensorMapEncodeTiled through cudaGetDriverEntryPoint (no -lcuda)
//   and is a __grid_constant__ parameter.
// * Both products on wgmma (m64nNk16, bf16 in, f32 accumulate). S = Q K^T
//   reads Q (stored once per block) and the K stage from shared memory
//   through 128B-swizzle descriptors; the accumulator stays in registers.
// * Softmax in registers. A wgmma accumulator fragment has mma.sync's
//   layout (warp w holds rows 16w + lane / 4 and + 8): each thread masks
//   its elements by their row's query position and key position, applies
//   the softcap, and takes the row max and sum over its quad by shuffles;
//   O is rescaled in registers.
// * O += P V with P as the register A operand of wgmma (the RS form): the
//   S fragment of 16 keys, rounded to bf16, is exactly that operand. V is
//   the shared-memory B operand, N-major (the descriptor's transpose bit).
//   O stays in registers (64 f32 a thread at head_dim 128) until the
//   epilogue writes O / max(l, 1e-9) as bf16.
// * Pages and key blocks outside the block's visible range (causal and
//   sliding window) are never read, and a page id outside the pool is
//   skipped, as the TPU kernel's clamp does.
// Not done yet: overlap of one key block's softmax with the next block's
// S product inside the warpgroup (the two blocks on an SM overlap each
// other instead), and a persistent grid.
// Its float16 form (route 3) is the same kernel with wgmma's .f16 form,
// a float16 tensor map and half2 packing of P and of the output: scores,
// the running max, l and O stay float32; P and the output round to
// float16.
//
// What the float32 design (route 2) does about it. Float32 on CUDA cores
// peaks at 67 TF/s (a first 512-token chunk at Llama-3-8B's heads: 32 us
// of FFMA), so the products go to the TF32 tensor cores in the 3xTF32
// form (attention_common.cuh): each operand split into a TF32 value and a
// TF32 remainder, three products, the small x small one dropped; within
// ~1e-6 of float32 products where one TF32 product is ~1e-3 off. The
// bound is then 3x the operations at 494.7 TF/s dense TF32 (13 us).
// * Work split, producer warp, TMA ring on full/empty mbarriers and the
//   key-block walk are the bf16 kernel's. Float32 boxes are [KB, 32]
//   (128 bytes a row, the 128-byte swizzle; at head_dim 16 one unswizzled
//   [KB, 16] box); a stage holds KB = min(ps, 64, 4096 / hd) keys (32 KB of
//   K and V at most), two stages, so that at head_dim <= 128 two blocks
//   share an SM (99 KB a block at head_dim 128).
// * Both products on mma.sync m16n8k8 .tf32 (wgmma's tf32 form needs both
//   operands K-major, so V would need a transpose; a warp's 16 rows per
//   mma.sync match the warpgroup's 64). Q sits in shared memory, stored
//   once per block and read back as A fragments at each key block (Q's
//   two halves in registers would take 128 of them at head_dim 128).
//   S = Q K^T: thread t's head_dim pair of a k-step is one 8-byte load
//   from a chunk picked so that eight rows meet eight bank groups
//   (kstep_d).
// * P V without shuffles: the m16n8k8 accumulator holds keys 2t and 2t + 1
//   of a row where the tf32 A operand wants keys t and t + 4, so A's
//   columns are read as keys 2t and 2t + 1 and V's rows are taken in the
//   same order (P V sums over keys in any order); with the swizzle these
//   V loads are free of bank conflicts too.
// * Softmax in registers with the bf16 kernel's masking, in float32.
// What bounds it as built (H100, PERF.md, Findings): mma.sync's TF32 rate.
// In one build the first 512-token chunk at Llama-3-8B's heads took 0.107
// ms with three TF32 products and 0.062 with one (an mma.sync m16n8k8
// .tf32 every ~14 cycles of an SM sub-partition, ~140 TF/s over the card,
// against wgmma's 495), 0.090 without the splits. Adding each key block's
// P V to O in float32, not on the tensor cores (mma_3xtf32), costs ~10%
// (0.113 ms); separate accumulators for the small products were no
// faster, 16-key stages at head_dim 128 slower (0.119 ms). wgmma would
// need V K-major: a transposing split pass.
//
// What the generic design (route 0) does about it. The bound is the
// same, and every shape outside routes 1-3 lands here (the tiny preset's
// head_dim 16, page 8 as the reference's --kv-cache-block-size allows,
// head_dim 80 or 96, groups above 8, MQA), so it takes what the other
// routes' TMA boxes cannot: a box's rows lie in one page and its strides
// are multiples of 16 bytes.
// * Work split as routes 1-3: a block owns 64 (query, head) rows of one
//   (row, kv head), 64 / G queries times G heads; past G = 64 one query
//   times 64 heads, the grid gaining head tiles. Four warps of 16 rows,
//   the query tiles reversed (heaviest first).
// * Keys in blocks of KB positions, not pages: position j lies on page
//   page_table[b, j / ps] at slot j % ps, so a block crosses page
//   boundaries freely and keeps a tensor-core width at any page size. A
//   block walks only its visible extent.
// * A ring of two stages filled with cp.async by all four warps (16-byte
//   copies where a row is a multiple of 16 bytes, else 8 or 4), rows in
//   padded strides so that ldmatrix and the fragment loads meet
//   different banks, head_dim padded to 16..256 with zero columns. The
//   row offsets of block j + 2 are loaded while block j computes. A row
//   whose page id lies outside [0, N) is zero-filled (never read) and
//   masked.
// * bfloat16 / float16: mma.sync m16n8k16 (f32 accumulate), Q and K
//   fragments by ldmatrix, P straight from the S accumulator rounded to
//   T (the C layout is the A layout), V by ldmatrix.trans. float32:
//   route 2's 3xTF32 m16n8k8 with its key order for P V, each block's
//   P V summed from zero. wgmma would want the 128-byte canonical layouts
//   (and V K-major for TF32) that TMA boxes give routes 1-3.
// * Softmax in registers per quad, O in registers until the epilogue.
//
// Semantics shared with the TPU kernel: causal visibility by absolute
// query position (-1 = padding, gives zeros) intersected with the row's
// sliding window; the Gemma-2 softcap before the mask; online softmax in
// f32 with the finite NEG_INF, and exp only where a key is visible (an
// all-masked row keeps m = NEG_INF, l = 0 and returns zeros); the 16-bit
// kernels' probabilities enter P V rounded to their type (bfloat16 or
// float16), as the gather path's einsum takes them; a page id outside
// [0, N) contributes nothing and is never read.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "attention_common.cuh"
#include "tma_wgmma.cuh"

namespace {

// ------------------------------------------------------ bfloat16 kernel
constexpr int PF_ROWS = 64;             // (query, head) rows per block
constexpr int PF_CONSUMERS = 128;       // one warpgroup
constexpr int PF_BF16_THREADS = PF_CONSUMERS + 32;  // + the producer warp
constexpr int PF_STAGES = 2;            // K/V stages in the ring

template <int HD, int PS> struct PrefillTile {
  static constexpr int KB = PS < 64 ? PS : 64;  // keys per stage
  static constexpr int SUBS = PS / KB;          // stages per page
  static constexpr int Q_BYTES = PF_ROWS * HD * 2;
  static constexpr int KV_BYTES = KB * HD * 2;  // the K (or V) tile of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles for the 128-byte swizzle, Q,
  // the stages, then a full and an empty mbarrier per stage
  static constexpr int SMEM =
      1024 + Q_BYTES + PF_STAGES * STAGE_BYTES + 2 * PF_STAGES * 8;
};

// Byte offset of 16-byte chunk c (8 bf16 of a row) of row r in a [rows,
// HD] bf16 tile stored as HD / 64 column blocks of [rows, 128 bytes], the
// chunk index XOR-swizzled by r % 8: what TMA's 128-byte swizzle writes
// for a box of [rows, 64] into a 1024-byte aligned block, and what a
// wgmma descriptor of layout type 1 (128B) reads.
__device__ __forceinline__ uint32_t swz(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// wgmma m64nNk16, T (bf16 or f16) in, f32 accumulators (d: N / 2 per
// thread of the warpgroup; warp w holds rows 16w + lane / 4 and + 8, as
// mma.sync's m16n8 fragment does), A and B from shared memory, both
// K-major (the register-A form, for P V, is tma_wgmma.cuh's wgmma_rs).
template <typename T>
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
#define DYN_WG_SS_N16(AB)                                                   \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                      \
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"                                      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7])                                              \
      : "l"(da), "l"(db), "r"(scale_d))
  DYN_AB(T, DYN_WG_SS_N16);
#undef DYN_WG_SS_N16
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
#define DYN_WG_SS_N32(AB)                                                   \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15"                                                  \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])     \
      : "l"(da), "l"(db), "r"(scale_d))
  DYN_AB(T, DYN_WG_SS_N32);
#undef DYN_WG_SS_N32
}

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
#define DYN_WG_SS_N64(AB)                                                   \
  asm volatile(                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
        "+f"(d[31])                                                         \
      : "l"(da), "l"(db), "r"(scale_d))
  DYN_AB(T, DYN_WG_SS_N64);
#undef DYN_WG_SS_N64
}

template <int N, typename T>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16<T>(d, da, db, scale_d);
  if constexpr (N == 32) wgmma_ss_n32<T>(d, da, db, scale_d);
  if constexpr (N == 64) wgmma_ss_n64<T>(d, da, db, scale_d);
}

__device__ __forceinline__ int warp_max_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// grid (B * KV, ceil(T / TQ)), TQ = 64 / G; block PF_BF16_THREADS: warps
// 0-3 are the consumer warpgroup (row r = t_local * G + g; warp w holds
// rows 16w .. 16w + 15 of every fragment), warp 4 the producer. Shared:
// Q [64, HD], then PF_STAGES stages of K and V [KB, HD] (all swizzled, see
// swz), then the stages' mbarriers. k_map / v_map: the layer's pool as a
// 2-D [N * KV * PS, HD] array, box [KB, 64], 128-byte swizzle. T: the
// element type, bfloat16 (route 1) or float16 (route 3).
template <int HD, int PS, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(PF_BF16_THREADS, HD <= 128 ? 2 : 1)
paged_prefill_bf16_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const T* __restrict__ q,
                          const int* __restrict__ page_table,
                          const int* __restrict__ q_positions,
                          const int* __restrict__ eff_win,
                          T* __restrict__ out, int Tq, int H,
                          int KV, int N, int P, float scale, float softcap) {
  using Tile = PrefillTile<HD, PS>;
  constexpr int KB = Tile::KB, SUBS = Tile::SUBS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* stages = q_s + Tile::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + PF_STAGES * Tile::STAGE_BYTES);
  uint64_t* empty = full + PF_STAGES;

  const int b = blockIdx.x / KV, kv = blockIdx.x - b * KV;
  const int G = H / KV, TQ = PF_ROWS / G, R = TQ * G;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // heaviest tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int win = eff_win[b];

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < PF_STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer's arrive + TMA bytes
      mbar_init(&empty[s], PF_CONSUMERS / 32);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's key blocks [j_begin, j_end) of KB keys: the visible extent
  // of its own queries, as the TPU wrapper computes it per row
  // (dynamo_tpu/ops/paged_attention.py:431-438) — length = max position
  // + 1, lower = min position + 1 - window. Every warp computes it.
  int maxq = -1, minq = 1 << 30;
  for (int i = lane; i < TQ; i += 32) {
    const int t = t0 + i;
    const int qp = t < Tq ? q_positions[(long long)b * Tq + t] : -1;
    maxq = max(maxq, qp);
    if (qp >= 0) minq = min(minq, qp);
  }
  maxq = warp_max_i(maxq);
  minq = warp_min_i(minq);
  const int length = maxq + 1;
  const int lo = min(max(minq + 1 - win, 0), max(length - 1, 0));
  const int j_begin = lo / KB;
  const int j_end = min((length + KB - 1) / KB, P * SUBS);
  const int* row_pages = page_table + (long long)b * P;
  __syncthreads();  // the mbarriers are initialised

  if (warp == PF_CONSUMERS / 32) {
    // ---- producer: one thread keeps the ring full with TMA, key blocks
    // in the consumers' order
    if (lane != 0) return;
    int it = 0;
    for (int j = j_begin; j < j_end; ++j) {
      const int page = row_pages[j / SUBS];
      if (page < 0 || page >= N) continue;  // never read outside the pool
      const int s = it % PF_STAGES;
      mbar_wait(&empty[s], ((it / PF_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], Tile::STAGE_BYTES);
      const int row0 = (page * KV + kv) * PS + (j % SUBS) * KB;
      const uint32_t ks = smem_u32(stages + s * Tile::STAGE_BYTES);
#pragma unroll
      for (int a = 0; a < HD / 64; ++a) {
        tma_load_2d(ks + a * KB * 128, &k_map, a * 64, row0, &full[s]);
        tma_load_2d(ks + Tile::KV_BYTES + a * KB * 128, &v_map, a * 64, row0,
                    &full[s]);
      }
      ++it;
    }
    return;
  }

  // ---- consumers: Q into shared memory once (rows past R or past the
  // chunk are zeros), made visible to wgmma (the async proxy)
  for (int i = tid; i < PF_ROWS * HD / 8; i += PF_CONSUMERS) {
    const int r = i / (HD / 8), c = i - r * (HD / 8);
    const int tl = r / G, t = t0 + tl;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < R && t < Tq)
      v = *reinterpret_cast<const uint4*>(
          q + (((long long)b * Tq + t) * H + kv * G + (r - tl * G)) * HD + c * 8);
    *reinterpret_cast<uint4*>(q_s + swz(r, c, PF_ROWS)) = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(PF_CONSUMERS) : "memory");

  // this thread's two rows (r0 and r0 + 8) and their query positions
  const int r0 = warp * 16 + (lane >> 2);
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, t = t0 + r / G;
    qpos[i] = (r < R && t < Tq) ? q_positions[(long long)b * Tq + t] : -1;
  }
  const uint32_t q_u32 = smem_u32(q_s);

  float o[HD / 8][4];
#pragma unroll
  for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[jd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int it = 0;
  for (int j = j_begin; j < j_end; ++j) {
    const int page = row_pages[j / SUBS];
    if (page < 0 || page >= N) continue;
    const int s = it % PF_STAGES;
    mbar_wait(&full[s], (it / PF_STAGES) & 1);
    const uint32_t ks = smem_u32(stages + s * Tile::STAGE_BYTES);
    const uint32_t vs = ks + Tile::KV_BYTES;

    // S = Q K^T: [64, KB] over the warpgroup, k-steps of 16 along head_dim
    // (32 bytes inside a 128-byte row, then the next column block)
    float sc[KB / 8][4];
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<KB, T>(&sc[0][0],
                   wgmma_desc(q_u32 + (kk >> 2) * PF_ROWS * 128 + (kk & 3) * 32,
                              16, 1024),
                   wgmma_desc(ks + (kk >> 2) * KB * 128 + (kk & 3) * 32, 16,
                              1024),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();

    // online softmax on the fragment: element e of block jn is row
    // r0 + 8 * (e >> 1), key j * KB + 8 * jn + 2 * (lane & 3) + (e & 1).
    // Scores go to log2 units; masked ones to -inf (exp2 gives exactly 0).
    const int kbase = j * KB + 2 * (lane & 3);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = kbase + 8 * jn + (e & 1), qp = qpos[e >> 1];
        const float x = cap(sc[jn][e] * scale, softcap) * LOG2E;
        sc[jn][e] = (kpos <= qp && kpos > qp - win) ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[jn][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[jn][e] = exp2f(sc[jn][e] - m[e >> 1]);
        l[e >> 1] += sc[jn][e];
      }
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[jd][e] *= alpha[e >> 1];

    // O += P V: the S fragment of keys 16kk .. 16kk + 15 is the register
    // A operand (all of P packed before the fence, so that the wgmmas
    // issue back to back); V [KB, HD] is B, N-major (16 keys = 2048
    // bytes further)
    uint32_t pa[KB / 16][4];
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      pa[kk][0] = pack2<T>(sc[2 * kk][0], sc[2 * kk][1]);
      pa[kk][1] = pack2<T>(sc[2 * kk][2], sc[2 * kk][3]);
      pa[kk][2] = pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[kk][3] = pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk)
      wgmma_rs<HD, 1, T>(&o[0][0], pa[kk],
                         wgmma_desc(vs + kk * 2048, KB * 128, 1024));
    wgmma_commit();
    wgmma_wait_all();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    ++it;
  }

  // epilogue: row sums over the quad, O / max(l, 1e-9) as T
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i, tl = r / G, t = t0 + tl;
    if (r >= R || t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-9f);
    T* orow = out + (((long long)b * Tq + t) * H + kv * G + (r - tl * G)) * HD +
              2 * (lane & 3);
#pragma unroll
    for (int jd = 0; jd < HD / 8; ++jd)
      *reinterpret_cast<uint32_t*>(orow + 8 * jd) =
          pack2<T>(o[jd][2 * i] * inv, o[jd][2 * i + 1] * inv);
  }
}

// The layer's pool [N, KV, ps, hd] as a 2-D [N * KV * ps, hd] array of T
// (bfloat16 or float16), read in boxes of [kb rows, 64 columns] with the
// 128-byte swizzle.
template <typename T>
bool pool_map(CUtensorMap* map, const void* pool, long long rows, int hd,
              int kb) {
  return tile_map(map,
                  is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  pool, rows, hd, (unsigned long long)hd * 2, kb, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD, int PS, typename T>
int launch_bf16(const void* q, const void* k_pages, const void* v_pages,
                const int* page_table, const int* q_positions,
                const int* eff_win, void* out, int B, int Tq, int H, int KV,
                int N, int P, float scale, float softcap, cudaStream_t st) {
  using Tile = PrefillTile<HD, PS>;
  CUtensorMap k_map, v_map;
  const long long rows = (long long)N * KV * PS;
  if (rows > INT_MAX || !pool_map<T>(&k_map, k_pages, rows, HD, Tile::KB) ||
      !pool_map<T>(&v_map, v_pages, rows, HD, Tile::KB))
    return (int)cudaErrorInvalidValue;
  const int TQ = PF_ROWS / (H / KV);
  cudaFuncSetAttribute(paged_prefill_bf16_kernel<HD, PS, T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  paged_prefill_bf16_kernel<HD, PS, T>
      <<<dim3(B * KV, (Tq + TQ - 1) / TQ), PF_BF16_THREADS, Tile::SMEM, st>>>(
          k_map, v_map, static_cast<const T*>(q), page_table, q_positions,
          eff_win, static_cast<T*>(out), Tq, H, KV, N, P, scale, softcap);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_bf16_ps(int ps, const void* q, const void* k_pages,
                   const void* v_pages, const int* page_table,
                   const int* q_positions, const int* eff_win, void* out,
                   int B, int Tq, int H, int KV, int N, int P, float scale,
                   float softcap, cudaStream_t st) {
  switch (ps) {
#define PF_CASE(PS)                                                         \
  case PS:                                                                  \
    return launch_bf16<HD, PS, T>(q, k_pages, v_pages, page_table,          \
                                  q_positions, eff_win, out, B, Tq, H, KV,  \
                                  N, P, scale, softcap, st);
    PF_CASE(16) PF_CASE(32) PF_CASE(64) PF_CASE(128)
#undef PF_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_bf16_hd(int hd, int ps, const void* q, const void* k_pages,
                   const void* v_pages, const int* page_table,
                   const int* q_positions, const int* eff_win, void* out,
                   int B, int Tq, int H, int KV, int N, int P, float scale,
                   float softcap, cudaStream_t st) {
  switch (hd) {
#define PF_HD_CASE(HD)                                                       \
  case HD:                                                                   \
    return launch_bf16_ps<HD, T>(ps, q, k_pages, v_pages, page_table,        \
                                 q_positions, eff_win, out, B, Tq, H, KV, N, \
                                 P, scale, softcap, st);
    PF_HD_CASE(64) PF_HD_CASE(128) PF_HD_CASE(256)
#undef PF_HD_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------- float32 kernel (3xTF32)
constexpr int PF_F32_STAGES = 2;  // K/V stages in the ring

// Keys a stage of the float32 kernel holds: a stage of K and V is at most
// 32 KB.
__host__ __device__ constexpr int f32_stage_keys(int hd) {
  return hd >= 256 ? 16 : hd >= 128 ? 32 : 64;
}

// Shared memory of a block of the float32 kernel at head_dim hd, kb keys
// a stage: 1024 bytes of slack to align the tiles for the swizzle, Q
// [PF_ROWS, hd], the stages of K and V, then a full and an empty
// mbarrier per stage (ops/paged_attention.py prefill_f32_smem mirrors
// it; dyn_paged_prefill_f32_smem lets the card tests hold the two equal).
__host__ __device__ constexpr int f32_tile_smem(int hd, int kb) {
  return 1024 + PF_ROWS * hd * 4 + PF_F32_STAGES * 2 * kb * hd * 4 +
         2 * PF_F32_STAGES * 8;
}

template <int HD, int KB> struct PrefillF32Tile {
  // floats in a row of one column block: 32 (128 bytes, read with the
  // 128-byte swizzle) or, at head_dim 16, the whole row (64 bytes, plain)
  static constexpr int COLS = HD < 32 ? HD : 32;
  static constexpr int CB = HD / COLS;  // column blocks
  static constexpr int Q_BYTES = PF_ROWS * HD * 4;
  static constexpr int KV_BYTES = KB * HD * 4;  // the K (or V) tile of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int SMEM = f32_tile_smem(HD, KB);
};

// Byte offset of element d of row r in a [rows, HD] float32 tile stored
// as HD / 32 column blocks of [rows, 128 bytes], the 16-byte chunk index
// XOR-swizzled by r % 8: what TMA's 128-byte swizzle writes for a box of
// [rows, 32] float32 into a 1024-byte aligned block. At head_dim 16,
// plain rows of 64 bytes.
template <int HD>
__device__ __forceinline__ uint32_t fswz(int r, int d, int rows) {
  if constexpr (HD >= 32) {
    return (uint32_t)((d >> 5) * rows * 128 + r * 128 +
                      ((((d >> 2) & 7) ^ (r & 7)) << 4) + (d & 3) * 4);
  } else {
    return (uint32_t)(r * HD * 4 + d * 4);
  }
}

// The head_dim elements d, d + 1 (returned: d) that column t and t + 4 of
// S = Q K^T's A operand (rows t and t + 4 of its B operand) stand for in
// k-step kk, thread t of a quad. Any assignment that pairs A and B alike
// gives the same S; this one puts both elements in one 8-byte load, and
// k-step s of a 32-float column block takes 16-byte chunks s and s + 4,
// so that a warp's loads of eight rows meet eight different chunks after
// the swizzle (no bank conflict).
template <int HD>
__device__ __forceinline__ int kstep_d(int kk, int t) {
  constexpr int KPG = (HD < 32 ? HD : 32) / 8;  // k-steps a column block
  return (kk / KPG) * 32 + ((kk % KPG) + KPG * (t & 1)) * 4 + 2 * (t >> 1);
}

// grid (B * KV, ceil(T / TQ)), TQ = 64 / G; block PF_BF16_THREADS: warps
// 0-3 consume (row r = t_local * G + g; warp w holds rows 16w .. 16w + 15
// of every fragment), warp 4 is the producer. Shared: Q [64, HD], then
// PF_F32_STAGES stages of K and V [KB, HD] (swizzled, see fswz), then the
// stages' mbarriers. k_map / v_map: the layer's pool as a 2-D
// [N * KV * ps, HD] float32 array, box [KB, min(HD, 32)].
template <int HD, int KB>
__global__ void __launch_bounds__(PF_BF16_THREADS, HD <= 128 ? 2 : 1)
paged_prefill_f32_kernel(const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const float* __restrict__ q,
                         const int* __restrict__ page_table,
                         const int* __restrict__ q_positions,
                         const int* __restrict__ eff_win,
                         float* __restrict__ out, int Tq, int H, int KV,
                         int N, int ps, int P, float scale, float softcap) {
  using Tile = PrefillF32Tile<HD, KB>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* stages = q_s + Tile::Q_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stages + PF_F32_STAGES * Tile::STAGE_BYTES);
  uint64_t* empty = full + PF_F32_STAGES;

  const int b = blockIdx.x / KV, kv = blockIdx.x - b * KV;
  const int G = H / KV, TQ = PF_ROWS / G, R = TQ * G;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // heaviest tiles first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int win = eff_win[b];
  const int subs = ps / KB;  // stages a page

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < PF_F32_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PF_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's key blocks [j_begin, j_end) of KB keys, as the bf16
  // kernel takes them
  int maxq = -1, minq = 1 << 30;
  for (int i = lane; i < TQ; i += 32) {
    const int t = t0 + i;
    const int qp = t < Tq ? q_positions[(long long)b * Tq + t] : -1;
    maxq = max(maxq, qp);
    if (qp >= 0) minq = min(minq, qp);
  }
  maxq = warp_max_i(maxq);
  minq = warp_min_i(minq);
  const int length = maxq + 1;
  const int lo = min(max(minq + 1 - win, 0), max(length - 1, 0));
  const int j_begin = lo / KB;
  const int j_end = min((length + KB - 1) / KB, P * subs);
  const int* row_pages = page_table + (long long)b * P;
  __syncthreads();  // the mbarriers are initialised

  if (warp == PF_CONSUMERS / 32) {
    // ---- producer: one thread keeps the ring full with TMA
    if (lane != 0) return;
    int it = 0;
    for (int j = j_begin; j < j_end; ++j) {
      const int page = row_pages[j / subs];
      if (page < 0 || page >= N) continue;  // never read outside the pool
      const int s = it % PF_F32_STAGES;
      mbar_wait(&empty[s], ((it / PF_F32_STAGES) & 1) ^ 1);
      mbar_expect_tx(&full[s], Tile::STAGE_BYTES);
      const int row0 = (page * KV + kv) * ps + (j % subs) * KB;
      const uint32_t ks = smem_u32(stages + s * Tile::STAGE_BYTES);
#pragma unroll
      for (int a = 0; a < Tile::CB; ++a) {
        tma_load_2d(ks + a * KB * Tile::COLS * 4, &k_map, a * Tile::COLS,
                    row0, &full[s]);
        tma_load_2d(ks + Tile::KV_BYTES + a * KB * Tile::COLS * 4, &v_map,
                    a * Tile::COLS, row0, &full[s]);
      }
      ++it;
    }
    return;
  }

  // ---- consumers: Q into shared memory once (rows past R or past the
  // chunk are zeros), read back as A fragments at every key block
  for (int i = tid; i < PF_ROWS * HD / 4; i += PF_CONSUMERS) {
    const int r = i / (HD / 4), d = (i - r * (HD / 4)) * 4;
    const int tl = r / G, t = t0 + tl;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R && t < Tq)
      v = *reinterpret_cast<const float4*>(
          q + (((long long)b * Tq + t) * H + kv * G + (r - tl * G)) * HD + d);
    *reinterpret_cast<float4*>(q_s + fswz<HD>(r, d, PF_ROWS)) = v;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(PF_CONSUMERS) : "memory");

  // this thread's rows r0 and r0 + 8, their query positions, and its
  // place in the quad
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, t = t0 + r / G;
    qpos[i] = (r < R && t < Tq) ? q_positions[(long long)b * Tq + t] : -1;
  }

  float o[HD / 8][4];
#pragma unroll
  for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  int it = 0;
  for (int j = j_begin; j < j_end; ++j) {
    const int page = row_pages[j / subs];
    if (page < 0 || page >= N) continue;
    const int s = it % PF_F32_STAGES;
    mbar_wait(&full[s], (it / PF_F32_STAGES) & 1);
    const uint8_t* ks = stages + s * Tile::STAGE_BYTES;
    const uint8_t* vs = ks + Tile::KV_BYTES;

    // S = Q K^T: [16, KB] a warp, k-steps of 8 along head_dim (kstep_d)
    float sc[KB / 8][4];
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int d = kstep_d<HD>(kk, tq);
      const float2 x0 = *reinterpret_cast<const float2*>(q_s + fswz<HD>(r0, d, PF_ROWS));
      const float2 x1 = *reinterpret_cast<const float2*>(q_s + fswz<HD>(r0 + 8, d, PF_ROWS));
      uint32_t ab[4], as[4];
      split_tf32(x0.x, ab[0], as[0]);
      split_tf32(x1.x, ab[1], as[1]);
      split_tf32(x0.y, ab[2], as[2]);
      split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
      for (int jn = 0; jn < KB / 8; ++jn) {
        const float2 kx = *reinterpret_cast<const float2*>(ks + fswz<HD>(8 * jn + g, d, KB));
        uint32_t bb[2], bs[2];
        split_tf32(kx.x, bb[0], bs[0]);
        split_tf32(kx.y, bb[1], bs[1]);
        mma_3xtf32(sc[jn], ab, as, bb, bs);
      }
    }

    // online softmax on the fragment, as the bf16 kernel takes it:
    // element e of block jn is row r0 + 8 * (e >> 1), key
    // j * KB + 8 * jn + 2 * tq + (e & 1); log2 units, masked keys -inf
    const int kbase = j * KB + 2 * tq;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = cap(sc[jn][e] * scale, softcap) * LOG2E;
        sc[jn][e] = visible(kbase + 8 * jn + (e & 1), qpos[e >> 1], win)
                        ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[jn][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[jn][e] = exp2f(sc[jn][e] - m[e >> 1]);
        l[e >> 1] += sc[jn][e];
      }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];

    // O += P V, k-steps of 8 keys. The S accumulator is the A operand as
    // it stands: column t of A stands for key 2t and column t + 4 for key
    // 2t + 1 (so no shuffle), and B's rows t and t + 4 are V's rows 2t
    // and 2t + 1 to match; the swizzle keeps these loads conflict-free.
    // Each 8-wide column tile of O takes the key block's products from
    // zero and one float32 add (see mma_3xtf32): added on the tensor
    // cores, outputs near 5 missed atol 1e-5 by up to 3e-6 (PERF.md,
    // Findings).
    uint32_t pb[KB / 8][4], psm[KB / 8][4];
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn) {
      split_tf32(sc[jn][0], pb[jn][0], psm[jn][0]);
      split_tf32(sc[jn][2], pb[jn][1], psm[jn][1]);
      split_tf32(sc[jn][1], pb[jn][2], psm[jn][2]);
      split_tf32(sc[jn][3], pb[jn][3], psm[jn][3]);
    }
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd) {
      const int dc = 8 * nd + g;
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jn = 0; jn < KB / 8; ++jn) {
        const int key = 8 * jn + 2 * tq;
        uint32_t bb[2], bs[2];
        split_tf32(*reinterpret_cast<const float*>(vs + fswz<HD>(key, dc, KB)),
                   bb[0], bs[0]);
        split_tf32(*reinterpret_cast<const float*>(vs + fswz<HD>(key + 1, dc, KB)),
                   bb[1], bs[1]);
        mma_3xtf32(t, pb[jn], psm[jn], bb, bs);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] += t[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
    ++it;
  }

  // epilogue: row sums over the quad, O / max(l, 1e-9)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i, tl = r / G, t = t0 + tl;
    if (r >= R || t >= Tq) continue;
    const float lc = fmaxf(l[i], 1e-9f);
    float* orow = out + (((long long)b * Tq + t) * H + kv * G + (r - tl * G)) * HD +
                  2 * tq;
#pragma unroll
    for (int nd = 0; nd < HD / 8; ++nd)
      *reinterpret_cast<float2*>(orow + 8 * nd) =
          make_float2(o[nd][2 * i] / lc, o[nd][2 * i + 1] / lc);
  }
}

// The layer's pool [N, KV, ps, hd] as a 2-D [N * KV * ps, hd] float32
// array, read in boxes of [kb rows, min(hd, 32) columns]: the 128-byte
// swizzle, or none at head_dim 16.
bool pool_map_f32(CUtensorMap* map, const void* pool, long long rows, int hd,
                  int kb) {
  return tile_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pool, rows, hd,
                  (unsigned long long)hd * 4, kb, hd < 32 ? hd : 32,
                  hd < 32 ? CU_TENSOR_MAP_SWIZZLE_NONE
                          : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD, int KB>
int launch_f32(const void* q, const void* k_pages, const void* v_pages,
               const int* page_table, const int* q_positions,
               const int* eff_win, void* out, int B, int Tq, int H, int KV,
               int N, int ps, int P, float scale, float softcap,
               cudaStream_t st) {
  using Tile = PrefillF32Tile<HD, KB>;
  CUtensorMap k_map, v_map;
  const long long rows = (long long)N * KV * ps;
  if (rows > INT_MAX || !pool_map_f32(&k_map, k_pages, rows, HD, KB) ||
      !pool_map_f32(&v_map, v_pages, rows, HD, KB))
    return (int)cudaErrorInvalidValue;
  const int TQ = PF_ROWS / (H / KV);
  cudaFuncSetAttribute(paged_prefill_f32_kernel<HD, KB>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  paged_prefill_f32_kernel<HD, KB>
      <<<dim3(B * KV, (Tq + TQ - 1) / TQ), PF_BF16_THREADS, Tile::SMEM, st>>>(
          k_map, v_map, static_cast<const float*>(q), page_table, q_positions,
          eff_win, static_cast<float*>(out), Tq, H, KV, N, ps, P, scale,
          softcap);
  return (int)cudaGetLastError();
}

// the float32 kernel with KB keys a stage (KB = min(ps, f32_stage_keys)):
// tries KB, KB / 2, ... down to 8
template <int HD, int KB>
int launch_f32_kb(int kb, const void* q, const void* k_pages,
                  const void* v_pages, const int* page_table,
                  const int* q_positions, const int* eff_win, void* out,
                  int B, int Tq, int H, int KV, int N, int ps, int P,
                  float scale, float softcap, cudaStream_t st) {
  if (kb == KB)
    return launch_f32<HD, KB>(q, k_pages, v_pages, page_table, q_positions,
                              eff_win, out, B, Tq, H, KV, N, ps, P, scale,
                              softcap, st);
  if constexpr (KB > 8)
    return launch_f32_kb<HD, KB / 2>(kb, q, k_pages, v_pages, page_table,
                                     q_positions, eff_win, out, B, Tq, H, KV,
                                     N, ps, P, scale, softcap, st);
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_f32_hd(const void* q, const void* k_pages, const void* v_pages,
                  const int* page_table, const int* q_positions,
                  const int* eff_win, void* out, int B, int Tq, int H,
                  int KV, int N, int ps, int P, float scale, float softcap,
                  cudaStream_t st) {
  constexpr int KBM = f32_stage_keys(HD);
  return launch_f32_kb<HD, KBM>(ps < KBM ? ps : KBM, q, k_pages, v_pages,
                                page_table, q_positions, eff_win, out, B, Tq,
                                H, KV, N, ps, P, scale, softcap, st);
}

// ------------------------------------------------- generic kernel (route 0)
constexpr int GN_ROWS = 64;      // (query, head) rows per block
constexpr int GN_THREADS = 128;  // four warps of 16 rows
constexpr int GN_STAGES = 2;     // K/V stages in the cp.async ring

// keys a stage, by element size: 16-bit 64 (32 past head_dim 128), float32
// 64 / 32 / 16 as route 2 takes them; the wide form (head_dim above 256)
// 32 in 16 bits, 8 in float32, so that its whole Q and K rows fit
__host__ __device__ constexpr int gn_keys(int esize, int hdp,
                                          bool wide = false) {
  return wide ? (esize == 4 ? 8 : 32)
              : esize == 4 ? (hdp <= 64 ? 64 : hdp <= 128 ? 32 : 16)
                           : (hdp <= 128 ? 64 : 32);
}

// Row strides in elements. Q and K: hdp + 8, so that the eight 16-byte
// rows of an ldmatrix phase (16-bit) or the float2 fragment loads of a
// half warp (float32) meet different banks. V: the same in 16 bits (read
// by ldmatrix.trans); hdp + 4 in float32, where lane (g, t) reads column
// g of keys 2t and 2t + 1.
__host__ __device__ constexpr int gn_v_stride(int esize, int hdp) {
  return esize == 4 ? hdp + 4 : hdp + 8;
}

// Shared memory of a block: Q [64, qw + 8], the stages' K [keys, qw + 8]
// and V [keys, v stride] rows, each stage's key positions (int) and a
// ring of two key blocks' row offsets (long long); qw = hdp but in the
// wide form, where it is gn_qk_width and hdp the column tile's width.
// ops/paged_attention.py prefill_generic_plan mirrors it;
// dyn_paged_prefill_generic_smem lets the card tests hold the two equal.
__host__ __device__ constexpr int gn_smem(int esize, int hdp, int qw,
                                         bool wide) {
  return (GN_ROWS * (qw + 8) + GN_STAGES * gn_keys(esize, hdp, wide) *
                                   (qw + 8 + gn_v_stride(esize, hdp))) *
             esize +
         GN_STAGES * gn_keys(esize, hdp, wide) * 4 +
         2 * gn_keys(esize, hdp, wide) * 8;
}

// gn_smem at head_dim hd in a type of esize bytes
__host__ __device__ constexpr int gn_smem_hd(int esize, int hd) {
  return hd > GN_MAX_COLS
             ? gn_smem(esize, gn_hdp(gn_col_width(hd)), gn_qk_width(hd), true)
             : gn_smem(esize, gn_hdp(hd), gn_hdp(hd), false);
}

__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// Element offset, in the layer's pool, of key position `key`'s row of kv
// head kv: page page_table[b, key / ps], slot key % ps; -1 where the
// entry lies past the table or the page id outside [0, N) (never read).
__device__ __forceinline__ long long gn_key_src(const int* row_pages, int key,
                                                int ps, int P, int N, int KV,
                                                int kv, int hd) {
  const int p = key / ps;
  if (p >= P) return -1;
  const int page = row_pages[p];
  if (page < 0 || page >= N) return -1;
  return (((long long)page * KV + kv) * ps + (key - p * ps)) * hd;
}

// The copies of one key block's K and V rows into a stage, BYTES a copy
// (copy_zfill), consecutive threads on consecutive copies of a row: K's hd
// columns, V's vc columns from column c0 (the block's column tile; all
// hd from 0 but in the wide form); a row whose offset is -1 is
// zero-filled. Columns past them are not written. QS: K's row stride.
template <typename T, int HDP, bool WIDE, int BYTES>
__device__ __forceinline__ void gn_issue(T* ks, const long long* src,
                                         const T* k_pages, const T* v_pages,
                                         int hd, int vc, int c0, int QS,
                                         int tid) {
  constexpr int KB = gn_keys(sizeof(T), HDP, WIDE);
  constexpr int VS = gn_v_stride(sizeof(T), HDP), CE = BYTES / sizeof(T);
  T* vs = ks + KB * QS;
  const int cpk = hd / CE, cpv = vc / CE;  // copies a K row, a V row
  const int nk = KB * cpk, n = nk + KB * cpv;
  for (int task = tid; task < n; task += GN_THREADS) {
    const bool v = task >= nk;
    const int tk = v ? task - nk : task, cpr = v ? cpv : cpk;
    const int i = tk / cpr, c = tk - i * cpr;
    const long long off = src[i];
    const T* g = (v ? v_pages + c0 : k_pages) + (off >= 0 ? off + c * CE : 0);
    copy_zfill<T, BYTES>((v ? vs + i * VS : ks + i * QS) + c * CE, g,
                         off >= 0);
  }
}

// One 3xTF32 m16n8k8 k-step of S = Q K^T in float32 (k-step kk, 8
// columns of head_dim): thread t's k = t and t + 4 stand for elements d
// and d + 1 (one 8-byte load), A and B alike, as route 2 takes them; rows
// r0 and r0 + 8 of Q, key g8 of each 8-key tile of K.
template <int KB>
__device__ __forceinline__ void gn_qk_f32_step(float (&acc)[KB / 8][4],
                                               const float* q_s,
                                               const float* ks, int QS,
                                               int r0, int g8, int tq,
                                               int kk) {
  const int d = 8 * kk + 2 * tq;
  const float2 x0 = *reinterpret_cast<const float2*>(q_s + r0 * QS + d);
  const float2 x1 = *reinterpret_cast<const float2*>(q_s + (r0 + 8) * QS + d);
  uint32_t ab[4], as[4];
  split_tf32(x0.x, ab[0], as[0]);
  split_tf32(x1.x, ab[1], as[1]);
  split_tf32(x0.y, ab[2], as[2]);
  split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
  for (int jn = 0; jn < KB / 8; ++jn) {
    const float2 kx =
        *reinterpret_cast<const float2*>(ks + (8 * jn + g8) * QS + d);
    uint32_t bb[2], bs[2];
    split_tf32(kx.x, bb[0], bs[0]);
    split_tf32(kx.y, bb[1], bs[1]);
    mma_3xtf32(acc[jn], ab, as, bb, bs);
  }
}

// grid (B * KV * head tiles, query tiles, column tiles), the query tile
// index reversed (the causal tiles that walk the most keys first); block
// GN_THREADS: warp w holds rows 16w .. 16w + 15 of every fragment. Row r
// of a block is (query t0 + r / GT, head h0 + r % GT) of kv head kv, GT =
// min(G, 64) heads and TQ = 64 / GT queries a block; past G = 64 a block
// takes one query and 64 heads (head tile h0 / 64 of ceil(G / 64)).
// Shared memory: see gn_smem. T: float (3xTF32), __nv_bfloat16 or
// __half; HDP: head_dim padded (gn_hdp). WIDE (head_dim above 256): Q
// and K rows at qw = gn_qk_width(hd) columns for the scores, HDP the
// padded width of the block's value columns [c0, c0 + cw) (column tile
// blockIdx.z, gn_col_width), which alone it writes; each column tile
// repeats the scores.
template <typename T, int HDP, bool WIDE>
__global__ void __launch_bounds__(GN_THREADS, HDP <= 128 ? 2 : 1)
paged_prefill_generic_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pages,
                             const T* __restrict__ v_pages,
                             const int* __restrict__ page_table,
                             const int* __restrict__ q_positions,
                             const int* __restrict__ eff_win,
                             T* __restrict__ out, int Tq, int H, int KV, int N,
                             int ps, int hd, int P, int HT, int qw, int cw,
                             float scale, float softcap) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int ES = sizeof(T), KB = gn_keys(ES, HDP, WIDE);
  constexpr int VS = gn_v_stride(ES, HDP);
  // Q and K: QW columns in rows of QS; the block's value columns
  const int QW = WIDE ? qw : HDP, QS = QW + 8, STAGE = KB * (QS + VS);
  const int c0 = WIDE ? (int)blockIdx.z * cw : 0;
  const int vc = WIDE ? min(cw, hd - c0) : hd;
  extern __shared__ __align__(16) uint8_t gn_smem_raw[];
  T* q_s = reinterpret_cast<T*>(gn_smem_raw);
  T* kv_s = q_s + GN_ROWS * QS;
  int* kpos_s = reinterpret_cast<int*>(kv_s + GN_STAGES * STAGE);
  long long* src_s = reinterpret_cast<long long*>(kpos_s + GN_STAGES * KB);

  const int G = H / KV, GT = G < GN_ROWS ? G : GN_ROWS, TQ = GN_ROWS / GT;
  const int tile = blockIdx.x % HT, bk = blockIdx.x / HT;
  const int b = bk / KV, kv = bk - b * KV, h0 = tile * GN_ROWS;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int win = eff_win[b];
  const int* row_pages = page_table + (long long)b * P;

  // the block's key blocks [j_begin, j_end) of KB keys: the visible
  // extent of its queries, as routes 1-3 take it; every warp computes it
  int maxq = -1, minq = 1 << 30;
  for (int i = lane; i < TQ; i += 32) {
    const int t = t0 + i;
    const int qp = t < Tq ? q_positions[(long long)b * Tq + t] : -1;
    maxq = max(maxq, qp);
    if (qp >= 0) minq = min(minq, qp);
  }
  maxq = warp_max_i(maxq);
  minq = warp_min_i(minq);
  const int length = maxq + 1;
  const int lo = min(max(minq + 1 - win, 0), max(length - 1, 0));
  const int j_begin = lo / KB;
  const int j_end = (int)min((long long)(length + KB - 1) / KB,
                             ((long long)P * ps + KB - 1) / KB);

  // Q into shared memory once: rows past the block's (query, head) pairs
  // and columns past hd are zeros
  constexpr int QC = 16 / ES;  // elements a 16-byte chunk
  for (int i = tid; i < GN_ROWS * QW / QC; i += GN_THREADS) {
    const int r = i / (QW / QC), d = (i - r * (QW / QC)) * QC;
    const int tl = r / GT, g = h0 + r - tl * GT, t = t0 + tl;
    const bool row = tl < TQ && g < G && t < Tq;
    const T* src = q + (((long long)b * Tq + t) * H + kv * G + g) * hd + d;
    if (hd % QC == 0) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (row && d < hd) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(q_s + r * QS + d) = v;
    } else {  // rows that are not 16-byte multiples
#pragma unroll
      for (int e = 0; e < QC; ++e)
        q_s[r * QS + d + e] = row && d + e < hd ? src[e] : from_f<T>(0.f);
    }
  }
  // columns hd .. QW - 1 of every stage's K rows and vc .. HDP - 1 of its
  // V rows stay zero (the copies write the first hd and vc); the row
  // offsets of the first two blocks
  const int kpad = QW - hd, vpad = HDP - vc;
  for (int i = tid; i < GN_STAGES * KB * kpad; i += GN_THREADS) {
    const int row = i / kpad, d = hd + i - row * kpad;
    kv_s[(row / KB) * STAGE + (row % KB) * QS + d] = from_f<T>(0.f);
  }
  for (int i = tid; i < GN_STAGES * KB * vpad; i += GN_THREADS) {
    const int row = i / vpad, d = vc + i - row * vpad;
    kv_s[(row / KB) * STAGE + KB * QS + (row % KB) * VS + d] = from_f<T>(0.f);
  }
  if (tid < KB)
    for (int a = 0; a < 2; ++a)
      src_s[((j_begin + a) & 1) * KB + tid] =
          gn_key_src(row_pages, (j_begin + a) * KB + tid, ps, P, N, KV, kv, hd);
  __syncthreads();

  // copies of key block jj into stage s (16-byte copies where a row is a
  // multiple of 16 bytes, else 8 or 4, else 16-bit elements), and its key
  // positions: a row not read takes INT_MAX, which no query sees
  const int row_bytes = hd * ES;
  auto issue = [&](int jj, int s) {
    T* ks = kv_s + s * STAGE;
    const long long* src = src_s + (jj & 1) * KB;
#define GN_COPY(BYTES)                                                     \
  gn_issue<T, HDP, WIDE, BYTES>(ks, src, k_pages, v_pages, hd, vc, c0, QS, tid)
    if (row_bytes % 16 == 0)
      GN_COPY(16);
    else if (row_bytes % 8 == 0)
      GN_COPY(8);
    else if (F32 || row_bytes % 4 == 0)
      GN_COPY(4);
    else if constexpr (!F32)
      GN_COPY(2);
#undef GN_COPY
    if (tid < KB) kpos_s[s * KB + tid] = src[tid] >= 0 ? jj * KB + tid : INT_MAX;
  };

  // this thread's rows r0 and r0 + 8, their query positions (-1: padding
  // query, or a head past G), and its place in the quad
  const int g8 = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16 + g8;
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i, tl = r / GT, g = h0 + r - tl * GT, t = t0 + tl;
    qpos[i] = (tl < TQ && g < G && t < Tq) ? q_positions[(long long)b * Tq + t]
                                           : -1;
  }

  float o[HDP / 8][4];
#pragma unroll
  for (int nd = 0; nd < HDP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  if (j_begin < j_end) issue(j_begin, 0);
  cp_async_commit_group();
  int s = 0;
  for (int j = j_begin; j < j_end; ++j, s ^= 1) {
    cp_async_wait_all();  // block j's copies (this thread's) have landed
    __syncthreads();      // everyone's; and everyone is done with block j - 1
    if (j + 1 < j_end) issue(j + 1, s ^ 1);
    cp_async_commit_group();
    // the row offsets of block j + 2, loaded while block j computes
    long long nxt = -1;
    if (tid < KB && j + 2 < j_end)
      nxt = gn_key_src(row_pages, (j + 2) * KB + tid, ps, P, N, KV, kv, hd);
    const T* ks = kv_s + s * STAGE;
    const T* vs = ks + KB * QS;
    const int* kp = kpos_s + s * KB;

    // S = Q K^T: [16, KB] a warp
    float sc[KB / 8][4];
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
    if constexpr (F32) {
      // 3xTF32 m16n8k8, k-steps of 8 along head_dim (gn_qk_f32_step; QW
      // is the constant HDP outside the wide form, so that the loop
      // unrolls fully there). The wide form sums each 128 columns'
      // products from zero and adds them in float32, as P V takes each
      // key block's: the tensor cores round accumulations toward zero,
      // a bias that grows with the chain (at head_dim 512 one chain
      // missed atol 1e-5 on an H100)
      if constexpr (WIDE) {
        for (int k0 = 0; k0 < QW / 8; k0 += 16) {
          float t[KB / 8][4] = {};
#pragma unroll
          for (int kk = k0; kk < k0 + 16; ++kk)
            if (kk < QW / 8) gn_qk_f32_step<KB>(t, q_s, ks, QS, r0, g8, tq, kk);
#pragma unroll
          for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[jn][e] += t[jn][e];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < HDP / 8; ++kk)
          gn_qk_f32_step<KB>(sc, q_s, ks, QS, r0, g8, tq, kk);
      }
    } else {
      // m16n8k16: Q's A fragment and two key blocks' B fragments a k-step,
      // each one ldmatrix.x4
#pragma unroll
      for (int kk = 0; kk < QW / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, q_s + (warp * 16 + (lane & 15)) * QS + kk * 16 +
                       (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < KB / 16; ++jp) {
          uint32_t bk[4];
          ldsm_x4(bk, ks + (jp * 16 + ((lane >> 4) << 3) + (lane & 7)) * QS +
                          kk * 16 + ((lane >> 3) & 1) * 8);
          mma_16816<T>(sc[2 * jp], a, bk[0], bk[1]);
          mma_16816<T>(sc[2 * jp + 1], a, bk[2], bk[3]);
        }
      }
    }

    // online softmax on the fragment, as routes 1-3 take it: element e of
    // block jn is row r0 + 8 * (e >> 1), key slot 8 * jn + 2 * tq + (e & 1)
    // at position kp[slot]; log2 units, masked keys -inf
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn) {
      const int2 kq = *reinterpret_cast<const int2*>(kp + 8 * jn + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = cap(sc[jn][e] * scale, softcap) * LOG2E;
        sc[jn][e] = visible((e & 1) ? kq.y : kq.x, qpos[e >> 1], win)
                        ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[jn][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[jn][e] = exp2f(sc[jn][e] - m[e >> 1]);
        l[e >> 1] += sc[jn][e];
      }
#pragma unroll
    for (int nd = 0; nd < HDP / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];

    if constexpr (F32) {
      // O += P V in 3xTF32, k-steps of 8 keys: the accumulator is the A
      // operand as it stands (columns t and t + 4 stand for keys 2t and
      // 2t + 1), B's rows are V's rows 2t and 2t + 1 to match; each
      // 8-wide column tile takes the block's products from zero and one
      // float32 add (the tensor cores round accumulations toward zero)
      uint32_t pb[KB / 8][4], psm[KB / 8][4];
#pragma unroll
      for (int jn = 0; jn < KB / 8; ++jn) {
        split_tf32(sc[jn][0], pb[jn][0], psm[jn][0]);
        split_tf32(sc[jn][2], pb[jn][1], psm[jn][1]);
        split_tf32(sc[jn][1], pb[jn][2], psm[jn][2]);
        split_tf32(sc[jn][3], pb[jn][3], psm[jn][3]);
      }
#pragma unroll
      for (int nd = 0; nd < HDP / 8; ++nd) {
        const int dc = 8 * nd + g8;
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int jn = 0; jn < KB / 8; ++jn) {
          const int key = 8 * jn + 2 * tq;
          uint32_t bb[2], bs[2];
          split_tf32(vs[key * VS + dc], bb[0], bs[0]);
          split_tf32(vs[(key + 1) * VS + dc], bb[1], bs[1]);
          mma_3xtf32(t, pb[jn], psm[jn], bb, bs);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] += t[e];
      }
    } else {
      // O += P V, k-steps of 16 keys: the S fragments of keys 16kk ..
      // 16kk + 15, rounded to T, are the A operand (the m16n8k16 C layout
      // is its A layout); V's B fragments by ldmatrix.trans, two 8-wide
      // column tiles an x4
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack2<T>(sc[2 * kk][0], sc[2 * kk][1]);
        pa[1] = pack2<T>(sc[2 * kk][2], sc[2 * kk][3]);
        pa[2] = pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        pa[3] = pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
        for (int ndp = 0; ndp < HDP / 16; ++ndp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * VS +
                            ndp * 16 + (lane >> 4) * 8);
          mma_16816<T>(o[2 * ndp], pa, bv[0], bv[1]);
          mma_16816<T>(o[2 * ndp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    if (tid < KB && j + 2 < j_end) src_s[(j & 1) * KB + tid] = nxt;
  }

  // epilogue: row sums over the quad, O / max(l, 1e-9) in T, into the
  // block's columns c0 .. c0 + vc - 1; columns past them are not written
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = r0 + 8 * i, tl = r / GT, g = h0 + r - tl * GT, t = t0 + tl;
    if (tl >= TQ || g >= G || t >= Tq) continue;
    T* orow = out + (((long long)b * Tq + t) * H + kv * G + g) * hd + c0;
    if constexpr (F32) {
      const float lc = fmaxf(l[i], 1e-9f);
#pragma unroll
      for (int nd = 0; nd < HDP / 8; ++nd) {
        const int d = 8 * nd + 2 * tq;
        if (hd % 2 == 0) {
          if (d < vc)
            *reinterpret_cast<float2*>(orow + d) =
                make_float2(o[nd][2 * i] / lc, o[nd][2 * i + 1] / lc);
        } else {
          if (d < vc) orow[d] = o[nd][2 * i] / lc;
          if (d + 1 < vc) orow[d + 1] = o[nd][2 * i + 1] / lc;
        }
      }
    } else {
      const float inv = 1.f / fmaxf(l[i], 1e-9f);
#pragma unroll
      for (int nd = 0; nd < HDP / 8; ++nd) {
        const int d = 8 * nd + 2 * tq;
        if (hd % 2 == 0) {
          if (d < vc)
            *reinterpret_cast<uint32_t*>(orow + d) =
                pack2<T>(o[nd][2 * i] * inv, o[nd][2 * i + 1] * inv);
        } else {  // odd rows are 2-byte aligned: one element a store
          if (d < vc) orow[d] = from_f<T>(o[nd][2 * i] * inv);
          if (d + 1 < vc) orow[d + 1] = from_f<T>(o[nd][2 * i + 1] * inv);
        }
      }
    }
  }
}

template <typename T, int HDP, bool WIDE>
int launch_generic(const void* q, const void* k_pages, const void* v_pages,
                   const int* page_table, const int* q_positions,
                   const int* eff_win, void* out, int B, int Tq, int H,
                   int KV, int N, int ps, int hd, int P, float scale,
                   float softcap, cudaStream_t st) {
  const int G = H / KV, GT = G < GN_ROWS ? G : GN_ROWS, TQ = GN_ROWS / GT;
  const int HT = (G + GN_ROWS - 1) / GN_ROWS;
  const long long blocks = (long long)B * KV * HT, tiles = (Tq + TQ - 1) / TQ;
  const int smem = gn_smem_hd(sizeof(T), hd);
  if (blocks > INT_MAX || tiles > 65535 || smem > GN_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(paged_prefill_generic_kernel<T, HDP, WIDE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  paged_prefill_generic_kernel<T, HDP, WIDE>
      <<<dim3((unsigned)blocks, (unsigned)tiles, gn_col_tiles(hd)),
         GN_THREADS, smem, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k_pages),
          static_cast<const T*>(v_pages), page_table, q_positions, eff_win,
          static_cast<T*>(out), Tq, H, KV, N, ps, hd, P, HT, gn_qk_width(hd),
          gn_col_width(hd), scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic_hd(const void* q, const void* k_pages, const void* v_pages,
                      const int* page_table, const int* q_positions,
                      const int* eff_win, void* out, int B, int Tq, int H,
                      int KV, int N, int ps, int hd, int P, float scale,
                      float softcap, cudaStream_t st) {
#define GN_CASE(HDP, WIDE)                                                  \
  case HDP:                                                                 \
    return launch_generic<T, HDP, WIDE>(q, k_pages, v_pages, page_table,    \
                                        q_positions, eff_win, out, B, Tq,   \
                                        H, KV, N, ps, hd, P, scale,         \
                                        softcap, st);
  if (hd > GN_MAX_COLS) {  // column tiles of more than 128 columns
    switch (gn_hdp(gn_col_width(hd))) { GN_CASE(192, true) GN_CASE(256, true) }
    return (int)cudaErrorInvalidValue;
  }
  switch (gn_hdp(hd)) {
    GN_CASE(16, false) GN_CASE(32, false) GN_CASE(64, false)
    GN_CASE(96, false) GN_CASE(128, false) GN_CASE(192, false)
    GN_CASE(256, false)
  }
#undef GN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The shapes the bf16 kernel and its float16 form are built for; the
// wrapper's PREFILL_BF16_* list the same, and tests/test_torch_kernels.py
// holds the two against each other.
bool bf16_prefill_shape(int G, int ps, int hd) {
  return G >= 1 && G <= 8 && (hd == 64 || hd == 128 || hd == 256) &&
         (ps == 16 || ps == 32 || ps == 64 || ps == 128);
}

// The float32 kernel's shared memory a block at head_dim hd and page size
// ps (the stage size launch_f32_hd picks), for a shape of f32_shape.
extern "C" int dyn_paged_prefill_f32_smem(int hd, int ps) {
  const int kb = f32_stage_keys(hd);
  return f32_tile_smem(hd, ps < kb ? ps : kb);
}

// The generic kernel's shared memory a block at head_dim hd in dtype
// (gn_smem; ops/paged_attention.py prefill_generic_plan mirrors it).
extern "C" int dyn_paged_prefill_generic_smem(int dtype, int hd) {
  return gn_smem_hd(dtype == 0 ? 4 : 2, hd);
}

// route (the wrapper picks it from the shape, ops/paged_attention.py
// prefill_route; never retried): 1 = paged_prefill_bf16_kernel (dtype 1:
// head_dim 64, 128 or 256, page size 16, 32, 64 or 128, GQA groups of 1
// to 8), 3 = its float16 form (dtype 2, the same shapes), 2 =
// paged_prefill_f32_kernel (dtype 0: f32_shape in attention_common.cuh),
// 0 = paged_prefill_generic_kernel (any dtype, generic_shape).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns
// cudaGetLastError() after the launch.
extern "C" int dyn_paged_attention_prefill(
    int route, int dtype, const void* q, const void* k_pages,
    const void* v_pages, const int* page_table, const int* q_positions,
    const int* eff_win, void* out, int B, int Tq, int H, int KV, int N,
    int ps, int hd, int P, float scale, float softcap, void* stream) {
  if (KV < 1 || H % KV != 0 || route < 0 || route > 3 || dtype < 0 ||
      dtype > 2 || (route != 0 && dtype != (route == 1 ? 1 : route == 3 ? 2 : 0)))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  if ((route == 2 && !f32_shape(G, ps, hd)) ||
      ((route == 1 || route == 3) && !bf16_prefill_shape(G, ps, hd)) ||
      (route == 0 && !generic_shape(dtype, G, ps, hd)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tq == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 2) {
    switch (hd) {
#define PF_F32_CASE(HD)                                                       \
  case HD:                                                                    \
    return launch_f32_hd<HD>(q, k_pages, v_pages, page_table, q_positions,    \
                             eff_win, out, B, Tq, H, KV, N, ps, P, scale,     \
                             softcap, st);
      PF_F32_CASE(16) PF_F32_CASE(32) PF_F32_CASE(64) PF_F32_CASE(128)
      PF_F32_CASE(256)
#undef PF_F32_CASE
    }
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1 || route == 3) {
    return route == 1 ? launch_bf16_hd<__nv_bfloat16>(
                            hd, ps, q, k_pages, v_pages, page_table,
                            q_positions, eff_win, out, B, Tq, H, KV, N, P,
                            scale, softcap, st)
                      : launch_bf16_hd<__half>(
                            hd, ps, q, k_pages, v_pages, page_table,
                            q_positions, eff_win, out, B, Tq, H, KV, N, P,
                            scale, softcap, st);
  }
  // route 0, the generic kernel, in the call's dtype
  switch (dtype) {
#define GN_DTYPE_CASE(D, T)                                                 \
  case D:                                                                   \
    return launch_generic_hd<T>(q, k_pages, v_pages, page_table,            \
                                q_positions, eff_win, out, B, Tq, H, KV, N, \
                                ps, hd, P, scale, softcap, st);
    GN_DTYPE_CASE(0, float) GN_DTYPE_CASE(1, __nv_bfloat16)
    GN_DTYPE_CASE(2, __half)
#undef GN_DTYPE_CASE
  }
  return (int)cudaErrorInvalidValue;
}
