// Paged GQA decode attention over the stacked KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel _decode_kernel, reached through
// paged_attention_decode_layered (dynamo_tpu/ops/paged_attention.py:52,211).
// Plain C entries return cudaGetLastError() after their launches and are
// loaded with ctypes by dynamo_tpu_torch/ops/paged_attention.py, which
// picks the route from the shape (the `route` argument; never retried):
//
//   route 1  paged_decode_bf16_kernel<hd>      bfloat16 at head_dim
//            64/128/256, page size 16/32/64/128, GQA groups 1-8 (the
//            llama3_8b and 1b presets: the serving path); one cluster
//            launch per call
//   route 3  paged_decode_bf16_kernel<hd,      its float16 form, at the
//            __half>                           same shapes (the presets
//                                              served in float16)
//   route 2  paged_decode_f32_kernel<hd, lpg>  float32 at head_dim
//            16/32/64/128/256, page size 8-128, GQA groups 1-8 (the tiny,
//            1b and llama3_8b presets in float32); one cluster launch per
//            call
//   route 0  paged_decode_generic_kernel     the shapes outside these
//            <T, hdp>                          sets, float32, bfloat16 or
//                                              float16: any page size and
//                                              GQA group, head_dim up to
//                                              256 (a multiple of 8 in 16
//                                              bits); one cluster launch
//                                              per call
//
// The prefill kernel (the TPU kernel _prefill_kernel) lives in
// paged_prefill.cu.
//
// Pool layout: [L, num_pages, KV, page_size, head_dim], contiguous; a page
// of one kv head is one contiguous [ps, hd] tile. Softmax and every sum in
// float32.
//
// What bounds it on an H100 SXM: decode (one query per row) reads every
// visible K/V row once and does ~4 * G * hd operations per row of one kv
// head: about 4 flops per byte of bf16 K/V at G = 4, far below the ~295
// flops per byte where 989 TF/s would bind. It is bound by the bytes of
// K/V, at 3.35 TB/s, once enough bytes are in flight (~24 KB per SM:
// 3.35 TB/s x ~1 us of latency / 132 SMs); a call with little K/V (a few
// short rows) is bound by its chain of dependent memory round trips and
// the launch.
//
// What the bf16 design (route 1) does about it:
// * No block-wide barrier in the key loop. A block works for one (row, kv
//   head, split) and packs the G query heads that share the kv head, so a
//   K/V row is read from device memory once for the whole group. Its four
//   warps are independent flash-decoding workers: warp w takes the 16-key
//   blocks w, w + 4, ... of the split's visible range, keeps its own m, l
//   and output fragment in registers, and the warps merge once, through
//   shared memory, at the end.
// * Both products on tensor cores, mma.sync m16n8k16 (bf16 in, f32
//   accumulate). S = Q K^T: Q is the A operand, the G <= 8 heads in rows
//   0-7 (rows 8-15 are zero and their accumulators discarded, so they
//   cost no registers); K is the B operand through ldmatrix. O += P V: S
//   rounded to bf16 is the A operand as it stands in registers; V is the
//   B operand through ldmatrix.trans. A 16-key block at head_dim 128 is 16
//   ldmatrix.x4 and 32 mma per warp, against ~10^3 FMAs per thread.
// * A ring of 3 stages per warp, each a 16-key block of K and V (8 KB at
//   head_dim 128), filled with 16-byte cp.async into rows whose 16-byte
//   chunks are XOR-swizzled by row % 8 (ldmatrix reads free of bank
//   conflicts). Completion is tracked per stage by an mbarrier that each
//   lane's cp.async arrives on (cp.async.mbarrier.arrive.noinc); a warp
//   waits on its own barriers only. Two blocks of 107,104 B share an SM
//   at head_dim 128 (146 registers a thread, no spills): up to 192 KB of
//   stages in flight per SM.
//   2 or 4 stages measured no faster on an H100 (PERF.md, Findings).
// * The splits of one (row, kv head) are one thread-block cluster, and
//   they fold through its distributed shared memory, in one launch. The
//   split plan (ops/paged_attention.py decode_cluster_plan) comes from
//   host-known shapes only: the cluster size S in 8, 4, 2, 1 (8 is the
//   portable maximum), at most the page-table width, the largest whose
//   rows x kv heads clusters the card holds at once
//   (cudaOccupancyMaxActiveClusters; 30 of 8 blocks, 62 of 4 on an H100
//   at head_dim 128), so one wave fills the card where the pairs allow.
//   On the device a row's pages are cut into n_live = min(S, ceil(n /
//   min_pages)) near-equal contiguous shares, the first n_live splits;
//   the others read nothing. min_pages is one ring of keys (DB_RING_KEYS
//   = 192 keys: 3 pages at page size 64), so a live split fills its
//   warps' rings: an H100 sweep of forced split counts at the served
//   4-row window (PERF.md, Findings) was fastest at about 3 pages a
//   split and slowed as splits grew past it, the fold over them included.
// * The fold. Each live split merges its warps into its partial (output
//   at its own max, and its (m, l) per head) in its own shared memory and
//   meets the cluster's barrier; split 0 then reads the live splits'
//   partials through distributed shared memory (mapa): one warp per head
//   takes the joint max and sum over them and the window keys by
//   shuffles, and each output element loads its live sources together. A
//   second cluster barrier keeps every split's shared memory alive until
//   split 0 is done. No partials go to global memory and no counter
//   needs resetting, so calls on any stream, and graph replays, are
//   independent.
// * Only split 0 takes the fused window's keys: it stages their K and V
//   rows into shared memory behind its first stages and, after its loop,
//   scores them on the tensor cores as one more 16-key block (the K rows
//   swizzled as a stage's), in place of 128-wide dot products from
//   global memory in its prologue (4-5% faster at tp 4 and 8 heads, 3.5%
//   at 32 rows on an H100). Staging them, and loading Q, ahead of every
//   other load was tried and dropped: 1.5% slower on long rows.
// * Pages outside [lower, length) are never read, and a page id outside
//   the pool is skipped, as the TPU kernel's clamp does.
//
// What the float32 design (route 2) does: the bf16 route's, with float32
// tiles and CUDA-core products.
// * Decode does 2-4 operations a byte of float32 K/V (4 * G * hd a key
//   against 8 * hd bytes): far below what FFMA sustains (67 TF/s against
//   3.35 TB/s is 20 a byte), so the tensor cores would buy nothing and the
//   products are FFMA. What matters is the bf16 route's shape: no
//   block-wide barrier in the key loop, independent warps with their own
//   rings, m, l and output, and the splits of a (row, kv head) one
//   cluster folded with the window keys through distributed shared memory.
// * Lanes by head: the G heads of a kv head take 32 / G lanes each (a power
//   of two, df_lanes), and a lane holds the 16-byte chunks s, s + lanes,
//   ... of q and of its output row. A score is the lane's FFMAs over its
//   chunks and a butterfly over the head's lanes, which leaves it in every
//   lane of the head: the softmax needs no broadcast, and P V is each
//   lane's FFMAs on its own chunks of V. The head's lanes read consecutive
//   chunks of a K or V row (no bank conflict), the heads the same ones.
// * A ring of 3 stages a warp of 8 keys, plain rows of float32 filled by
//   16-byte cp.async, completion on an mbarrier per stage as on route 1:
//   8 KB a stage at head_dim 128, as a bf16 stage of 16 keys, so the
//   block takes 113 KB and two blocks share an SM. 16-key stages (192 KB
//   of rings, one block an SM, 2 splits at the served window) and 4
//   stages of 8 keys were slower on an H100 (PERF.md, Findings).
//
// What the generic design (route 0) does: route 1's, carried to any
// shape with the generic prefill kernel's key blocks (paged_prefill.cu).
// Its predecessor staged whole pages through block-wide phases (scores,
// softmax, P V with a barrier between, ~10^3 scalar FMAs a thread a page,
// then a second launch over global partials): 17-29x its byte bound, and
// refused past 8 heads a kv head or 227 KB of pages (page 256).
// * Key blocks, not pages: position j lies on page page_table[b, j / ps]
//   at slot j % ps, so a block of KB keys (16 in 16 bits, 8 in float32)
//   crosses page boundaries freely; shared memory depends on the block,
//   not on ps, and any page size keeps a tensor-core width. Lane r of a
//   warp loads the table entry of key r of the warp's next block while
//   the current one computes.
// * Heads in tiles of 16, the m16 rows of mma.sync: a block owns one
//   (row, kv head, head tile); rows past the group are zero. Up to 16
//   heads a kv head, K and V are read from device memory once per (row,
//   kv head); past 16 (MQA, 12 < G), the grid gains head tiles, which
//   re-read K/V, mostly from L2.
// * Independent warps as route 1's: warp w takes the key blocks w, w +
//   4, ... of its split, with its own ring of 3 stages filled by
//   cp.async (16-byte copies where a row is a multiple of 16 bytes, else
//   8 or 4 in float32; a key out of view or on a page outside the pool
//   is zero-filled, never read, and masked), completion by cp.async
//   groups and __syncwarp, its own m, l and output fragment; no
//   block-wide barrier in the key loop. Rows are padded (head_dim + 8
//   elements; V + 4 in float32) for conflict-free ldmatrix and fragment
//   loads; head_dim pads to 16/32/64/96/128/192/256 with zero columns.
// * A block's walk is bound by its own chain of dependent instructions
//   where a long row leaves one block an SM (one warp a sub-partition):
//   the copy loop's trip counts are compile-time (it unrolls, the rows'
//   offsets load together; with a runtime-bounded loop 8 x 3,968 keys at
//   12 heads took 0.0715 ms, unrolled 0.0566, PERF.md, Findings), Q's A
//   fragments stay in registers where the output fragment leaves room
//   (16 bits to head_dim 128, float32's TF32 parts to 96), and float32's
//   three score products take three accumulators.
// * Products: bfloat16 / float16 mma.sync m16n8k16 as route 1 (Q and K
//   by ldmatrix, P from the S accumulator rounded to T, V by
//   ldmatrix.trans). float32: 3xTF32 m16n8k8 as the generic prefill
//   kernel, each block's P V summed from zero and added in float32 (the
//   tensor cores round accumulations toward zero). Decode does 2-4
//   operations a byte of float32 K/V, so FFMA as route 2 would do as
//   well; the tensor-core form keeps one code path for any group, where
//   route 2's lanes-by-head layout stops at 8 heads.
// * The splits of a (row, kv head, head tile) are one cluster (at most
//   8, decode_cluster_plan over the card's co-resident clusters of this
//   kernel, from host-known shapes only); a row's blocks are cut into
//   near-equal contiguous shares, one for each ring of 12 blocks the row
//   fills, up to that many, folded through distributed shared memory as
//   route 1's. Split
//   0 also walks the fused window's in-flight keys, as key blocks after
//   its pool blocks (slot w's rows at wk/wv[b, w, kv]), so the window
//   takes any Kw. One launch a call, no global partials.

// The float16 form (route 3) is the bf16 kernel with the float16 forms
// of its instructions (mma.sync .f16, half2 packing of P and of the
// output): the same shapes, tiles and plan. Scores, the running max, l
// and every sum stay float32; only P (in [0, 1]) and the output round to
// float16, whose 10 mantissa bits hold them closer than bf16's 7.
//
// Semantics shared with the TPU kernel: online softmax in float32 with
// the finite NEG_INF = -1e30; exp() only where a key is visible, so an
// all-masked view returns m = NEG_INF, l = 0 and a zero output; the
// Gemma-2 tanh softcap comes before the mask. The bf16 kernel rounds the
// probabilities to bf16 (its float16 form to float16) before P V, as the
// gather path's einsum takes them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int MAX_G = 8;         // GQA group size the decode kernels take

// ------------------------------------------------------ shared by both
// A row's visible pool extent [lo, len): given, or (fused window step)
// derived as the JAX wrapper derives it — pool = positions [0, start),
// and on sliding layers lo = clip(q_pos + 1 - window, 0, start).
__device__ __forceinline__ void row_extent(int b, const int* lengths,
                                           const int* lower, const int* start,
                                           const int* q_pos,
                                           const int* eff_win, int& len,
                                           int& lo) {
  if (lengths != nullptr) {
    len = lengths[b];
    lo = lower[b];
  } else {
    len = max(start[b], 0);
    lo = eff_win != nullptr ? min(max(q_pos[b] + 1 - eff_win[b], 0), len) : 0;
  }
}

// The row's pages that cover [lo, len): [row_begin, row_begin + n).
__device__ __forceinline__ int row_pages(int len, int lo, int ps, int P,
                                         int& row_begin) {
  row_begin = lo > 0 ? lo / ps : 0;
  const int row_end = len > 0 ? min((len + ps - 1) / ps, P) : 0;
  return max(row_end - row_begin, 0);
}

// 16-byte asynchronous copy global -> shared (sm_80+), and its group fences
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// ------------------------------------------------------- route 1: bf16
constexpr int DB_WARPS = 4;                 // independent warps per block
constexpr int DB_THREADS = DB_WARPS * 32;
constexpr int DB_KB = 16;                   // keys per stage
constexpr int DB_STAGES = 3;                // stages in each warp's ring
// keys the block's rings hold at once: a split takes at least this many
// of a long enough row (DB_MIN_PAGES)
constexpr int DB_RING_KEYS = DB_WARPS * DB_STAGES * DB_KB;
constexpr int MAX_SPLITS = 8;               // one cluster: the portable maximum
constexpr int MAX_KW = 16;                  // in-flight window keys it folds

// a split's fewest pages: one ring of keys (3 pages at page size 64)
__device__ __forceinline__ int db_min_pages(int ps) {
  return max(DB_RING_KEYS / ps, 1);
}

template <int HD> struct DecodeTile {
  static constexpr int KV_BYTES = DB_KB * HD * 2;  // the K (or V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING_BYTES = DB_WARPS * DB_STAGES * STAGE_BYTES;
  // after the loop the rings hold, in float32: each warp's output
  // fragment [MAX_G, HD] (warp 0's slot then holds the block's partial,
  // which split 0 reads through distributed shared memory), the warps'
  // (m, l) and weights, the block's (m, l) per head (read by split 0 as
  // well), and split 0's fold weights [MAX_G, MAX_SPLITS] and sums
  static constexpr int MERGE_BYTES =
      4 * (DB_WARPS * MAX_G * HD + 3 * DB_WARPS * MAX_G + 2 * MAX_G +
           MAX_G * MAX_SPLITS + MAX_G);
  static constexpr int WIN_OFFSET = RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES;
  // the window's K rows of the block's kv head as one 16-key tile
  // (swizzled, see dswz) and its V rows [MAX_KW, HD] (bf16), then the
  // slots' scores, then weights, [MAX_G, MAX_KW] (float32)
  static constexpr int WIN_BYTES = 2 * MAX_KW * HD * 2 + 4 * MAX_G * MAX_KW;
  static constexpr int SMEM = WIN_OFFSET + WIN_BYTES + DB_WARPS * DB_STAGES * 8;
};

// Byte offset of 16-byte chunk c of row r in a [DB_KB, HD] bf16 tile:
// rows of HD * 2 bytes, the chunk index XORed with r % 8, so that the
// eight rows an ldmatrix phase reads at one chunk fall in eight different
// 16-byte bank groups.
template <int HD>
__device__ __forceinline__ uint32_t dswz(int r, int c) {
  return (uint32_t)(r * HD * 2 + ((c ^ (r & 7)) << 4));
}

// arrive on bar once every cp.async this thread issued so far has landed
// (the arrival counts toward the barrier's expected count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// mma.sync m16n8k16, T (bf16 or f16) in, f32 accumulate, for an A whose
// rows 8-15 are zero: a0/a2 are rows 0-7 (k 0-7 and 8-15 of the thread's
// quad), d0/d1 the accumulators of row lane / 4; rows 8-15 of D are
// discarded.
template <typename T>
__device__ __forceinline__ void mma_rows8(float& d0, float& d1, uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
#define DYN_MMA_ROWS8(AB)                                                   \
  asm("{\n.reg .f32 t<2>;\n"                                              \
      "mma.sync.aligned.m16n8k16.row.col.f32." AB "." AB ".f32 "           \
      "{%0, %1, t0, t1}, {%2, %3, %4, %5}, {%6, %7}, {%0, %1, %8, %9};\n}\n" \
      : "+f"(d0), "+f"(d1)                                                 \
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(0.f),    \
        "f"(0.f))
  DYN_AB(T, DYN_MMA_ROWS8);
#undef DYN_MMA_ROWS8
}

// The cluster's barrier: every thread of every block arrives, and wait
// returns once all have. The release/acquire form orders shared-memory
// writes before it with reads after it, across the cluster's blocks.
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n"
               "barrier.cluster.wait;\n" ::: "memory");
}

// The address in block `rank` of the cluster of this block's shared
// address `addr`, and loads through it (distributed shared memory).
__device__ __forceinline__ uint32_t dsmem_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float2 ld_dsmem_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_dsmem_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}

// grid (B, KV, S), clusters (1, 1, S): the S splits of one (row, kv head)
// are one cluster, split = blockIdx.z = the block's rank in it. T: the
// element type, bfloat16 (route 1) or float16 (route 3). Block
// DB_THREADS: four warps, each an independent worker over the 16-key
// blocks w, w + 4, ... of the split's visible range. Lane t of a warp
// works for head g = t / 4 (rows >= G are zero) and its quad position
// qd = t % 4: in S it holds keys 2qd, 2qd + 1 and 8 + 2qd, 8 + 2qd + 1 of
// a block, in O head_dim elements 8n + 2qd, + 1 of every 8-wide column
// tile n. Shared: the warps' rings of DB_STAGES stages (K tile, then V
// tile, swizzled, see dswz), then one mbarrier per stage; the merge and
// the fold at the end reuse the rings.
template <int HD, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(DB_THREADS)
paged_decode_bf16_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pools,
                         const T* __restrict__ v_pools,
                         long long layer_offset,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths,
                         const int* __restrict__ lower,
                         T* __restrict__ out,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         const int* __restrict__ start,
                         const int* __restrict__ q_pos,
                         const int* __restrict__ eff_win,
                         const T* __restrict__ wk,
                         const T* __restrict__ wv, int n_win,
                         int Kw, int H, int KV, int N, int ps, int P,
                         float scale, float softcap) {
  using Tile = DecodeTile<HD>;
  constexpr int CH = HD / 8;  // 16-byte chunks in a row
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, kv = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, qd = lane & 3;

  // the row's pages that cover [lo, len), cut into n_live near-equal
  // contiguous shares of at least db_min_pages pages (the first n_live
  // splits; the rest have nothing to read)
  int len, lo, row_begin;
  row_extent(b, lengths, lower, start, q_pos, eff_win, len, lo);
  const int n = row_pages(len, lo, ps, P, row_begin);
  const int min_pages = db_min_pages(ps);
  const int n_live = min(S, (n + min_pages - 1) / min_pages);
  // a split without pages only keeps the cluster's two barriers; split 0
  // folds even when no split has pages (zeros, or the window keys alone)
  if (split > 0 && split >= n_live) {
    cluster_sync_acq_rel();
    cluster_sync_relaxed();
    return;
  }
  const int p_begin = split < n_live ? row_begin + n * split / n_live : row_begin;
  const int n_pages =
      split < n_live ? row_begin + n * (split + 1) / n_live - p_begin : 0;

  uint8_t* ring = smem + warp * DB_STAGES * Tile::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(
                       smem + (Tile::SMEM - DB_WARPS * DB_STAGES * 8)) +
                   warp * DB_STAGES;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < DB_STAGES; ++s) mbar_init(&full[s], 32);
  }
  __syncwarp();

  // the split's visible keys [k_lo, k_hi), in 16-key blocks (a page holds
  // a whole number of them)
  const int k_lo = max(lo, p_begin * ps);
  const int k_hi = min(len, (p_begin + n_pages) * ps);
  const int jb = k_lo / DB_KB;
  const int je = k_hi > k_lo ? (k_hi + DB_KB - 1) / DB_KB : jb;
  const int nblk = je - jb > warp ? (je - jb - warp + DB_WARPS - 1) / DB_WARPS : 0;
  const int* row_table = page_table + (long long)b * P;
  const long long page_elems = (long long)KV * ps * HD;
  const T* k_head = k_pools + layer_offset + (long long)kv * ps * HD;
  const T* v_head = v_pools + layer_offset + (long long)kv * ps * HD;

  // stage block i of this warp's walk (a page id outside the pool is never
  // read; the stage's barrier still completes and its compute is skipped)
  auto issue = [&](int i) {
    const int key0 = (jb + warp + i * DB_WARPS) * DB_KB;
    const int page = row_table[key0 / ps];
    uint8_t* st = ring + (i % DB_STAGES) * Tile::STAGE_BYTES;
    if (page >= 0 && page < N) {
      const long long off = page * page_elems + (long long)(key0 % ps) * HD;
#pragma unroll
      for (int c = lane; c < DB_KB * CH; c += 32) {
        const int r = c / CH, cc = c - r * CH;
        cp_async16(st + dswz<HD>(r, cc), k_head + off + r * HD + cc * 8);
        cp_async16(st + Tile::KV_BYTES + dswz<HD>(r, cc),
                   v_head + off + r * HD + cc * 8);
      }
    }
    cp_async_arrive(&full[i % DB_STAGES]);
  };
#pragma unroll
  for (int i = 0; i < DB_STAGES - 1; ++i)
    if (i < nblk) issue(i);

  // split 0 folds the fused window's in-flight keys: their K and V rows
  // of this kv head are staged into shared memory behind the first
  // stages (waited for after the loop, where they are scored)
  const int nw = wk != nullptr && split == 0 ? Kw : 0;
  uint8_t* wk_s = smem + Tile::WIN_OFFSET;  // [MAX_KW, HD] swizzled
  T* wv_s = reinterpret_cast<T*>(wk_s + MAX_KW * HD * 2);
  float* wsc_s = reinterpret_cast<float*>(wv_s + MAX_KW * HD);  // [MAX_G][MAX_KW]
  for (int c = tid; c < nw * CH; c += DB_THREADS) {
    const int w = c / CH, cc = c - w * CH;
    const long long row = (((long long)b * Kw + w) * KV + kv) * HD + cc * 8;
    cp_async16(wk_s + dswz<HD>(w, cc), wk + row);
    cp_async16(wv_s + w * HD + cc * 8, wv + row);
  }

  // Q of head g as the A operand (rows 0-7; a row past G is zero)
  uint32_t qa[HD / 16][2];
  {
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + ((long long)b * H + kv * G + g) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = g < G ? qr[kk * 8 + qd] : 0u;
      qa[kk][1] = g < G ? qr[kk * 8 + 4 + qd] : 0u;
    }
  }
  float o[CH][2];
#pragma unroll
  for (int n8 = 0; n8 < CH; ++n8) o[n8][0] = o[n8][1] = 0.f;
  float m = NEG_INF, l = 0.f;

  // ldmatrix lane addresses inside a tile: K (B of S, k = head_dim): lanes
  // 0-7 / 8-15 / 16-23 / 24-31 give rows of matrices keys 0-7 chunk 2kk,
  // keys 0-7 chunk 2kk + 1, keys 8-15 chunk 2kk, keys 8-15 chunk 2kk + 1.
  // V (B of P V, k = keys, transposed): keys 0-7 chunk 2n, keys 8-15
  // chunk 2n, keys 0-7 chunk 2n + 1, keys 8-15 chunk 2n + 1.
  const int k_row = (lane & 7) + (lane >> 4) * 8, k_sub = (lane >> 3) & 1;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_sub = lane >> 4;

  for (int i = 0; i < nblk; ++i) {
    if (i + DB_STAGES - 1 < nblk) issue(i + DB_STAGES - 1);
    const int key0 = (jb + warp + i * DB_WARPS) * DB_KB;
    const int page = row_table[key0 / ps];
    mbar_wait(&full[i % DB_STAGES], (i / DB_STAGES) & 1);
    if (page >= 0 && page < N) {  // uniform across the warp
      const uint32_t ks = smem_u32(ring + (i % DB_STAGES) * Tile::STAGE_BYTES);
      const uint32_t vs = ks + Tile::KV_BYTES;

      // S = Q K^T for 16 keys: two 8-key column tiles
      float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + dswz<HD>(k_row, 2 * kk + k_sub));
        mma_rows8<T>(s0[0], s0[1], qa[kk][0], qa[kk][1], kb[0], kb[1]);
        mma_rows8<T>(s1[0], s1[1], qa[kk][0], qa[kk][1], kb[2], kb[3]);
      }

      // online softmax of head g over the block's visible keys; the four
      // lanes of a quad share a head
      float x[4] = {s0[0], s0[1], s1[0], s1[1]};
      bool vis[4];
      float mx = NEG_INF;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = key0 + 2 * qd + (e & 1) + 8 * (e >> 1);
        x[e] = cap(x[e] * scale, softcap);
        vis[e] = pos >= lo && pos < len;
        if (vis[e]) mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f((m - m_new) * LOG2E);
      m = m_new;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = vis[e] ? exp2f((x[e] - m_new) * LOG2E) : 0.f;
      l = l * alpha + (p[0] + p[1]) + (p[2] + p[3]);
      const uint32_t pa0 = pack2<T>(p[0], p[1]), pa2 = pack2<T>(p[2], p[3]);

      // O = O * alpha + P V: two 8-wide head_dim tiles per ldmatrix
#pragma unroll
      for (int n8 = 0; n8 < CH; n8 += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, vs + dswz<HD>(v_row, n8 + v_sub));
        o[n8][0] *= alpha;
        o[n8][1] *= alpha;
        o[n8 + 1][0] *= alpha;
        o[n8 + 1][1] *= alpha;
        mma_rows8<T>(o[n8][0], o[n8][1], pa0, pa2, vb[0], vb[1]);
        mma_rows8<T>(o[n8 + 1][0], o[n8 + 1][1], pa0, pa2, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with the stage before it refills
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // merge the warps, the first block-wide barrier, after the loop (no
  // ring copy is in flight: every block a warp staged it also consumed;
  // split 0's window rows have landed once each thread has waited)
  if (nw > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem);     // [DB_WARPS][MAX_G][HD]
  float* ml_s = o_s + DB_WARPS * MAX_G * HD;       // [DB_WARPS][MAX_G][2]
  float* w_s = ml_s + 2 * DB_WARPS * MAX_G;        // [DB_WARPS][MAX_G]
  float* part_ml = w_s + DB_WARPS * MAX_G;         // [MAX_G][2]
  float* fw_s = part_ml + 2 * MAX_G;               // [MAX_G][MAX_SPLITS]
  float* L_s = fw_s + MAX_G * MAX_SPLITS;          // [MAX_G]
  if (g < G) {
    float* orow = o_s + (warp * MAX_G + g) * HD + 2 * qd;
#pragma unroll
    for (int n8 = 0; n8 < CH; ++n8)
      *reinterpret_cast<float2*>(orow + 8 * n8) = make_float2(o[n8][0], o[n8][1]);
    if (qd == 0) {
      ml_s[(warp * MAX_G + g) * 2] = m;
      ml_s[(warp * MAX_G + g) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // split 0, warp 1: the window slots' scores, one more 16-key block on
  // the tensor cores (its K tile staged at the start). Slot w holds
  // position start + w, visible when w < n_win, start >= 0 and start + w
  // > q_pos - eff_win (the merge of dynamo_tpu/models/llama.py:981-1006);
  // a slot out of view scores -inf, which weighs exactly 0 in the fold.
  if (nw > 0 && warp == 1) {
    const uint32_t ks = smem_u32(wk_s);
    float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t kb[4];
      ldsm_x4(kb, ks + dswz<HD>(k_row, 2 * kk + k_sub));
      mma_rows8<T>(s0[0], s0[1], qa[kk][0], qa[kk][1], kb[0], kb[1]);
      mma_rows8<T>(s1[0], s1[1], qa[kk][0], qa[kk][1], kb[2], kb[3]);
    }
    const int st = start[b];
    const int floor_pos = eff_win != nullptr ? q_pos[b] - eff_win[b] : INT_MIN;
    const float x[4] = {s0[0], s0[1], s1[0], s1[1]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int w = 2 * qd + (e & 1) + 8 * (e >> 1);
      const bool vis = w < nw && w < n_win && st >= 0 && st + w > floor_pos;
      if (g < G) wsc_s[g * MAX_KW + w] = vis ? cap(x[e] * scale, softcap) : -INFINITY;
    }
  }
  // the block's (m, l) per head, and each warp's weight in it
  if (tid < G) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) M = fmaxf(M, ml_s[(w * MAX_G + tid) * 2]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float e = exp2f((ml_s[(w * MAX_G + tid) * 2] - M) * LOG2E);
      w_s[w * MAX_G + tid] = e;
      L += e * ml_s[(w * MAX_G + tid) * 2 + 1];
    }
    part_ml[tid * 2] = M;
    part_ml[tid * 2 + 1] = L;
  }
  __syncthreads();
  // the block's partial (unnormalized output at the block's max) in warp
  // 0's slot: each element is read and written by one thread
  for (int i = tid; i < G * HD / 4; i += DB_THREADS) {
    const int gi = i / (HD / 4), d = (i - gi * (HD / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float e = w_s[w * MAX_G + gi];
      const float4 x = *reinterpret_cast<const float4*>(o_s + (w * MAX_G + gi) * HD + d);
      a.x += e * x.x;
      a.y += e * x.y;
      a.z += e * x.z;
      a.w += e * x.w;
    }
    *reinterpret_cast<float4*>(o_s + gi * HD + d) = a;
  }
  // every live split's partial is in its shared memory before split 0
  // reads it
  cluster_sync_acq_rel();
  if (split != 0) {
    cluster_sync_relaxed();  // keeps this block's partial alive for split 0
    return;
  }

  // Split 0 folds the live splits' partials (its own included) and the
  // window keys. Per head, one warp: lanes 0-7 take the splits' (m, l),
  // lanes 8-23 the window slots' scores; the joint max and sum by
  // shuffles, each source's and slot's weight to shared memory.
  const int n_src = max(n_live, 1);
  const uint32_t ml_local = smem_u32(part_ml), o_local = smem_u32(o_s);
  for (int gi = warp; gi < G; gi += DB_WARPS) {
    float x = -INFINITY, mass = 0.f;  // -inf weighs exactly 0
    if (lane < n_src) {
      const float2 v = ld_dsmem_f2(dsmem_addr(ml_local + gi * 8, lane));
      x = v.x;
      mass = v.y;
    } else if (lane >= MAX_SPLITS && lane - MAX_SPLITS < nw) {
      x = wsc_s[gi * MAX_KW + lane - MAX_SPLITS];
      mass = 1.f;
    }
    const float M = fmaxf(warp_max(x), NEG_INF);
    const float e = exp2f((x - M) * LOG2E);
    const float L = warp_sum(e * mass);
    if (lane < MAX_SPLITS)
      fw_s[gi * MAX_SPLITS + lane] = e;
    else if (lane - MAX_SPLITS < MAX_KW)
      wsc_s[gi * MAX_KW + lane - MAX_SPLITS] = e;  // the slot's weight now
    if (lane == 0) {
      L_s[gi] = L;
      if (m_out != nullptr) {
        m_out[(long long)b * H + kv * G + gi] = M;
        l_out[(long long)b * H + kv * G + gi] = L;
      }
    }
  }
  __syncthreads();
  // the output, four head_dim elements of one head a thread: the live
  // splits' partials loaded together through distributed shared memory
  const long long obase = ((long long)b * H + kv * G) * HD;
  for (int i = tid; i < G * HD / 4; i += DB_THREADS) {
    const int gi = i / (HD / 4), d = (i - gi * (HD / 4)) * 4;
    const uint32_t src = o_local + (uint32_t)(gi * HD + d) * 4;
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n_src) x[s] = ld_dsmem_f4(dsmem_addr(src, s));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < n_src) {
        const float e = fw_s[gi * MAX_SPLITS + s];
        a.x += e * x[s].x;
        a.y += e * x[s].y;
        a.z += e * x[s].z;
        a.w += e * x[s].w;
      }
    }
    for (int w = 0; w < nw; ++w) {
      const float e = wsc_s[gi * MAX_KW + w];
      const float2 v0 = unpack2(wv_s + w * HD + d);
      const float2 v1 = unpack2(wv_s + w * HD + d + 2);
      a.x += e * v0.x;
      a.y += e * v0.y;
      a.z += e * v1.x;
      a.w += e * v1.y;
    }
    const float Lc = fmaxf(L_s[gi], 1e-9f);
    uint2 packed;
    packed.x = pack2<T>(a.x / Lc, a.y / Lc);
    packed.y = pack2<T>(a.z / Lc, a.w / Lc);
    *reinterpret_cast<uint2*>(out + obase + gi * HD + d) = packed;
  }
  cluster_sync_relaxed();  // the other splits' shared memory outlives the reads
}

// ---------------------------------------------------- route 2: float32
constexpr int DF_STAGES = 3;  // stages in each warp's ring
// keys a stage holds: as many bytes as a bf16 stage of 16 keys, and never
// more than a page (the smallest is 8)
constexpr int DF_KB = 8;

template <int HD> struct DecodeF32Tile {
  static constexpr int KB = DF_KB;
  static constexpr int KV_BYTES = KB * HD * 4;  // the K (or V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int RING_BYTES = DB_WARPS * DF_STAGES * STAGE_BYTES;
  // keys the block's rings hold at once: a split's fewest
  static constexpr int RING_KEYS = DB_WARPS * DF_STAGES * KB;
  // the merge and the fold reuse the rings as the bf16 kernel's do
  static constexpr int MERGE_BYTES =
      4 * (DB_WARPS * MAX_G * HD + 3 * DB_WARPS * MAX_G + 2 * MAX_G +
           MAX_G * MAX_SPLITS + MAX_G);
  static constexpr int WIN_OFFSET = RING_BYTES > MERGE_BYTES ? RING_BYTES : MERGE_BYTES;
  // the window's K and V rows of the block's kv head [MAX_KW, HD], then
  // the slots' scores, then weights, [MAX_G, MAX_KW] (all float32)
  static constexpr int WIN_BYTES = 2 * MAX_KW * HD * 4 + 4 * MAX_G * MAX_KW;
  static constexpr int SMEM = WIN_OFFSET + WIN_BYTES + DB_WARPS * DF_STAGES * 8;
};

// The lanes a head takes in the float32 kernel: 32 / G rounded down to a
// power of two, at most one 16-byte chunk of its row each (head_dim / 4).
int df_lanes(int hd, int G) {
  int gp = 1;
  while (gp < G) gp <<= 1;
  return 32 / gp < hd / 4 ? 32 / gp : hd / 4;
}

// This lane's part of q . K[j] for the NK rows of a float32 tile (rows of
// HD floats), summed over the LPG lanes of its head, so that every lane of
// the head holds the whole dot product. Lane s of a head holds the 16-byte
// chunks s, s + LPG, s + 2 LPG, ... of a row: the head's lanes read
// consecutive chunks (no bank conflict), the heads the same (a broadcast).
template <int HD, int LPG, int NK>
__device__ __forceinline__ void df_dots(float* x, const uint8_t* tile,
                                        const float4* qv, int s) {
  constexpr int NV = HD / (4 * LPG);
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 k = *reinterpret_cast<const float4*>(
          tile + j * HD * 4 + 16 * (i * LPG + s));
      a = fmaf(qv[i].x, k.x, a);
      a = fmaf(qv[i].y, k.y, a);
      a = fmaf(qv[i].z, k.z, a);
      a = fmaf(qv[i].w, k.w, a);
    }
    x[j] = a;
  }
#pragma unroll
  for (int o = 1; o < LPG; o <<= 1)
#pragma unroll
    for (int j = 0; j < NK; ++j) x[j] += __shfl_xor_sync(0xffffffffu, x[j], o);
}

// grid (B, KV, S), clusters (1, 1, S), as the bf16 kernel's: the S splits
// of one (row, kv head) are one cluster and fold through its distributed
// shared memory. Block DB_THREADS: four warps, each an independent worker
// over the KB-key blocks w, w + 4, ... of the split's visible range, with
// its own ring of DF_STAGES stages (K tile, then V tile, plain rows of HD
// floats, from one page). Lane t works for head g = t / LPG (rows >= G
// are zero) and holds the head_dim chunks of df_dots in q and in its
// output. Products on the CUDA cores (FFMA):
// scores by df_dots, P V by each lane on its own chunks.
template <int HD, int LPG>
__global__ void __launch_bounds__(DB_THREADS)
paged_decode_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pools,
                        const float* __restrict__ v_pools,
                        long long layer_offset,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths,
                        const int* __restrict__ lower,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out,
                        const int* __restrict__ start,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ eff_win,
                        const float* __restrict__ wk,
                        const float* __restrict__ wv, int n_win, int Kw,
                        int H, int KV, int N, int ps, int P, float scale,
                        float softcap) {
  using Tile = DecodeF32Tile<HD>;
  constexpr int KB = Tile::KB;
  constexpr int CH = HD / 4;          // 16-byte chunks in a row
  constexpr int NV = HD / (4 * LPG);  // chunks a lane holds
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x, kv = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z, G = H / KV;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / LPG, sl = lane % LPG;

  // the row's pages that cover [lo, len), cut into n_live near-equal
  // contiguous shares of at least one ring of keys (the first n_live
  // splits; the rest have nothing to read), as the bf16 kernel cuts them
  int len, lo, row_begin;
  row_extent(b, lengths, lower, start, q_pos, eff_win, len, lo);
  const int n = row_pages(len, lo, ps, P, row_begin);
  const int min_pages = max(Tile::RING_KEYS / ps, 1);
  const int n_live = min(S, (n + min_pages - 1) / min_pages);
  if (split > 0 && split >= n_live) {
    cluster_sync_acq_rel();
    cluster_sync_relaxed();
    return;
  }
  const int p_begin = split < n_live ? row_begin + n * split / n_live : row_begin;
  const int n_pages =
      split < n_live ? row_begin + n * (split + 1) / n_live - p_begin : 0;

  uint8_t* ring = smem + warp * DF_STAGES * Tile::STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(
                       smem + (Tile::SMEM - DB_WARPS * DF_STAGES * 8)) +
                   warp * DF_STAGES;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < DF_STAGES; ++s) mbar_init(&full[s], 32);
  }
  __syncwarp();

  // the split's visible keys [k_lo, k_hi), in KB-key blocks
  const int k_lo = max(lo, p_begin * ps);
  const int k_hi = min(len, (p_begin + n_pages) * ps);
  const int jb = k_lo / KB;
  const int je = k_hi > k_lo ? (k_hi + KB - 1) / KB : jb;
  const int nblk = je - jb > warp ? (je - jb - warp + DB_WARPS - 1) / DB_WARPS : 0;
  const int* row_table = page_table + (long long)b * P;
  const long long page_elems = (long long)KV * ps * HD;
  const float* k_head = k_pools + layer_offset + (long long)kv * ps * HD;
  const float* v_head = v_pools + layer_offset + (long long)kv * ps * HD;
  // page sizes are powers of two: shifts, not divisions, in the key loop
  const int ps_log = __ffs(ps) - 1;

  // stage block i of this warp's walk, KB rows of one page (a page id
  // outside the pool is never read; the stage's barrier still completes
  // and its compute is skipped)
  auto issue = [&](int i) {
    const int key0 = (jb + warp + i * DB_WARPS) * KB;
    const int page = row_table[key0 >> ps_log];
    uint8_t* st = ring + (i % DF_STAGES) * Tile::STAGE_BYTES;
    if (page >= 0 && page < N) {
      const long long off = page * page_elems + (long long)(key0 & (ps - 1)) * HD;
#pragma unroll
      for (int c = lane; c < KB * CH; c += 32) {
        cp_async16(st + c * 16, k_head + off + c * 4);
        cp_async16(st + Tile::KV_BYTES + c * 16, v_head + off + c * 4);
      }
    }
    cp_async_arrive(&full[i % DF_STAGES]);
  };
#pragma unroll
  for (int i = 0; i < DF_STAGES - 1; ++i)
    if (i < nblk) issue(i);

  // split 0 folds the fused window's in-flight keys: their K and V rows
  // of this kv head are staged behind the first stages
  const int nw = wk != nullptr && split == 0 ? Kw : 0;
  uint8_t* wk_s = smem + Tile::WIN_OFFSET;                        // [MAX_KW, HD]
  float* wv_s = reinterpret_cast<float*>(wk_s + MAX_KW * HD * 4);  // [MAX_KW, HD]
  float* wsc_s = wv_s + MAX_KW * HD;                              // [MAX_G][MAX_KW]
  for (int c = tid; c < nw * CH; c += DB_THREADS) {
    const int w = c / CH, cc = c - w * CH;
    const long long row = (((long long)b * Kw + w) * KV + kv) * HD + cc * 4;
    cp_async16(wk_s + c * 16, wk + row);
    cp_async16(wv_s + w * HD + cc * 4, wv + row);
  }

  // q of head g, this lane's chunks (zero for a lane past the group)
  float4 qv[NV];
  {
    const float* qr = q + ((long long)b * H + kv * G + (g < G ? g : 0)) * HD;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      qv[i] = g < G ? *reinterpret_cast<const float4*>(qr + 4 * (i * LPG + sl))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 o[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) o[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = NEG_INF, l = 0.f;

  for (int i = 0; i < nblk; ++i) {
    if (i + DF_STAGES - 1 < nblk) issue(i + DF_STAGES - 1);
    const int key0 = (jb + warp + i * DB_WARPS) * KB;
    const int page = row_table[key0 >> ps_log];
    mbar_wait(&full[i % DF_STAGES], (i / DF_STAGES) & 1);
    if (page >= 0 && page < N) {  // uniform across the warp
      const uint8_t* ks = ring + (i % DF_STAGES) * Tile::STAGE_BYTES;
      const uint8_t* vs = ks + Tile::KV_BYTES;
      float x[KB];
      df_dots<HD, LPG, KB>(x, ks, qv, sl);
      // online softmax of head g over the block's visible keys
      float mx = NEG_INF;
      bool vis[KB];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int pos = key0 + j;
        x[j] = cap(x[j] * scale, softcap);
        vis[j] = in_extent(pos, lo, len);
        if (vis[j]) mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f((m - m_new) * LOG2E);
      m = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        x[j] = vis[j] ? exp2f((x[j] - m_new) * LOG2E) : 0.f;
        sum += x[j];
      }
      l = l * alpha + sum;
      // O = O * alpha + P V on this lane's chunks
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        o[c].x *= alpha;
        o[c].y *= alpha;
        o[c].z *= alpha;
        o[c].w *= alpha;
      }
#pragma unroll
      for (int j = 0; j < KB; ++j)
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              vs + j * HD * 4 + 16 * (c * LPG + sl));
          o[c].x = fmaf(x[j], v.x, o[c].x);
          o[c].y = fmaf(x[j], v.y, o[c].y);
          o[c].z = fmaf(x[j], v.z, o[c].z);
          o[c].w = fmaf(x[j], v.w, o[c].w);
        }
    }
    __syncwarp();  // every lane is done with the stage before it refills
  }

  // merge the warps, the first block-wide barrier, after the loop
  if (nw > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem);     // [DB_WARPS][MAX_G][HD]
  float* ml_s = o_s + DB_WARPS * MAX_G * HD;       // [DB_WARPS][MAX_G][2]
  float* w_s = ml_s + 2 * DB_WARPS * MAX_G;        // [DB_WARPS][MAX_G]
  float* part_ml = w_s + DB_WARPS * MAX_G;         // [MAX_G][2]
  float* fw_s = part_ml + 2 * MAX_G;               // [MAX_G][MAX_SPLITS]
  float* L_s = fw_s + MAX_G * MAX_SPLITS;          // [MAX_G]
  if (g < G) {
    float* orow = o_s + (warp * MAX_G + g) * HD;
#pragma unroll
    for (int c = 0; c < NV; ++c)
      *reinterpret_cast<float4*>(orow + 4 * (c * LPG + sl)) = o[c];
    if (sl == 0) {
      ml_s[(warp * MAX_G + g) * 2] = m;
      ml_s[(warp * MAX_G + g) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // split 0, warp 1: the window slots' scores (a slot out of view scores
  // -inf, which weighs exactly 0 in the fold), as the bf16 kernel's
  if (nw > 0 && warp == 1) {
    float x[MAX_KW];
    df_dots<HD, LPG, MAX_KW>(x, wk_s, qv, sl);
    const int st = start[b];
    const int floor_pos = eff_win != nullptr ? q_pos[b] - eff_win[b] : INT_MIN;
#pragma unroll
    for (int w = 0; w < MAX_KW; ++w) {
      const bool vis = w < nw && w < n_win && st >= 0 && st + w > floor_pos;
      if (g < G && sl == 0)
        wsc_s[g * MAX_KW + w] = vis ? cap(x[w] * scale, softcap) : -INFINITY;
    }
  }
  // the block's (m, l) per head, and each warp's weight in it
  if (tid < G) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) M = fmaxf(M, ml_s[(w * MAX_G + tid) * 2]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float e = exp2f((ml_s[(w * MAX_G + tid) * 2] - M) * LOG2E);
      w_s[w * MAX_G + tid] = e;
      L += e * ml_s[(w * MAX_G + tid) * 2 + 1];
    }
    part_ml[tid * 2] = M;
    part_ml[tid * 2 + 1] = L;
  }
  __syncthreads();
  // the block's partial (unnormalized output at the block's max) in warp
  // 0's slot
  for (int i = tid; i < G * HD / 4; i += DB_THREADS) {
    const int gi = i / (HD / 4), d = (i - gi * (HD / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float e = w_s[w * MAX_G + gi];
      const float4 x = *reinterpret_cast<const float4*>(o_s + (w * MAX_G + gi) * HD + d);
      a.x += e * x.x;
      a.y += e * x.y;
      a.z += e * x.z;
      a.w += e * x.w;
    }
    *reinterpret_cast<float4*>(o_s + gi * HD + d) = a;
  }
  cluster_sync_acq_rel();
  if (split != 0) {
    cluster_sync_relaxed();  // keeps this block's partial alive for split 0
    return;
  }

  // split 0 folds the live splits' partials and the window keys, as the
  // bf16 kernel does
  const int n_src = max(n_live, 1);
  const uint32_t ml_local = smem_u32(part_ml), o_local = smem_u32(o_s);
  for (int gi = warp; gi < G; gi += DB_WARPS) {
    float x = -INFINITY, mass = 0.f;
    if (lane < n_src) {
      const float2 v = ld_dsmem_f2(dsmem_addr(ml_local + gi * 8, lane));
      x = v.x;
      mass = v.y;
    } else if (lane >= MAX_SPLITS && lane - MAX_SPLITS < nw) {
      x = wsc_s[gi * MAX_KW + lane - MAX_SPLITS];
      mass = 1.f;
    }
    const float M = fmaxf(warp_max(x), NEG_INF);
    const float e = exp2f((x - M) * LOG2E);
    const float L = warp_sum(e * mass);
    if (lane < MAX_SPLITS)
      fw_s[gi * MAX_SPLITS + lane] = e;
    else if (lane - MAX_SPLITS < MAX_KW)
      wsc_s[gi * MAX_KW + lane - MAX_SPLITS] = e;
    if (lane == 0) {
      L_s[gi] = L;
      if (m_out != nullptr) {
        m_out[(long long)b * H + kv * G + gi] = M;
        l_out[(long long)b * H + kv * G + gi] = L;
      }
    }
  }
  __syncthreads();
  const long long obase = ((long long)b * H + kv * G) * HD;
  for (int i = tid; i < G * HD / 4; i += DB_THREADS) {
    const int gi = i / (HD / 4), d = (i - gi * (HD / 4)) * 4;
    const uint32_t src = o_local + (uint32_t)(gi * HD + d) * 4;
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n_src) x[s] = ld_dsmem_f4(dsmem_addr(src, s));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < n_src) {
        const float e = fw_s[gi * MAX_SPLITS + s];
        a.x += e * x[s].x;
        a.y += e * x[s].y;
        a.z += e * x[s].z;
        a.w += e * x[s].w;
      }
    }
    for (int w = 0; w < nw; ++w) {
      const float e = wsc_s[gi * MAX_KW + w];
      const float4 v = *reinterpret_cast<const float4*>(wv_s + w * HD + d);
      a.x += e * v.x;
      a.y += e * v.y;
      a.z += e * v.z;
      a.w += e * v.w;
    }
    const float Lc = fmaxf(L_s[gi], 1e-9f);
    *reinterpret_cast<float4*>(out + obase + gi * HD + d) =
        make_float4(a.x / Lc, a.y / Lc, a.z / Lc, a.w / Lc);
  }
  cluster_sync_relaxed();  // the other splits' shared memory outlives the reads
}

// ---------------------------------------------------- route 0: generic
// blocks of DB_THREADS (DB_WARPS independent warps), as every route's:
// ClusterLaunch launches each with DB_THREADS
constexpr int DG_STAGES = 3;                // stages in each warp's ring
constexpr int DG_ROWS = 16;                 // head rows of a tile: mma's m16

// stages in each warp's ring: DG_STAGES, and in the wide form (head_dim
// above 256, whole K rows) 2 in 16 bits and 1 in float32, so that four
// rings fit; a row takes one live split for each ring of key blocks
// (each warp's stages) it fills
__host__ __device__ constexpr int dg_stages(int esize, bool wide) {
  return wide ? (esize == 4 ? 1 : 2) : DG_STAGES;
}

// keys a block, by element size: 16 in 16 bits (one m16n8k16 k-step of
// P V), 8 in float32 (one m16n8k8 k-step), so that a stage holds about
// as many bytes in either
__host__ __device__ constexpr int dg_keys(int esize) {
  return esize == 4 ? 8 : 16;
}

// Row strides in elements: Q and K hdp + 8, so that the eight 16-byte rows
// of an ldmatrix phase (16-bit) or the float2 fragment loads of a half
// warp (float32) meet different banks; V the same in 16 bits (read by
// ldmatrix.trans), hdp + 4 in float32, where lane (g, t) reads column g
// of keys 2t and 2t + 1.
__host__ __device__ constexpr int dg_v_stride(int esize, int hdp) {
  return esize == 4 ? hdp + 4 : hdp + 8;
}

// Shared memory of a block, in bytes: Q [16, qw + 8] and the warps'
// rings of `st` stages (a stage: K [keys, qw + 8], then V [keys, v
// stride]), which the merge at the end reuses as float32 [warps, 16,
// hdp] partial outputs, the warps' (m, l) and weights, the block's (m, l)
// and split 0's fold weights; then each stage's row sources (long long a
// key) and visible-key mask. qw = hdp but in the wide form, where it is
// gn_qk_width and hdp the column tile's width. ops/paged_attention.py
// decode_generic_plan mirrors it; dyn_paged_decode_generic_smem lets the
// card tests hold the two equal.
__host__ __device__ constexpr int dg_ring_bytes(int esize, int hdp, int qw,
                                                int st) {
  return (DG_ROWS * (qw + 8) + DB_WARPS * st * dg_keys(esize) *
                                   (qw + 8 + dg_v_stride(esize, hdp))) *
         esize;
}
__host__ __device__ constexpr int dg_merge_bytes(int hdp) {
  return 4 * (DB_WARPS * DG_ROWS * hdp + 3 * DB_WARPS * DG_ROWS +
              2 * DG_ROWS + DG_ROWS * MAX_SPLITS + DG_ROWS);
}
__host__ __device__ constexpr int dg_main_bytes(int esize, int hdp, int qw,
                                                int st) {
  return dg_ring_bytes(esize, hdp, qw, st) > dg_merge_bytes(hdp)
             ? dg_ring_bytes(esize, hdp, qw, st)
             : dg_merge_bytes(hdp);
}
__host__ __device__ constexpr int dg_smem(int esize, int hdp, int qw, int st) {
  return dg_main_bytes(esize, hdp, qw, st) +
         DB_WARPS * st * (dg_keys(esize) * 8 + 4);
}

// dg_smem at head_dim hd in a type of esize bytes
__host__ __device__ constexpr int dg_smem_hd(int esize, int hd) {
  return hd > GN_MAX_COLS
             ? dg_smem(esize, gn_hdp(gn_col_width(hd)), gn_qk_width(hd),
                       dg_stages(esize, true))
             : dg_smem(esize, gn_hdp(hd), gn_hdp(hd), DG_STAGES);
}

template <int ST>
__device__ __forceinline__ void cp_async_wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(ST - 1) : "memory");
}

// The power of two at least n, at most 32: the lanes a row's copies take.
__host__ __device__ constexpr int dg_row_lanes(int n) {
  return n >= 32 ? 32 : n > 16 ? 32 : n > 8 ? 16 : n > 4 ? 8 : n > 2 ? 4
       : n > 1 ? 2 : 1;
}

// The copies of one key block's K and V rows into a warp's stage, BYTES
// a copy (copy_zfill). src[i]: row i's element offset in the layer's pool
// (>= 0), or -2 - its offset in the window buffers wk/wv (<= -2), or -1:
// not read, the row zero-filled. The copies of a padded row go to LPR
// lanes, which take the same columns of every row they copy, K and V
// together; every trip count is known at compile time, so the loops
// unroll and the rows' offsets load together. Columns past hd are not
// written.
template <typename T, int HDP, int BYTES>
__device__ __forceinline__ void dg_copy(T* ks, const long long* src,
                                        const T* k_base, const T* v_base,
                                        const T* wk, const T* wv, int hd,
                                        int lane) {
  constexpr int KB = dg_keys(sizeof(T)), KS = HDP + 8;
  constexpr int VS = dg_v_stride(sizeof(T), HDP), CE = BYTES / sizeof(T);
  constexpr int CPR = HDP / CE, LPR = dg_row_lanes(CPR), RPP = 32 / LPR;
  T* vs = ks + KB * KS;
  const int r0 = lane / LPR, c0 = (lane % LPR) * CE;
#pragma unroll
  for (int pass = 0; pass < (KB + RPP - 1) / RPP; ++pass) {
    const int r = pass * RPP + r0;
    if (RPP > KB && r >= KB) continue;
    const long long off = src[r];
    const bool ok = off != -1;
    const T* kg = off >= 0 ? k_base + off : ok ? wk + (-2 - off) : k_base;
    const T* vg = off >= 0 ? v_base + off : ok ? wv + (-2 - off) : k_base;
#pragma unroll
    for (int j = 0; j < (CPR + LPR - 1) / LPR; ++j) {
      const int c = c0 + j * LPR * CE;
      if (c < hd) {
        copy_zfill<T, BYTES>(ks + r * KS + c, kg + c, ok);
        copy_zfill<T, BYTES>(vs + r * VS + c, vg + c, ok);
      }
    }
  }
}

// dg_copy in the wide form: K's hd columns at row stride KS, V's vc
// columns from column c0 (the block's column tile); trip counts known at
// run time.
template <typename T, int HDP, int BYTES>
__device__ __forceinline__ void dg_copy_wide(T* ks, const long long* src,
                                             const T* k_base, const T* v_base,
                                             const T* wk, const T* wv, int hd,
                                             int vc, int c0, int KS,
                                             int lane) {
  constexpr int KB = dg_keys(sizeof(T)), CE = BYTES / sizeof(T);
  constexpr int VS = dg_v_stride(sizeof(T), HDP);
  T* vs = ks + KB * KS;
  const int cpk = hd / CE, cpv = vc / CE;
  for (int i = lane; i < KB * cpk; i += 32) {
    const int r = i / cpk, c = (i - r * cpk) * CE;
    const long long off = src[r];
    const T* kg = off >= 0 ? k_base + off : off != -1 ? wk + (-2 - off) : k_base;
    copy_zfill<T, BYTES>(ks + r * KS + c, kg + c, off != -1);
  }
  for (int i = lane; i < KB * cpv; i += 32) {
    const int r = i / cpv, c = (i - r * cpv) * CE;
    const long long off = src[r];
    const T* vg = off >= 0 ? v_base + off : off != -1 ? wv + (-2 - off) : v_base;
    copy_zfill<T, BYTES>(vs + r * VS + c, vg + c0 + c, off != -1);
  }
}

// grid (B, KV * head tiles * CT, S), clusters (1, 1, S): the S splits of
// one (row, kv head, head tile, column tile) are one cluster, split =
// blockIdx.z = the block's rank in it. A head tile is up to 16 query
// heads of one kv head (head tile t holds heads 16t .. 16t + 15 of the
// group; rows past the group are zero). T: float (3xTF32),
// __nv_bfloat16 or __half; HDP: head_dim padded to a width of gn_hdp.
// Block DB_THREADS: four warps, each an independent worker over the key
// blocks w, w + 4, ... of the split's share, with its own ring of
// dg_stages stages, its own m, l and output fragment (rows g and g + 8 of
// the tile, lane = 4g + t). Split 0 also walks the fused window's
// in-flight keys, as blocks after its pool blocks. Shared memory: see
// dg_smem. WIDE (head_dim above 256): Q and K rows at qw =
// gn_qk_width(hd) columns for the scores, HDP the padded width of the
// block's value columns [c0, c0 + cw) (column tile ct of CT,
// gn_col_width), which alone it folds and writes; each column tile
// repeats the scores.
template <typename T, int HDP, bool WIDE>
__global__ void __launch_bounds__(DB_THREADS)
paged_decode_generic_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_pools,
                            const T* __restrict__ v_pools,
                            long long layer_offset,
                            const int* __restrict__ page_table,
                            const int* __restrict__ lengths,
                            const int* __restrict__ lower,
                            T* __restrict__ out, float* __restrict__ m_out,
                            float* __restrict__ l_out,
                            const int* __restrict__ start,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ eff_win,
                            const T* __restrict__ wk,
                            const T* __restrict__ wv, int n_win, int Kw,
                            int H, int KV, int N, int ps, int hd, int P,
                            int HT, int qw, int cw, int CT, float scale,
                            float softcap) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int ES = sizeof(T), KB = dg_keys(ES), ST = dg_stages(ES, WIDE);
  constexpr int VS = dg_v_stride(ES, HDP);
  // Q and K: QW columns in rows of KS (QW is the constant HDP outside the
  // wide form, so that the loops over it unroll fully there); the
  // block's value columns [c0, c0 + vc)
  const int QW = WIDE ? qw : HDP, KS = QW + 8, STAGE = KB * (KS + VS);
  const int CTS = WIDE ? CT : 1, yt = blockIdx.y / CTS;
  const int c0 = WIDE ? (int)(blockIdx.y - yt * CTS) * cw : 0;
  const int vc = WIDE ? min(cw, hd - c0) : hd;
  extern __shared__ __align__(16) uint8_t dg_smem_raw[];
  T* q_s = reinterpret_cast<T*>(dg_smem_raw);
  T* rings = q_s + DG_ROWS * KS;
  long long* src_all = reinterpret_cast<long long*>(
      dg_smem_raw + dg_main_bytes(ES, HDP, QW, ST));
  uint32_t* mask_all =
      reinterpret_cast<uint32_t*>(src_all + DB_WARPS * ST * KB);

  const int b = blockIdx.x, kv = yt / HT;
  const int h0 = (yt - kv * HT) * DG_ROWS;
  const int split = blockIdx.z, S = gridDim.z, G = H / KV;
  const int GT = min(G - h0, DG_ROWS);  // the tile's heads
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, tq = lane & 3;

  // the row's key blocks [jb_row, jb_row + nrow) of KB positions that
  // cover its visible extent [lo, len) (and no position past the page
  // table), cut into n_live near-equal contiguous shares, one for each
  // ring of blocks the row fills up to S (the first n_live splits; the
  // rest have nothing to read)
  int len, lo;
  row_extent(b, lengths, lower, start, q_pos, eff_win, len, lo);
  const int len_t = (int)min((long long)len, (long long)P * ps);
  const int jb_row = lo / KB;
  const int nrow = len_t > lo ? (len_t + KB - 1) / KB - jb_row : 0;
  const int n_live = min(S, (nrow + DB_WARPS * ST - 1) / (DB_WARPS * ST));
  // a split without blocks only keeps the cluster's two barriers; split 0
  // folds even when no split has any (zeros, or the window keys alone)
  if (split > 0 && split >= n_live) {
    cluster_sync_acq_rel();
    cluster_sync_relaxed();
    return;
  }
  const int jb = split < n_live
                     ? jb_row + (int)((long long)nrow * split / n_live)
                     : jb_row;
  const int nb = split < n_live
                     ? jb_row + (int)((long long)nrow * (split + 1) / n_live) - jb
                     : 0;
  // split 0's window blocks follow its pool blocks
  const int nwb = wk != nullptr && split == 0 ? (Kw + KB - 1) / KB : 0;
  const int nv = nb + nwb;
  const int nblk = nv > warp ? (nv - warp + DB_WARPS - 1) / DB_WARPS : 0;

  // copies of rows of hd elements: 16 bytes where a row is a multiple of
  // 16 bytes, else 8 or 4, else (16-bit rows of an odd head_dim) 2
  const int row_bytes = hd * ES;
  const int cbytes = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8
                   : row_bytes % 4 == 0 ? 4 : 2;
  // Q of the tile's heads by cp.async, the first group (rows past GT and
  // columns past hd zero-filled), and zeros in the columns hd .. QW - 1
  // of every stage's K rows and vc .. HDP - 1 of its V rows (the copies
  // write the first hd and vc)
  const long long qbase = ((long long)b * H + (long long)kv * G + h0) * hd;
  {
    const int ce = cbytes / ES, cpr = QW / ce;
    for (int i = tid; i < DG_ROWS * cpr; i += DB_THREADS) {
      const int r = i / cpr, d = (i - r * cpr) * ce;
      const bool ok = r < GT && d < hd;
      const T* src = q + (ok ? qbase + (long long)r * hd + d : 0);
      if (cbytes == 16)
        cp_async_zfill<16>(q_s + r * KS + d, src, ok);
      else if (cbytes == 8)
        cp_async_zfill<8>(q_s + r * KS + d, src, ok);
      else if (F32 || cbytes == 4)
        cp_async_zfill<4>(q_s + r * KS + d, src, ok);
      else
        q_s[r * KS + d] = ok ? *src : from_f<T>(0.f);
    }
    cp_async_commit();
  }
  const int kpad = QW - hd, vpad = HDP - vc;
  for (int i = tid; i < DB_WARPS * ST * KB * kpad; i += DB_THREADS) {
    const int row = i / kpad, d = hd + i - row * kpad;
    rings[(row / KB) * STAGE + (row % KB) * KS + d] = from_f<T>(0.f);
  }
  for (int i = tid; i < DB_WARPS * ST * KB * vpad; i += DB_THREADS) {
    const int row = i / vpad, d = vc + i - row * vpad;
    rings[(row / KB) * STAGE + KB * KS + (row % KB) * VS + d] = from_f<T>(0.f);
  }

  T* ring = rings + warp * ST * STAGE;
  long long* src_w = src_all + warp * ST * KB;
  uint32_t* mask_w = mask_all + warp * ST;
  const int* row_table = page_table + (long long)b * P;
  const T* k_base = k_pools + layer_offset;
  const T* v_base = v_pools + layer_offset;
  const int st_b = wk != nullptr ? start[b] : 0;
  const int floor_pos =
      wk != nullptr && eff_win != nullptr ? q_pos[b] - eff_win[b] : INT_MIN;

  // lane r < KB: the page-table entry of key r of the warp's i-th block
  // when that is a pool block (-1 past the table), loaded a block ahead
  // of its copies
  auto page_of = [&](int i) -> int {
    const int v = warp + i * DB_WARPS;
    if (i >= nblk || v >= nb || lane >= KB) return -1;
    const int p = ((jb + v) * KB + lane) / ps;
    return p < P ? row_table[p] : -1;
  };
  // the warp's i-th block into stage i % ST: each key row's source
  // and the block's mask of visible keys, then the copies. A pool key is
  // visible in [lo, len) on a page inside the pool; window slot w (position
  // start + w) when w < n_win, start >= 0 and start + w > q_pos - eff_win
  // (the merge of dynamo_tpu/models/llama.py:981-1006). A key out of view
  // is not read: its rows are zero-filled and masked.
  auto issue = [&](int i, int page) {
    const int v = warp + i * DB_WARPS, s = i % ST;
    bool vis = false;
    if (lane < KB) {
      long long off = -1;
      if (v < nb) {
        const int key = (jb + v) * KB + lane;
        vis = in_extent(key, lo, len) && page >= 0 && page < N;
        if (vis)
          off = (((long long)page * KV + kv) * ps + key % ps) * hd;
      } else {
        const int w = (v - nb) * KB + lane;
        vis = w < Kw && w < n_win && st_b >= 0 && st_b + w > floor_pos;
        if (vis) off = -2 - (((long long)b * Kw + w) * KV + kv) * hd;
      }
      src_w[s * KB + lane] = off;
    }
    const uint32_t m = __ballot_sync(0xffffffffu, vis);
    if (lane == 0) mask_w[s] = m;
    __syncwarp();
    T* ks = ring + s * STAGE;
    const long long* src = src_w + s * KB;
#define DG_COPY(BYTES)                                                      \
  if constexpr (WIDE)                                                       \
    dg_copy_wide<T, HDP, BYTES>(ks, src, k_base, v_base, wk, wv, hd, vc,    \
                                c0, KS, lane);                              \
  else                                                                      \
    dg_copy<T, HDP, BYTES>(ks, src, k_base, v_base, wk, wv, hd, lane)
    if (cbytes == 16) {
      DG_COPY(16);
    } else if (cbytes == 8) {
      DG_COPY(8);
    } else if (F32 || cbytes == 4) {
      DG_COPY(4);
    } else if constexpr (!F32) {
      DG_COPY(2);
    }
#undef DG_COPY
  };

  float o[HDP / 8][4];
#pragma unroll
  for (int nd = 0; nd < HDP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // the first blocks' table entries loaded together, then their copies;
  // Q (the first group) and every thread's zeros are in place before the
  // loop
  int pages[ST];
#pragma unroll
  for (int i = 0; i < ST; ++i) pages[i] = page_of(i);
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {
    if (i < nblk) issue(i, pages[i]);
    cp_async_commit();
  }
  int page_next = pages[ST - 1];
  cp_async_wait_stages<ST>();
  __syncthreads();
  // Q's A fragments stay in registers for the whole walk where the
  // output fragment leaves room: in 16 bits up to head_dim 128, in
  // float32 (its TF32 big and small parts) up to 96
  constexpr bool Q_REGS = !WIDE && (F32 ? HDP <= 96 : HDP <= 128);
  constexpr int QK = F32 ? HDP / 8 : HDP / 16;  // k-steps along head_dim
  uint32_t qa[Q_REGS ? QK : 1][4], qsm[Q_REGS && F32 ? QK : 1][4];
  if constexpr (Q_REGS && F32) {
#pragma unroll
    for (int kk = 0; kk < QK; ++kk) {
      const int d = 8 * kk + 2 * tq;
      const float2 x0 = *reinterpret_cast<const float2*>(q_s + g8 * KS + d);
      const float2 x1 =
          *reinterpret_cast<const float2*>(q_s + (g8 + 8) * KS + d);
      split_tf32(x0.x, qa[kk][0], qsm[kk][0]);
      split_tf32(x1.x, qa[kk][1], qsm[kk][1]);
      split_tf32(x0.y, qa[kk][2], qsm[kk][2]);
      split_tf32(x1.y, qa[kk][3], qsm[kk][3]);
    }
  } else if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < QK; ++kk)
      ldsm_x4(qa[kk], smem_u32(q_s + (lane & 15) * KS + kk * 16 +
                               (lane >> 4) * 8));
  }
  for (int i = 0; i < nblk; ++i) {
    if (i + ST - 1 < nblk) issue(i + ST - 1, page_next);
    cp_async_commit();
    page_next = page_of(i + ST);
    cp_async_wait_stages<ST>();  // block i's copies (this lane's) have landed
    __syncwarp();                // and the warp's
    const int s = i % ST;
    const uint32_t vmask = mask_w[s];
    if (vmask != 0) {  // uniform across the warp
      const T* ks = ring + s * STAGE;
      const T* vs = ks + KB * KS;

      // S = Q K^T: [16 heads, KB keys]; element e of column tile jn is
      // row g8 + 8 (e >> 1), key 8 jn + 2 tq + (e & 1)
      float sc[KB / 8][4];
#pragma unroll
      for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[jn][e] = 0.f;
      if constexpr (F32) {
        // 3xTF32 m16n8k8 along head_dim: thread t's k = t and t + 4
        // stand for elements d and d + 1 (one 8-byte load), A and B
        // alike; the three products in three accumulators, so that no
        // chain of dependent mma runs longer than head_dim / 8, summed as
        // (small x big + big x small) + big x big
        float s_sb[4] = {0.f, 0.f, 0.f, 0.f}, s_bs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < QW / 8; ++kk) {
          const int d = 8 * kk + 2 * tq;
          uint32_t ab[4], as[4];
          if constexpr (Q_REGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ab[e] = qa[kk][e];
              as[e] = qsm[kk][e];
            }
          } else {
            const float2 x0 =
                *reinterpret_cast<const float2*>(q_s + g8 * KS + d);
            const float2 x1 =
                *reinterpret_cast<const float2*>(q_s + (g8 + 8) * KS + d);
            split_tf32(x0.x, ab[0], as[0]);
            split_tf32(x1.x, ab[1], as[1]);
            split_tf32(x0.y, ab[2], as[2]);
            split_tf32(x1.y, ab[3], as[3]);
          }
          const float2 kx = *reinterpret_cast<const float2*>(ks + g8 * KS + d);
          uint32_t bb[2], bs[2];
          split_tf32(kx.x, bb[0], bs[0]);
          split_tf32(kx.y, bb[1], bs[1]);
          mma_tf32(s_sb, as, bb[0], bb[1]);
          mma_tf32(s_bs, ab, bs[0], bs[1]);
          mma_tf32(sc[0], ab, bb[0], bb[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[0][e] = (s_sb[e] + s_bs[e]) + sc[0][e];
      } else {
        // m16n8k16: Q's A fragment and the block's two key tiles' B
        // fragments a k-step, each one ldmatrix.x4
#pragma unroll
        for (int kk = 0; kk < QW / 16; ++kk) {
          uint32_t a[4], bk[4];
          if constexpr (Q_REGS) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
          } else {
            ldsm_x4(a, smem_u32(q_s + (lane & 15) * KS + kk * 16 +
                                (lane >> 4) * 8));
          }
          ldsm_x4(bk, smem_u32(ks + (((lane >> 4) << 3) + (lane & 7)) * KS +
                               kk * 16 + ((lane >> 3) & 1) * 8));
          mma_16816<T>(sc[0], a, bk[0], bk[1]);
          mma_16816<T>(sc[1], a, bk[2], bk[3]);
        }
      }

      // online softmax of rows g8 and g8 + 8 over the block's visible
      // keys (natural units, exp2 of the difference times log2 e); the
      // four lanes of a quad share a row
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[jn][e] = cap(sc[jn][e] * scale, softcap);
          if ((vmask >> (8 * jn + 2 * tq + (e & 1))) & 1)
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[jn][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * LOG2E);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int jn = 0; jn < KB / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[jn][e] = (vmask >> (8 * jn + 2 * tq + (e & 1))) & 1
                          ? exp2f((sc[jn][e] - m[e >> 1]) * LOG2E)
                          : 0.f;
          l[e >> 1] += sc[jn][e];
        }
#pragma unroll
      for (int nd = 0; nd < HDP / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] *= alpha[e >> 1];

      if constexpr (F32) {
        // O += P V in 3xTF32, one k-step of the block's 8 keys: the
        // accumulator is the A operand as it stands (columns t and t + 4
        // stand for keys 2t and 2t + 1), B's rows are V's rows 2t and
        // 2t + 1 to match; each 8-wide column tile takes the block's
        // products from zero and one float32 add (the tensor cores round
        // accumulations toward zero)
        uint32_t pb[4], psm[4];
        split_tf32(sc[0][0], pb[0], psm[0]);
        split_tf32(sc[0][2], pb[1], psm[1]);
        split_tf32(sc[0][1], pb[2], psm[2]);
        split_tf32(sc[0][3], pb[3], psm[3]);
        const float* v0 = vs + (2 * tq) * VS + g8;
#pragma unroll
        for (int nd = 0; nd < HDP / 8; ++nd) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          uint32_t bb[2], bs[2];
          split_tf32(v0[8 * nd], bb[0], bs[0]);
          split_tf32(v0[VS + 8 * nd], bb[1], bs[1]);
          mma_3xtf32(t, pb, psm, bb, bs);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[nd][e] += t[e];
        }
      } else {
        // O += P V: the S fragments rounded to T are the A operand (the
        // m16n8k16 C layout is its A layout); V's B fragments by
        // ldmatrix.trans, two 8-wide column tiles an x4
        uint32_t pa[4];
        pa[0] = pack2<T>(sc[0][0], sc[0][1]);
        pa[1] = pack2<T>(sc[0][2], sc[0][3]);
        pa[2] = pack2<T>(sc[1][0], sc[1][1]);
        pa[3] = pack2<T>(sc[1][2], sc[1][3]);
#pragma unroll
        for (int ndp = 0; ndp < HDP / 16; ++ndp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, smem_u32(vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * VS +
                                 ndp * 16 + (lane >> 4) * 8));
          mma_16816<T>(o[2 * ndp], pa, bv[0], bv[1]);
          mma_16816<T>(o[2 * ndp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncwarp();  // every lane is done with the stage before it refills
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  // merge the warps, the first block-wide barrier since the start (no
  // copy is in flight: every block a warp staged it also consumed)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(dg_smem_raw);  // [W][16][HDP]
  float* ml_s = o_s + DB_WARPS * DG_ROWS * HDP;        // [W][16][2]
  float* w_s = ml_s + 2 * DB_WARPS * DG_ROWS;          // [W][16]
  float* part_ml = w_s + DB_WARPS * DG_ROWS;           // [16][2]
  float* fw_s = part_ml + 2 * DG_ROWS;                 // [16][MAX_SPLITS]
  float* L_s = fw_s + DG_ROWS * MAX_SPLITS;            // [16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g8 + 8 * r;
    if (row < GT) {
      float* orow = o_s + (warp * DG_ROWS + row) * HDP + 2 * tq;
#pragma unroll
      for (int nd = 0; nd < HDP / 8; ++nd)
        *reinterpret_cast<float2*>(orow + 8 * nd) =
            make_float2(o[nd][2 * r], o[nd][2 * r + 1]);
      if (tq == 0) {
        ml_s[(warp * DG_ROWS + row) * 2] = m[r];
        ml_s[(warp * DG_ROWS + row) * 2 + 1] = l[r];
      }
    }
  }
  __syncthreads();
  // the block's (m, l) per head, and each warp's weight in it
  if (tid < GT) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w)
      M = fmaxf(M, ml_s[(w * DG_ROWS + tid) * 2]);
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float e = exp2f((ml_s[(w * DG_ROWS + tid) * 2] - M) * LOG2E);
      w_s[w * DG_ROWS + tid] = e;
      L += e * ml_s[(w * DG_ROWS + tid) * 2 + 1];
    }
    part_ml[tid * 2] = M;
    part_ml[tid * 2 + 1] = L;
  }
  __syncthreads();
  // the block's partial (unnormalized output at the block's max) in warp
  // 0's slot: each element is read and written by one thread
  for (int i = tid; i < GT * HDP / 4; i += DB_THREADS) {
    const int gi = i / (HDP / 4), d = (i - gi * (HDP / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < DB_WARPS; ++w) {
      const float e = w_s[w * DG_ROWS + gi];
      const float4 x =
          *reinterpret_cast<const float4*>(o_s + (w * DG_ROWS + gi) * HDP + d);
      a.x += e * x.x;
      a.y += e * x.y;
      a.z += e * x.z;
      a.w += e * x.w;
    }
    *reinterpret_cast<float4*>(o_s + gi * HDP + d) = a;
  }
  // every live split's partial is in its shared memory before split 0
  // reads it
  cluster_sync_acq_rel();
  if (split != 0) {
    cluster_sync_relaxed();  // keeps this block's partial alive for split 0
    return;
  }

  // Split 0 folds the live splits' partials (its own included): per head,
  // one warp, lanes < n_src each a split's (m, l) through distributed
  // shared memory; the joint max and sum by shuffles, each split's
  // weight to shared memory.
  const int n_src = max(n_live, 1);
  const uint32_t ml_local = smem_u32(part_ml), o_local = smem_u32(o_s);
  for (int gi = warp; gi < GT; gi += DB_WARPS) {
    float x = -INFINITY, mass = 0.f;  // -inf weighs exactly 0
    if (lane < n_src) {
      const float2 v = ld_dsmem_f2(dsmem_addr(ml_local + gi * 8, lane));
      x = v.x;
      mass = v.y;
    }
    const float M = fmaxf(warp_max(x), NEG_INF);
    const float e = exp2f((x - M) * LOG2E);
    const float L = warp_sum(e * mass);
    if (lane < MAX_SPLITS) fw_s[gi * MAX_SPLITS + lane] = e;
    if (lane == 0) {
      L_s[gi] = L;
      if (m_out != nullptr && c0 == 0) {
        m_out[(long long)b * H + kv * G + h0 + gi] = M;
        l_out[(long long)b * H + kv * G + h0 + gi] = L;
      }
    }
  }
  __syncthreads();
  // the output, four head_dim elements of one head a thread: the live
  // splits' partials loaded together through distributed shared memory
  for (int i = tid; i < GT * HDP / 4; i += DB_THREADS) {
    const int gi = i / (HDP / 4), d = (i - gi * (HDP / 4)) * 4;
    if (d >= vc) continue;
    const uint32_t src = o_local + (uint32_t)(gi * HDP + d) * 4;
    float4 x[MAX_SPLITS];
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n_src) x[s] = ld_dsmem_f4(dsmem_addr(src, s));
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s) {
      if (s < n_src) {
        const float e = fw_s[gi * MAX_SPLITS + s];
        a[0] += e * x[s].x;
        a[1] += e * x[s].y;
        a[2] += e * x[s].z;
        a[3] += e * x[s].w;
      }
    }
    const float Lc = fmaxf(L_s[gi], 1e-9f);
    T* orow = out + qbase + (long long)gi * hd + c0 + d;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d + e < vc) orow[e] = from_f<T>(a[e] / Lc);
  }
  cluster_sync_relaxed();  // the other splits' shared memory outlives the reads
}

}  // namespace

// The fused decode window's in-flight keys (null wk = none).
struct Window {
  const void* wk;
  const void* wv;
  const int* start;
  const int* q_pos;
  const int* eff_win;
  int n_win;
  int Kw;
};

// The operands of one decode call.
struct DecodeArgs {
  const void* q;
  const void* k_pools;
  const void* v_pools;
  long long layer;
  const int* page_table;
  const int* lengths;  // null in the window form (extent from the window)
  const int* lower;
  void* out;
  float* m_out;
  float* l_out;
  int B, H, KV, N, ps, hd, P, splits;
  float scale, softcap;
};

// A launch of a cluster kernel (any route) with `smem` bytes of shared
// memory: grid `grid`, in clusters of (1, 1, grid.z) blocks (the splits
// of one (row, kv head), or of one (row, kv head, head tile) on the
// generic route). Built in place: the config points at the attribute
// beside it.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  template <typename K>
  ClusterLaunch(K kernel, int smem, dim3 grid, cudaStream_t st) : cfg{} {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = grid.z;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(DB_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// f(kernel, smem) on the bf16 kernel's instantiation for head_dim hd in
// element type T (bfloat16, or float16 for its float16 form)
template <typename T, typename F>
int with_mma_kernel(int hd, F f) {
  switch (hd) {
    case 64: return f(paged_decode_bf16_kernel<64, T>, DecodeTile<64>::SMEM);
    case 128: return f(paged_decode_bf16_kernel<128, T>, DecodeTile<128>::SMEM);
    case 256: return f(paged_decode_bf16_kernel<256, T>, DecodeTile<256>::SMEM);
  }
  return (int)cudaErrorInvalidValue;
}

// one cluster launch: the bf16 kernel (or its float16 form, T = __half)
// folds its splits and the window itself; a launch the card refuses
// returns its error
template <typename T>
int launch_bf16(const DecodeArgs& a, const Window& win, cudaStream_t st) {
  const long long layer_offset = a.layer * (long long)a.N * a.KV * a.ps * a.hd;
  return with_mma_kernel<T>(a.hd, [&](auto kernel, int smem) {
    ClusterLaunch l(kernel, smem, dim3(a.B, a.KV, a.splits), st);
    const cudaError_t err = cudaLaunchKernelEx(
        &l.cfg, kernel, static_cast<const T*>(a.q),
        static_cast<const T*>(a.k_pools), static_cast<const T*>(a.v_pools),
        layer_offset, a.page_table, a.lengths, a.lower, static_cast<T*>(a.out),
        a.m_out, a.l_out, win.start, win.q_pos, win.eff_win,
        static_cast<const T*>(win.wk), static_cast<const T*>(win.wv),
        win.n_win, win.Kw, a.H, a.KV, a.N, a.ps, a.P, a.scale, a.softcap);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  });
}

// f(kernel, smem) on the float32 kernel's instantiation for head_dim HD
// and G query heads a kv head (its lanes a head, df_lanes)
template <int HD, typename F>
int f32_lanes(int G, F f) {
  constexpr int SMEM = DecodeF32Tile<HD>::SMEM;
  switch (df_lanes(HD, G)) {
    case 4: return f(paged_decode_f32_kernel<HD, 4>, SMEM);
    case 8: if constexpr (HD >= 32) return f(paged_decode_f32_kernel<HD, 8>, SMEM); break;
    case 16: if constexpr (HD >= 64) return f(paged_decode_f32_kernel<HD, 16>, SMEM); break;
    case 32: if constexpr (HD >= 128) return f(paged_decode_f32_kernel<HD, 32>, SMEM); break;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename F>
int with_f32_kernel(int hd, int G, F f) {
  switch (hd) {
    case 16: return f32_lanes<16>(G, f);
    case 32: return f32_lanes<32>(G, f);
    case 64: return f32_lanes<64>(G, f);
    case 128: return f32_lanes<128>(G, f);
    case 256: return f32_lanes<256>(G, f);
  }
  return (int)cudaErrorInvalidValue;
}

// one cluster launch of the float32 kernel, as launch_bf16
int launch_f32(const DecodeArgs& a, const Window& win, cudaStream_t st) {
  const long long layer_offset = a.layer * (long long)a.N * a.KV * a.ps * a.hd;
  return with_f32_kernel(a.hd, a.H / a.KV, [&](auto kernel, int smem) {
    ClusterLaunch l(kernel, smem, dim3(a.B, a.KV, a.splits), st);
    const cudaError_t err = cudaLaunchKernelEx(
        &l.cfg, kernel, static_cast<const float*>(a.q),
        static_cast<const float*>(a.k_pools),
        static_cast<const float*>(a.v_pools), layer_offset, a.page_table,
        a.lengths, a.lower, static_cast<float*>(a.out), a.m_out, a.l_out,
        win.start, win.q_pos, win.eff_win, static_cast<const float*>(win.wk),
        static_cast<const float*>(win.wv), win.n_win, win.Kw, a.H, a.KV,
        a.N, a.ps, a.P, a.scale, a.softcap);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  });
}

// f(kernel, smem) on the generic kernel's instantiation for element type
// T at head_dim hd (padded to gn_hdp; above 256 the wide form, at its
// column tile's padded width)
template <typename T, typename F>
int with_generic_kernel(int hd, F f) {
  const int smem = dg_smem_hd(sizeof(T), hd);
  if (smem > GN_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
#define DG_CASE(HDP, WIDE)                                                  \
  case HDP:                                                                 \
    return f(paged_decode_generic_kernel<T, HDP, WIDE>, smem);
  if (hd > GN_MAX_COLS) {  // column tiles of more than 128 columns
    switch (gn_hdp(gn_col_width(hd))) { DG_CASE(192, true) DG_CASE(256, true) }
    return (int)cudaErrorInvalidValue;
  }
  switch (gn_hdp(hd)) {
    DG_CASE(16, false) DG_CASE(32, false) DG_CASE(64, false)
    DG_CASE(96, false) DG_CASE(128, false) DG_CASE(192, false)
    DG_CASE(256, false)
  }
#undef DG_CASE
  return (int)cudaErrorInvalidValue;
}

// one cluster launch of the generic kernel in element type T: grid (B,
// KV x head tiles x column tiles, splits); it folds its splits and the
// window itself
template <typename T>
int launch_generic(const DecodeArgs& a, const Window& win, cudaStream_t st) {
  const int HT = (a.H / a.KV + DG_ROWS - 1) / DG_ROWS, CT = gn_col_tiles(a.hd);
  if ((long long)a.KV * HT * CT > 65535) return (int)cudaErrorInvalidValue;
  const long long layer_offset = a.layer * (long long)a.N * a.KV * a.ps * a.hd;
  return with_generic_kernel<T>(a.hd, [&](auto kernel, int smem) {
    ClusterLaunch l(kernel, smem, dim3(a.B, a.KV * HT * CT, a.splits), st);
    const cudaError_t err = cudaLaunchKernelEx(
        &l.cfg, kernel, static_cast<const T*>(a.q),
        static_cast<const T*>(a.k_pools), static_cast<const T*>(a.v_pools),
        layer_offset, a.page_table, a.lengths, a.lower, static_cast<T*>(a.out),
        a.m_out, a.l_out, win.start, win.q_pos, win.eff_win,
        static_cast<const T*>(win.wk), static_cast<const T*>(win.wv),
        win.n_win, win.Kw, a.H, a.KV, a.N, a.ps, a.hd, a.P, HT,
        gn_qk_width(a.hd), gn_col_width(a.hd), CT, a.scale, a.softcap);
    return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
  });
}

// f(kernel, smem) on the generic kernel in dtype (0 = float32, 1 =
// bfloat16, 2 = float16) at head_dim hd
template <typename F>
int with_generic_dtype(int dtype, int hd, F f) {
  return dtype == 0   ? with_generic_kernel<float>(hd, f)
         : dtype == 1 ? with_generic_kernel<__nv_bfloat16>(hd, f)
                      : with_generic_kernel<__half>(hd, f);
}

// The bf16 kernel's shapes (and its float16 form's); the wrapper's
// DECODE_BF16_* (and
// DECODE_BF16_MAX_SPLITS for MAX_SPLITS) list the same, and
// tests/test_torch_kernels.py holds the two against each other.
bool bf16_shape(int H, int KV, int ps, int hd) {
  const int G = KV > 0 ? H / KV : 0;
  return G >= 1 && G <= MAX_G && (hd == 64 || hd == 128 || hd == 256) &&
         (ps == 16 || ps == 32 || ps == 64 || ps == 128);
}

// dtype of x, the pools and the output: 0 = float32, 1 = bfloat16, 2 =
// float16
int check_decode(int route, int dtype, int H, int KV, int ps, int hd,
                 int splits) {
  if (splits < 1 || splits > MAX_SPLITS || KV < 1 || H % KV != 0 ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (route == 1 || route == 3)
    return dtype == (route == 1 ? 1 : 2) && bf16_shape(H, KV, ps, hd)
               ? 0 : (int)cudaErrorInvalidValue;
  if (route == 2)
    return dtype == 0 && f32_shape(H / KV, ps, hd)
               ? 0 : (int)cudaErrorInvalidValue;
  return route == 0 && generic_shape(dtype, H / KV, ps, hd)
             ? 0 : (int)cudaErrorInvalidValue;
}

int launch_decode(int route, int dtype, const DecodeArgs& a,
                  const Window& win, cudaStream_t st) {
  if (route == 1) return launch_bf16<__nv_bfloat16>(a, win, st);
  if (route == 3) return launch_bf16<__half>(a, win, st);
  if (route == 2) return launch_f32(a, win, st);
  return dtype == 0   ? launch_generic<float>(a, win, st)
         : dtype == 1 ? launch_generic<__nv_bfloat16>(a, win, st)
                      : launch_generic<__half>(a, win, st);
}

template <typename K>
int resident_clusters(K kernel, int smem, int splits, int* clusters) {
  ClusterLaunch l(kernel, smem, dim3(1, 1, splits), nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg);
}

// *clusters = how many clusters of `splits` blocks of the route's kernel
// (0 = generic, 1 = bf16, 2 = float32, 3 = float16) in dtype (0 =
// float32, 1 = bfloat16, 2 = float16) the card holds at once at this
// shape (cudaOccupancyMaxActiveClusters), for its split plan; refused for
// a route, dtype, shape or split count it does not take.
extern "C" int dyn_paged_decode_clusters(int route, int dtype, int H, int KV,
                                         int ps, int hd, int splits,
                                         int* clusters) {
  const int bad = check_decode(route, dtype, H, KV, ps, hd, splits);
  if (bad) return bad;
  auto query = [&](auto kernel, int smem) {
    return resident_clusters(kernel, smem, splits, clusters);
  };
  if (route == 0) return with_generic_dtype(dtype, hd, query);
  if (route == 2) return with_f32_kernel(hd, H / KV, query);
  return route == 1 ? with_mma_kernel<__nv_bfloat16>(hd, query)
                    : with_mma_kernel<__half>(hd, query);
}

// DecodeF32Tile<hd>::SMEM, the float32 kernel's shared memory a block,
// for a head_dim of f32_shape (ops/paged_attention.py decode_f32_smem
// mirrors it; the card tests hold the two equal).
extern "C" int dyn_paged_decode_f32_smem(int hd) {
  return with_f32_kernel(hd, 1, [](auto, int smem) { return smem; });
}

// dg_smem, the generic kernel's shared memory a block in dtype at head_dim
// hd (ops/paged_attention.py decode_generic_plan mirrors it; the card
// tests hold the two equal); -1 outside generic_shape.
extern "C" int dyn_paged_decode_generic_smem(int dtype, int hd) {
  if (!generic_shape(dtype, 1, 1, hd)) return -1;
  return with_generic_dtype(dtype, hd, [](auto, int smem) { return smem; });
}

// route: 1 = the bf16 tensor-core kernel, 3 = its float16 form, 2 = the
// float32 kernel, 0 = the generic kernel (the wrapper picks it from the
// shape; see bf16_shape, f32_shape and generic_shape). dtype: 0 =
// float32, 1 = bfloat16, 2 = float16. Every route is one cluster launch
// of `splits` blocks a (row, kv head) (and head tile on the generic
// route), which folds its splits itself: no scratch. Each entry returns
// cudaGetLastError() after its launch (0 = cudaSuccess), or the launch's
// own error. m_out/l_out may be null (no stats).
extern "C" int dyn_paged_attention_decode(
    int route, int dtype, const void* q, const void* k_pools,
    const void* v_pools, long long layer, const int* page_table,
    const int* lengths, const int* lower, void* out, float* m_out,
    float* l_out, int B, int H, int KV, int N, int ps, int hd, int P,
    int splits, float scale, float softcap, void* stream) {
  const int bad = check_decode(route, dtype, H, KV, ps, hd, splits);
  if (bad) return bad;
  if (B == 0) return (int)cudaSuccess;
  const DecodeArgs a = {q, k_pools, v_pools, layer, page_table, lengths,
                        lower, out, m_out, l_out, B, H, KV, N, ps, hd, P,
                        splits, scale, softcap};
  const Window none = {nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0};
  return launch_decode(route, dtype, a, none, static_cast<cudaStream_t>(stream));
}

// One fused-window decode step: the pool's positions [lower, start) of
// each row (lower from q_pos and eff_win) and the in-flight keys wk/wv
// [B, Kw, KV, hd] (slots < n_win) in one softmax, folded in the kernel
// (routes 1-3 take Kw <= MAX_KW; the generic route any Kw). eff_win may
// be null (no sliding window).
extern "C" int dyn_paged_attention_decode_window(
    int route, int dtype, const void* q, const void* k_pools,
    const void* v_pools, long long layer, const int* page_table,
    const int* start, const int* q_pos, const int* eff_win, const void* wk,
    const void* wv, int n_win, int Kw, void* out, int B, int H, int KV,
    int N, int ps, int hd, int P, int splits, float scale, float softcap,
    void* stream) {
  const int bad = check_decode(route, dtype, H, KV, ps, hd, splits);
  if (bad || wk == nullptr || wv == nullptr || Kw < 1 ||
      (route != 0 && Kw > MAX_KW))
    return bad ? bad : (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const DecodeArgs a = {q, k_pools, v_pools, layer, page_table, nullptr,
                        nullptr, out, nullptr, nullptr, B, H, KV, N, ps, hd,
                        P, splits, scale, softcap};
  const Window win = {wk, wv, start, q_pos, eff_win, n_win, Kw};
  return launch_decode(route, dtype, a, win, static_cast<cudaStream_t>(stream));
}
