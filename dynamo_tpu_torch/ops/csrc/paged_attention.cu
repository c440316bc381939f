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
//   route 0  paged_decode_kernel<T>            the shapes outside these
//            + paged_decode_combine<T>         sets, float32, bfloat16 or
//                                              float16 (CUDA-core FMAs
//                                              from shared memory)
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
// the launch. The generic kernel is bound by neither: each page goes
// through scores, a softmax and P V as block-wide phases with a barrier
// between, ~10^3 scalar instructions per thread per page, so it is bound
// by issued instructions (22% of the bound at 32 rows of 520 positions).
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
constexpr size_t MAX_SMEM = 227 * 1024;  // per block, after opt-in
constexpr int DEC_THREADS = 128;
constexpr int DEC_MAX_DPT = 2;   // head_dim <= DEC_THREADS * DEC_MAX_DPT

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

// The pages [p_begin, p_begin + n) of split `split` of S on the generic
// route: the row's pages cut into S near-equal contiguous shares (a split
// is empty only when the row has fewer pages than splits).
__device__ __forceinline__ int split_pages(int len, int lo, int ps, int P,
                                           int S, int split, int& p_begin) {
  int row_begin;
  const int n = row_pages(len, lo, ps, P, row_begin);
  p_begin = row_begin + (int)((long long)n * split / S);
  return row_begin + (int)((long long)n * (split + 1) / S) - p_begin;
}

// 16-byte asynchronous copy global -> shared (sm_80+), and its group fences
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// ---------------------------------------------------- route 0: generic
// One 16-byte vector of T as floats (8 bf16 or float16, or 4 float).
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2(h + 2 * i);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x;
  f[1] = x.y;
  f[2] = x.z;
  f[3] = x.w;
}

// Padded row length (elements) of a page tile in shared memory: one extra
// 16-byte slot per row, so that 16-byte reads of consecutive rows fall in
// different banks.
template <typename T> __host__ __device__ constexpr int vec_elems() {
  return 16 / (int)sizeof(T);
}

size_t decode_smem_bytes(int G, int ps, int hd, int elem) {
  // K and V tiles (padded rows), double-buffered, then q, scores and
  // stats in float32
  return 4 * (size_t)ps * (hd + 16 / elem) * elem +
         sizeof(float) * ((size_t)G * hd + (size_t)G * ps + 3 * (size_t)G);
}

// grid (B, KV, S); block DEC_THREADS. Split s of S walks its share of the
// row's pages (flash-decoding): given partial buffers it writes
// unnormalized partials (acc, m, l) that paged_decode_combine folds (with
// the fused window's in-flight keys, if any); without, S is 1 and it
// writes the output and stats itself. Pages stream through two shared-memory buffers:
// page i+1 is in flight (cp.async) while page i is computed. Shared: K/V
// tiles [2][2][ps*(hd+VEC)] (element type), then float32 q [G*hd],
// scores/probs [G*ps], m, l, alpha [G]. Scores: each key is scored by
// blockDim/ps threads, one per subset of the group's heads, with 16-byte
// reads of the key; P V: each thread owns head_dim slots for all heads.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pools,
                    const T* __restrict__ v_pools, long long layer_offset,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    const int* __restrict__ lower, T* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    const int* __restrict__ start,
                    const int* __restrict__ q_pos,
                    const int* __restrict__ eff_win,
                    int H, int KV, int N, int ps, int hd, int P, float scale,
                    float softcap) {
  constexpr int VEC = vec_elems<T>();
  extern __shared__ float4 smem_raw[];
  const int b = blockIdx.x, kv = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z, G = H / KV;
  const int rowp = hd + VEC;
  const int tile = ps * rowp;
  T* tiles = reinterpret_cast<T*>(smem_raw);  // [buf][k|v][ps*rowp]
  float* q_s = reinterpret_cast<float*>(tiles + 4 * tile);
  float* s_s = q_s + G * hd;
  float* m_s = s_s + G * ps;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  const long long qbase = ((long long)b * H + (long long)kv * G) * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) q_s[i] = to_f(q[qbase + i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[DEC_MAX_DPT][MAX_G];
#pragma unroll
  for (int k = 0; k < DEC_MAX_DPT; ++k)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[k][g] = 0.f;

  int len, lo, p_begin;
  row_extent(b, lengths, lower, start, q_pos, eff_win, len, lo);
  const int n_pages = split_pages(len, lo, ps, P, S, split, p_begin);
  const long long page_elems = (long long)KV * ps * hd;
  const long long head_off = (long long)kv * ps * hd;
  const int* row_pages = page_table + (long long)b * P + p_begin;
  const int chunks_per_row = hd / VEC;
  const int tpk = max((int)blockDim.x / ps, 1);  // threads per key

  // stage page i of this split's walk into buffer i & 1 (a page id outside
  // the pool is never read; its compute is skipped below)
  auto fetch = [&](int i) {
    if (i < n_pages) {
      const int page = row_pages[i];
      if (page >= 0 && page < N) {
        const long long off = layer_offset + page * page_elems + head_off;
        T* kb = tiles + (i & 1) * 2 * tile;
        for (int c = tid; c < ps * chunks_per_row; c += blockDim.x) {
          const int r = c / chunks_per_row, cc = c - r * chunks_per_row;
          cp_async16(kb + r * rowp + cc * VEC, k_pools + off + r * hd + cc * VEC);
          cp_async16(kb + tile + r * rowp + cc * VEC,
                     v_pools + off + r * hd + cc * VEC);
        }
      }
    }
    cp_async_commit();
  };

  fetch(0);
  for (int i = 0; i < n_pages; ++i) {
    fetch(i + 1);
    cp_async_wait_1();  // every group but the newest (page i+1) has landed
    __syncthreads();
    const int p = p_begin + i;
    const int page = row_pages[i];
    if (page >= 0 && page < N) {  // uniform across the block
      const T* kt = tiles + (i & 1) * 2 * tile;
      const T* vt = kt + tile;

      for (int pair = tid; pair < ps * tpk; pair += blockDim.x) {
        const int j = pair % ps, h = pair / ps;
        const T* kr = kt + j * rowp;
        float sc[MAX_G];
#pragma unroll
        for (int gi = 0; gi < MAX_G; ++gi) sc[gi] = 0.f;
        for (int d0 = 0; d0 < hd; d0 += VEC) {
          float kf[8];
          load_vec(kr + d0, kf);
#pragma unroll
          for (int gi = 0; gi < MAX_G; ++gi) {
            const int g = h + gi * tpk;
            if (g < G) {
              const float* qg = q_s + g * hd + d0;
#pragma unroll
              for (int e = 0; e < VEC; ++e) sc[gi] += qg[e] * kf[e];
            }
          }
        }
#pragma unroll
        for (int gi = 0; gi < MAX_G; ++gi) {
          const int g = h + gi * tpk;
          if (g < G) s_s[g * ps + j] = cap(sc[gi] * scale, softcap);
        }
      }
      __syncthreads();

      // online softmax update: one warp per head
      for (int g = warp; g < G; g += nwarps) {
        float mx = NEG_INF;
        for (int j = lane; j < ps; j += 32) {
          const int pos = p * ps + j;
          if (pos >= lo && pos < len) mx = fmaxf(mx, s_s[g * ps + j]);
        }
        mx = warp_max(mx);
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int j = lane; j < ps; j += 32) {
          const int pos = p * ps + j;
          const float pe = (pos >= lo && pos < len) ? expf(s_s[g * ps + j] - m_new) : 0.f;
          s_s[g * ps + j] = pe;
          sum += pe;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[g] = alpha;
          l_s[g] = alpha * l_s[g] + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();

      // acc = acc * alpha + P V: thread owns head_dim slots
#pragma unroll
      for (int k = 0; k < DEC_MAX_DPT; ++k) {
        const int d = tid + k * blockDim.x;
        if (d < hd) {
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) acc[k][g] *= a_s[g];
          for (int j = 0; j < ps; ++j) {
            const float vd = to_f(vt[j * rowp + d]);
#pragma unroll
            for (int g = 0; g < MAX_G; ++g)
              if (g < G) acc[k][g] += s_s[g * ps + j] * vd;
          }
        }
      }
    }
    __syncthreads();  // buffer i & 1 is refilled by fetch(i + 2)
  }
  __syncthreads();  // stats written by the last page (or the init)

  if (part_acc == nullptr) {
#pragma unroll
    for (int k = 0; k < DEC_MAX_DPT; ++k) {
      const int d = tid + k * blockDim.x;
      if (d < hd) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) out[qbase + (long long)g * hd + d] =
              from_f<T>(acc[k][g] / fmaxf(l_s[g], 1e-9f));
      }
    }
    if (m_out != nullptr && tid < G) {
      m_out[(long long)b * H + kv * G + tid] = m_s[tid];
      l_out[(long long)b * H + kv * G + tid] = l_s[tid];
    }
    return;
  }
  const long long pbase = (((long long)b * KV + kv) * S + split) * G;
#pragma unroll
  for (int k = 0; k < DEC_MAX_DPT; ++k) {
    const int d = tid + k * blockDim.x;
    if (d < hd) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part_acc[(pbase + g) * hd + d] = acc[k][g];
    }
  }
  if (tid < G) {
    part_ml[(pbase + tid) * 2] = m_s[tid];
    part_ml[(pbase + tid) * 2 + 1] = l_s[tid];
  }
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

// ---------------------------------------------------------- combine
// The generic route's second kernel. grid (B, KV); dynamic shared
// (2 * Kw + S + 1) * G floats. Folds the S splits' partials of each (row,
// kv head) into the output and the stats: rescale each split to the joint
// max, normalize once; an all-masked or empty split has m = NEG_INF,
// l = 0 and adds nothing. With a window buffer (wk != null)
// it also scores the fused decode window's in-flight keys — slot w holds
// position start + w, visible when w < n_win, start >= 0 and
// start + w > q_pos - eff_win — and folds them in the same sum (the
// merge of dynamo_tpu/models/llama.py:981-1006, with exp only where a key
// is visible).
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
paged_decode_combine(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int H, int KV, int S, int hd, const T* __restrict__ q,
                     const T* __restrict__ wk, const T* __restrict__ wv,
                     const int* __restrict__ start,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ eff_win, int n_win, int Kw,
                     float scale, float softcap) {
  extern __shared__ float win_s[];  // slot scores [G*Kw], then flags [G*Kw]
  const int b = blockIdx.x, kv = blockIdx.y, G = H / KV;
  const long long base = ((long long)b * KV + kv) * S * G;
  const int nw = wk != nullptr ? Kw : 0;
  float* vis_s = win_s + G * nw;
  if (nw > 0) {
    const int st = start[b];
    // visible: position > floor_pos (no sliding window: every slot)
    const int floor_pos = eff_win != nullptr ? q_pos[b] - eff_win[b] : INT_MIN;
    // one warp per (head, slot): lanes split head_dim
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int pair = warp; pair < G * nw; pair += blockDim.x >> 5) {
      const int g = pair / nw, w = pair - g * nw;
      const bool vis = w < n_win && st >= 0 && st + w > floor_pos;
      float sc = NEG_INF;
      if (vis) {  // uniform across the warp
        const T* qg = q + ((long long)b * H + kv * G + g) * hd;
        const T* kw = wk + (((long long)b * Kw + w) * KV + kv) * hd;
        float dot = 0.f;
        for (int d = lane; d < hd; d += 32) dot += to_f(qg[d]) * to_f(kw[d]);
        sc = cap(warp_sum(dot) * scale, softcap);
      }
      if (lane == 0) {
        win_s[pair] = sc;
        vis_s[pair] = vis ? 1.f : 0.f;
      }
    }
    __syncthreads();
  }
  // per head: the joint max, each split's and slot's weight, the sum
  float* w_s = vis_s + G * nw;  // split weights [S*G]
  float* l_sum = w_s + S * G;   // [G]
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float M = NEG_INF;
    for (int s = 0; s < S; ++s) M = fmaxf(M, part_ml[(base + s * G + g) * 2]);
    for (int w = 0; w < nw; ++w)
      if (vis_s[g * nw + w] != 0.f) M = fmaxf(M, win_s[g * nw + w]);
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      const long long r = base + s * G + g;
      const float e = expf(part_ml[r * 2] - M);
      w_s[s * G + g] = e;
      L += e * part_ml[r * 2 + 1];
    }
    for (int w = 0; w < nw; ++w) {
      const float e = vis_s[g * nw + w] != 0.f ? expf(win_s[g * nw + w] - M) : 0.f;
      win_s[g * nw + w] = e;  // the slot's weight from here on
      L += e;
    }
    l_sum[g] = L;
    if (m_out != nullptr) {
      m_out[(long long)b * H + kv * G + g] = M;
      l_out[(long long)b * H + kv * G + g] = L;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i - g * hd;
    float a = 0.f;
    for (int s = 0; s < S; ++s)
      a += w_s[s * G + g] * part_acc[(base + s * G + g) * hd + d];
    for (int w = 0; w < nw; ++w)
      a += win_s[g * nw + w] *
           to_f(wv[(((long long)b * Kw + w) * KV + kv) * hd + d]);
    out[((long long)b * H + kv * G + g) * hd + d] =
        from_f<T>(a / fmaxf(l_sum[g], 1e-9f));
  }
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
  float* part_acc;  // the generic route's partials (null: it does not fold)
  float* part_ml;
  int B, H, KV, N, ps, hd, P, splits;
  float scale, softcap;
};

template <typename T>
int launch_combine(const DecodeArgs& a, const Window& win, cudaStream_t st) {
  const int nw = win.wk != nullptr ? win.Kw : 0;
  paged_decode_combine<T><<<dim3(a.B, a.KV), DEC_THREADS,
                            sizeof(float) * (a.H / a.KV) * (2 * nw + a.splits + 1),
                            st>>>(
      a.part_acc, a.part_ml, static_cast<T*>(a.out), a.m_out, a.l_out, a.H,
      a.KV, a.splits, a.hd, static_cast<const T*>(a.q),
      static_cast<const T*>(win.wk),
      static_cast<const T*>(win.wv), win.start, win.q_pos, win.eff_win,
      win.n_win, win.Kw, a.scale, a.softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_generic(const DecodeArgs& a, const Window& win, cudaStream_t st) {
  const size_t smem = decode_smem_bytes(a.H / a.KV, a.ps, a.hd, (int)sizeof(T));
  const long long layer_offset = a.layer * (long long)a.N * a.KV * a.ps * a.hd;
  cudaFuncSetAttribute(paged_decode_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  paged_decode_kernel<T><<<dim3(a.B, a.KV, a.splits), DEC_THREADS, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pools),
      static_cast<const T*>(a.v_pools), layer_offset, a.page_table, a.lengths,
      a.lower, static_cast<T*>(a.out), a.m_out, a.l_out, a.part_acc,
      a.part_ml, win.start, win.q_pos, win.eff_win, a.H, a.KV, a.N, a.ps,
      a.hd, a.P, a.scale, a.softcap);
  if (a.part_acc == nullptr) return (int)cudaGetLastError();
  return launch_combine<T>(a, win, st);
}

// A launch of a cluster kernel (the bf16 or the float32 route) with
// `smem` bytes of shared memory: grid `grid`, in clusters of (1, 1,
// grid.z) blocks (the splits of one (row, kv head)). Built in place: the
// config points at the attribute beside it.
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
  if (splits < 1 || splits > 1024 || KV < 1 || H % KV != 0 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (route == 1 || route == 3)
    return dtype == (route == 1 ? 1 : 2) && bf16_shape(H, KV, ps, hd) &&
                   splits <= MAX_SPLITS
               ? 0 : (int)cudaErrorInvalidValue;
  if (route == 2)
    return dtype == 0 && f32_shape(H / KV, ps, hd) && splits <= MAX_SPLITS
               ? 0 : (int)cudaErrorInvalidValue;
  const int G = H / KV;
  const int elem = dtype == 0 ? 4 : 2;
  if (route != 0 || G > MAX_G || hd > DEC_THREADS * DEC_MAX_DPT ||
      hd % (16 / elem) != 0 || decode_smem_bytes(G, ps, hd, elem) > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The scratch a call needs: none on the bf16 and float32 routes (their
// splits fold through the cluster's shared memory); on the generic route
// the partials whenever it folds (splits, or a window).
bool has_scratch(int route, const DecodeArgs& a, bool window) {
  return route != 0 || !(a.splits > 1 || window) ||
         (a.part_acc != nullptr && a.part_ml != nullptr);
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
int resident(K kernel, int threads, int smem, int* blocks) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                            threads, smem);
}

template <typename K>
int resident_clusters(K kernel, int smem, int splits, int* clusters) {
  ClusterLaunch l(kernel, smem, dim3(1, 1, splits), nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &l.cfg);
}

// *blocks = the generic decode kernel's resident blocks per SM at this
// shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for its split
// plan.
extern "C" int dyn_paged_decode_resident(int dtype, int H, int KV, int ps,
                                         int hd, int* blocks) {
  const int bad = check_decode(0, dtype, H, KV, ps, hd, 1);
  if (bad) return bad;
  const int smem = (int)decode_smem_bytes(H / KV, ps, hd, dtype == 0 ? 4 : 2);
  return dtype == 0 ? resident(paged_decode_kernel<float>, DEC_THREADS, smem,
                               blocks)
         : dtype == 1 ? resident(paged_decode_kernel<__nv_bfloat16>,
                                 DEC_THREADS, smem, blocks)
                      : resident(paged_decode_kernel<__half>, DEC_THREADS,
                                 smem, blocks);
}

// *clusters = how many clusters of `splits` blocks of the route's kernel
// (1 = bf16, 2 = float32, 3 = float16) the card holds at once at this
// shape (cudaOccupancyMaxActiveClusters), for its split plan; refused for
// a route, shape or split count it does not take.
extern "C" int dyn_paged_decode_clusters(int route, int H, int KV, int ps,
                                         int hd, int splits, int* clusters) {
  if (route < 1 || route > 3) return (int)cudaErrorInvalidValue;
  const int dtype = route == 1 ? 1 : route == 2 ? 0 : 2;
  const int bad = check_decode(route, dtype, H, KV, ps, hd, splits);
  if (bad) return bad;
  auto query = [&](auto kernel, int smem) {
    return resident_clusters(kernel, smem, splits, clusters);
  };
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

// route: 1 = the bf16 tensor-core kernel, 3 = its float16 form, 2 = the
// float32 kernel, 0 = the generic kernel (the wrapper picks it from the
// shape; see bf16_shape and f32_shape). dtype: 0 = float32, 1 =
// bfloat16, 2 = float16. Each entry returns cudaGetLastError() after its
// launches (0 = cudaSuccess), or the launch's own error. Scratch the
// caller allocates for the generic route (see has_scratch): part_acc
// [B*KV*splits*G*hd]
// and part_ml [B*KV*splits*G*2] in float32; the other routes take none.
// m_out/l_out may be null (no stats).
extern "C" int dyn_paged_attention_decode(
    int route, int dtype, const void* q, const void* k_pools,
    const void* v_pools, long long layer, const int* page_table,
    const int* lengths, const int* lower, void* out, float* m_out,
    float* l_out, float* part_acc, float* part_ml, int B, int H, int KV,
    int N, int ps, int hd, int P, int splits, float scale, float softcap,
    void* stream) {
  const int bad = check_decode(route, dtype, H, KV, ps, hd, splits);
  if (splits == 1) part_acc = part_ml = nullptr;
  const DecodeArgs a = {q, k_pools, v_pools, layer, page_table, lengths,
                        lower, out, m_out, l_out, part_acc, part_ml, B, H,
                        KV, N, ps, hd, P, splits, scale, softcap};
  if (bad || !has_scratch(route, a, false))
    return bad ? bad : (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Window none = {nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0};
  return launch_decode(route, dtype, a, none, static_cast<cudaStream_t>(stream));
}

// One fused-window decode step: the pool's positions [lower, start) of
// each row (lower from q_pos and eff_win) and the in-flight keys wk/wv
// [B, Kw, KV, hd] (slots < n_win) in one softmax — folded in the bf16 and
// float32 kernels, or by the combine kernel on the generic route. eff_win
// may be null (no sliding window).
extern "C" int dyn_paged_attention_decode_window(
    int route, int dtype, const void* q, const void* k_pools,
    const void* v_pools, long long layer, const int* page_table,
    const int* start, const int* q_pos, const int* eff_win, const void* wk,
    const void* wv, int n_win, int Kw, void* out, float* part_acc,
    float* part_ml, int B, int H, int KV, int N, int ps, int hd, int P,
    int splits, float scale, float softcap, void* stream) {
  const int bad = check_decode(route, dtype, H, KV, ps, hd, splits);
  const DecodeArgs a = {q, k_pools, v_pools, layer, page_table, nullptr,
                        nullptr, out, nullptr, nullptr, part_acc, part_ml,
                        B, H, KV, N, ps, hd, P, splits, scale, softcap};
  if (bad || !has_scratch(route, a, true) || wk == nullptr || wv == nullptr ||
      Kw < 1 || (route != 0 && Kw > MAX_KW))
    return bad ? bad : (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Window win = {wk, wv, start, q_pos, eff_win, n_win, Kw};
  return launch_decode(route, dtype, a, win, static_cast<cudaStream_t>(stream));
}
