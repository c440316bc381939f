// Paged GQA decode attention over the stacked KV pool, for Hopper (sm_90a).
//
// Two kernels behind plain C entries that return cudaGetLastError() and
// are loaded with ctypes by dynamo_tpu_torch/ops/paged_attention.py:
//
//   paged_decode_kernel + paged_decode_combine  replace the TPU kernel
//       _decode_kernel, reached through paged_attention_decode_layered
//       (dynamo_tpu/ops/paged_attention.py:52,211).
//
// The prefill kernel (the TPU kernel _prefill_kernel) lives in
// paged_prefill.cu.
//
// Pool layout: [L, num_pages, KV, page_size, head_dim], contiguous; a page
// of one kv head is one contiguous [ps, hd] tile. Element types: float and
// __nv_bfloat16; softmax and every sum in float32.
//
// What bounds it on an H100 SXM, and what the design does about it:
// decode (one query per row) reads every visible K/V row once and does
// ~4*H*hd flops per row: about 4 flops per byte of bf16 K/V, far below
// the ~295 flops/byte where 989 TF/s bf16 would bind. It is bound by the
// bytes of K/V read, at 3.35 TB/s. A block works for one (row, kv head)
// and packs the whole GQA group, so each K/V page of that head is read
// from device memory exactly once for all of the group's query heads; the
// blocks walk only the pages that cover [lower, length) (the loop bounds
// do the job of the TPU kernel's page-index clamp), read the page id from
// the page table themselves, and take the layer as an offset into the
// stacked pool (no copy of a layer). Pages stream through shared memory in
// 16-byte cp.async copies, double-buffered, so the next page's fetch
// overlaps the current page's compute. A row's pages are split over
// enough blocks to give every SM two (flash-decoding); a combine kernel
// folds the splits, and the fused decode window's in-flight keys, by
// their (m, l) stats. Not done yet: fewer block-wide phases per page
// (each page's scores, softmax and P V are separate phases with a barrier
// between, which bounds a block at a few microseconds per page).
//
// Semantics shared with the TPU kernel: online softmax in float32 with
// the finite NEG_INF = -1e30; exp() only where a key is visible, so an
// all-masked view returns m = NEG_INF, l = 0 and a zero output; the
// Gemma-2 tanh softcap comes before the mask.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int MAX_G = 8;         // GQA group size the decode kernel takes
constexpr size_t MAX_SMEM = 227 * 1024;  // per block, after opt-in
constexpr int DEC_THREADS = 128;
constexpr int DEC_MAX_DPT = 2;   // head_dim <= DEC_THREADS * DEC_MAX_DPT

// ------------------------------------------------------------------ decode
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

// Copy one [ps, hd] tile (n_bytes, a multiple of 16) with every thread of
// the block issuing independent 16-byte copies.
__device__ __forceinline__ void tile_async(void* dst, const void* src,
                                           int n_bytes, int tid, int nthreads) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  for (int c = tid * 16; c < n_bytes; c += nthreads * 16) cp_async16(d + c, s + c);
}

// One 16-byte vector of T as floats (8 bf16 or 4 float).
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
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

  // the pool extent: given, or (fused window step) derived as the JAX
  // wrapper derives it — pool = positions [0, start), and on sliding
  // layers lower = clip(q_pos + 1 - window, 0, start)
  int len, lo;
  if (lengths != nullptr) {
    len = lengths[b];
    lo = lower[b];
  } else {
    len = max(start[b], 0);
    lo = eff_win != nullptr ? min(max(q_pos[b] + 1 - eff_win[b], 0), len) : 0;
  }
  const int row_begin = lo > 0 ? lo / ps : 0;
  const int row_end = len > 0 ? min((len + ps - 1) / ps, P) : 0;
  const int per_split = (max(row_end - row_begin, 0) + S - 1) / S;
  const int p_begin = row_begin + split * per_split;
  const int n_pages = max(min(p_begin + per_split, row_end) - p_begin, 0);
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

// grid (B, KV); dynamic shared (2 * Kw + S + 1) * G floats. Folds the S
// splits' partials of each (row, kv head) into the output and the stats:
// rescale each split to the joint max, normalize once; an all-masked
// split has m = NEG_INF, l = 0 and adds nothing. With a window buffer (wk != null)
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

template <typename T>
int launch_decode(const void* q, const void* k_pools, const void* v_pools,
                  long long layer, const int* page_table, const int* lengths,
                  const int* lower, const Window& win, void* out,
                  float* m_out, float* l_out, float* part_acc,
                  float* part_ml, int B, int H, int KV, int N, int ps, int hd,
                  int P, int splits, float scale, float softcap,
                  cudaStream_t st) {
  const size_t smem = decode_smem_bytes(H / KV, ps, hd, (int)sizeof(T));
  const long long layer_offset = layer * (long long)N * KV * ps * hd;
  const bool fold = part_acc != nullptr;  // splits > 1 or a window
  cudaFuncSetAttribute(paged_decode_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  paged_decode_kernel<T><<<dim3(B, KV, splits), DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pools),
      static_cast<const T*>(v_pools), layer_offset, page_table, lengths,
      lower, static_cast<T*>(out), m_out, l_out, part_acc, part_ml,
      win.start, win.q_pos, win.eff_win, H, KV, N, ps, hd, P, scale, softcap);
  if (fold) {
    const int nw = win.wk != nullptr ? win.Kw : 0;
    paged_decode_combine<T><<<dim3(B, KV), DEC_THREADS,
                              sizeof(float) * (H / KV) * (2 * nw + splits + 1),
                              st>>>(
        part_acc, part_ml, static_cast<T*>(out), m_out, l_out, H, KV, splits,
        hd, static_cast<const T*>(q), static_cast<const T*>(win.wk),
        static_cast<const T*>(win.wv), win.start, win.q_pos, win.eff_win,
        win.n_win, win.Kw, scale, softcap);
  }
  return (int)cudaGetLastError();
}

int check_decode(int dtype, int H, int KV, int ps, int hd, int splits) {
  const int G = H / KV;
  const int elem = dtype == 0 ? 4 : 2;
  if (G > MAX_G || hd > DEC_THREADS * DEC_MAX_DPT || hd % (16 / elem) != 0 ||
      decode_smem_bytes(G, ps, hd, elem) > MAX_SMEM || splits < 1 ||
      splits > 1024)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Each entry returns cudaGetLastError()
// after its launches (0 = cudaSuccess). part_acc [B*KV*splits*G*hd] and
// part_ml [B*KV*splits*G*2] are float32 scratch the caller allocates;
// they may be null only when splits == 1 (no fold). m_out/l_out may be
// null (no stats).
extern "C" int dyn_paged_attention_decode(
    int dtype, const void* q, const void* k_pools, const void* v_pools,
    long long layer, const int* page_table, const int* lengths,
    const int* lower, void* out, float* m_out, float* l_out, float* part_acc,
    float* part_ml, int B, int H, int KV, int N, int ps, int hd, int P,
    int splits, float scale, float softcap, void* stream) {
  const int bad = check_decode(dtype, H, KV, ps, hd, splits);
  if (bad || (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return bad ? bad : (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Window none = {nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 1) part_acc = part_ml = nullptr;
  if (dtype == 0)
    return launch_decode<float>(q, k_pools, v_pools, layer, page_table,
                                lengths, lower, none, out, m_out, l_out,
                                part_acc, part_ml, B, H, KV, N, ps, hd, P,
                                splits, scale, softcap, st);
  return launch_decode<__nv_bfloat16>(q, k_pools, v_pools, layer, page_table,
                                      lengths, lower, none, out, m_out, l_out,
                                      part_acc, part_ml, B, H, KV, N, ps, hd,
                                      P, splits, scale, softcap, st);
}

// One fused-window decode step: the pool's positions [lower, start) of
// each row (lower from q_pos and eff_win) through the split kernel, then
// the in-flight keys wk/wv [B, Kw, KV, hd] (slots < n_win) folded in by
// the combine kernel. Always folds: part_acc/part_ml are required;
// eff_win may be null (no sliding window).
extern "C" int dyn_paged_attention_decode_window(
    int dtype, const void* q, const void* k_pools, const void* v_pools,
    long long layer, const int* page_table, const int* start,
    const int* q_pos, const int* eff_win, const void* wk, const void* wv,
    int n_win, int Kw, void* out, float* part_acc, float* part_ml, int B,
    int H, int KV, int N, int ps, int hd, int P, int splits, float scale,
    float softcap, void* stream) {
  const int bad = check_decode(dtype, H, KV, ps, hd, splits);
  if (bad || part_acc == nullptr || part_ml == nullptr || wk == nullptr ||
      wv == nullptr)
    return bad ? bad : (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Window win = {wk, wv, start, q_pos, eff_win, n_win, Kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_decode<float>(q, k_pools, v_pools, layer, page_table,
                                nullptr, nullptr, win, out, nullptr, nullptr,
                                part_acc, part_ml, B, H, KV, N, ps, hd, P,
                                splits, scale, softcap, st);
  return launch_decode<__nv_bfloat16>(q, k_pools, v_pools, layer, page_table,
                                      nullptr, nullptr, win, out, nullptr,
                                      nullptr, part_acc, part_ml, B, H, KV, N,
                                      ps, hd, P, splits, scale, softcap, st);
}
