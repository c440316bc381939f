// Helpers shared by the paged-attention kernels (paged_attention.cu for
// decode, paged_prefill.cu for prefill). build.py hashes this header (and
// the one it includes) into the name of every library whose source
// includes it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tma_wgmma.cuh"  // the element types, smem_u32, the mbarriers

namespace {

// finite "masked" value of the online softmax: keeps exp() NaN-free
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Gemma-2 logit softcap (0 = off); applied before the mask
__device__ __forceinline__ float cap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// The shapes both float32 kernels (route 2: paged_decode_f32_kernel,
// paged_prefill_f32_kernel) are built for, by GQA group, page size and
// head_dim; ops/paged_attention.py F32_* lists the same, and
// tests/test_torch_kernels.py holds the two against each other.
bool f32_shape(int G, int ps, int hd) {
  return G >= 1 && G <= 8 &&
         (hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256) &&
         (ps == 8 || ps == 16 || ps == 32 || ps == 64 || ps == 128);
}

// The shapes both generic kernels (route 0: paged_decode_generic_kernel,
// paged_prefill_generic_kernel) take, in every dtype (0 = float32, 1 =
// bfloat16, 2 = float16): any page size and GQA group, head_dim from 1
// to GN_MAX_HD_F32 in float32 and GN_MAX_HD_16 in 16 bits. Those bounds
// come from shared memory: they are the largest head_dim below which
// every head_dim's plan of both kernels (gn_smem in paged_prefill.cu,
// dg_smem in paged_attention.cu) fits a block's 227 KB.
// ops/paged_attention.py GENERIC_MAX_HEAD_DIM lists the same, and
// generic_shape there.
constexpr int GN_MAX_HD_F32 = 656;  // the prefill kernel's Q, K and V rows
constexpr int GN_MAX_HD_16 = 576;   // the decode kernel's two-stage rings
constexpr int GN_SMEM_LIMIT = 232448;
bool generic_shape(int dtype, int G, int ps, int hd) {
  return dtype >= 0 && dtype <= 2 && G >= 1 && ps >= 1 && hd >= 1 &&
         hd <= (dtype == 0 ? GN_MAX_HD_F32 : GN_MAX_HD_16);
}

// head_dim above GN_MAX_COLS (the wide form of both generic kernels): Q
// and K rows are taken whole, at head_dim padded to 16 (gn_qk_width), for
// the scores; the value columns are cut into gn_col_tiles tiles of
// gn_col_width columns (a multiple of 8, so that each tile's first
// column starts a 16-byte copy; the last tile may be narrower), one
// block each, so that a block's output fragment stays that of a head_dim
// up to 256. At head_dim up to 256: one tile of head_dim columns.
constexpr int GN_MAX_COLS = 256;
__host__ __device__ constexpr int gn_qk_width(int hd) {
  return (hd + 15) / 16 * 16;
}
__host__ __device__ constexpr int gn_col_width(int hd) {
  return hd <= GN_MAX_COLS
             ? hd
             : ((hd + (hd + GN_MAX_COLS - 1) / GN_MAX_COLS - 1) /
                    ((hd + GN_MAX_COLS - 1) / GN_MAX_COLS) +
                7) / 8 * 8;
}
__host__ __device__ constexpr int gn_col_tiles(int hd) {
  return (hd + gn_col_width(hd) - 1) / gn_col_width(hd);
}

// Key position `pos` is visible to a query at `qp` under the row's sliding
// window `win`: the causal mask intersected with the window (qp = -1, a
// padding query, sees nothing).
__device__ __forceinline__ bool visible(int pos, int qp, int win) {
  return pos <= qp && pos > qp - win;
}

// Pool position `pos` lies in a decode row's visible extent [lo, len).
__device__ __forceinline__ bool in_extent(int pos, int lo, int len) {
  return pos >= lo && pos < len;
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory; where
// `valid` is false nothing is read and the destination is zero-filled
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  const uint32_t d = smem_u32(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n) : "memory");
  }
}

// One copy of BYTES from global to shared memory where `valid`, else
// zeros: cp.async for 4, 8 or 16 bytes; for 2, a plain load and store of
// one 16-bit element (rows of an odd 16-bit head_dim are 2-byte aligned)
template <typename T, int BYTES>
__device__ __forceinline__ void copy_zfill(T* dst, const T* src, bool valid) {
  if constexpr (BYTES >= 4)
    cp_async_zfill<BYTES>(dst, src, valid);
  else
    *dst = valid ? *src : from_f<T>(0.f);
}

// mma.sync m16n8k16, T (bf16 or f16) in, f32 accumulate: A a[0..3] (rows
// g, g + 8 at k 2t, 2t + 1; the same at k + 8), B b0 (k 2t, 2t + 1), b1
// (k + 8) at column g, D d[0..3] (row g cols 2t, 2t + 1; row g + 8 the
// same), g = lane / 4, t = lane % 4.
template <typename T>
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
#define DYN_MMA_16816(AB)                                                   \
  asm("mma.sync.aligned.m16n8k16.row.col.f32." AB "." AB ".f32 "            \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                     \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  DYN_AB(T, DYN_MMA_16816);
#undef DYN_MMA_16816
}

// head_dim (or a wide form's column tile) as the generic kernels'
// products take it: the next of 16, 32, 64, 96, 128, 192 and 256
// (columns past it are zeros in shared memory)
__host__ __device__ constexpr int gn_hdp(int hd) {
  return hd <= 16 ? 16 : hd <= 32 ? 32 : hd <= 64 ? 64 : hd <= 96 ? 96
       : hd <= 128 ? 128 : hd <= 192 ? 192 : 256;
}

// ---- 3xTF32: float32 products on the TF32 tensor cores. An operand x is
// split into big = tf32(x) (round to nearest, ties away from zero: 10
// mantissa bits) and small = x - big, which the tensor cores read as a
// TF32 value (its 13 low bits dropped); a product a * b is taken as
// a_small * b_big + a_big * b_small + a_big * b_big, in float32
// accumulators, the small * small term dropped. The error is that of
// about 21 mantissa bits a product (one TF32 product alone keeps 10).
// tf32_rna is cvt.rna.tf32.f32 as two integer operations: half a TF32 ulp
// added to the magnitude, the 13 low bits cleared (the cvt form made the
// prefill kernel's first 512-token chunk at Llama-3-8B's heads 0.130 ms
// against 0.105 on an H100: PERF.md, Findings).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// mma.sync m16n8k8, tf32 in, f32 accumulate: A a[0..3] (rows g, g + 8 at
// k t; rows g, g + 8 at k t + 4), B b0 (k t), b1 (k t + 4) at column g,
// D d[0..3] (row g cols 2t, 2t + 1; row g + 8 the same), g = lane / 4,
// t = lane % 4.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in the 3xTF32 form, from the split operands: the two small
// terms first, then the big one. The tensor cores round each of these
// accumulations toward zero, a bias that grows with the adds a sum takes
// from them: a running sum over many key blocks (the prefill kernel's O)
// takes each block's products from zero and adds them in float32.
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t* a_big,
                                           const uint32_t* a_small,
                                           const uint32_t* b_big,
                                           const uint32_t* b_small) {
  mma_tf32(d, a_small, b_big[0], b_big[1]);
  mma_tf32(d, a_big, b_small[0], b_small[1]);
  mma_tf32(d, a_big, b_big[0], b_big[1]);
}

}  // namespace
