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
// cores (989 TF/s, which only wgmma reaches). In float32 both routes take
// two TF32 products an operation (below), so the tensor-core bound is
// 2 x 2MKN at 494.7 TF/s, and at decode rows the bytes still bind.
//
// Two routes, each in three forms: bf16, float16 and float32 x (T). The
// weights are widened to T on chip, in registers, never in device memory:
// int8 -127..127 is exact in bf16 (8 significant bits), in float16 (11)
// and in TF32 (11). In bf16 the wgmma route's widening (widen_i8x4) is a
// byte permute into the mantissa of 2^23 and a subtraction per value, and
// one byte permute per pair; the small-M route's (widen_i8x4_split) two
// masks a pair and one bf16x2 fma, no permute (cvt to bf16x2 issues at a
// quarter of the integer rate). In float16 both are one half2 subtraction
// a pair (widen_f16x4, widen_f16x4_split): the byte, offset to 0..255, is
// the low mantissa byte of 1024 (whose ulp is 1), and 1024 + 128 comes
// off. In float32 it is widen_i8x4's first half alone (widen_f32x4): the
// byte permute and one subtraction a value, no cvt (I2F issues at a
// quarter rate); the result is the exact integer, whose 13 low mantissa
// bits are zero, so the tensor cores read it exactly as TF32.
// At decode rows the widening, on the integer pipe, is what a block's
// compute costs: about 40 GB of weights a second an SM. The float16 forms
// are the bf16 designs with mma.sync's and wgmma's .f16 forms, a float16
// tensor map of x and half2 stores.
// The float32 forms ("2xTF32") run on the TF32 tensor cores, which read
// an operand's float32 bits with the 13 low ones dropped: x's TF32 part
// hi = x with those bits cleared, and lo = x - hi (exact in float32) read
// as TF32 in turn; q is exact. Each product is lo q + hi q, two TF32
// products, and the error is lo's dropped bits, below 2^-20 of |x| (one
// TF32 product alone errs by up to 2^-10). The tensor cores round each
// accumulation toward zero, a bias that grows with the adds a chain takes
// (a K = 8,192 product chains 2,048 of them, and with x and q of one sign
// the bias passes 2^-16 of the sum of the terms' magnitudes): so each
// ring stage (small_m, 32 adds) or 64-wide chunk (wgmma, 16) sums its
// products from zero and adds them to a float32 register sum.
// * small_m (route 0, decode rows: M <= 32 in bf16 or float16, 16 in
//   float32), mma.sync m16n8k16
//   (T in, f32 accumulate), both operands from shared memory. A block
//   is 64 output channels by a share of K, one producer warp and eight
//   consumer warps. One producer thread streams the share through a ring
//   of 128-wide stages with TMA, each the [64, 128] int8 tile of q
//   (128-byte swizzle) and two [16 MT, 64] 16-bit boxes of x (128-byte
//   swizzle), completion counted in bytes on the stage's full mbarrier,
//   keeping four stages of q in flight (with all of a block's stages in
//   flight every stage lands at the end of the burst, and compute cannot
//   overlap it); the two consumer warps of a stage release it on its
//   empty mbarrier. The launch is programmatic (PDL): q and s are
//   read-only while serving, so the producer issues the first stages of
//   weights before griddepcontrol.wait, and only then x; no thread reads
//   x or writes y before that wait. Once its last weight stage is issued
//   the block executes griddepcontrol.launch_dependents (unless its share
//   is long and the grid one block an SM: launch_small), so the next
//   call's blocks (about 101 or 73 KB of shared memory: two blocks fit an
//   SM) start streaming their weights during this call's tail. The
//   consumer warps are two channel halves by four K groups (group g takes
//   the stages g, g + 4, ...; a ring slot is always one group's). The
//   contraction order of a lane is permuted, the same way for both
//   operands: lane (g, t) takes k = 32t .. 32t + 31 of each stage, in step
//   j feeding 4 of them (k, k + 2 as k' = 2t, 2t + 1 and k + 1, k + 3 as
//   k' = 2t + 8, 2t + 9: a weight word's even and odd bytes, and x's
//   halves by one byte permute), so that its weights are two 16-byte
//   shared loads a column and its x four a row; lanes t >= 2 walk their
//   steps rotated by four, which with the swizzle makes both kinds of
//   load free of bank conflicts. The K groups fold through shared memory
//   in order. K is also split over the S <= 8 blocks of a thread-block
//   cluster, as many as still place every tile's cluster one block an SM
//   (two blocks on an SM compute at half speed, and a cluster waits for
//   its slowest): each block stores its partial sums asynchronously into
//   the block that owns them (st.async, counted in bytes on the owner's
//   mbarrier), and each owner sums its slices in rank order. No block
//   reads a peer's shared memory, so no closing cluster barrier: a
//   replay gives the eager call's bits.
//   The float32 form (small_m_f32) computes the product transposed, y^T
//   = q x^T, on mma.sync m16n8k8 .tf32: the weights are A (16 channels),
//   the tokens B (n8), so a 4-row call pads to 8 tokens, not 16; two
//   products at n8 cost 32 operations a weight byte, about 107 TF/s at
//   the byte rate, under mma.sync's TF32 rate on this card (~140 TF/s,
//   paged_prefill.cu). x comes in four [8 NT, 32] float32 boxes a stage
//   (a 128-byte swizzle row holds 32 floats); lane (g, t) takes box t,
//   k = 32t .. 32t + 31 again, a weight word feeding two k8 steps (bytes
//   0, 1 as k' = t, t + 4, then bytes 2, 3) and x's float4 the same two
//   steps, split once a fragment and used for both of the warp's channel
//   tiles.
// * wgmma (route 1: prefill chunks, decode batches above
//   the measured crossover and the widest decode products): the product is
//   computed transposed, y^T = q x^T, so that the weights are wgmma's A
//   operand, from registers, and the tokens its N (16 .. 256). A block is a
//   producer warpgroup and two consumer warpgroups on a tile of 128 output
//   channels (64 a warpgroup) by BT tokens; setmaxnreg moves the producer's
//   registers to the consumers (40 and 232 a thread), so the 256-token
//   tile's 128 accumulators a thread do not spill. One producer thread
//   keeps a ring of stages in flight with TMA, each a [BT, 64] 16-bit tile
//   of x (128-byte swizzle, the K-major B operand of wgmma m64nBTk16) and a
//   [128, 64] int8 tile of q (64-byte swizzle), completion counted in bytes
//   on the stage's full mbarrier; the consumers release a stage on its
//   empty mbarrier once its wgmmas have completed. A consumer thread
//   gathers its A fragment (k = 2t, 2t + 1, 2t + 8, 2t + 9 of rows g and g
//   + 8 in each k16 step) with two 32-bit shared loads and one byte permute
//   a row and step (the swizzle makes them conflict-free), widens it in
//   registers, and issues the chunk's four wgmmas while one (BT >= 128) or
//   two (BT <= 64) earlier chunks' are still running, each with its own A
//   fragment registers. The grid is persistent: each cluster walks the
//   tiles tile = cluster + i * clusters, tokens fastest (neighbouring tiles
//   share their weights through L2), as many clusters as the card holds at
//   once. Where the tiles are too few to fill the card, K is split over the
//   S <= 8 blocks of one cluster: each block writes its partial sums to
//   shared memory and the blocks fold them through distributed shared
//   memory in rank order. No atomics and no global counters: a replayed
//   CUDA graph gives the eager call's bits.
//   The float32 form (wgmma_f32, BT 16 .. 128) runs wgmma m64nBTk8 .tf32,
//   which reads both operands K-major: q stays register A (float32 bits,
//   four registers a k8 step: k t and t + 4 of rows g and g + 8, byte t
//   of a word widened), x B from shared memory as two [BT, 32] float32
//   boxes a stage. lo must be in shared memory too: once a stage lands,
//   the 256 consumer threads write lo = x - hi beside x (the same bytes
//   at the same swizzle), fence the generic writes to the async proxy and
//   meet at a named barrier; then a chunk's 16 wgmmas (lo, hi per k8
//   step) run into a zeroed sum while the next stage is split and its A
//   fragment widened, and the chunk's sum is added to the accumulators.
//   The second sum (BT / 2 registers) caps BT at 128.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- helpers

// mma.sync m16n8k16, T (bf16 or f16) in, f32 accumulate: d += a b
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
#define DYN_MMA16816(AB)                                                    \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k16.row.col.f32." AB "." AB ".f32 "           \
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                     \
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))
  DYN_AB(T, DYN_MMA16816);
#undef DYN_MMA16816
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

// a - b of two bf16 pairs, as b * -1 + a (exact where the difference is)
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(b), "r"(0xBF80BF80u), "r"(a));
  return d;
}

// four int8 (one 32-bit word, lowest byte first) as two bf16 pairs, bytes
// 0 and 2 in `even` and bytes 1 and 3 in `odd`, the lower byte in the
// lower half. A byte b is (128 + (b & 127)) - (b < 0 ? 256 : 128), and
// both terms are bf16 built by masking the byte into 0x4300 (128, whose
// mantissa steps by 1) and its sign into the exponent's lowest bit (0x4380
// is 256): two logic ops a term, one fma a pair, no byte permute.
__device__ __forceinline__ void widen_i8x4_split(uint32_t w, uint32_t& even,
                                                 uint32_t& odd) {
  const uint32_t w8 = w >> 8;
  even = bf16x2_sub((w & 0x007F007Fu) | 0x43004300u,
                    (w & 0x00800080u) | 0x43004300u);
  odd = bf16x2_sub((w8 & 0x007F007Fu) | 0x43004300u,
                   (w8 & 0x00800080u) | 0x43004300u);
}

// a - b of two float16 pairs (exact where the difference is)
__device__ __forceinline__ uint32_t f16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// 1024 + 128 in both halves of a float16 pair
constexpr uint32_t F16X2_1152 = 0x64806480u;

// widen_i8x4 in float16: four int8 (one word, lowest byte first) as two
// float16 pairs, bytes 0, 1 in lo and 2, 3 in hi. Each byte, offset to
// 0..255, becomes the low mantissa byte of 1024 (0x6400: float16 steps by
// 1 there) by one byte permute a pair; subtracting 1024 + 128 gives the
// signed value exactly.
__device__ __forceinline__ void widen_f16x4(uint32_t w, uint32_t& lo,
                                            uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  lo = f16x2_sub(__byte_perm(u, 0x64646464u, 0x4140), F16X2_1152);
  hi = f16x2_sub(__byte_perm(u, 0x64646464u, 0x4342), F16X2_1152);
}

// widen_i8x4_split in float16: bytes 0 and 2 in `even` and 1 and 3 in
// `odd`, each byte offset to 0..255 masked into the low mantissa byte of
// 1024, less 1024 + 128: one logic op and one subtraction a pair.
__device__ __forceinline__ void widen_f16x4_split(uint32_t w, uint32_t& even,
                                                  uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  even = f16x2_sub((u & 0x00FF00FFu) | 0x64006400u, F16X2_1152);
  odd = f16x2_sub(((u >> 8) & 0x00FF00FFu) | 0x64006400u, F16X2_1152);
}

// the widenings of T: bf16's forms above, or their float16 forms
template <typename T>
__device__ __forceinline__ void widen_pair(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  if constexpr (is_f16<T>) widen_f16x4(w, lo, hi);
  else widen_i8x4(w, lo, hi);
}
template <typename T>
__device__ __forceinline__ void widen_split(uint32_t w, uint32_t& even,
                                            uint32_t& odd) {
  if constexpr (is_f16<T>) widen_f16x4_split(w, even, odd);
  else widen_i8x4_split(w, even, odd);
}

// ---- float32 x: 2xTF32

template <typename T>
constexpr bool is_f32 = std::is_same<T, float>::value;

// four int8 (one word, lowest byte first) as four floats, exactly:
// widen_i8x4's byte permute into the mantissa of 2^23 and subtraction.
// Each is an integer of at most 8 significant bits, so its 13 low
// mantissa bits are zero and the tensor cores read it as TF32 exactly.
__device__ __forceinline__ void widen_f32x4(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// byte `sel & 3` of the word u (a weight word already XORed with
// 0x80808080), as that int8's exact float: sel = 0x7540 + the byte
__device__ __forceinline__ uint32_t widen_f32_byte(uint32_t u, uint32_t sel) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f);
}

// x's low TF32 part: the tensor cores read x itself as hi (x with its 13
// low bits dropped), and lo = x - hi is exact in float32
__device__ __forceinline__ uint32_t tf32_lo(float x) {
  return __float_as_uint(x - __uint_as_float(__float_as_uint(x) & 0xffffe000u));
}

// mma.sync m16n8k8, tf32 in, f32 accumulate: d += a b. A a0 (row g, k
// t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4);
// B b0 (k t), b1 (k t + 4) at column g; D (row g, columns 2t, 2t + 1),
// (row g + 8, the same); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma1688_tf32(float (&d)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// the cluster's barrier (release/acquire: shared-memory writes before it
// are seen by reads after it, across the cluster's blocks), its relaxed
// form, its two halves, and accesses to a peer's shared memory
__device__ __forceinline__ void cluster_sync_acq_rel() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n"
               "barrier.cluster.wait;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t dsmem_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_dsmem_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr) : "memory");
  return v;
}
// four floats into a peer's shared memory, their 16 bytes counted on the
// peer's mbarrier (both addresses the peer's, from dsmem_addr)
__device__ __forceinline__ void st_async_f4(uint32_t addr, float4 v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}
// wait until the phase of the given parity has completed, acquiring at
// cluster scope what the peers' asynchronous stores wrote
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

// programmatic dependent launch: wait until the grids this one depends on
// have completed and their writes are visible; let the grids that depend
// on this one launch once every block has said so (or exited)
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// two sums (token m, channels n0 + c, + 1) scaled (sc: the scales of
// channels n0 ..) and rounded to T
template <typename T>
__device__ __forceinline__ void store2(T* y, const float* sc, int N, int m,
                                       int n0, int c, float a, float b) {
  const int n = n0 + c;
  T* out = y + (size_t)m * N + n;
  if ((N & 1) == 0 && n + 1 < N) {
    if constexpr (is_f32<T>)
      *reinterpret_cast<float2*>(out) = make_float2(a * sc[c], b * sc[c + 1]);
    else
      *reinterpret_cast<uint32_t*>(out) = pack2<T>(a * sc[c], b * sc[c + 1]);
    return;
  }
  if (n < N) out[0] = from_f<T>(a * sc[c]);
  if (n + 1 < N) out[1] = from_f<T>(b * sc[c + 1]);
}

// ------------------------------------------------------- route 0: small M

constexpr int SM_BN = 64;   // output channels a block
constexpr int SM_BK = 128;  // K a ring stage: 128 bytes of a q row
constexpr int SM_KGROUPS = 4;
constexpr int SM_CONSUMER_WARPS = 2 * SM_KGROUPS;  // channel halves x groups
constexpr int SM_CONSUMERS = 32 * SM_CONSUMER_WARPS;
constexpr int SM_THREADS = SM_CONSUMERS + 32;  // + the producer warp
constexpr int SM_Q_BYTES = SM_BN * SM_BK;
constexpr int SM_RED_LD = SM_BN + 8;  // floats a row of the K groups'
                                      // partials (conflict-free writes)
constexpr int MAX_SPLITS = 8;  // one cluster: the portable maximum

// Shared memory of MT tiles of tokens (16-bit T: m16 tiles, 16 MT token
// rows; float32: n8 tiles, 8 MT rows): STAGES ring stages, each the q
// tile [64, 128] int8 then x's boxes of 128-byte rows (k 0-63 and 64-127
// of the stage in 16-bit T, two boxes [16 MT, 64]; float32, four [8 MT,
// 32]), all 128-byte swizzled (1024-byte aligned); the cluster fold
// buffer (S slices of the owner's share of the partial sums, one a rank);
// the block's 64 scales; a full and an empty mbarrier a stage and the
// fold buffer's mbarrier. The K groups' partials [4][ROWS][SM_RED_LD]
// take the ring's place once every stage is consumed. 1024 bytes of
// slack align the ring.
template <int MT, typename T> struct SmTile {
  static constexpr int ROWS = (is_f32<T> ? 8 : 16) * MT;
  static constexpr int X_BOXES = (int)sizeof(T) * SM_BK / 128;
  static constexpr int BOX_K = SM_BK / X_BOXES;  // k a box row
  static constexpr int X_BOX_BYTES = ROWS * 128;
  static constexpr int STAGE_BYTES = SM_Q_BYTES + X_BOXES * X_BOX_BYTES;
  // a multiple of the K groups, so that a slot is always the same
  // group's (its full barrier's phases are then waited for in order)
  static constexpr int STAGES = MT == 1 ? 8 : 4;
  static_assert(STAGES % SM_KGROUPS == 0, "a slot is one group's");
  // stages of q the producer keeps in flight ahead of the oldest one
  // that has not landed: about what the card's memory needs in flight
  // with one block an SM; more only delays every stage's arrival
  static constexpr int LEAD = 4;
  static constexpr int FOLD_FLOATS = ROWS * SM_BN + 4 * MAX_SPLITS;
  static constexpr int RED_BYTES = SM_KGROUPS * ROWS * SM_RED_LD * 4;
  static_assert(RED_BYTES <= STAGES * STAGE_BYTES, "partials > ring");
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES +
                              (FOLD_FLOATS + SM_BN) * 4 + (2 * STAGES + 1) * 8;
};

// The 16-bit forms' consumer warp: channels 32 half .. + 31 of the
// block's 64 (four n8 tiles, B) by its 16 MT tokens (MT m16 tiles, A),
// over the stages group, group + 4, ... of its n_st; the partial sums
// stored to the group's slice of `red` [group][token][SM_RED_LD].
template <int MT, typename T>
__device__ __forceinline__ void small_consume(
    uint8_t* smem, float* red, uint64_t* full, uint64_t* empty, int n_st,
    int half, int group, int lane) {
  using Tile = SmTile<MT, T>;
  constexpr int STAGES = Tile::STAGES;
  constexpr int ROWS = Tile::ROWS;
  const int g = lane >> 2, t = lane & 3, u = t >> 1;
  // lane (g, t) takes k = 32t .. 32t + 31 of a stage. Its weights of
  // column c: the 16-byte chunks 2t and 2t + 1 of q's row, in the order
  // (w + u) % 2 for w = 0, 1; its x of row m: chunks 4 (t % 2) .. + 3 of
  // box u (8 values each), in the order (i + 2u) % 4 for i = 0 .. 3. Step
  // j (4 values of k a lane) of the stage is then word j % 4 of weight
  // slot j / 4 and half j % 2 of x slot j / 2 for every lane, and lanes
  // t >= 2 walk k rotated by 64 (the 128-byte swizzle stores chunk c of
  // row r at c ^ (r % 8), and rows n, m = g modulo 8)
  uint32_t qoff[4][2], xoff[MT][2][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int w = 0; w < 2; ++w)
      qoff[nt][w] = (32 * half + 8 * nt + g) * 128 +
                    (((2 * t + ((w + u) & 1)) ^ g) << 4);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xoff[mt][r][i] = SM_Q_BYTES + u * Tile::X_BOX_BYTES +
                         (16 * mt + 8 * r + g) * 128 +
                         (((4 * (t & 1) + ((i + 2 * u) & 3)) ^ g) << 4);

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int i = group; i < n_st; i += SM_KGROUPS) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t base = smem_u32(smem + st * Tile::STAGE_BYTES);
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint4 bq[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) bq[nt] = lds128(base + qoff[nt][w]);
#pragma unroll
      for (int xi = 2 * w; xi < 2 * w + 2; ++xi) {
        uint4 ax[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int r = 0; r < 2; ++r) ax[mt][r] = lds128(base + xoff[mt][r][xi]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 2 * xi + h;  // the step: word j % 4 of slot w
          uint32_t b0[4], b1[4];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            widen_split<T>(word(bq[nt], j & 3), b0[nt], b1[nt]);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            // x at k, k + 2 and k + 1, k + 3 of the step's four, as the
            // weights' even and odd bytes
            const uint32_t a0 = __byte_perm(word(ax[mt][0], 2 * h),
                                            word(ax[mt][0], 2 * h + 1), 0x5410);
            const uint32_t a1 = __byte_perm(word(ax[mt][1], 2 * h),
                                            word(ax[mt][1], 2 * h + 1), 0x5410);
            const uint32_t a2 = __byte_perm(word(ax[mt][0], 2 * h),
                                            word(ax[mt][0], 2 * h + 1), 0x7632);
            const uint32_t a3 = __byte_perm(word(ax[mt][1], 2 * h),
                                            word(ax[mt][1], 2 * h + 1), 0x7632);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma16816<T>(acc[mt][nt], a0, a1, a2, a3, b0[nt], b1[nt]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the K groups' partials over the ring, once every consumer is done
  // with it (every copy issued has landed: each was waited for); lane
  // (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of each n8 tile
  asm volatile("bar.sync 1, %0;\n" ::"n"(SM_CONSUMERS) : "memory");
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = red + (group * ROWS + 16 * mt + g) * SM_RED_LD + 32 * half +
                 8 * nt + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * SM_RED_LD) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(SM_CONSUMERS) : "memory");
}

// The float32 form's consumer warp: channels 32 half .. + 31 of the
// block's 64 (two m16 tiles, the A operand) by the block's 8 MT tokens
// (MT n8 tiles, B), over the stages group, group + 4, ... of its n_st;
// the block's partial sums of those channels and tokens stored to the
// group's slice of `red` [group][token][SM_RED_LD] (once every consumer
// is done with the ring, which `red` aliases).
template <int MT>
__device__ __forceinline__ void small_f32_consume(
    uint8_t* smem, float* red, uint64_t* full, uint64_t* empty, int n_st,
    int half, int group, int lane) {
  using Tile = SmTile<MT, float>;
  constexpr int STAGES = Tile::STAGES;
  constexpr int ROWS = Tile::ROWS;
  const int g = lane >> 2, t = lane & 3, u = t >> 1;
  // lane (g, t) takes k = 32t .. 32t + 31 of a stage: q bytes 32t ..
  // (16-byte chunks 2t, 2t + 1 of a row) and x box t. Its weights of
  // channel row r: chunk 2t + (w + u) % 2 for slot w = 0, 1; word i of
  // slot w feeds two k8 steps (bytes 0 and 1 as k' = t and t + 4, then 2
  // and 3), as the floats of x's chunk 4 ((w + u) % 2) + i of its token
  // row do. Lanes t >= 2 take their two slots in the other order, so that
  // lanes t and t + 2 load other banks (the swizzle stores chunk c of row
  // r at c ^ (r % 8), and rows = g modulo 8).
  uint32_t qoff[4][2];  // rows 16 mt + g + 8 (r % 2) for r = 2 mt + (0, 1)
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int w = 0; w < 2; ++w)
      qoff[r][w] = (32 * half + 16 * (r >> 1) + 8 * (r & 1) + g) * 128 +
                   (((2 * t + ((w + u) & 1)) ^ g) << 4);
  const uint32_t xbase = SM_Q_BYTES + t * Tile::X_BOX_BYTES + g * 128;

  float acc[2][MT][4], sum[2][MT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int i = group; i < n_st; i += SM_KGROUPS) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const uint32_t base = smem_u32(smem + st * Tile::STAGE_BYTES);
    // the stage's products from zero (see the note on 2xTF32)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < MT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mt][nt][e] = 0.f;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      uint4 wq[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wq[r] = lds128(base + qoff[r][w]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // x's floats of k 4c' .. 4c' + 3 of the lane's 32 (c' = 4 ((w + u)
        // % 2) + c), each n8 tile's token row g: hi as read, and lo
        uint32_t xh[MT][4], xl[MT][4];
#pragma unroll
        for (int nt = 0; nt < MT; ++nt) {
          const uint4 v = lds128(base + xbase + nt * 1024 +
                                 (((4 * ((w + u) & 1) + c) ^ g) << 4));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xh[nt][e] = word(v, e);
            xl[nt][e] = tf32_lo(__uint_as_float(xh[nt][e]));
          }
        }
        float f[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) widen_f32x4(word(wq[r], c), f[r]);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const uint32_t a0 = __float_as_uint(f[2 * mt][2 * h]);
            const uint32_t a1 = __float_as_uint(f[2 * mt + 1][2 * h]);
            const uint32_t a2 = __float_as_uint(f[2 * mt][2 * h + 1]);
            const uint32_t a3 = __float_as_uint(f[2 * mt + 1][2 * h + 1]);
#pragma unroll
            for (int nt = 0; nt < MT; ++nt) {
              mma1688_tf32(sum[mt][nt], a0, a1, a2, a3, xl[nt][2 * h],
                           xl[nt][2 * h + 1]);
              mma1688_tf32(sum[mt][nt], a0, a1, a2, a3, xh[nt][2 * h],
                           xh[nt][2 * h + 1]);
            }
          }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < MT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += sum[mt][nt][e];
  }

  // the partials over the ring once every consumer is done with it; lane
  // (g, t) holds channels 16 mt + g (e < 2) and + 8 (e >= 2) of tokens 8
  // nt + 2t + e % 2
  asm volatile("bar.sync 1, %0;\n" ::"n"(SM_CONSUMERS) : "memory");
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < MT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(group * ROWS + 8 * nt + 2 * t + (e & 1)) * SM_RED_LD +
            32 * half + 16 * mt + 8 * (e >> 1) + g] = acc[mt][nt][e];
  asm volatile("bar.sync 1, %0;\n" ::"n"(SM_CONSUMERS) : "memory");
}

// grid: S blocks a 64-channel tile, clusters of S (blockIdx.x = tile * S
// + rank); block r takes the 128-wide stages [r * cps, (r + 1) * cps) of
// K. early: let the next grid launch once the last weight stage is
// issued (else when this one ends; see launch_small). x_map: x as [M, K]
// T, box [ROWS, BOX_K] (bfloat16 or float16 [16 MT, 64], float32 [8 MT,
// 32]); q_map: q as [N, K] uint8, box [64, 128]; both 128-byte swizzle,
// zeros past M, N and K.
template <int MT, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(SM_THREADS, 2)
int8_gemm_small_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map,
                       const float* __restrict__ s, T* __restrict__ y, int M,
                       int N, int K, int splits, int cps, int early) {
  using Tile = SmTile<MT, T>;
  constexpr int STAGES = Tile::STAGES;
  constexpr int ROWS = Tile::ROWS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem);  // aliases the ring
  float* fold = reinterpret_cast<float*>(smem + STAGES * Tile::STAGE_BYTES);
  float* sc = fold + Tile::FOLD_FLOATS;
  uint64_t* full = reinterpret_cast<uint64_t*>(sc + SM_BN);
  uint64_t* empty = full + STAGES;
  uint64_t* folded = empty + STAGES;  // the fold buffer's bytes, K split

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % splits;
  const int n0 = (blockIdx.x / splits) * SM_BN;
  const int C = (K + SM_BK - 1) / SM_BK;
  const int c_begin = min(C, rank * cps);
  const int n_st = min(C, c_begin + cps) - c_begin;  // this block's stages
  const int pre = min(n_st, Tile::LEAD);  // stages issued before the wait
  // K split: the quads (four columns of a row < M) of the partial sums
  // and the quads each rank owns (the last ranks may own fewer, or none)
  const int quads = min(M, ROWS) * (SM_BN / 4);
  const int per = (quads + splits - 1) / splits;
  const int owned = max(0, min(quads, (rank + 1) * per) - rank * per);

  if (tid == SM_CONSUMERS) {
    // the producer thread: the barriers, then at once the first stages
    // of weights (q is not written by any grid this one may overlap)
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);   // the producer + TMA bytes
      mbar_init(&empty[i], 2);  // the stage's two consumer warps
    }
    mbar_init(folded, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // every rank's slice of the quads this block owns
    if (splits > 1 && owned > 0) mbar_expect_tx(folded, splits * owned * 16);
    for (int i = 0; i < pre; ++i) {
      mbar_expect_tx(&full[i], Tile::STAGE_BYTES);
      tma_load_2d(smem_u32(smem + i * Tile::STAGE_BYTES), &q_map,
                  (c_begin + i) * SM_BK, n0, &full[i]);
    }
  } else if (tid < SM_BN) {  // the scales, read-only too
    sc[tid] = n0 + tid < N ? s[n0 + tid] : 0.f;
  }
  __syncthreads();
  // the first half of the barrier that tells a block its peers have
  // started (so their shared memory may be written); its wait comes at
  // the fold, long after (threads that exit sooner are not waited for)
  if (splits > 1) cluster_arrive_relaxed();

  if (warp == SM_CONSUMER_WARPS) {
    // ---- producer: once the grid dependency resolves, x for the first
    // ring of stages, then the rest stage by stage
    if (lane == 0) {
      if (early && pre == n_st) grid_dep_launch();
      grid_dep_wait();
      for (int i = 0; i < n_st; ++i) {
        const int st = i % STAGES;
        if (i >= pre) {
          if (i >= STAGES) mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
          if (i >= Tile::LEAD) {
            const int j = i - Tile::LEAD;
            mbar_wait(&full[j % STAGES], (j / STAGES) & 1);
          }
          mbar_expect_tx(&full[st], Tile::STAGE_BYTES);
          tma_load_2d(smem_u32(smem + st * Tile::STAGE_BYTES), &q_map,
                      (c_begin + i) * SM_BK, n0, &full[st]);
        }
        const uint32_t xs =
            smem_u32(smem + st * Tile::STAGE_BYTES + SM_Q_BYTES);
        const int k = (c_begin + i) * SM_BK;
#pragma unroll
        for (int b = 0; b < Tile::X_BOXES; ++b)
          tma_load_2d(xs + b * Tile::X_BOX_BYTES, &x_map, k + b * Tile::BOX_K,
                      0, &full[st]);
      }
      if (early && pre < n_st) grid_dep_launch();
    }
    return;
  }

  // ---- consumers: warp (half, group) computes channels 32 half .. + 31
  // of the block's 64 over the stages group, group + 4, ...
  grid_dep_wait();
  const int half = warp & 1, group = warp >> 1;
  if constexpr (is_f32<T>) {
    small_f32_consume<MT>(smem, red, full, empty, n_st, half, group, lane);
  } else {
    small_consume<MT, T>(smem, red, full, empty, n_st, half, group, lane);
  }

  // the block's partial, groups summed in order: quad e = (row, four
  // columns) of the rows < M. Unsplit: scaled and stored. Split: stored
  // asynchronously into slice [this rank] of its owner's fold buffer
  // (rank e / per), counted on the owner's mbarrier; each owner waits for
  // its slices, sums them over the ranks in order, scales and stores. No
  // block reads a peer's shared memory, so none waits for its peers to
  // finish.
  if (splits > 1) cluster_wait_acquire();  // every peer has started
  for (int e = tid; e < quads; e += SM_CONSUMERS) {
    const int row = e / (SM_BN / 4), col = 4 * (e % (SM_BN / 4));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int gr = 0; gr < SM_KGROUPS; ++gr) {
      const float4 w = *reinterpret_cast<const float4*>(
          red + (gr * ROWS + row) * SM_RED_LD + col);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    if (splits == 1) {
      store2(y, sc, N, row, n0, col, v.x, v.y);
      store2(y, sc, N, row, n0, col + 2, v.z, v.w);
    } else {
      const int owner = e / per;
      st_async_f4(
          dsmem_addr(smem_u32(fold + 4 * (rank * per + e - owner * per)),
                     owner),
          v, dsmem_addr(smem_u32(folded), owner));
    }
  }
  if (splits == 1 || owned == 0) return;
  mbar_wait_cluster(folded, 0);
  for (int j = tid; j < owned; j += SM_CONSUMERS) {
    float4 v = *reinterpret_cast<const float4*>(fold + 4 * j);
    for (int r = 1; r < splits; ++r) {
      const float4 w = *reinterpret_cast<const float4*>(fold + 4 * (r * per + j));
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int e = rank * per + j;
    const int row = e / (SM_BN / 4), col = 4 * (e % (SM_BN / 4));
    store2(y, sc, N, row, n0, col, v.x, v.y);
    store2(y, sc, N, row, n0, col + 2, v.z, v.w);
  }
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
// tile of K 64 (16-bit T: [BT, 64]; float32: two boxes [BT, 32], then
// their lo parts, the same bytes at the same swizzle; rows of 128 bytes,
// 128-byte swizzle) then the q tile [128, 64] int8 (rows of 64 bytes,
// 64-byte swizzle), and a full and an empty mbarrier a stage. With K
// splits, the fold buffer [BT, WG_PART_LD] float32 takes the ring's place
// between a tile's last chunk and the next tile's first (the producer
// loads nothing then). 1024 bytes of slack align the ring for the
// swizzles.
template <int BT, typename T> struct WgTile {
  static constexpr int X_BOXES = (int)sizeof(T) / 2;
  static constexpr int BOX_K = WG_BK / X_BOXES;  // k a box row
  static constexpr int X_BOX_BYTES = BT * 128;
  static constexpr int X_BYTES = X_BOXES * X_BOX_BYTES;
  static constexpr int Q_OFF = (is_f32<T> ? 2 : 1) * X_BYTES;
  static constexpr int STAGE_BYTES = Q_OFF + WG_Q_BYTES;
  static constexpr int TX_BYTES = X_BYTES + WG_Q_BYTES;  // what TMA writes
  static constexpr int STAGES =
      !is_f32<T> ? (BT == 256 ? 5 : 8)
                 : (232448 - 1024 - 16 * 8) / STAGE_BYTES < 8
                       ? (232448 - 1024 - 16 * 8) / STAGE_BYTES
                       : 8;
  // chunks whose wgmmas a consumer warpgroup keeps in flight (16-bit
  // forms): three where a chunk's products are short (their latency, not
  // the tensor cores, sets the pace), two at 128 tokens and more, where a
  // third would leave the producer too few stages to fill ahead
  static constexpr int DEPTH = BT <= 64 ? 3 : 2;
  static constexpr int PART_BYTES = BT * WG_PART_LD * 4;
  static_assert(PART_BYTES <= STAGES * STAGE_BYTES, "fold buffer > ring");
  static_assert(!is_f32<T> || BT <= 128, "float32 tiles hold <= 128 tokens");
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

// registers that an in-flight wgmma reads or writes stay where they are
// until this point (the compiler sees them used here)
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]),
                 "+r"(a[i][3]) :: "memory");
}
__device__ __forceinline__ void hold(uint32_t (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    asm volatile("" : "+r"(a[i][0]), "+r"(a[i][1]), "+r"(a[i][2]),
                 "+r"(a[i][3]) :: "memory");
}
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// four sums (tokens m, channels n .. n + 3) scaled and rounded to T
template <typename T>
__device__ __forceinline__ void store4(T* y, const float* s, int M, int N,
                                       int m, int n, float4 v) {
  if (m >= M) return;
  T* row = y + (size_t)m * N;
  if constexpr (is_f32<T>) {
    if ((N & 3) == 0 && n + 3 < N) {
      *reinterpret_cast<float4*>(row + n) =
          make_float4(v.x * s[n], v.y * s[n + 1], v.z * s[n + 2],
                      v.w * s[n + 3]);
      return;
    }
  } else if ((N & 3) == 0 && n + 3 < N) {
    uint2 packed;
    packed.x = pack2<T>(v.x * s[n], v.y * s[n + 1]);
    packed.y = pack2<T>(v.z * s[n + 2], v.w * s[n + 3]);
    *reinterpret_cast<uint2*>(row + n) = packed;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N) row[n + i] = from_f<T>(e[i] * s[n + i]);
}

// Register-A wgmma m64nNk8, tf32 in, f32 accumulators (d: N / 2 a thread
// of the warpgroup, laid out as wgmma_rs's): a is mma.sync's m16n8k8 tf32
// A fragment (a thread's k t and t + 4 of rows g and g + 8 of its warp's
// 16), B comes from shared memory through db, K-major (tf32 takes no
// transpose). SD = 0 writes d = a b, ignoring what d held; SD = 1 adds.
#define DYN_F8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DYN_F32(i) DYN_F8(i), DYN_F8(i + 8), DYN_F8(i + 16), DYN_F8(i + 24)

template <int SD>
__device__ __forceinline__ void wgmma_tf32_n16(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : DYN_F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SD));
}

template <int SD>
__device__ __forceinline__ void wgmma_tf32_n32(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : DYN_F8(0), DYN_F8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SD));
}

template <int SD>
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : DYN_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SD));
}

template <int SD>
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : DYN_F32(0), DYN_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(SD));
}

#undef DYN_F32
#undef DYN_F8

template <int N, int SD>
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                           uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "wgmma_tf32: N must be 16, 32, 64 or 128");
  if constexpr (N == 16) wgmma_tf32_n16<SD>(d, a, db);
  if constexpr (N == 32) wgmma_tf32_n32<SD>(d, a, db);
  if constexpr (N == 64) wgmma_tf32_n64<SD>(d, a, db);
  if constexpr (N == 128) wgmma_tf32_n128<SD>(d, a, db);
}

// The 16-bit forms' chunks of one tile: the nc chunks of a consumer
// warpgroup's 64 channels (thread rows crow, crow + 8) by BT tokens into
// acc, starting at ring position `it` (advanced past them).
template <int BT, typename T>
__device__ __forceinline__ void wgmma_chunks(
    float (&acc)[BT / 2], uint8_t* smem, uint64_t* full, uint64_t* empty,
    int& it, int nc, int crow, int lane) {
  using Tile = WgTile<BT, T>;
  constexpr int STAGES = Tile::STAGES;
  const int t = lane & 3;
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
        widen_pair<T>(__byte_perm(lds32(addr), lds32(addr + 8), sel),
                      a[kk][h], a[kk][2 + h]);
      }
  };
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };

  constexpr int DEPTH = Tile::DEPTH;
  uint32_t afrag[DEPTH][4][4];  // one chunk's A fragments a buffer
  // chunk i of the tile: its A fragments into `a` (buffer i % DEPTH)
  // while the DEPTH - 1 chunks before it run, then its four wgmmas; once
  // they are issued, chunk i - DEPTH + 1's have completed: its stage is
  // released and its buffer `done` may be written again
  auto chunk = [&](uint32_t (&a)[4][4], uint32_t (&done)[4][4], int i) {
    const int st = it % STAGES;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint32_t xs = smem_u32(smem + st * Tile::STAGE_BYTES);
    load_a(xs + Tile::Q_OFF, a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<BT, 0, T>(acc, a[kk], wgmma_desc(xs + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<DEPTH - 1>();
    hold(done);
    if (i >= DEPTH - 1) release((it + STAGES - DEPTH + 1) % STAGES);
    ++it;
  };
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
}

// The float32 form's chunks of one tile: the nc chunks of a consumer
// warpgroup's 64 channels (thread rows crow, crow + 8) by BT tokens into
// acc, starting at ring position `it` (advanced past them). Chunk i:
// prep (wait for its stage; the 256 consumer threads write lo = x - hi
// beside x and fence those writes to the async proxy; this thread widens
// its A fragment, byte t of each word of rows crow and crow + 8), then,
// once every consumer's prep is done (a named barrier), its 16 wgmmas
// (lo then hi a k8 step) into `sum` from zero while chunk i + 1 is
// prepped; then sum is added to acc and the stage released.
template <int BT>
__device__ __forceinline__ void wgmma_f32_chunks(
    float (&acc)[BT / 2], uint8_t* smem, uint64_t* full, uint64_t* empty,
    int& it, int nc, int crow, int tid, int lane) {
  using Tile = WgTile<BT, float>;
  constexpr int STAGES = Tile::STAGES;
  const uint32_t sel = 0x7540u | (lane & 3);
  // chunk kk of the q tile's row crow (row crow + 8 is 512 bytes on, with
  // the same swizzle): the 64-byte swizzle stores it at kk ^ ((r / 2) % 4)
  uint32_t qoff[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    qoff[kk] = crow * 64 + ((kk ^ ((crow >> 1) & 3)) << 4);
  float sum[BT / 2];
  uint32_t afrag[2][8][4];
  auto prep = [&](int i, uint32_t (&a)[8][4]) {
    const int st = (it + i) % STAGES;
    mbar_wait(&full[st], ((it + i) / STAGES) & 1);
    const uint32_t xs = smem_u32(smem + st * Tile::STAGE_BYTES);
    for (int p = tid; p < Tile::X_BYTES / 16; p += WG_CONSUMERS) {
      const uint4 v = lds128(xs + 16 * p);
      sts128(xs + Tile::X_BYTES + 16 * p,
             make_uint4(tf32_lo(__uint_as_float(v.x)),
                        tf32_lo(__uint_as_float(v.y)),
                        tf32_lo(__uint_as_float(v.z)),
                        tf32_lo(__uint_as_float(v.w))));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // step 2kk: words 0 (k 0-3) and 1 (k 4-7) of chunk kk; step 2kk + 1:
    // words 2 and 3; a = {row crow k t, row crow + 8 k t, row crow k t +
    // 4, row crow + 8 k t + 4}
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 v = lds128(xs + Tile::Q_OFF + qoff[kk] + h * 512);
        a[2 * kk][h] = widen_f32_byte(v.x ^ 0x80808080u, sel);
        a[2 * kk][2 + h] = widen_f32_byte(v.y ^ 0x80808080u, sel);
        a[2 * kk + 1][h] = widen_f32_byte(v.z ^ 0x80808080u, sel);
        a[2 * kk + 1][2 + h] = widen_f32_byte(v.w ^ 0x80808080u, sel);
      }
  };
  auto chunk = [&](uint32_t (&a)[8][4], uint32_t (&next)[8][4], int i) {
    const int st = (it + i) % STAGES;
    const uint32_t xs = smem_u32(smem + st * Tile::STAGE_BYTES);
    hold(sum);
    wgmma_fence();
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) {
      const uint32_t off = (k8 >> 2) * Tile::X_BOX_BYTES + (k8 & 3) * 32;
      const uint64_t lo = wgmma_desc(xs + Tile::X_BYTES + off, 16, 1024);
      const uint64_t hi = wgmma_desc(xs + off, 16, 1024);
      if (k8 == 0) wgmma_tf32<BT, 0>(sum, a[k8], lo);
      else wgmma_tf32<BT, 1>(sum, a[k8], lo);
      wgmma_tf32<BT, 1>(sum, a[k8], hi);
    }
    wgmma_commit();
    if (i + 1 < nc) prep(i + 1, next);
    wgmma_wait<0>();
    hold(sum);
    hold(a);
#pragma unroll
    for (int e = 0; e < BT / 2; ++e) acc[e] += sum[e];
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    // every consumer's lo of chunk i + 1 is written and fenced
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
  };
  if (nc > 0) {
    prep(0, afrag[0]);
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG_CONSUMERS) : "memory");
  }
  int i = 0;
  for (; i + 1 < nc; i += 2) {
    chunk(afrag[0], afrag[1], i);
    chunk(afrag[1], afrag[0], i + 1);
  }
  if (i < nc) chunk(afrag[0], afrag[1], i);
  it += nc;
}

// grid: clusters of `splits` blocks (1..8), as many clusters as the card
// holds at once (or fewer where the tiles are fewer). Cluster c walks the
// tiles c, c + clusters, ...; tile i covers tokens (i % TT) * BT .. + BT -
// 1 and channels (i / TT) * 128 .. + 127. Block r of a cluster takes the
// 64-wide chunks [r * cps, (r + 1) * cps) of K. Warps 0-7 are the
// consumers (warpgroup wg computes channels 64 wg .. + 63 of the
// block's 128, warp w its rows 16 (w % 4) + g and + 8), warps 8-11 the
// producer warpgroup (one thread issues the copies). x_map: x as [M, K]
// T (bfloat16 or float16), box [BT, 64], 128-byte swizzle; q_map: q as
// [N, K] uint8, box [128, 64], 64-byte swizzle (zeros past M, N and K).
template <int BT, typename T = __nv_bfloat16>
__global__ void __launch_bounds__(WG_THREADS, 1)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap q_map,
                       const float* __restrict__ s, T* __restrict__ y, int M,
                       int N, int K, int splits, int cps) {
  using Tile = WgTile<BT, T>;
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
          mbar_expect_tx(&full[st], Tile::TX_BYTES);
          const uint32_t xs = smem_u32(smem + st * Tile::STAGE_BYTES);
#pragma unroll
          for (int b = 0; b < Tile::X_BOXES; ++b)
            tma_load_2d(xs + b * Tile::X_BOX_BYTES, &x_map,
                        c * WG_BK + b * Tile::BOX_K, m0, &full[st]);
          tma_load_2d(xs + Tile::Q_OFF, &q_map, c * WG_BK, n0, &full[st]);
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
  float acc[BT / 2];
  int it = 0;
  for (int tile = cluster; tile < tiles; tile += clusters) {
    const int m0 = (tile % TT) * BT, n0 = (tile / TT) * WG_BN;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
    if constexpr (is_f32<T>)
      wgmma_f32_chunks<BT>(acc, smem, full, empty, it, c_end - c_begin, crow,
                           tid, lane);
    else
      wgmma_chunks<BT, T>(acc, smem, full, empty, it, c_end - c_begin, crow,
                          lane);

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
                from_f<T>(acc[4 * j + e] * (e < 2 ? sa : sb));
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

// launches of the small-M route are programmatic unless switched off
// (dyn_int8_gemm_programmatic), to time the two side by side
int g_programmatic = 1;

// a cluster of `splits` blocks where K is split (or always: `cluster`),
// and programmatic launch where switched on
cudaLaunchConfig_t small_config(int splits, int grid, cudaStream_t st,
                                cudaLaunchAttribute* attr,
                                bool cluster = false) {
  cudaLaunchConfig_t cfg = {};
  int n = 0;
  if (splits > 1 || cluster) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = splits;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (g_programmatic) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(SM_THREADS);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return cfg;
}

// the tensor-map type of T
template <typename T>
constexpr CUtensorMapDataType map_type() {
  return is_f32<T>   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <int MT, typename T>
int launch_small(const void* x, const void* q, const float* s, T* y, int M,
                 int N, int K, int splits, int grid, cudaStream_t st) {
  using Tile = SmTile<MT, T>;
  if (splits < 1 || splits > MAX_SPLITS ||
      grid != (N + SM_BN - 1) / SM_BN * splits)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, q_map;
  if (!tile_map(&x_map, map_type<T>(), x, M, K, sizeof(T) * K, Tile::ROWS,
                Tile::BOX_K, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, K, SM_BN,
                SM_BK, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_small_kernel<MT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int C = (K + SM_BK - 1) / SM_BK;
  const int cps = (C + splits - 1) / splits;
  // The next grid's blocks, launched early, take the SMs' free slots: where
  // this grid holds one block an SM for a long share (w_down's 56 stages)
  // some land two to an SM and run at half speed to their end, slower
  // than launched when this grid ends. So the early launch is for short
  // shares, and for grids that already hold more blocks than SMs.
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int early = cps <= 4 * Tile::STAGES || grid > sms;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = small_config(splits, grid, st, attr);
  cfg.dynamicSmemBytes = Tile::SMEM;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_small_kernel<MT, T>, x_map, q_map,
                           s, y, M, N, K, splits, cps, early);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// blocks of the MT-tile small-M kernel in T (clusters of `splits`) the
// card holds at once (negative: a CUDA error)
template <int MT, typename T>
int small_resident(int splits) {
  using Tile = SmTile<MT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_small_kernel<MT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = small_config(splits, splits, nullptr, attr, true);
  cfg.dynamicSmemBytes = Tile::SMEM;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, int8_gemm_small_kernel<MT, T>,
                                       &cfg);
  return err != cudaSuccess ? -(int)err : n * splits;
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

template <int BT, typename T>
int launch_wgmma(const void* x, const void* q, const float* s, T* y, int M,
                 int N, int K, int splits, int grid, cudaStream_t st) {
  using Tile = WgTile<BT, T>;
  if (splits < 1 || splits > MAX_SPLITS || grid < splits ||
      grid % splits != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map, q_map;
  if (!tile_map(&x_map, map_type<T>(), x, M, K, sizeof(T) * K, BT,
                Tile::BOX_K, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tile_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, K, WG_BN,
                WG_BK, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_wgmma_kernel<BT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int C = (K + WG_BK - 1) / WG_BK;
  const int cps = (C + splits - 1) / splits;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wgmma_config(splits, grid, st, attr);
  cfg.dynamicSmemBytes = Tile::SMEM;
  err = cudaLaunchKernelEx(&cfg, int8_gemm_wgmma_kernel<BT, T>, x_map, q_map,
                           s, y, M, N, K, splits, cps);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// clusters of `splits` blocks of the BT-token kernel in T the card holds
// at once (negative: a CUDA error)
template <int BT, typename T>
int wgmma_resident(int splits) {
  using Tile = WgTile<BT, T>;
  cudaError_t err = cudaFuncSetAttribute(
      int8_gemm_wgmma_kernel<BT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = wgmma_config(splits, splits, nullptr, attr);
  cfg.dynamicSmemBytes = Tile::SMEM;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, int8_gemm_wgmma_kernel<BT, T>,
                                       &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

// the routes in T: route 0 (small_m; tile: m16 tiles in bfloat16 or
// float16, n8 tiles in float32, 1 or 2) or 1 (wgmma; tile: BT tokens, 16
// .. 256, at most 128 in float32)
template <typename T>
int launch_tc(const void* x, const void* q, const float* s, void* y, int M,
              int N, int K, int route, int tile, int splits, int grid,
              cudaStream_t st) {
  T* yt = static_cast<T*>(y);
  if (route == 0) {
    if (M > SmTile<1, T>::ROWS * tile) return (int)cudaErrorInvalidValue;
    switch (tile) {
      case 1: return launch_small<1, T>(x, q, s, yt, M, N, K, splits, grid, st);
      case 2: return launch_small<2, T>(x, q, s, yt, M, N, K, splits, grid, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (route != 1) return (int)cudaErrorInvalidValue;
  switch (tile) {
#define WG_CASE(BT) \
  case BT: return launch_wgmma<BT, T>(x, q, s, yt, M, N, K, splits, grid, st);
    WG_CASE(16) WG_CASE(32) WG_CASE(64) WG_CASE(128)
#undef WG_CASE
    case 256:
      if constexpr (!is_f32<T>)
        return launch_wgmma<256, T>(x, q, s, yt, M, N, K, splits, grid, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y [M, N] = (x [M, K] @ q [N, K]^T) * s [N]; dtype of x and y: 0
// bfloat16, 1 float16, 2 float32. route 0 (small_m): `tile` tiles of
// tokens (1 or 2: m16 tiles in bfloat16 and float16, M <= 16 tile; n8
// tiles in float32, M <= 8 tile), `splits` blocks of K a cluster (1..8)
// and `grid` = ceil(N / 64) * splits blocks; route 1 (wgmma): `tile`
// tokens a tile (16, 32, 64, 128, or 256 outside float32), `splits`
// blocks of K a cluster and `grid` blocks (a multiple of splits). K must
// be a multiple of 16 and x and q 16-byte aligned; the wrapper checks
// both, and the entry refuses what it does not take.
extern "C" int dyn_int8_gemm(const void* x, const void* q, const void* s,
                             void* y, int M, int N, int K, int route,
                             int tile, int splits, int grid, int dtype,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const float*>(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tc<__nv_bfloat16>(x, q, sb, y, M, N, K, route, tile,
                                    splits, grid, st);
  if (dtype == 1)
    return launch_tc<__half>(x, q, sb, y, M, N, K, route, tile, splits,
                             grid, st);
  if (dtype == 2)
    return launch_tc<float>(x, q, sb, y, M, N, K, route, tile, splits, grid,
                            st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int resident_of(int tile, int splits) {
  switch (tile) {
    case 1: return small_resident<1, T>(splits);
    case 2: return small_resident<2, T>(splits);
    case 16: return wgmma_resident<16, T>(splits);
    case 32: return wgmma_resident<32, T>(splits);
    case 64: return wgmma_resident<64, T>(splits);
    case 128: return wgmma_resident<128, T>(splits);
    case 256:
      if constexpr (!is_f32<T>) return wgmma_resident<256, T>(splits);
  }
  return -(int)cudaErrorInvalidValue;
}

// How many clusters of `splits` blocks of the wgmma route's
// `tile`-token kernel the card holds at once (the persistent grid's
// size), or, for tile 1 or 2, how many blocks of the small-M route's
// kernel of that many token tiles in clusters of `splits`, in the form
// for dtype (0 bfloat16, 1 float16, 2 float32: the plans take each form's
// own counts); a negative value is a CUDA error.
extern "C" int dyn_int8_gemm_resident(int tile, int splits, int dtype) {
  if (splits < 1 || splits > MAX_SPLITS || dtype < 0 || dtype > 2)
    return -(int)cudaErrorInvalidValue;
  return dtype == 0   ? resident_of<__nv_bfloat16>(tile, splits)
         : dtype == 1 ? resident_of<__half>(tile, splits)
                      : resident_of<float>(tile, splits);
}

// Switch programmatic launch of the small-M route on (1) or off (0), to
// time the two; returns the previous setting.
extern "C" int dyn_int8_gemm_programmatic(int on) {
  const int was = g_programmatic;
  g_programmatic = on != 0;
  return was;
}
