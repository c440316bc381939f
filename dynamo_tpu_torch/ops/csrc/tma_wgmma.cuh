// Hopper building blocks shared by the kernels that feed wgmma from TMA
// rings (paged_prefill.cu, int8_gemm.cu): the 16-bit operand types
// (bfloat16 and float16: conversions, and which PTX type a product
// names), mbarriers, 2-D TMA loads, wgmma descriptors and the register-A
// wgmma, and cuTensorMapEncodeTiled found at run time.
// attention_common.cuh includes it for the decode kernel's mbarriers and
// types. build.py hashes this header into the name of every library
// whose source includes it, directly or through another csrc header.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---- element types. The tensor-core kernels take bfloat16 or float16
// operands (T); a product's PTX names the type ("bf16" or "f16"), so each
// one is written once as a macro of that name and stamped for T by
// DYN_AB: the bfloat16 form is the same instruction either way.
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;
#define DYN_AB(T, STMT)                  \
  do {                                   \
    if constexpr (is_f16<T>) {           \
      STMT("f16");                       \
    } else {                             \
      STMT("bf16");                      \
    }                                    \
  } while (0)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

// float to T, rounded to nearest even
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// two floats as one 32-bit pair of T (lo in the lower half), rounded to
// nearest even, and a pair back to floats
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                                     float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <typename T> __device__ __forceinline__ float2 unpack2(const T* p);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive, and expect `bytes` more of asynchronous copies before the phase
// completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes) : "memory");
}

// TMA: the box at (col, row) of a 2-D tensor map into shared memory,
// completion counted in bytes on bar (a box reaching past the tensor is
// filled with zeros and still counts its full size)
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row),
      "r"(smem_u32(bar)) : "memory");
}

// wgmma descriptor of a 128-byte swizzled operand at shared address addr:
// lbo = bytes between 64-element column blocks (read for N-major B),
// sbo = bytes between groups of 8 rows
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register-A wgmma m64nNk16, T (bf16 or f16) in, f32 accumulators (d:
// N / 2 per thread of the warpgroup; warp w holds rows 16w + lane / 4 and
// + 8, as mma.sync's m16n8 fragment does): a is mma.sync's m16n8k16 A
// fragment, B comes from shared memory through db, K-major (TB = 0) or
// N-major (TB = 1, the descriptor's transpose bit).
#define DYN_WG_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define DYN_WG_D32(i) \
  DYN_WG_D8(i), DYN_WG_D8(i + 8), DYN_WG_D8(i + 16), DYN_WG_D8(i + 24)

template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
#define DYN_WG_RS_N16(AB)                                                   \
  asm volatile(                                                             \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                      \
      "}, {%8, %9, %10, %11}, %12, 1, 1, 1, %13;\n"                         \
      : DYN_WG_D8(0)                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB))
  DYN_AB(T, DYN_WG_RS_N16);
#undef DYN_WG_RS_N16
}

template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
#define DYN_WG_RS_N32(AB)                                                   \
  asm volatile(                                                             \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15"                                                  \
      "}, {%16, %17, %18, %19}, %20, 1, 1, 1, %21;\n"                       \
      : DYN_WG_D8(0), DYN_WG_D8(8)                                          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB))
  DYN_AB(T, DYN_WG_RS_N32);
#undef DYN_WG_RS_N32
}

template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
#define DYN_WG_RS_N64(AB)                                                   \
  asm volatile(                                                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." AB "." AB " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31"                              \
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, %37;\n"                       \
      : DYN_WG_D32(0)                                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB))
  DYN_AB(T, DYN_WG_RS_N64);
#undef DYN_WG_RS_N64
}

template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t db) {
#define DYN_WG_RS_N128(AB)                                                  \
  asm volatile(                                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." AB "." AB " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "        \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "        \
      "%60, %61, %62, %63"                                                  \
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, %69;\n"                       \
      : DYN_WG_D32(0), DYN_WG_D32(32)                                       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB))
  DYN_AB(T, DYN_WG_RS_N128);
#undef DYN_WG_RS_N128
}

template <int TB, typename T>
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a,
                                             uint64_t db) {
#define DYN_WG_RS_N256(AB)                                                  \
  asm volatile(                                                             \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." AB "." AB " {"         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                  \
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "        \
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "        \
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "        \
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "        \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "        \
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "        \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, " \
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
      "%120, %121, %122, %123, %124, %125, %126, %127"                      \
      "}, {%128, %129, %130, %131}, %132, 1, 1, 1, %133;\n"                 \
      : DYN_WG_D32(0), DYN_WG_D32(32), DYN_WG_D32(64), DYN_WG_D32(96)       \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TB))
  DYN_AB(T, DYN_WG_RS_N256);
#undef DYN_WG_RS_N256
}

#undef DYN_WG_D32
#undef DYN_WG_D8

template <int N, int TB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "wgmma_rs: N must be 16, 32, 64, 128 or 256");
  if constexpr (N == 16) wgmma_rs_n16<TB, T>(d, a, db);
  if constexpr (N == 32) wgmma_rs_n32<TB, T>(d, a, db);
  if constexpr (N == 64) wgmma_rs_n64<TB, T>(d, a, db);
  if constexpr (N == 128) wgmma_rs_n128<TB, T>(d, a, db);
  if constexpr (N == 256) wgmma_rs_n256<TB, T>(d, a, db);
}

// cuTensorMapEncodeTiled from the CUDA driver, found at run time so that the
// library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, cols] array (row stride `row_bytes`, a multiple of
// 16) as a 2-D tensor map read in boxes of [box_rows, box_cols]; boxes
// past the array are filled with zeros.
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              unsigned long long rows, unsigned long long cols,
              unsigned long long row_bytes, int box_rows, int box_cols,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
