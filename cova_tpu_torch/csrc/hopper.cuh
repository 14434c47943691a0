// Helpers shared by the Hopper (sm_90a) kernels of this directory: vectors
// of a fixed width, mbarriers, cp.async copies, TMA tile loads and the
// tensor-map encoder.
// Each kernel source includes this header and is built on its own
// (ops/_build.py hashes the headers with each source).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

// N elements of T, read and written as one access of sizeof(T) * N bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Returns once the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// ------------------------------------------------------------- cp.async

// One asynchronous copy of BYTES (4, 8 or 16) from global memory to the
// shared-memory address d.
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned d, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ------------------------------------------------- TMA tile loads (by rank)

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// ------------------------------------------------------ tensor-map encoder

// cuTensorMapEncodeTiled is the one libcuda call the kernels make; it is
// looked up in libcuda.so.1, which the process has already loaded, so each
// library links against the CUDA runtime alone.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<EncodeTiled>(
                   dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

constexpr int kErrNoEncoder = 20001;    // cuTensorMapEncodeTiled not found
constexpr int kErrEncodeBase = 30000;  // + the CUresult of a refused map

// A tiled tensor map of rank <= 5 over `base` (element strides of 1, zero
// fill outside the tensor). Returns 0, kErrNoEncoder, or kErrEncodeBase +
// the CUresult of a refused map.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType dtype, int rank,
                      const void* base, const cuuint64_t* dims,
                      const cuuint64_t* strides, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return kErrNoEncoder;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult rc = enc(
      map, dtype, (cuuint32_t)rank, const_cast<void*>(base), dims, strides,
      box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : kErrEncodeBase + (int)rc;
}
