// TMA plumbing shared by the TMA-fed kernels (tma_probe.cu, conv_dma.cu,
// gemm_f32.cu, and through wgmma_s8.cuh gemm_fused.cu and conv3x3_rs.cu,
// and through stem_common.cuh the three stems, stem_fused_k2.cu,
// stem_fused_dg.cu and stage0_fused.cu): the host encoding of a tiled
// int8 tensor map, the
// mbarrier helpers, the cp.async.bulk.tensor issue for ranks 1 to 5, the
// plain bulk copies both ways, and (conv_w8a8.cu) the encoding of an
// im2col tensor map.
//
// The encode function comes through cudaGetDriverEntryPoint, so no
// library links libcuda (-lcuda) and the build flags stay those of every
// other kernel.
//
// Device-side rules are held here, not probed: a copy that breaks one
// faults and poisons the context. So every tensor-copy destination is
// checked to be 128-byte aligned, and a barrier wait is bounded: one that
// outlasts its budget (a wrong transaction count, a copy that never lands)
// prints and traps, and the launch fails at the next sync instead of
// hanging. The transaction count a caller arms is the whole box, the
// zero-filled out-of-bounds bytes included. One rule the encode does not
// check is the caller's: a box may leave the innermost dimension only if
// that dimension's bytes are a multiple of 16 (on an H100 the copy faults
// otherwise, an illegal instruction). conv_dma.cu keeps Cin % 16 == 0;
// the probe refuses the rest.

#pragma once

#include <cstdint>
#include <cstdio>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

namespace tma {

// Encodes a tiled tensor map of an int8 tensor of rank 1-5. dims, box
// (both rank long) and strides (bytes, rank - 1 long: dims 1..rank-1) are
// innermost first; the innermost elements are dense. Out-of-bounds
// elements of a box read as zeros (FLOAT_OOB_FILL_NONE). `swizzle` is the
// shared-memory layout of the box (CU_TENSOR_MAP_SWIZZLE_128B for a wgmma
// operand: the box's inner extent is then at most 128 bytes, and its
// destination 1024-byte aligned). `elem` (rank long, or null for all
// ones) are the traversal strides: a box of box[i] elements along
// dimension i lands every elem[i]-th of them, box[i] / elem[i] elements,
// densely (the innermost stride must be 1). Returns the encode's CUresult.
inline CUresult encode_s8(
    CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
    const uint64_t* strides, const uint32_t* box,
    CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE,
    const uint32_t* elem = nullptr) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr) {
      return CUDA_ERROR_NOT_FOUND;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  if (rank < 1 || rank > 5) return CUDA_ERROR_INVALID_VALUE;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = elem != nullptr ? elem[i] : 1;
  }
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, s,
                b, e, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes an im2col tensor map of an int8 tensor of rank 3-5 (channels
// innermost, then the spatial dimensions, then the batch), dims and
// strides as encode_s8's. A copy through it walks `pixels` pixels of the
// bounding box whose spatial dimension i spans [lower[i], dims[i+1] - 1 +
// upper[i]], from the copy's start pixel on (innermost spatial dimension
// first, then the next, then the batch), each pixel sampled at the copy's
// offsets from it, `channels` of its channels from the copy's first; a
// sample outside the tensor reads as zeros. Returns the encode's
// CUresult.
inline CUresult encode_im2col_s8(
    CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
    const uint64_t* strides, const int* lower, const int* upper,
    uint32_t channels, uint32_t pixels, CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
      const cuuint64_t*, const cuuint64_t*, const int*, const int*,
      cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
      CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 13000
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeIm2col", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeIm2col", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr) {
      return CUDA_ERROR_NOT_FOUND;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  if (rank < 3 || rank > 5) return CUDA_ERROR_INVALID_VALUE;
  cuuint64_t d[5], s[4];
  cuuint32_t e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    e[i] = 1;
  }
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8,
                static_cast<cuuint32_t>(rank), const_cast<void*>(base), d, s,
                lower, upper, channels, pixels, e,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Clock cycles a barrier wait may spin before it traps (~1 s).
constexpr long long kWaitBudget = 1ll << 31;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread: a barrier that completes a phase after `count` arrivals and
// the transaction bytes armed for it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// After mbar_init, before the __syncthreads that publishes the barriers:
// makes them visible to the copy engine (the async proxy).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Orders this thread's shared-memory accesses before later copies of the
// copy engine into the same buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Arrives once and arms `bytes` of transactions for the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Waits until the phase of parity `parity` has completed (the parity of a
// barrier's k-th phase is k & 1); traps after kWaitBudget cycles.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity,
                                          const char* who) {
  const uint32_t a = smem_addr(bar);
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > kWaitBudget) {
      printf("%s: mbarrier wait timed out (block %d, thread %d, parity %u)\n",
             who, blockIdx.x, threadIdx.x, parity);
      __trap();
    }
  }
}

// One thread: copies the box of `map` at the signed coordinates c[0..rank)
// (innermost first) into shared memory at `dst`, completing its bytes on
// `bar`. The box lands dense, innermost dimension first.
__device__ __forceinline__ void load(void* dst, const CUtensorMap* map,
                                     uint64_t* bar, const int* c, int rank) {
  const uint32_t d = smem_addr(dst), b = smem_addr(bar);
  if (d & 127) {
    printf("tma::load: shared destination 0x%x is not 128-byte aligned\n", d);
    __trap();
  }
  const uint64_t m = reinterpret_cast<uint64_t>(map);
  switch (rank) {
    case 1:
      asm volatile(
          "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3}], [%2];\n"
          :: "r"(d), "l"(m), "r"(b), "r"(c[0]) : "memory");
      break;
    case 2:
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
          :: "r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]) : "memory");
      break;
    case 3:
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
          :: "r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2])
          : "memory");
      break;
    case 4:
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
          :: "r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]),
             "r"(c[3])
          : "memory");
      break;
    default:
      asm volatile(
          "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
          :: "r"(d), "l"(m), "r"(b), "r"(c[0]), "r"(c[1]), "r"(c[2]),
             "r"(c[3]), "r"(c[4])
          : "memory");
      break;
  }
}

// One thread: a bulk copy (no tensor map) of `bytes` (a multiple of 16)
// from global memory at `src` to shared memory at `dst` (both 16-byte
// aligned), completing its bytes on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One thread: a bulk copy (no tensor map) of `bytes` (a multiple of 16)
// from shared memory at `src` to global memory at `dst` (both 16-byte
// aligned), in the thread's current bulk group; bulk_wait_all waits for
// every group it committed to complete.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      :: "l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_addr(src)),
         "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace tma
