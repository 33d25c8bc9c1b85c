// TMA rule probe for Hopper (sm_90a): encode a tensor map of an int8
// tensor, and if cuTensorMapEncodeTiled accepts it, copy one box into
// shared memory with one cp.async.bulk.tensor and copy it back out with
// one bulk copy.
//
// Replaces: tools/probe_dma_rules.py, probe (the JAX repo's probe of which
// slices Mosaic accepts for a VMEM->VMEM DMA on a TPU). The question here
// is the same for the copy engine the port uses, TMA (global -> shared):
// which shapes, strides, boxes and coordinates cuTensorMapEncodeTiled
// accepts, and whether the box that lands equals the slice, with zeros
// where the box leaves the source. The Python side
// (dnn_inference_engine_tpu_torch/tools/probe_dma_rules.py) holds the
// encode's verdicts against the documented rules.
//
// What bounds it: bytes (one box read, one written; a few KB, so in
// practice the launch). Design: one block of one warp, of which one
// thread does it all: it initialises the barrier, arms it with the whole
// box, issues the box's copy, waits (tma.cuh bounds the wait) and sends
// the box back out with one bulk copy of the copy engine (shared ->
// global), waiting for that to complete. No block-wide sync and no store
// loop: a copy in, a copy out.

#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int THREADS = 32;
constexpr int SMEM_LIMIT = 232448;   // a block's dynamic shared memory

struct Coords {
  int c[5];                           // innermost first
};

__global__ void __launch_bounds__(THREADS)
    tma_probe_kernel(const __grid_constant__ CUtensorMap map, const Coords at,
                     int rank, int box_bytes, int bar_offset, void* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (threadIdx.x != 0) return;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + bar_offset);
  tma::mbar_init(bar, 1);
  tma::fence_barrier_init();
  tma::mbar_expect_tx(bar, static_cast<uint32_t>(box_bytes));
  tma::load(smem, &map, bar, at.c, rank);
  tma::mbar_wait(bar, 0, "tma_probe");
  tma::bulk_store(out, smem, static_cast<uint32_t>(box_bytes));
  tma::bulk_wait_all();
}

}  // namespace

// dims, box, coords: rank entries, innermost first; strides: rank - 1 byte
// strides (dims 1..rank-1). *cu_result gets the encode's CUresult. With
// launch == 0, or a refused encode, nothing is launched. out holds the box
// (its bytes are a multiple of 16 wherever the encode accepts it).
extern "C" int tma_probe(const void* src, int rank, const long long* dims,
                         const long long* strides, const int* box,
                         const int* coords, int launch, void* out,
                         int* cu_result, void* stream) {
  if (rank < 1 || rank > 5) {
    *cu_result = CUDA_ERROR_INVALID_VALUE;
    return 0;
  }
  uint64_t d[5], s[4];
  uint32_t b[5];
  Coords at{};
  long long box_bytes = 1;
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<uint64_t>(dims[i]);
    b[i] = static_cast<uint32_t>(box[i]);
    at.c[i] = coords[i];
    box_bytes *= box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) s[i] = static_cast<uint64_t>(strides[i]);
  CUtensorMap map;
  const CUresult res = tma::encode_s8(&map, src, rank, d, s, b);
  *cu_result = static_cast<int>(res);
  if (res != CUDA_SUCCESS || !launch) return 0;
  const long long bar_offset = (box_bytes + 127) / 128 * 128;
  const long long smem = bar_offset + 8;
  if (box_bytes % 16 || smem > SMEM_LIMIT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tma_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tma_probe_kernel<<<1, THREADS, static_cast<size_t>(smem),
                     static_cast<cudaStream_t>(stream)>>>(
      map, at, rank, static_cast<int>(box_bytes),
      static_cast<int>(bar_offset), out);
  return static_cast<int>(cudaGetLastError());
}
