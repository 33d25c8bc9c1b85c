// The NMS fixpoint for Hopper (sm_90a): exact greedy NMS keep masks as a
// Jacobi fixpoint over a bit-packed dominance relation, the whole loop in
// one launch, so the host reads nothing inside the NMS.
//
// Replaces: dnn_inference_engine_tpu/postprocess.py, _greedy_fixpoint's
// jax.lax.while_loop. It is not a Pallas kernel: XLA runs that loop on the
// device inside the jitted detect, and PyTorch has no loop that runs on the
// device. Same contract, for each (image, class):
//   keep0 = valid; keep = step(keep0); it = 1
//   while any(prev != keep) and it < K: prev, keep = keep, step(keep); ++it
// with step(keep)[i] = valid[i] and not any_w(dom[i][w] & pack(keep)[w]).
//
// Operands (the port's layouts, postprocess.py): dom (B, C, K, W) int64,
// bit j of word w set when candidate 64w + j dominates candidate i (zero
// past K); valid (B, C, K) bool. Out: keep (B, C, K) bool and, where the
// pointer is not null, sweeps (B*C) int32, the `it` each (image, class)
// stopped at.
//
// What bounds it on an H100: the chain of sweeps, each waiting for the last.
// The bytes are few (dom is 5.2 MB at b32, K = 256): a sweep reads the rows
// of the valid candidates, from L2 after the first. So the design spends
// nothing between sweeps: one block a (image, class), its keep bitsets
// in shared memory (two for the sweep, one for valid), each thread a row
// at a time (rows i = tid, tid + 256, ...), a row read only while its
// candidate is valid and only up to its first hit, a word of keep bits
// taken only where it is not zero; the new words are warp ballots of 32
// rows, the convergence test a __syncthreads_or. Each block stops at its
// own fixpoint: a sweep after it changes nothing, so the masks are those of
// the batched loop. The K cap never binds before the fixpoint (a
// suppression chain is at most K - 1 deep).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nms_fixpoint_kernel(const unsigned long long* __restrict__ dom,
                    const uint8_t* __restrict__ valid,
                    uint8_t* __restrict__ keep, int* __restrict__ sweeps,
                    int K, int W) {
  // three bitsets of W words: the sweep's input and output, and valid
  extern __shared__ unsigned long long bits[];
  unsigned long long* cur = bits;
  unsigned long long* nxt = bits + W;
  unsigned* vb = reinterpret_cast<unsigned*>(bits + 2 * W);
  const size_t bc = blockIdx.x;
  const unsigned long long* dom_bc = dom + bc * K * W;
  const uint8_t* valid_bc = valid + bc * K;
  const int lane = threadIdx.x & 31;
  // whole warps take every ballot: rows past K are invalid, their bits 0
  const int rows = (K + 31) / 32 * 32;

  // zero all three (a last 32-bit half past the rows is never written)
  for (int w = threadIdx.x; w < 3 * W; w += THREADS) bits[w] = 0ull;
  __syncthreads();
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const unsigned word = __ballot_sync(0xffffffffu, i < K && valid_bc[i]);
    if (lane == 0) {
      vb[i >> 5] = word;
      reinterpret_cast<unsigned*>(cur)[i >> 5] = word;   // keep0 = valid
    }
  }
  __syncthreads();

  int it = 0;
  for (;;) {
    const unsigned* cur32 = reinterpret_cast<const unsigned*>(cur);
    unsigned* nxt32 = reinterpret_cast<unsigned*>(nxt);
    int changed = 0;
    for (int i = threadIdx.x; i < rows; i += THREADS) {
      bool kept = false;
      if ((vb[i >> 5] >> (i & 31)) & 1u) {
        const unsigned long long* row = dom_bc + static_cast<size_t>(i) * W;
        kept = true;
        for (int w = 0; w < W; ++w) {
          const unsigned long long kw = cur[w];
          if (kw != 0ull && (__ldg(row + w) & kw) != 0ull) {
            kept = false;
            break;
          }
        }
      }
      const unsigned word = __ballot_sync(0xffffffffu, kept);
      if (lane == 0) {
        nxt32[i >> 5] = word;
        changed |= word != cur32[i >> 5];
      }
    }
    ++it;
    // also the barrier between this sweep's writes and the next one's reads
    if (!__syncthreads_or(changed) || it >= K) break;
    unsigned long long* t = cur;
    cur = nxt;
    nxt = t;
  }

  const unsigned* out32 = reinterpret_cast<const unsigned*>(nxt);
  for (int i = threadIdx.x; i < K; i += THREADS)
    keep[bc * K + i] = static_cast<uint8_t>((out32[i >> 5] >> (i & 31)) & 1u);
  if (sweeps != nullptr && threadIdx.x == 0) sweeps[bc] = it;
}

}  // namespace

// BC = B * C blocks; 3 * W * 8 bytes of shared memory (the wrapper keeps it
// under the 48 KB a launch takes without opting in).
extern "C" int nms_fixpoint(const void* dom, const void* valid, void* keep,
                            void* sweeps, int BC, int K, int W,
                            void* stream) {
  if (BC > 0 && K > 0) {
    const size_t smem = 3 * static_cast<size_t>(W) * sizeof(unsigned long long);
    nms_fixpoint_kernel<<<BC, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(dom),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
        static_cast<int*>(sweeps), K, W);
  }
  return static_cast<int>(cudaGetLastError());
}
