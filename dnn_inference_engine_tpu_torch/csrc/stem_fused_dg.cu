// Fused stem for Hopper (sm_90a), from the per-tap weight slabs: quantize +
// shifted space-to-depth(4) + the four K=48 int8 tap products accumulated
// + int32 pool-major group-max + epilogue, one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, stem_fused_dg
// (kernel body _stem_dg_kernel), YOLOv3-tiny's stage 0. It computes the
// same function as stem_fused_k2 (see stem_fused_k2.cu for the contract),
// bit for bit. What is its own is the weights' form: wk (4, 256, 48) int8,
// the per-tap slabs w[dh, dw, :48, :] transposed K-major (tap = 2*dh +
// dw), which the host lays out once (ops/fused_conv.stem_dg_weight_slabs).
// Any cin_pad rows of the folded weights are dropped there.
//
// What bounds it on an H100: 2*M*192*256 operations (M = N*H*W/16 output
// pixels) against the input's bytes and M*64 bytes out; at batch 16 and
// 416 px, 17.0 G operations (0.0086 ms at the data-sheet 1,979 int8
// TOP/s of the SXM part at 700 W) bind over 19.4 MB (0.0058 ms at 3.35
// TB/s).
//
// The TPU formulation's point was four K=48 products with no K padding
// and no in-kernel transposes. The per-tap split has no Hopper form:
// wgmma takes s8 operands only in k32 steps, and a tap is 48 lanes, so a
// tap product would be one k32 and a k16 (mma.sync, not wgmma). Over the
// tap-major K = tap*48 + lane the four products are the k2 stem's 6 x k32,
// so this kernel is stem_common.cuh's persistent wgmma mainloop with the
// k2 stem's A addressing (K2Addr). The block lays the slabs into the
// mainloop's swizzled B tile in shared memory once (once an SM), each
// 16-byte chunk of a slab row one chunk of the tile (stem::lay_slabs),
// while the first band's raw rows are in flight.

#include "stem_common.cuh"

namespace {

using stem::Args;

// U8: exact-u8 input (else f32); ACT: the activation code.
template <bool U8, int ACT>
__global__ void __launch_bounds__(stem::THREADS, 1)
stem_dg_kernel(const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  stem::run<stem::K2Addr, true, U8, ACT>(p, smem);
}

template <bool U8, int ACT>
int start(const Args& p, int grid, cudaStream_t st) {
  return stem::launch<stem::K2Addr>(stem_dg_kernel<U8, ACT>, p, U8 ? 1 : 4,
                                    grid, st);
}

}  // namespace

// wk: the (4, 256, 48) slabs, 16-byte aligned. rows: output rows a unit
// (a band); grid: persistent blocks; the caller picks both.
extern "C" int stem_fused_dg(const void* x, const void* wk, const void* scale,
                             const void* bias, float s_in, void* out, int N,
                             int H, int W, int rows, int grid, int exact_u8,
                             int act, void* stream) {
  const Args p = stem::make_args(x, wk, scale, bias, s_in, out, N, H, W, rows);
  if (act < 0 || act > 2) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  switch ((exact_u8 != 0) * 3 + act) {
    case 0: return start<false, 0>(p, grid, st);
    case 1: return start<false, 1>(p, grid, st);
    case 2: return start<false, 2>(p, grid, st);
    case 3: return start<true, 0>(p, grid, st);
    case 4: return start<true, 1>(p, grid, st);
    default: return start<true, 2>(p, grid, st);
  }
}
