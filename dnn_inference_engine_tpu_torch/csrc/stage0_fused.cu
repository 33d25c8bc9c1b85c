// Fused stage 0 for Hopper (sm_90a): quantize + conv1 3x3 (3 -> 16) + 2x2/s2
// maxpool on the int32 accumulator + epilogue + requant, emitting the fold-2
// tensor, in one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/attic/pallas_stage0.py,
// stage0_fused (kernel body _stage0_kernel) and stage0_fused_v2 (kernel body
// _stage0_v2_kernel). The two compute one function and differ only in how
// they feed the TPU's matrix unit (v1 gathers sublanes into a band-rolled
// operand; v2 runs three transposed-LHS GEMMs over lane shifts, 384 K rows
// for 108 useful ones). Neither trick means anything here: each wrapper
// gathers its operand into one dense-K matrix B (256 x 128, K-major), lays
// that out once as this kernel's B tile (ops/attic/stage0.py
// stage0_tile_matrix), and this kernel computes the function:
//   codes q = clip(rint(x / s_in), +-127), zero outside the image (SAME);
//   A row of fold-2 output pixel (i, j): the 6x6x3 patch of codes at raw
//     rows 4i-1 .. 4i+4, columns 4j-1 .. 4j+4 (108 true k);
//   acc[n] = A . B[:, n], n = P*64 + c with P = u*2+v the pool position
//     and c = (a*2+b)*16 + co the fold-2 channel; am = max over P (int32);
//   y = am*scale[c] + bias[c], activation, clip(rint(y)) -> (N,H/4,W/4,64).
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the bytes. At batch 32 and 416 px the f32 input is 66.45 MB
// and the output 22.15 MB, 0.0264 ms; the product over K = 128 is 22.7 G
// operations, 0.0115 ms. So the design reads each input element once, from
// device memory, and writes each output byte once: neither the quantized
// input, nor the A matrix, nor the pre-pool accumulator reaches device
// memory, and the f32 rows come by one bulk copy a band, under the math.
//
// The kernel is stem_common.cuh's persistent wgmma mainloop with the
// stage-0 A addressing (Stage0Addr): the B tile lays each 18-byte patch
// row as a 20-byte run of K (the 2 extra lanes meet zero rows of B), so
// every 4-byte group of A is one aligned word of one staged row and A goes
// from the staged codes straight into wgmma's registers; K = 120 of 128,
// 4 x k32, one 128-byte K atom (32 KB of B). A band is 4*rows + 2 input
// rows. f32 input only.

#include "stem_common.cuh"

namespace {

using stem::Args;

// ACT: the activation code.
template <int ACT>
__global__ void __launch_bounds__(stem::THREADS, 1)
stage0_kernel(const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  stem::run<stem::Stage0Addr, false, false, ACT>(p, smem);
}

template <int ACT>
int start(const Args& p, int grid, cudaStream_t st) {
  return stem::launch<stem::Stage0Addr>(stage0_kernel<ACT>, p, 4, grid, st);
}

}  // namespace

// tile: the B tile as stage0_tile_matrix lays it out (32 KB, 16-byte
// aligned); x f32, H and W multiples of 4; rows: output rows a unit (a
// band); grid: persistent blocks.
extern "C" int stage0_fused(const void* x, const void* tile,
                            const void* scale, const void* bias, float s_in,
                            void* out, int N, int H, int W, int rows,
                            int grid, int act, void* stream) {
  const Args p =
      stem::make_args(x, tile, scale, bias, s_in, out, N, H, W, rows);
  auto st = static_cast<cudaStream_t>(stream);
  switch (act) {
    case 0: return start<0>(p, grid, st);
    case 1: return start<1>(p, grid, st);
    case 2: return start<2>(p, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
