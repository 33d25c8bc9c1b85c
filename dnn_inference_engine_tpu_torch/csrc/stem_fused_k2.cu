// Fused stem for Hopper (sm_90a): quantize + shifted space-to-depth(4) +
// 2x2 folded int8 conv + int32 pool-major group-max + epilogue, one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, stem_fused_k2
// (kernel body _stem_k2_kernel). Same contract:
//   x (N,H,W,3) uint8 or f32, zero-padded 1 top/left and 7 bottom/right;
//   codes: exact u8  v = u - 128 (the int8 view of u XOR 0x80; padding
//          pixels become -128 and the caller's bias fold cancels them),
//          f32       clip(rint(x / s_in));
//   folded input lane l = p*12 + q*3 + c of tap (dh, dw) at output (y, x)
//   is the code at row 4*(y+dh)+p-1, column 4*(x+dw)+q-1; lanes 48.. are
//   zero, so the product skips them (K = 4 taps x 48 = 192);
//   acc (int32) over the 256 pool-major folded outputs, max over the 4
//   groups of 64, then y = acc*scale + bias, activation, clip(rint(y)).
//   Output (N, H/4, W/4, 64) int8.
//
// What bounds it on an H100: 2*M*192*256 operations (M = N*H*W/16 output
// pixels) against 16.6 MB in and 22 MB out at batch 32 and 416 px; at the
// data-sheet rates of the SXM part at 700 W (1,979 int8 TOP/s, 3.35 TB/s)
// the operations bind, narrowly (0.0172 against 0.0116 ms). The int8
// tensor rate is reached only through wgmma, and only if the weights stay
// in shared memory and the staging of the input runs under the math. The
// design keeps the TPU kernel's point: the folded input and the pre-max
// accumulator never reach device memory.
//
// The kernel is stem_common.cuh's persistent wgmma mainloop with the
// folded conv's A addressing (K2Addr: 6 k32 steps over the 4 taps x 48
// lanes) and B by bulk copies of the 64 KB tile that
// ops/fused_conv.py stem_tile_matrix lays out once per weight tensor (two
// 128-byte K atoms: K 0..127, 128..191 and 64 bytes never read).

#include "stem_common.cuh"

namespace {

using stem::Args;

// U8: exact-u8 input (else f32); ACT: the activation code.
template <bool U8, int ACT>
__global__ void __launch_bounds__(stem::THREADS, 1)
stem_k2_kernel(const Args p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  stem::run<stem::K2Addr, false, U8, ACT>(p, smem);
}

template <bool U8, int ACT>
int start(const Args& p, int grid, cudaStream_t st) {
  return stem::launch<stem::K2Addr>(stem_k2_kernel<U8, ACT>, p, U8 ? 1 : 4,
                                    grid, st);
}

}  // namespace

// rows: output rows a unit (a band); grid: persistent blocks; w: the
// weights as stem_tile_matrix lays them out (64 KB, 16-byte aligned).
extern "C" int stem_fused_k2(const void* x, const void* w, const void* scale,
                             const void* bias, float s_in, void* out, int N,
                             int H, int W, int rows, int grid, int exact_u8,
                             int act, void* stream) {
  const Args p = stem::make_args(x, w, scale, bias, s_in, out, N, H, W, rows);
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
