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
// gathers its operand into one dense-K matrix B (K-major, 256 x 128) and
// this kernel computes the function:
//   codes q = clip(rint(x / s_in), +-127), zero outside the image (SAME);
//   A row of fold-2 output pixel (i, j): k = r6*18 + c6*3 + ch is the code
//     at raw row 4i-1+r6, column 4j-1+c6, channel ch (108 true k; the
//     product runs over K = 128, rows 108.. of B are zero);
//   acc[n] = A . B[:, n], n = P*64 + c with P = u*2+v the pool position
//     and c = (a*2+b)*16 + co the fold-2 channel; am = max over P (int32);
//   y = am*scale[c] + bias[c], activation, clip(rint(y)) -> (N,H/4,W/4,64).
//
// What bounds it on an H100 (SXM data sheet at 700 W: 1,979 int8 TOP/s,
// 3.35 TB/s): the bytes. At batch 32 and 416 px the f32 input is 66.45 MB
// and the output 22.15 MB, 0.0264 ms; the dense-K product is 22.7 G
// operations, 0.0115 ms. So the design reads each input element once, from
// device memory, and writes each output byte once: neither the quantized
// input, nor the A matrix, nor the pre-pool accumulator reaches device
// memory.
//
// One block per (image, band of `rows` output rows), 8 warps. The block
// stages its band's raw rows (with the halo) as int8 codes in shared memory,
// quantizing each element once (stem_common.cuh's stage_rows: 16-byte
// loads, __fdiv_rn), and copies B (32 KB) into shared memory with cp.async.
// Per tile of 64 output pixels it gathers the pixels' 108-byte A rows from
// the staged codes (six 18-byte runs each; a run is 2-byte aligned, not 16,
// so the gather is a separate pass in halfwords) into a K-major A tile, then
// runs mma.sync m16n8k32 over K = 128 (4 steps). A warp owns 16 pixels x 32
// channels in all 4 pool positions, so the 2x2 max is a max over a thread's
// own registers (stem_common.cuh's store_tile, explicit __fmul_rn,
// __fadd_rn and rintf). The host picks `rows` (4, 2 or 1) so that small
// batches still fill the SMs.

#include "mma_s8.cuh"
#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int KP = 128;         // dense-K rows
constexpr int KT = 108;         // true rows: the 6 x 6 x 3 patch
constexpr int LDK = KP + 16;    // shared row stride of B and A, in bytes
constexpr int RUN = 18;         // bytes of one patch row (6 columns x 3)

size_t smem_bytes(int W, int rows) {
  return size_t(NF) * LDK + size_t(BM) * LDK + staged_bytes(W, rows);
}

__global__ void __launch_bounds__(THREADS)
stage0_kernel(const float* __restrict__ x, const int8_t* __restrict__ bt,
              const float* __restrict__ scale, const float* __restrict__ bias,
              float s_in, int8_t* __restrict__ out, int H, int W, int rows,
              int act) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bs = smem;                  // [NF][LDK], K-major
  int8_t* As = Bs + NF * LDK;         // [BM][LDK], the tile's A rows
  int8_t* Xs = As + BM * LDK;         // [4*rows+4][rb], staged codes

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hout = H / 4, wout = W / 4;
  const int bands = (hout + rows - 1) / rows;
  const int n = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * rows;
  const int rb = staged_row_bytes(W);

  for (int i = tid; i < NF * (KP / 16); i += THREADS) {
    const int row = i / (KP / 16), c = i % (KP / 16);
    s8mma::cp_async16(Bs + row * LDK + c * 16, bt + row * KP + c * 16, true);
  }
  s8mma::cp_async_commit();
  for (int i = tid; i < BM * (KP - KT); i += THREADS) {
    As[(i / (KP - KT)) * LDK + KT + i % (KP - KT)] = 0;   // never gathered
  }
  stage_rows(x, Xs, n, y0, rows, H, W, s_in, 0);
  s8mma::cp_async_wait<0>();
  __syncthreads();

  const int wm = warp / 2;      // 4 warps along pixels, 16 each
  const int wn = warp % 2;      // 2 warps along channels, 32 each
  const int g = lane / 4, t = lane % 4;
  const int band_px = rows * wout;
  const int8_t* arow = As + (wm * 16 + g) * LDK + t * 4;

  for (int m0 = 0; m0 < band_px; m0 += BM) {
    // A rows of the tile's pixels: pixel p's run r6 is staged row 4*ii+r6
    // (raw row 4*(y0+ii)-1+r6), bytes 12*j .. 12*j+17 (columns 4j-1 ..
    // 4j+4); 9 halfwords each
    for (int i = tid; i < BM * 6 * (RUN / 2); i += THREADS) {
      const int p = i / (6 * (RUN / 2)), rest = i % (6 * (RUN / 2));
      const int r6 = rest / (RUN / 2), h = rest % (RUN / 2);
      const int m = m0 + p;
      unsigned short v = 0;
      if (m < band_px && y0 + m / wout < hout) {
        const int ii = m / wout, j = m % wout;
        v = *reinterpret_cast<const unsigned short*>(
            Xs + (4 * ii + r6) * rb + 12 * j + 2 * h);
      }
      *reinterpret_cast<unsigned short*>(As + p * LDK + r6 * RUN + 2 * h) = v;
    }
    __syncthreads();

    const Pixels px = tile_pixels(Xs, m0, wm, g, rows, y0, hout, wout, rb);
    int acc[4][4][4];           // [pool position][n8 tile][fragment]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
    for (int kc = 0; kc < KP / 32; ++kc) {
      const unsigned a0 = ld32(arow + kc * 32);
      const unsigned a1 = ld32(arow + 8 * LDK + kc * 32);
      const unsigned a2 = ld32(arow + kc * 32 + 16);
      const unsigned a3 = ld32(arow + 8 * LDK + kc * 32 + 16);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* pw =
              Bs + (gi * GO + wn * 32 + ni * 8 + g) * LDK + kc * 32 + t * 4;
          mma_k32(acc[gi][ni], a0, a1, a2, a3, ld32(pw), ld32(pw + 16));
        }
      }
    }
    store_tile(acc, px, wn, t, scale, bias, act, out, n, y0, hout, wout);
    __syncthreads();            // the next gather overwrites As
  }
}

}  // namespace

// bt: the dense-K matrix, K-major (256, 128), 16-byte aligned; x 16-byte
// aligned, H and W multiples of 4; rows: output rows per block.
extern "C" int stage0_fused(const void* x, const void* bt, const void* scale,
                            const void* bias, float s_in, void* out, int N,
                            int H, int W, int rows, int act, void* stream) {
  const size_t smem = smem_bytes(W, rows);
  const cudaError_t e = allow_smem(stage0_kernel, smem, rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = N * ((H / 4 + rows - 1) / rows);
  if (blocks > 0 && W >= 4) {
    stage0_kernel<<<blocks, THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(bt),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        s_in, static_cast<int8_t*>(out), H, W, rows, act);
  }
  return static_cast<int>(cudaGetLastError());
}
