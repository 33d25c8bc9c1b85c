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
// the operations bind, narrowly. The design keeps the TPU kernel's point:
// the folded input and the pre-max accumulator never reach device memory.
//
// One block per (image, band of `rows` output rows). It stages the band's
// 4*rows+4 input rows (with the halo) in shared memory, quantizing each
// input element once (stem_common.cuh), and transposes the 48 KB of
// folded weights K-major into shared memory once. The shifted s2d(4) is
// then only an addressing rule: the 4 lanes (p, q..q+3 of a 12-lane p row)
// that an mma fragment register holds are 4 contiguous, 4-aligned bytes
// of one staged row, so the A fragments are 32-bit shared loads straight
// from the staged rows. mma.sync m16n8k32 from 8 warps: a warp owns 16
// pixels x 32 output channels in all 4 pool groups, so the group-max is a
// register max. The host picks `rows` (4, 2 or 1) so that small batches
// still fill the SMs. Roundings are explicit (__fdiv_rn, __fmul_rn,
// __fadd_rn, rintf) so the codes match XLA's.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int KC = 192;         // 4 taps x 48 real lanes
constexpr int LDS = KC + 16;    // weight row stride in bytes

size_t smem_bytes(int W, int rows) {
  return size_t(NF) * LDS + staged_bytes(W, rows);
}

__global__ void __launch_bounds__(THREADS)
stem_kernel(const void* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            float s_in, int8_t* __restrict__ out, int H, int W, int cin,
            int rows, int exact_u8, int act) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bs = smem;                 // [NF][LDS], K-major weights
  int8_t* Xs = smem + NF * LDS;      // [4*rows+4][rb], staged input codes

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hout = H / 4, wout = W / 4;
  const int bands = (hout + rows - 1) / rows;
  const int n = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * rows;
  const int rb = staged_row_bytes(W);

  // Folded weights (2,2,cin,256) -> Bs[o][tap*48 + l], lanes l < 48: a
  // lane loads a 4 (k) x 4 (o) byte block with 32-bit loads (each row of
  // 8 lanes reads 32 contiguous bytes) and transposes it in registers.
  constexpr int W_ITEMS = (KC / 16) * (NF / 32) / (THREADS / 32);
#pragma unroll 4
  for (int it = 0; it < W_ITEMS; ++it) {
    const int item = it * (THREADS / 32) + warp;
    const int kq = (item % (KC / 16)) * 4 + lane / 8;   // k = 4*kq .. +3
    const int o4 = ((item / (KC / 16)) * 8 + lane % 8) * 4;
    const int tap = (4 * kq) / 48, l = (4 * kq) % 48;
    const int8_t* src = w + (size_t(tap) * cin + l) * NF + o4;
    const unsigned r0 = ld32g(src), r1 = ld32g(src + NF);
    const unsigned r2 = ld32g(src + 2 * NF), r3 = ld32g(src + 3 * NF);
    const unsigned lo01 = __byte_perm(r0, r1, 0x5140);
    const unsigned hi01 = __byte_perm(r0, r1, 0x7362);
    const unsigned lo23 = __byte_perm(r2, r3, 0x5140);
    const unsigned hi23 = __byte_perm(r2, r3, 0x7362);
    unsigned* dst = reinterpret_cast<unsigned*>(Bs + o4 * LDS + 4 * kq);
    dst[0] = __byte_perm(lo01, lo23, 0x5410);
    dst[LDS / 4] = __byte_perm(lo01, lo23, 0x7632);
    dst[2 * LDS / 4] = __byte_perm(hi01, hi23, 0x5410);
    dst[3 * LDS / 4] = __byte_perm(hi01, hi23, 0x7632);
  }

  stage_rows(x, Xs, n, y0, rows, H, W, s_in, exact_u8);
  __syncthreads();

  const int wm = warp / 2;      // 4 warps along pixels, 16 each
  const int wn = warp % 2;      // 2 warps along outputs, 32 each
  const int g = lane / 4, t = lane % 4;

  // a0/a1 of k-step kc read group kc*8 + t, a2/a3 group kc*8 + 4 + t
  int koff[KC / 16];
#pragma unroll
  for (int i = 0; i < KC / 16; ++i) {
    koff[i] = group_offset((i / 2) * 8 + (i % 2) * 4 + t, rb);
  }

  for (int m0 = 0; m0 < rows * wout; m0 += BM) {
    const Pixels px = tile_pixels(Xs, m0, wm, g, rows, y0, hout, wout, rb);

    int acc[4][4][4];           // [pool group][n8 tile][fragment]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

#pragma unroll
    for (int kc = 0; kc < KC / 32; ++kc) {
      const unsigned a0 = ld32(px.pa + koff[2 * kc]);
      const unsigned a1 = ld32(px.pb + koff[2 * kc]);
      const unsigned a2 = ld32(px.pa + koff[2 * kc + 1]);
      const unsigned a3 = ld32(px.pb + koff[2 * kc + 1]);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* pw =
              Bs + (gi * GO + wn * 32 + ni * 8 + g) * LDS + kc * 32 + t * 4;
          mma_k32(acc[gi][ni], a0, a1, a2, a3, ld32(pw), ld32(pw + 16));
        }
      }
    }
    store_tile(acc, px, wn, t, scale, bias, act, out, n, y0, hout, wout);
  }
}

}  // namespace

// rows: output rows per block (a band); the caller picks it.
extern "C" int stem_fused_k2(const void* x, const void* w, const void* scale,
                             const void* bias, float s_in, void* out, int N,
                             int H, int W, int cin, int rows, int exact_u8,
                             int act, void* stream) {
  const size_t smem = smem_bytes(W, rows);
  const cudaError_t e = allow_smem(stem_kernel, smem, rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hout = H / 4;
  const int blocks = N * ((hout + rows - 1) / rows);
  if (blocks > 0 && W >= 4) {
    stem_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int8_t*>(w), static_cast<const float*>(scale),
        static_cast<const float*>(bias), s_in, static_cast<int8_t*>(out), H,
        W, cin, rows, exact_u8, act);
  }
  return static_cast<int>(cudaGetLastError());
}
