// Fused stem for Hopper (sm_90a), per-tap formulation: quantize + shifted
// space-to-depth(4) + four K=48 int8 products accumulated + int32
// pool-major group-max + epilogue, one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, stem_fused_dg
// (kernel body _stem_dg_kernel), YOLOv3-tiny's stage 0. It computes the
// same function as stem_fused_k2 (see stem_fused_k2.cu for the contract),
// bit for bit; only the weights differ in form: wk (4, 256, 48) int8, the
// per-tap slabs w[dh, dw, :48, :] transposed K-major (tap = 2*dh + dw),
// which the host lays out once (ops/fused_conv.stem_dg_weight_slabs). Any
// cin_pad rows of the folded weights are dropped there.
//
// What bounds it on an H100: 2*M*192*256 operations (M = N*H*W/16 output
// pixels) against the input's bytes and M*64 bytes out; at batch 16 and
// 416 px, 17.0 G operations (0.0086 ms at the data-sheet 1,979 int8
// TOP/s of the SXM part at 700 W) bind over 19.4 MB (0.0058 ms at 3.35
// TB/s).
//
// The TPU formulation's point was to drop the in-kernel transposes and
// the K padding, which pays where the grid is small (batch 16 and 1). Here
// the stem_fused_k2 kernel's per-block fixed cost is the byte transpose of
// the 48 KB of folded weights into shared memory; this kernel has none:
// the slabs are already in the shared-memory layout (48-byte rows, which
// the B-fragment reads hit in 32 distinct banks), and the block copies
// them with 16-byte cp.async while it stages and quantizes its band's
// input rows (stem_common.cuh), so the copy overlaps the staging. Per tap,
// a warp runs one mma.sync m16n8k32 (lanes 0..31) and one m16n8k16 (lanes
// 32..47) for each of its 16 output tiles, accumulating the 4 taps in the
// same fragments: K is the 48 real lanes, with no padding. The group-max
// and epilogue are stem_fused_k2's, with explicit roundings.

#include "stem_common.cuh"

namespace {

using namespace stem;

constexpr int TAPL = 48;              // real lanes per tap
constexpr int SLAB = NF * TAPL;       // bytes of one tap's slab

size_t smem_bytes(int W, int rows) {
  return size_t(4) * SLAB + staged_bytes(W, rows);
}

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

__global__ void __launch_bounds__(THREADS)
stem_dg_kernel(const void* __restrict__ x, const int8_t* __restrict__ wk,
               const float* __restrict__ scale,
               const float* __restrict__ bias, float s_in,
               int8_t* __restrict__ out, int H, int W, int rows,
               int exact_u8, int act) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Bs = smem;                 // [4 taps][NF][48], the slabs as given
  int8_t* Xs = smem + 4 * SLAB;      // [4*rows+4][rb], staged input codes

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int hout = H / 4, wout = W / 4;
  const int bands = (hout + rows - 1) / rows;
  const int n = blockIdx.x / bands;
  const int y0 = (blockIdx.x % bands) * rows;
  const int rb = staged_row_bytes(W);

  for (int c = tid; c < 4 * SLAB / 16; c += THREADS) {
    cp_async16(Bs + 16 * c, wk + 16 * c);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  stage_rows(x, Xs, n, y0, rows, H, W, s_in, exact_u8);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int wm = warp / 2;      // 4 warps along pixels, 16 each
  const int wn = warp % 2;      // 2 warps along outputs, 32 each
  const int g = lane / 4, t = lane % 4;

  // tap T's k32 reads 4-lane groups t and 4+t of the tap, its k16 group
  // 8+t (global group T*12 + local group)
  int koff[4][3];
#pragma unroll
  for (int tap = 0; tap < 4; ++tap)
#pragma unroll
    for (int i = 0; i < 3; ++i)
      koff[tap][i] = group_offset(tap * 12 + 4 * i + t, rb);

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
    for (int tap = 0; tap < 4; ++tap) {
      const unsigned a0 = ld32(px.pa + koff[tap][0]);
      const unsigned a1 = ld32(px.pb + koff[tap][0]);
      const unsigned a2 = ld32(px.pa + koff[tap][1]);
      const unsigned a3 = ld32(px.pb + koff[tap][1]);
      const unsigned a4 = ld32(px.pa + koff[tap][2]);
      const unsigned a5 = ld32(px.pb + koff[tap][2]);
#pragma unroll
      for (int gi = 0; gi < 4; ++gi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int8_t* pw = Bs + tap * SLAB +
                             (gi * GO + wn * 32 + ni * 8 + g) * TAPL + t * 4;
          mma_k32(acc[gi][ni], a0, a1, a2, a3, ld32(pw), ld32(pw + 16));
          mma_k16(acc[gi][ni], a4, a5, ld32(pw + 32));
        }
      }
    }
    store_tile(acc, px, wn, t, scale, bias, act, out, n, y0, hout, wout);
  }
}

}  // namespace

// wk: the (4, 256, 48) slabs, 16-byte aligned. rows: output rows per
// block (a band); the caller picks it.
extern "C" int stem_fused_dg(const void* x, const void* wk, const void* scale,
                             const void* bias, float s_in, void* out, int N,
                             int H, int W, int rows, int exact_u8, int act,
                             void* stream) {
  const size_t smem = smem_bytes(W, rows);
  const cudaError_t e = allow_smem(stem_dg_kernel, smem, rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int hout = H / 4;
  const int blocks = N * ((hout + rows - 1) / rows);
  if (blocks > 0 && W >= 4) {
    stem_dg_kernel<<<blocks, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        x, static_cast<const int8_t*>(wk), static_cast<const float*>(scale),
        static_cast<const float*>(bias), s_in, static_cast<int8_t*>(out), H,
        W, rows, exact_u8, act);
  }
  return static_cast<int>(cudaGetLastError());
}
