// Fused pool-major group-max + shifted space-to-depth(2) for Hopper
// (sm_90a): the seam between a fold-2 conv stage and the shifted k=2 conv
// that consumes it, in one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, gmax_shift_s2d2
// (kernel body _gs2_kernel). Same contract, for y (N, H, W, 4*go) int8:
//   out[n, i, j, (2p+q)*go + c] = max over k of y[n, 2i+p-1, 2j+q-1, k*go+c]
// zero where that pixel lies outside y; the output has W/2+1 columns and
// H/2+1 valid rows, then zero rows up to a multiple of 8.
//
// What bounds it on an H100 (3.35 TB/s, SXM data sheet at 700 W): bytes.
// It reads y once and writes a quarter of that, with no arithmetic beyond
// byte maxes. Each thread makes one 16-byte chunk of the output (go % 16
// == 0: a chunk never straddles a (p, q) block): four 16-byte loads of the
// four pool groups' slices of one input pixel, __vmaxs4 (signed byte max,
// four lanes a word) and one 16-byte store; the halo and the junk rows
// are zeros from the index bounds, with no padded copy. Other widths take
// a byte path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint4 vmax4(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gmax_shift_s2d2_kernel(const int8_t* __restrict__ y, int8_t* __restrict__ out,
                       int N, int H, int W, int go, int hout_p, int wout) {
  constexpr int E = VEC ? 16 : 1;            // bytes per thread
  const int c4 = 4 * go;
  const long long total =
      static_cast<long long>(N) * hout_p * wout * c4 / E;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * THREADS) {
    const long long o = i * E;               // output byte offset
    const int ch = static_cast<int>(o % c4);
    long long pix = o / c4;
    const int xx = static_cast<int>(pix % wout);
    pix /= wout;
    const int yy = static_cast<int>(pix % hout_p);
    const int n = static_cast<int>(pix / hout_p);
    const int pq = ch / go, c = ch % go;
    const int row = 2 * yy + (pq >> 1) - 1;
    const int col = 2 * xx + (pq & 1) - 1;
    const bool in = row >= 0 && row < H && col >= 0 && col < W;
    const size_t src =
        in ? ((static_cast<size_t>(n) * H + row) * W + col) * c4 + c : 0;
    if (VEC) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (in) {
        const uint4* p = reinterpret_cast<const uint4*>(y + src);
        const int step = go / 16;
        v = vmax4(vmax4(p[0], p[step]), vmax4(p[2 * step], p[3 * step]));
      }
      *reinterpret_cast<uint4*>(out + o) = v;
    } else {
      int8_t v = 0;
      if (in) {
        const int8_t* p = y + src;
        v = static_cast<int8_t>(max(max(int(p[0]), int(p[go])),
                                    max(int(p[2 * go]), int(p[3 * go]))));
      }
      out[o] = v;
    }
  }
}

}  // namespace

// vec: go % 16 == 0 and y 16-byte aligned.
extern "C" int gmax_shift_s2d2(const void* y, void* out, int N, int H, int W,
                               int go, int vec, void* stream) {
  const int hout = H / 2 + 1;
  const int hout_p = (hout + 7) / 8 * 8;
  const int wout = W / 2 + 1;
  const long long total = static_cast<long long>(N) * hout_p * wout * 4 * go /
                          (vec ? 16 : 1);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* yi = static_cast<const int8_t*>(y);
  auto* o = static_cast<int8_t*>(out);
  if (blocks > 0) {
    if (vec) {
      gmax_shift_s2d2_kernel<true><<<unsigned(blocks), THREADS, 0, st>>>(
          yi, o, N, H, W, go, hout_p, wout);
    } else {
      gmax_shift_s2d2_kernel<false><<<unsigned(blocks), THREADS, 0, st>>>(
          yi, o, N, H, W, go, hout_p, wout);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
