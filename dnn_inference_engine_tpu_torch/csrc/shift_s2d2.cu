// Shifted space-to-depth(2) for Hopper (sm_90a): pad + relayout of an
// int8 NHWC tensor in one pass.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py, shift_s2d2_pallas
// (kernel body _shift_s2d2_kernel). Same contract:
//   out[n, y, x, (p*2+q)*C + c] = xpad[n, 2y+p, 2x+q, c]
// where xpad has one zero row/col top/left and one bottom/right; the
// output has W/2+1 columns, H/2+1 valid rows, then zero rows up to a
// multiple of 8.
//
// What bounds it on an H100: bytes. It reads the input once and writes the
// output once (23 MB together at (32,104,104,32)), with no arithmetic. So
// each thread moves one 16-byte chunk (C % 16 == 0: a chunk never straddles
// a (p, q) block), neighbouring threads on neighbouring addresses, and
// writes zeros for padding without reading. Other widths take a byte path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
shift_s2d2_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                  int N, int H, int W, int C, int hout, int hout_p,
                  int wout) {
  constexpr int E = VEC ? 16 : 1;            // bytes per thread
  const int c4 = 4 * C;
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
    const int pq = ch / C, c = ch % C;
    const int row = 2 * yy + (pq >> 1) - 1;
    const int col = 2 * xx + (pq & 1) - 1;
    const bool in = yy < hout && row >= 0 && row < H && col >= 0 && col < W;
    const size_t src = ((static_cast<size_t>(n) * H + row) * W + col) * C + c;
    if (VEC) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (in) v = *reinterpret_cast<const uint4*>(x + src);
      *reinterpret_cast<uint4*>(out + o) = v;
    } else {
      out[o] = in ? x[src] : int8_t(0);
    }
  }
}

}  // namespace

extern "C" int shift_s2d2(const void* x, void* out, int N, int H, int W,
                          int C, int vec, void* stream) {
  const int hout = H / 2 + 1;
  const int hout_p = (hout + 7) / 8 * 8;
  const int wout = W / 2 + 1;
  const long long total = static_cast<long long>(N) * hout_p * wout * 4 * C /
                          (vec ? 16 : 1);
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* xi = static_cast<const int8_t*>(x);
  auto* o = static_cast<int8_t*>(out);
  if (blocks > 0) {
    if (vec) {
      shift_s2d2_kernel<true><<<unsigned(blocks), THREADS, 0, st>>>(
          xi, o, N, H, W, C, hout, hout_p, wout);
    } else {
      shift_s2d2_kernel<false><<<unsigned(blocks), THREADS, 0, st>>>(
          xi, o, N, H, W, C, hout, hout_p, wout);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
