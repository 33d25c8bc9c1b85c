// Fused quantize + space-to-depth(4) for Hopper (sm_90a): the network
// input of a folded entry stage, uint8 wire or f32, into int8 fold-4 codes.
//
// Replaces: dnn_inference_engine_tpu/ops/pallas_conv.py,
// quant_space_to_depth4 (kernel body _qs2d_kernel). Same contract:
//   out[n, i, j, 12p + 3q + c] = clip(rint(v / s), +-127),
//   v = xpad[n, 4i+p, 4j+q, c]  (uint8: v = u / 255 first)
// lanes 48 .. c_out-1 zero. Both divisions are correctly rounded
// (__fdiv_rn), never a multiply by a reciprocal, as the JAX kernel and
// quantize_act divide. xpad is x seen through a zero border (top, left,
// and whatever reaches past H, W up to the padded Hp, Wp): the border is
// read as zero from the bounds, so the padded copy the JAX path makes
// before its kernel is never written. Zero quantizes to zero in both
// dtypes.
//
// What bounds it on an H100 (3.35 TB/s, SXM data sheet at 700 W): bytes.
// It reads each input byte once (3 B or 12 B a pixel) and writes 48 or 64
// bytes per output pixel, a few divisions per byte. One thread makes one
// output pixel: it reads its 4 x 4 input pixels (4 rows of 12 contiguous
// bytes, or 48 for f32; neighbouring threads read neighbouring bytes),
// packs the 48 codes in 12 registers and writes them, and the zero lanes,
// as 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool U8>
__global__ void __launch_bounds__(THREADS)
qs2d4_kernel(const void* __restrict__ xin, float s, int8_t* __restrict__ out,
             int N, int H, int W, int top, int left, int H4, int W4,
             int c_out) {
  const long long total = static_cast<long long>(N) * H4 * W4;
  for (long long pix = blockIdx.x * static_cast<long long>(THREADS) +
                       threadIdx.x;
       pix < total; pix += static_cast<long long>(gridDim.x) * THREADS) {
    const int j = static_cast<int>(pix % W4);
    const long long rest = pix / W4;
    const int i = static_cast<int>(rest % H4);
    const int n = static_cast<int>(rest / H4);
    unsigned words[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) words[k] = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int y = 4 * i + p - top;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int x = 4 * j + q - left;
        const bool in = y >= 0 && y < H && x >= 0 && x < W;
        const size_t base =
            in ? ((static_cast<size_t>(n) * H + y) * W + x) * 3 : 0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float v = 0.f;
          if (in) {
            if (U8) {
              v = __fdiv_rn(
                  __uint2float_rn(static_cast<const uint8_t*>(xin)[base + c]),
                  255.f);
            } else {
              v = static_cast<const float*>(xin)[base + c];
            }
          }
          const float q8 = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
          const int lane = 12 * p + 3 * q + c;
          words[lane / 4] |=
              unsigned(uint8_t(static_cast<int8_t>(static_cast<int>(q8))))
              << (8 * (lane % 4));
        }
      }
    }
    uint4* o = reinterpret_cast<uint4*>(out + pix * c_out);
    o[0] = make_uint4(words[0], words[1], words[2], words[3]);
    o[1] = make_uint4(words[4], words[5], words[6], words[7]);
    o[2] = make_uint4(words[8], words[9], words[10], words[11]);
    for (int k = 3; k < c_out / 16; ++k) o[k] = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

// x (N, H, W, 3) uint8 (u8 != 0) or f32, read as if zero-padded to
// (Hp, Wp) with its first pixel at (top, left); out (N, Hp/4, Wp/4, c_out)
// int8, c_out a multiple of 16 and >= 48.
extern "C" int quant_space_to_depth4(const void* x, float s, void* out, int N,
                                     int H, int W, int top, int left, int Hp,
                                     int Wp, int c_out, int u8,
                                     void* stream) {
  const int H4 = Hp / 4, W4 = Wp / 4;
  const long long total = static_cast<long long>(N) * H4 * W4;
  long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535LL * 16) blocks = 65535LL * 16;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int8_t*>(out);
  if (blocks > 0) {
    if (u8) {
      qs2d4_kernel<true><<<unsigned(blocks), THREADS, 0, st>>>(
          x, s, o, N, H, W, top, left, H4, W4, c_out);
    } else {
      qs2d4_kernel<false><<<unsigned(blocks), THREADS, 0, st>>>(
          x, s, o, N, H, W, top, left, H4, W4, c_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
