// The int8 code of one accumulator in each epilogue order of the int8
// kernels, shared by the GEMM (gemm_fused.cu, its wgmma form) and the
// conv of the xla tier (conv_w8a8.cu), so that the two give the same
// codes for the same accumulator, scale, bias and s_out.
//
//   MODE 0  conv order, as conv2d_w8a8 and the fold stages compute it:
//           y = act(acc*scale + bias), q = clip(rint(y / s_out), +-127),
//           the quotient by wg::div_rn (s_out a positive normal float);
//   MODE 1  folded order (the caller folded 1/s_out into scale and bias):
//           q = clip(rint(y));
//   MODE 4  MODE 0 for an s_out that is not a positive normal float (zero,
//           subnormal, huge, negative): the float y / s_out rounded once
//           is RN_float(y * RN_double(1/s_out)), the product in double --
//           a quotient of two 24-bit significands is never a float
//           midpoint and lies at least 2^-49 (relative) from every one,
//           while the double product errs by at most 2^-52 -- at the cost
//           of two conversions a code.
//
// Every rounding is explicit (s8mma::epilogue_f32, wg::div_rn,
// wg::code_bits): nvcc would otherwise contract a*b+c into an FMA and the
// codes would drift by 1 LSB.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"
#include "wgmma_s8.cuh"

namespace rq {

// s_out, RN(1/s_out), the clamp 128 s_out and RN_double(1/s_out).
struct Requant {
  float s_out, rs_out, lim;
  double rd_out;
};

// The constants of a conv-order epilogue dividing by s_out; *mode 0
// becomes 4 where s_out, its reciprocal or 128 s_out is not a positive
// normal float (wg::div_rn's precondition).
inline Requant requant(float s_out, int* mode) {
  Requant q;
  q.s_out = s_out;
  q.rs_out = 1.0f / s_out;
  q.lim = 128.0f * s_out;
  q.rd_out = 1.0 / static_cast<double>(s_out);
  if (*mode == 0 && !(std::isnormal(s_out) && s_out > 0.f &&
                      std::isnormal(q.rs_out) && std::isnormal(q.lim))) {
    *mode = 4;
  }
  return q;
}

// The code of one accumulator in the low byte (two's complement). `act`
// is 0 linear, 1 leaky, 2 relu; a caller that passes a constant gets it
// folded in.
template <int MODE>
__device__ __forceinline__ uint32_t code(int acc, float sc, float bi,
                                         int act, const Requant& q) {
  float y = s8mma::epilogue_f32(acc, sc, bi, act);
  if (MODE == 0) {
    y = wg::div_rn(fminf(fmaxf(y, -q.lim), q.lim), q.s_out, q.rs_out);
  } else if (MODE == 4) {
    y = __double2float_rn(__dmul_rn(static_cast<double>(y), q.rd_out));
  }
  return wg::code_bits(y);
}

}  // namespace rq
