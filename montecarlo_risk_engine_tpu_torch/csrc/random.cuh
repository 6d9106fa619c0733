// Draws shared by the path kernels K1 (heston_qe.cu) and K2 (hybrid_paths.cu).
//
// Philox4x32-10 keyed (seed, phase), the stream of rng.py; each 32-bit word
// maps to a uniform ((w >> 8) + 0.5) / 2^24 clamped below 1; two words give
// one Box-Muller pair (r cos, r sin) with r = sqrt(-2 log u1) and the angle
// 2 pi u2.  The pair comes from one sincosf, which reduces the angle once for
// both values and rounds each like the separate sinf / cosf (and the
// torch.sin / torch.cos of the plain versions).

#pragma once

#include <stdint.h>

namespace mcre {

constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kUMax = 0x1.fffffep-1f;  // largest float below 1

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k.x += 0x9E3779B9u;
      k.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
  }
  return c;
}

__device__ __forceinline__ float uniform_from_word(uint32_t w) {
  const float u = __uint2float_rn(w >> 8) * 0x1p-24f + 0x1p-25f;
  return fminf(u, kUMax);
}

// One Box-Muller pair (r cos, r sin) from two words.
__device__ __forceinline__ float2 box_muller(uint32_t wa, uint32_t wb) {
  const float u1 = uniform_from_word(wa);
  const float u2 = uniform_from_word(wb);
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincosf(u2 * kTwoPi, &s, &c);
  return make_float2(r * c, r * s);
}

// A launch's rows 0 .. num_paths - 1 draw global paths path_offset +
// path_stride * i (a rank of a path-sharded run): a positive stride, and the
// last of them a 32-bit counter word.
inline bool valid_path_stride(uint32_t num_paths, uint32_t path_offset, uint32_t path_stride) {
  return path_stride >= 1 &&
         (uint64_t)path_offset + (uint64_t)path_stride * (num_paths - 1) < (1ull << 32);
}

}  // namespace mcre
