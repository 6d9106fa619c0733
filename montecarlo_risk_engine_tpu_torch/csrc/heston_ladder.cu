// The Heston-QE substep ladder (K3) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel of benchmarks/kernel_decomposition.py (build :226
// -> make_kernel :240, pallas_call :262): Heston path generations, each
// through one of nine substep variants, whose differences split K1's cost
// per substep by stage.  The plain PyTorch version, op for op, is
// heston_ladder_paths_reference in ops/heston_ladder.py.
//
// Design:
//   * K1's launch geometry (heston_qe.cu): one thread per path, 256-thread
//     blocks, log S and v in registers, the per-point dt table passed by
//     value (kThreads and PointTable from heston_qe_step.cuh), the parameters a device f32 vector [spot, sigma, rate, rho,
//     kappa, theta, v0], the states stored as float2 into [T, N, 2].  K1's
//     stages are its own device code: Philox4x32-10 and Box-Muller
//     (random.cuh), the per-point scalars and the QE update
//     (heston_qe_step.cuh).
//   * What bounds it: the SMs' issue slots for every rung but no-draws,
//     which is bound by its 8 bytes per path and point.  A simple kernel:
//     each rung's cost is what it asks the card to issue, which is what the
//     ladder measures.
//   * Rungs (template kRung; the JAX script's variants, :281-291):
//       0 no-draws         log S * 0.9999 + 1e-6, v likewise: the loop and
//                          the emission;
//       1 raw-bits-x3      one Philox call at K1's counter, words 0 ^ 1 ^ 2
//                          read as int32 and converted to float;
//       2 box-muller       K1's Box-Muller pair and uniform, consumed
//                          trivially;
//       3 icdf             the same call's three uniforms, two through
//                          Giles' erfinv polynomial (a branch per thread on
//                          w < 5, where the TPU evaluated both sides);
//       4 qe-full          K1's substep with hard branches (bitwise K1's
//                          states at generation 0);
//       5 qe-icdf          the QE update on icdf normals;
//       6 qe-batched-prng  a point's 3 * num_steps words from
//                          ceil(3 * num_steps / 4) calls at counter (path,
//                          point, call, 3), 3 calls per 4 substeps; substep
//                          k takes words 3k .. 3k+2;
//       7 qe-algebra       the division-reduced QE update on K1's draws;
//       8 qe-combined      the batched draws with the division-reduced
//                          update.
//   * Draws: Philox4x32-10 keyed (seed + generation, phase); K1's counter
//     (path, point * num_steps + k, 0, 0) but for the batched rungs, whose
//     lane (counter word 3 = 3) no other stream of the port uses.  The
//     generation stands for the TPU script's per-program seed offset, so
//     back-to-back launches draw different streams.
//   * Every loop keeps `#pragma unroll 1`, so the innermost loop of each
//     instance's SASS is one substep, or one group of 4 substeps in the
//     batched rungs, whose instruction count the counter divides by 4
//     (ops/sass.py, substeps_per_iteration); their last group of fewer
//     than 4 substeps runs after that loop, which holds no branch around a
//     substep (the counter would take such a region for a slow path).
//   * Built with -fmad=false and without fast math, as K1: every expression
//     rounds like the separate torch ops of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "heston_qe_step.cuh"
#include "random.cuh"

namespace {

using mcre::kThreads;
using mcre::PointTable;

constexpr uint32_t kBatchedLane = 3;
constexpr float kSqrt2 = (float)1.4142135623730951;

enum Rung {
  kNoDraws,
  kRawBits,
  kBoxMuller,
  kIcdf,
  kQeFull,
  kQeIcdf,
  kQeBatched,
  kQeAlgebra,
  kQeCombined,
  kNumRungs
};

// N(0, 1) quantile through Giles' single-precision erfinv polynomial,
// z = sqrt(2) erfinv(2u - 1) (benchmarks/kernel_decomposition.py:82).
__device__ __forceinline__ float normal_icdf(float u) {
  const float x = 2.0f * u - 1.0f;
  const float w = -logf((1.0f - x) * (1.0f + x));
  float p;
  if (w < 5.0f) {
    const float t = w - 2.5f;
    p = (float)2.81022636e-08;
    p = p * t + (float)3.43273939e-07;
    p = p * t + (float)-3.5233877e-06;
    p = p * t + (float)-4.39150654e-06;
    p = p * t + (float)2.1858087e-04;
    p = p * t + (float)-1.25372503e-03;
    p = p * t + (float)-4.17768164e-03;
    p = p * t + (float)2.46640727e-01;
    p = p * t + (float)1.50140941e+00;
  } else {
    const float t = sqrtf(w) - 3.0f;
    p = (float)-2.00214257e-04;
    p = p * t + (float)1.00950558e-04;
    p = p * t + (float)1.34934322e-03;
    p = p * t + (float)-3.67342844e-03;
    p = p * t + (float)5.73950773e-03;
    p = p * t + (float)-7.62246130e-03;
    p = p * t + (float)9.43887047e-03;
    p = p * t + (float)1.00167406e+00;
    p = p * t + (float)2.83297682e+00;
  }
  return kSqrt2 * p * x;
}

// One substep of a rung with draws on the three words (w0, w1, w2).
template <int kRung>
__device__ __forceinline__ void substep(const mcre::QeScalars& c, uint32_t w0, uint32_t w1,
                                        uint32_t w2, float& log_s, float& v) {
  if constexpr (kRung == kRawBits) {
    const float step = (float)1e-12 * __int2float_rn((int32_t)(w0 ^ w1 ^ w2));
    log_s = log_s + step;
    v = v + step;
  } else {
    constexpr bool kIcdfNormals = kRung == kIcdf || kRung == kQeIcdf;
    float z1, z2;
    if constexpr (kIcdfNormals) {
      z1 = normal_icdf(mcre::uniform_from_word(w0));
      z2 = normal_icdf(mcre::uniform_from_word(w1));
    } else {
      const float2 zz = mcre::box_muller(w0, w1);
      z1 = zz.x;
      z2 = zz.y;
    }
    const float u = mcre::uniform_from_word(w2);
    if constexpr (kRung == kBoxMuller || kRung == kIcdf) {
      log_s = log_s + (float)1e-3 * (z1 + z2);
      v = v + (float)1e-3 * u;
    } else {
      mcre::qe_update<false, kRung == kQeAlgebra || kRung == kQeCombined>(c, z1, z2, u, log_s, v);
    }
  }
}

// A group of the batched rungs' substeps from consecutive calls at counter
// (path, point, call, kBatchedLane): call j gives words 4j .. 4j+3 of the
// point, substep k words 3k .. 3k+2.  kFull: 4 substeps from 3 calls, with
// no branch; else the left < 4 substeps of the point's last group.
template <int kRung, bool kFull>
__device__ __forceinline__ void batched_group(const mcre::QeScalars& c, uint32_t path,
                                              int point, int call, uint2 key, int left,
                                              float& log_s, float& v) {
  const auto draw = [&](int j) {
    return mcre::philox4x32_10(
        make_uint4(path, (uint32_t)point, (uint32_t)(call + j), kBatchedLane), key);
  };
  const uint4 a = draw(0);
  substep<kRung>(c, a.x, a.y, a.z, log_s, v);
  if (kFull || left > 1) {
    const uint4 b = draw(1);
    substep<kRung>(c, a.w, b.x, b.y, log_s, v);
    if (kFull || left > 2) {
      const uint4 d = draw(2);
      substep<kRung>(c, b.z, b.w, d.x, log_s, v);
      if (kFull) substep<kRung>(c, d.y, d.z, d.w, log_s, v);
    }
  }
}

// At least one block per SM: left to its occupancy heuristic, ptxas held
// the batched rungs to 40 registers and spilled 24 bytes.
template <int kRung>
__global__ void __launch_bounds__(kThreads, 1)
heston_ladder_kernel(float2* __restrict__ states, const PointTable table, int num_points,
                     int num_steps, uint32_t num_paths, const float* __restrict__ prm,
                     uint32_t seed, uint32_t phase) {
  const uint32_t path = blockIdx.x * blockDim.x + threadIdx.x;
  if (path >= num_paths) return;
  const uint2 key = make_uint2(seed, phase);

  const float sigma = __ldg(prm + 1), rate = __ldg(prm + 2), rho = __ldg(prm + 3);
  const float kappa = __ldg(prm + 4), theta = __ldg(prm + 5);
  float log_s = logf(__ldg(prm));
  float v = __ldg(prm + 6);

#pragma unroll 1
  for (int point = 0; point < num_points; ++point) {
    const float dt = table.dt[point];
    if (dt > 0.0f) {
      const mcre::QeScalars c = mcre::qe_scalars(dt, sigma, rate, rho, kappa, theta);
      if constexpr (kRung == kNoDraws) {
#pragma unroll 1
        for (int k = 0; k < num_steps; ++k) {
          log_s = log_s * (float)0.9999 + (float)1e-6;
          v = v * (float)0.9999 + (float)1e-6;
        }
      } else if constexpr (kRung == kQeBatched || kRung == kQeCombined) {
        // Substeps 4g .. 4g+3 take calls 3g .. 3g+2; a last group of
        // r < 4 substeps takes r calls, outside the loop.
        const int full = num_steps & ~3;
#pragma unroll 1
        for (int k = 0; k < full; k += 4) {
          batched_group<kRung, true>(c, path, point, 3 * (k / 4), key, 4, log_s, v);
        }
        if (full < num_steps) {
          batched_group<kRung, false>(c, path, point, 3 * (full / 4), key, num_steps - full,
                                      log_s, v);
        }
      } else {
#pragma unroll 1
        for (int k = 0; k < num_steps; ++k) {
          const uint4 w = mcre::philox4x32_10(
              make_uint4(path, (uint32_t)(point * num_steps + k), 0u, 0u), key);
          substep<kRung>(c, w.x, w.y, w.z, log_s, v);
        }
      }
    }
    states[(size_t)point * num_paths + path] = make_float2(log_s, v);
  }
}

using Launch = void (*)(float2*, const PointTable&, int, int, uint32_t, const float*, uint32_t,
                        uint32_t, cudaStream_t);

template <int kRung>
void launch(float2* states, const PointTable& table, int num_points, int num_steps,
            uint32_t num_paths, const float* prm, uint32_t seed, uint32_t phase,
            cudaStream_t stream) {
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  heston_ladder_kernel<kRung><<<blocks, kThreads, 0, stream>>>(
      states, table, num_points, num_steps, num_paths, prm, seed, phase);
}

constexpr Launch kLaunch[kNumRungs] = {
    launch<kNoDraws>,   launch<kRawBits>, launch<kBoxMuller>,
    launch<kIcdf>,      launch<kQeFull>,  launch<kQeIcdf>,
    launch<kQeBatched>, launch<kQeAlgebra>, launch<kQeCombined>};

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  rung indexes the
// nine rungs in the order above (RUNGS in ops/heston_ladder.py); states and
// params are device pointers, params f32 [7] (spot, sigma, rate, rho, kappa,
// theta, v0); dts is a host array of num_points floats (the per-substep dt
// of each point).  The Philox key is (seed + generation, phase).
extern "C" int mcre_heston_ladder(int rung, void* states, const void* dts, int num_points,
                                  int num_steps, uint32_t num_paths, const void* params,
                                  uint32_t seed, uint32_t phase, uint32_t generation,
                                  void* stream) {
  if (rung < 0 || rung >= kNumRungs ||
      !mcre::valid_paths_launch(num_points, num_steps, num_paths, states, params)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const PointTable table = mcre::point_table(dts, num_points);
  kLaunch[rung](static_cast<float2*>(states), table, num_points, num_steps, num_paths,
                static_cast<const float*>(params), seed + generation, phase,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
