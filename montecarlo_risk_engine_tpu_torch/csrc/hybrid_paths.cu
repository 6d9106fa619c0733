// Hybrid-model path kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel hybrid_paths
// (montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153) for its Euler blocks
// bs, vasicek and cirpp.  The plain PyTorch version, op for op, is
// hybrid_paths_reference in ops/hybrid_paths.py.
//
// What it computes: the joint paths of a ModelConfig of Black-Scholes,
// Vasicek and CIR++ sub-models.  Per substep: sim_dim standard normals,
// w = L z through the static lower-triangular joint Cholesky factor, then
// each block's Euler update.  Output [T, N, D] f32 in block order; the bs
// block emits S (pallas_hybrid.py:465-468).
//
// Design:
//   * One thread per path.  Every sub-model has at most two state columns
//     and exactly one noise factor, so block b's state lives in s0[b] / s1[b]
//     and its factor in w[b]; all loops over blocks, factors and Cholesky
//     entries are unrolled to kMax*, so the indices are compile-time and the
//     whole state stays in registers across every point and substep (the
//     TPU kernel's VMEM carry, time chunks, per-block seeding and 128-lane
//     padding have no counterpart here).
//   * Block descriptors are read at run time: the kinds, parameter offsets,
//     state offsets, psi columns and the f32 Cholesky factor travel in a
//     struct passed by value (the kernel parameter space, in constant
//     memory).  A switch per block is uniform across the warp, and one
//     build serves every ModelConfig of these kinds.
//   * No host syncs: the parameters are a device f32 vector [P], and the
//     per-substep scalars come from a device table [T * num_steps, W] f32
//     computed by the wrapper in torch: dt, sqrt(dt) and, per cirpp block,
//     psi(t1) = lambda_mkt(t1) + D(t1) - y0 E(t1).  A point whose first row
//     has dt = 0 draws nothing and keeps its state.
//   * Draws: Philox4x32-10 keyed (seed, phase); call c at counter
//     (path, point * num_steps + k, c, 0) gives normals 4c .. 4c+3, each
//     word pair one Box-Muller pair (r cos, r sin), uniforms
//     ((w >> 8) + 0.5) / 2^24 clamped below 1 (rng.substep_normals).
//   * What bounds it: device-memory bytes.  Per path-substep one Philox call,
//     two Box-Muller pairs, a 3x3 triangular combine and three block updates
//     are about 170 operations (counted in chip_smoke.py), 0.14 ms over
//     1e6 x 56 path-substeps at 67 TFLOP/s; the emission of D f32 per path
//     per point is 1.14 GB at the north-star shapes, 0.34 ms at 3.35 TB/s.  The design writes each
//     state once and reads nothing per path, so the emission is all the
//     traffic there is; a warp's stores cover 32 * D * 4 contiguous bytes.
//   * Built with -fmad=false and without fast math: every expression rounds
//     like the separate torch ops of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBlocks = 8;  // == kMaxSim: every block has one noise factor
constexpr int kMaxSim = 8;
constexpr int kThreads = 256;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kUMax = 0x1.fffffep-1f;  // largest float below 1
constexpr float kYFloor = (float)1e-12;

enum Kind : int { kBs = 0, kVasicek = 1, kCirpp = 2 };

struct Desc {
  int num_blocks;
  int state_dim;
  int table_width;
  int kind[kMaxBlocks];
  int param_base[kMaxBlocks];
  int state_off[kMaxBlocks];
  int psi_col[kMaxBlocks];
  float chol[kMaxSim * kMaxSim];  // row-major, lower triangular
};

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

// One Box-Muller pair from two words into z[i] (cos) and z[i + 1] (sin),
// each only if it is one of the sim_dim normals asked for.
__device__ __forceinline__ void box_muller(uint32_t wa, uint32_t wb, int i, int sim_dim,
                                           float* z) {
  const float u1 = uniform_from_word(wa);
  const float u2 = uniform_from_word(wb);
  const float r = sqrtf(-2.0f * logf(u1));
  const float ang = u2 * kTwoPi;
  if (i < sim_dim) z[i] = r * cosf(ang);
  if (i + 1 < sim_dim) z[i + 1] = r * sinf(ang);
}

__global__ void __launch_bounds__(kThreads)
hybrid_kernel(float* __restrict__ out, const float* __restrict__ prm,
              const float* __restrict__ table, const Desc d, int num_points,
              int num_steps, uint32_t num_paths, uint32_t seed, uint32_t phase) {
  const uint32_t path = blockIdx.x * blockDim.x + threadIdx.x;
  if (path >= num_paths) return;
  const uint2 key = make_uint2(seed, phase);
  const int nb = d.num_blocks;  // == sim_dim

  float s0[kMaxBlocks], s1[kMaxBlocks];
#pragma unroll
  for (int b = 0; b < kMaxBlocks; ++b) {
    s0[b] = 0.0f;
    s1[b] = 0.0f;
    if (b < nb) {
      const float* p = prm + d.param_base[b];
      switch (d.kind[b]) {
        case kBs: s0[b] = __ldg(p); break;           // S = spot
        case kVasicek: s0[b] = __ldg(p); break;      // r = rate, log_B = 0
        case kCirpp: s0[b] = __ldg(p + 3); break;    // y = y0, log_B = 0
      }
    }
  }

  for (int point = 0; point < num_points; ++point) {
    const float* row0 = table + (size_t)point * num_steps * d.table_width;
    if (__ldg(row0) > 0.0f) {
      for (int k = 0; k < num_steps; ++k) {
        const float* row = row0 + (size_t)k * d.table_width;
        const float dt = __ldg(row);
        const float sqrt_dt = __ldg(row + 1);
        const uint32_t counter = (uint32_t)(point * num_steps + k);

        float z[kMaxSim];
#pragma unroll
        for (int c = 0; c < kMaxSim / 4; ++c) {
          if (4 * c < nb) {
            const uint4 w4 = philox4x32_10(make_uint4(path, counter, (uint32_t)c, 0u), key);
            box_muller(w4.x, w4.y, 4 * c, nb, z);
            box_muller(w4.z, w4.w, 4 * c + 2, nb, z);
          }
        }
        // w = L z, summed left to right over the non-zero entries.
        float w[kMaxSim];
#pragma unroll
        for (int i = 0; i < kMaxSim; ++i) {
          w[i] = 0.0f;
          if (i < nb) {
            bool first = true;
#pragma unroll
            for (int e = 0; e <= i; ++e) {
              const float c = d.chol[i * kMaxSim + e];
              if (c != 0.0f) {
                w[i] = first ? c * z[e] : w[i] + c * z[e];
                first = false;
              }
            }
          }
        }

#pragma unroll
        for (int b = 0; b < kMaxBlocks; ++b) {
          if (b < nb) {
            const float* p = prm + d.param_base[b];
            switch (d.kind[b]) {
              case kBs: {  // S' = S (1 + r dt) + sigma S sqrt(dt) w
                const float sigma = __ldg(p + 1), rate = __ldg(p + 2);
                const float s = s0[b];
                s0[b] = s * (1.0f + rate * dt) + sigma * s * sqrt_dt * w[b];
                break;
              }
              case kVasicek: {  // log_B += r dt; r' = r + a (theta - r) dt + sigma sqrt(dt) w
                const float sigma = __ldg(p + 1), theta = __ldg(p + 2), a = __ldg(p + 3);
                const float r = s0[b];
                s1[b] = s1[b] + r * dt;
                s0[b] = r + a * (theta - r) * dt + sigma * sqrt_dt * w[b];
                break;
              }
              case kCirpp: {  // log_B += (y + psi) dt; full-truncation Euler on y
                const float kappa = __ldg(p), theta = __ldg(p + 1), sigma = __ldg(p + 2);
                const float psi = __ldg(row + d.psi_col[b]);
                const float y = s0[b];
                s1[b] = s1[b] + (y + psi) * dt;
                const float sqrt_y = sqrtf(fmaxf(y, 0.0f));
                s0[b] = fmaxf(y + kappa * (theta - y) * dt + sigma * sqrt_y * sqrt_dt * w[b],
                              kYFloor);
                break;
              }
            }
          }
        }
      }
    }
    float* dst = out + ((size_t)point * num_paths + path) * d.state_dim;
#pragma unroll
    for (int b = 0; b < kMaxBlocks; ++b) {
      if (b < nb) {
        dst[d.state_off[b]] = s0[b];
        if (d.kind[b] != kBs) dst[d.state_off[b] + 1] = s1[b];
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  out, params and
// table are device pointers: out [num_points, num_paths, state_dim] f32,
// params [P] f32, table [num_points * num_steps, table_width] f32.  The
// descriptor arrays (length num_blocks) and chol (num_blocks^2, row-major)
// are host arrays.
extern "C" int mcre_hybrid_paths(void* out, const void* params, const void* table,
                                 int num_blocks, const int* kinds, const int* param_base,
                                 const int* state_off, const int* psi_col,
                                 const float* chol, int state_dim, int table_width,
                                 int num_points, int num_steps, uint32_t num_paths,
                                 uint32_t seed, uint32_t phase, void* stream) {
  if (num_blocks < 1 || num_blocks > kMaxBlocks || num_points < 0 || num_steps < 1 ||
      num_paths == 0 || out == nullptr || params == nullptr || table == nullptr ||
      table_width < 2) {
    return (int)cudaErrorInvalidValue;
  }
  Desc d = {};
  d.num_blocks = num_blocks;
  d.state_dim = state_dim;
  d.table_width = table_width;
  for (int b = 0; b < num_blocks; ++b) {
    if (kinds[b] < kBs || kinds[b] > kCirpp) return (int)cudaErrorInvalidValue;
    d.kind[b] = kinds[b];
    d.param_base[b] = param_base[b];
    d.state_off[b] = state_off[b];
    d.psi_col[b] = psi_col[b];
    for (int e = 0; e < num_blocks; ++e) d.chol[b * kMaxSim + e] = chol[b * num_blocks + e];
  }
  if (num_points == 0) return 0;
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  hybrid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<const float*>(params),
      static_cast<const float*>(table), d, num_points, num_steps, num_paths, seed, phase);
  return (int)cudaGetLastError();
}
