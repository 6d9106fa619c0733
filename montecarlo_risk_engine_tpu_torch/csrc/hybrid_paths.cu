// Hybrid-model path kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel hybrid_paths
// (montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153) whole: the blocks
// bs, bs_multi, vasicek, cirpp, cirpp_det, hw and s2f, each in every scheme
// the TPU kernel gives it (pallas_hybrid.py:286-416).  The plain PyTorch
// version, op for op, is hybrid_paths_reference in ops/hybrid_paths.py.
//
// What it computes: the joint paths of a standalone model or a ModelConfig.
// Per substep: sim_dim standard normals, w = L z through the static
// lower-triangular joint Cholesky factor, then each block's update.  Output
// [T, N, D] f32 in block order; exact bs / bs_multi keep log S and emit S
// (pallas_hybrid.py:465-468).
//
// Design:
//   * One thread per path.  The state lives in registers as one slot per
//     noise factor, each slot holding at most two state values a[s], b[s]:
//     a bs_multi block is one slot per asset (sharing the rate), vasicek /
//     cirpp / cirpp_det / hw one slot (value, log_B), and s2f two coupled
//     slots (x with the derived log S, then y, which reads the x slot's
//     normal for its own rho).  The kernel is a template on an upper bound
//     S of the slot count (4 for block lists of at most four noise factors,
//     else kMaxSim = 8), so every loop over slots, factors and Cholesky
//     entries unrolls to S: the indices are compile-time, nothing goes to
//     local memory (ptxas: no stack frame), and a narrow block list holds
//     registers for four slots, not eight.  A cirpp_det
//     slot's factor is drawn and not read, so the draw count matches the
//     TPU block layout.
//   * Slot descriptors are read at run time: role, parameter indices, table
//     column, output columns and the f32 Cholesky factor travel in a struct
//     passed by value (the kernel parameter space).  A switch per slot is
//     uniform across the warp, and one build serves every block list.
//   * No host syncs: the parameters are a device f32 vector [P], the
//     initial state a device vector [D], and every per-substep constant a
//     device table [T * num_steps, W] f32 computed by the wrapper in torch
//     (dt, sqrt(dt); psi; decay and scale; alpha(t1), alpha(t1 + dt);
//     lambda_mkt; log F0; rho_c and the s2f stds).  A point whose first row
//     has dt = 0 draws nothing and keeps its state.
//   * Draws: Philox4x32-10 keyed (seed, phase); call c at counter
//     (path, point * num_steps + k, c, 0) gives normals 4c .. 4c+3, each
//     word pair one Box-Muller pair (r cos, r sin), uniforms
//     ((w >> 8) + 0.5) / 2^24 clamped below 1 (rng.substep_normals).
//   * What bounds it: device-memory bytes.  The BS-multi European book
//     ([10, 2^20, 4]) writes 168 MB, 0.050 ms at 3.35 TB/s; one Philox call,
//     two Box-Muller pairs, a 4x4 triangular combine and four exact updates
//     are about 180 operations per path-substep (counted in chip_smoke.py),
//     0.028 ms over 1.05e7 path-substeps at 67 TFLOP/s.  The design writes
//     each state once and reads nothing per path, so the emission is all the
//     traffic there is; a warp's stores cover 32 * D * 4 contiguous bytes.
//   * Built with -fmad=false and without fast math: every expression rounds
//     like the separate torch ops of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSim = 8;  // slots = noise factors
constexpr int kThreads = 256;
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kUMax = 0x1.fffffep-1f;  // largest float below 1
constexpr float kYFloor = (float)1e-12;

// Slot roles (ops/hybrid_paths.py GBM_EXACT ...).
enum Role : int {
  kGbmExact = 0,   // a = log S; sigma = prm[pa], rate = prm[pb]
  kGbmEuler = 1,   // a = S
  kVasExact = 2,   // a = r, b = log_B; theta = prm[pa]; table decay, scale
  kVasEuler = 3,   // sigma, theta, speed = prm[pa .. pa + 2]
  kCirpp = 4,      // a = y, b = log_B; kappa, theta, sigma = prm[pa ..]; table psi
  kCirppDet = 5,   // table lambda(t1), lambda(t1 + dt)
  kHwExact = 6,    // a = r, b = log_B; table alpha1, alpha2, decay, scale
  kHwEuler = 7,    // sigma, speed = prm[pa], prm[pa + 1]; table alpha1, alpha2
  kS2fXExact = 8,  // a = x, b = log S; table [logF0, rho_c, decay, std_x, std_y]
  kS2fXEuler = 9,  // kappa = prm[pa], sigma_s = prm[pb]
  kS2fYExact = 10, // a = y; mu = prm[pa], rho = prm[pb]; follows its x slot
  kS2fYEuler = 11, // mu, sigma_l = prm[pa], prm[pa + 1]; rho = prm[pb]
};

struct Desc {
  int num_slots;
  int state_dim;
  int table_width;
  int role[kMaxSim];
  int pa[kMaxSim];
  int pb[kMaxSim];
  int tcol[kMaxSim];
  int oa[kMaxSim];
  int ob[kMaxSim];                // -1: the slot has no second value
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

template <int S>  // an upper bound of the slot count, a multiple of 4
__global__ void __launch_bounds__(kThreads)
hybrid_kernel(float* __restrict__ out, const float* __restrict__ prm,
              const float* __restrict__ table, const float* __restrict__ init, const Desc d,
              int num_points, int num_steps, uint32_t num_paths, uint32_t seed,
              uint32_t phase) {
  const uint32_t path = blockIdx.x * blockDim.x + threadIdx.x;
  if (path >= num_paths) return;
  const uint2 key = make_uint2(seed, phase);
  const int ns = d.num_slots;  // == sim_dim, in (S - 4, S]

  float a[S], b[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s] = 0.0f;
    b[s] = 0.0f;
    if (s < ns) {
      a[s] = __ldg(init + d.oa[s]);
      if (d.ob[s] >= 0) b[s] = __ldg(init + d.ob[s]);
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

        // Every Philox call's four normals are formed, used or not (the
        // instance for S is taken only when a call of S / 4 is needed).
        float z[S];
#pragma unroll
        for (int c = 0; c < S / 4; ++c) {
          const uint4 w4 = philox4x32_10(make_uint4(path, counter, (uint32_t)c, 0u), key);
          box_muller(w4.x, w4.y, 4 * c, S, z);
          box_muller(w4.z, w4.w, 4 * c + 2, S, z);
        }
        // w = L z, summed left to right over the non-zero entries.
        float w[S];
#pragma unroll
        for (int i = 0; i < S; ++i) {
          w[i] = 0.0f;
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

#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s >= ns) break;
          const float* tc = row + d.tcol[s];
          const float* pa = prm + d.pa[s];
          const int xs = s > 0 ? s - 1 : 0;  // the x slot of an s2f y slot
          switch (d.role[s]) {
            case kGbmExact: {  // log S' = log S + (r - sigma^2/2) dt + sigma sqrt(dt) w
              const float sigma = __ldg(pa), rate = __ldg(prm + d.pb[s]);
              a[s] = a[s] + (rate - 0.5f * sigma * sigma) * dt + sigma * sqrt_dt * w[s];
              break;
            }
            case kGbmEuler: {  // S' = S (1 + r dt) + sigma S sqrt(dt) w
              const float sigma = __ldg(pa), rate = __ldg(prm + d.pb[s]);
              a[s] = a[s] * (1.0f + rate * dt) + sigma * a[s] * sqrt_dt * w[s];
              break;
            }
            case kVasExact: {  // log_B += r dt; r' = theta + (r - theta) decay + scale w
              const float theta = __ldg(pa);
              b[s] = b[s] + a[s] * dt;
              a[s] = theta + (a[s] - theta) * __ldg(tc) + __ldg(tc + 1) * w[s];
              break;
            }
            case kVasEuler: {  // log_B += r dt; r' = r + a (theta - r) dt + sigma sqrt(dt) w
              const float sigma = __ldg(pa), theta = __ldg(pa + 1), speed = __ldg(pa + 2);
              const float r = a[s];
              b[s] = b[s] + r * dt;
              a[s] = r + speed * (theta - r) * dt + sigma * sqrt_dt * w[s];
              break;
            }
            case kCirpp: {  // log_B += (y + psi) dt; full-truncation Euler on y
              const float kappa = __ldg(pa), theta = __ldg(pa + 1), sigma = __ldg(pa + 2);
              const float y = a[s];
              b[s] = b[s] + (y + __ldg(tc)) * dt;
              const float sqrt_y = sqrtf(fmaxf(y, 0.0f));
              a[s] = fmaxf(y + kappa * (theta - y) * dt + sigma * sqrt_y * sqrt_dt * w[s],
                           kYFloor);
              break;
            }
            case kCirppDet: {  // log_B += lambda(t1) dt; y' = lambda(t1 + dt)
              b[s] = b[s] + __ldg(tc) * dt;
              a[s] = __ldg(tc + 1);
              break;
            }
            case kHwExact:
            case kHwEuler: {  // on x = r - alpha: exact OU or Euler; r' = x' + alpha(t1 + dt)
              b[s] = b[s] + a[s] * dt;
              float x = a[s] - __ldg(tc);
              if (d.role[s] == kHwExact) {
                x = x * __ldg(tc + 2) + __ldg(tc + 3) * w[s];
              } else {
                const float sigma = __ldg(pa), speed = __ldg(pa + 1);
                x = x - speed * x * dt + sigma * sqrt_dt * w[s];
              }
              a[s] = x + __ldg(tc + 1);
              break;
            }
            case kS2fXExact:
              a[s] = a[s] * __ldg(tc + 2) + __ldg(tc + 3) * w[s];
              break;
            case kS2fXEuler: {
              const float kappa = __ldg(pa), sig_s = __ldg(prm + d.pb[s]);
              a[s] = a[s] - kappa * a[s] * dt + sig_s * sqrt_dt * w[s];
              break;
            }
            case kS2fYExact:
            case kS2fYEuler: {  // y' from rho w_x + rho_c w, then log S = log F0 + x' + y'
              const float mu = __ldg(pa), rho = __ldg(prm + d.pb[s]);
              const float drive = rho * w[xs] + __ldg(tc + 1) * w[s];
              if (d.role[s] == kS2fYExact) {
                a[s] = a[s] + mu * dt + __ldg(tc + 4) * drive;
              } else {
                a[s] = a[s] + mu * dt + __ldg(pa + 1) * sqrt_dt * drive;
              }
              b[xs] = __ldg(tc) + a[xs] + a[s];
              break;
            }
          }
        }
      }
    }
    float* dst = out + ((size_t)point * num_paths + path) * d.state_dim;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s >= ns) break;
      dst[d.oa[s]] = d.role[s] == kGbmExact ? expf(a[s]) : a[s];
      if (d.ob[s] >= 0) dst[d.ob[s]] = b[s];
    }
  }
}

template <int S>
int launch(float* out, const float* prm, const float* table, const float* init, const Desc& d,
           int num_points, int num_steps, uint32_t num_paths, uint32_t seed, uint32_t phase,
           cudaStream_t stream) {
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  hybrid_kernel<S><<<blocks, kThreads, 0, stream>>>(out, prm, table, init, d, num_points,
                                                     num_steps, num_paths, seed, phase);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  out, params, table
// and init are device pointers: out [num_points, num_paths, state_dim] f32,
// params [P] f32, table [num_points * num_steps, table_width] f32, init
// [state_dim] f32.  The slot arrays (length num_slots) and chol
// (num_slots^2, row-major) are host arrays.
extern "C" int mcre_hybrid_paths(void* out, const void* params, const void* table,
                                 const void* init, int num_slots, const int* role,
                                 const int* pa, const int* pb, const int* tcol, const int* oa,
                                 const int* ob, const float* chol, int state_dim,
                                 int table_width, int num_points, int num_steps,
                                 uint32_t num_paths, uint32_t seed, uint32_t phase,
                                 void* stream) {
  if (num_slots < 1 || num_slots > kMaxSim || num_points < 0 || num_steps < 1 ||
      num_paths == 0 || out == nullptr || params == nullptr || table == nullptr ||
      init == nullptr || table_width < 2 || state_dim < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Desc d = {};
  d.num_slots = num_slots;
  d.state_dim = state_dim;
  d.table_width = table_width;
  for (int s = 0; s < num_slots; ++s) {
    const bool y_slot = role[s] == kS2fYExact || role[s] == kS2fYEuler;
    if (role[s] < kGbmExact || role[s] > kS2fYEuler || (y_slot && s == 0) ||
        oa[s] < 0 || oa[s] >= state_dim || ob[s] >= state_dim || tcol[s] < 0 ||
        tcol[s] >= table_width || pa[s] < 0 || pb[s] < 0) {
      return (int)cudaErrorInvalidValue;
    }
    d.role[s] = role[s];
    d.pa[s] = pa[s];
    d.pb[s] = pb[s];
    d.tcol[s] = tcol[s];
    d.oa[s] = oa[s];
    d.ob[s] = ob[s];
    for (int e = 0; e < num_slots; ++e) d.chol[s * kMaxSim + e] = chol[s * num_slots + e];
  }
  if (num_points == 0) return 0;
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  float* o = static_cast<float*>(out);
  const float* p = static_cast<const float*>(params);
  const float* t = static_cast<const float*>(table);
  const float* i0 = static_cast<const float*>(init);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return num_slots <= 4
             ? launch<4>(o, p, t, i0, d, num_points, num_steps, num_paths, seed, phase, st)
             : launch<kMaxSim>(o, p, t, i0, d, num_points, num_steps, num_paths, seed, phase, st);
}
