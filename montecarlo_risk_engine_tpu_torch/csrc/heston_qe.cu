// Andersen-QE Heston path kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel heston_qe_paths
// (montecarlo_risk_engine_tpu/ops/pallas_paths.py:148).  The plain PyTorch
// version, op for op, is heston_qe_paths_reference in ops/heston_qe.py.
//
// Design:
//   * One thread per path; log S and v live in registers across every point
//     and substep (the TPU kernel's VMEM residency becomes register
//     residency).  Device-memory traffic is only the emission: one float2
//     (log S, v) per path per point, stored path-minor into the public
//     [T, N, 2] layout, so a warp writes 256 contiguous bytes.  The
//     noise-emitting variant also writes z [T, N, 2] and u [T, N].
//   * What bounds it: arithmetic.  Per substep one Philox4x32-10 call, a
//     Box-Muller pair (logf, sqrtf, sinf, cosf), the QE update (IEEE
//     divisions, sqrtf, logf).  The scalars that depend only on (params, dt)
//     are computed once per timeline point, as _heston_qe_substep hoists
//     them; per-point dts come in a small table passed by value (the kernel
//     parameter space is constant memory).
//   * Draws: Philox4x32-10, key (seed, phase), counter
//     (path, point * num_steps + k, 0, 0).  Words 0 and 1 give
//     the Box-Muller pair (z_s, z_v), word 2 the QE uniform, each mapped as
//     ((w >> 8) + 0.5) / 2^24 and clamped below 1.
//   * Built with -fmad=false and without fast math: every expression rounds
//     like the separate torch ops of the plain version.
//   * Variants are template flags: kSmooth (fuzzy branch widths 0.3 / 0.5)
//     and kEmit (write the draws of each point's last substep; zeros at
//     zero-dt points).  The eq.-44 martingale correction is not implemented;
//     the Python side refuses such models.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxPoints = 512;
constexpr int kThreads = 256;
constexpr float kEps = (float)1e-12;
constexpr float kClipP = (float)(1.0 - 1e-6);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kUMax = 0x1.fffffep-1f;  // largest float below 1
constexpr float kInvSixTenths = (float)(1.0 / 0.6);

struct PointTable {
  float dt[kMaxPoints];
};

struct HestonParams {
  float spot, sigma, rate, rho, kappa, theta, v0;
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

template <bool kSmooth, bool kEmit>
__global__ void __launch_bounds__(kThreads)
heston_qe_kernel(float2* __restrict__ states, float2* __restrict__ zs,
                 float* __restrict__ us, const PointTable table, int num_points,
                 int num_steps, uint32_t num_paths, const HestonParams prm,
                 uint32_t seed, uint32_t phase) {
  const uint32_t path = blockIdx.x * blockDim.x + threadIdx.x;
  if (path >= num_paths) return;
  const uint2 key = make_uint2(seed, phase);

  const float sigma = prm.sigma, rate = prm.rate, rho = prm.rho;
  const float kappa = prm.kappa, theta = prm.theta;
  float log_s = logf(prm.spot);
  float v = prm.v0;

  for (int point = 0; point < num_points; ++point) {
    const float dt = table.dt[point];
    const size_t row = (size_t)point * num_paths + path;
    if (dt > 0.0f) {
      // ---- scalars (params x dt only) ----
      const float ekt = expf(-kappa * dt);
      const float one_m_ekt = 1.0f - ekt;
      const float sig2 = sigma * sigma;
      const float c_m = theta * one_m_ekt;
      const float c1 = sig2 * ekt * one_m_ekt / kappa;
      const float c2 = theta * sig2 * one_m_ekt * one_m_ekt / (2.0f * kappa);
      const float k0 = -rho * kappa * theta / sigma * dt;
      const float k1 = (kappa * rho / sigma - 0.5f) * dt - rho / sigma;
      const float k2 = rho / sigma;
      const float k3 = (1.0f - rho * rho) * dt;
      const float drift = rate * dt + k0;

      float z_s = 0.0f, z_v = 0.0f, u = 0.0f;
      for (int k = 0; k < num_steps; ++k) {
        const uint4 w = philox4x32_10(
            make_uint4(path, (uint32_t)(point * num_steps + k), 0u, 0u), key);
        const float u1 = uniform_from_word(w.x);
        const float u2 = uniform_from_word(w.y);
        u = uniform_from_word(w.z);
        const float r = sqrtf(-2.0f * logf(u1));
        const float ang = u2 * kTwoPi;
        z_s = r * cosf(ang);
        z_v = r * sinf(ang);

        // ---- per-path QE update ----
        const float m = c_m + v * ekt;
        const float s2 = v * c1 + c2;
        const float m2 = m * m + kEps;
        const float psi = s2 / m2;
        const float inv_psi = m2 / (s2 + kEps);

        const float tail = fmaxf(2.0f * inv_psi - 1.0f, 0.0f);
        const float b2 = fmaxf(tail + sqrtf(2.0f * inv_psi * tail), 0.0f);
        const float a = m / (1.0f + b2);
        const float sb2_z = sqrtf(b2) + z_v;
        const float v_quad = a * (sb2_z * sb2_z);

        const float p = fminf(fmaxf((psi - 1.0f) / (psi + 1.0f), 0.0f), kClipP);
        const float one_m_p = 1.0f - p;
        const float v_tail = logf(fmaxf(one_m_p, kEps) / fmaxf(1.0f - u, kEps)) *
                             (m + kEps) / (one_m_p + kEps);
        float v_next;
        if (kSmooth) {
          const float w_mass = fminf(fmaxf((u - p + 0.3f) * kInvSixTenths, 0.0f), 1.0f);
          const float v_exp = w_mass * v_tail;
          const float wsw = fminf(fmaxf(psi - 1.0f, 0.0f), 1.0f);
          v_next = (1.0f - wsw) * v_quad + wsw * v_exp;
        } else {
          const float v_exp = (u > p) ? v_tail : 0.0f;
          v_next = (psi > 1.5f) ? v_exp : v_quad;
        }
        const float vol = sqrtf(fmaxf(k3 * v, kEps));
        log_s = (log_s + drift) + k1 * v + k2 * v_next + vol * z_s;
        v = v_next;
      }
      if (kEmit) {
        zs[row] = make_float2(z_s, z_v);
        us[row] = u;
      }
    } else if (kEmit) {
      zs[row] = make_float2(0.0f, 0.0f);
      us[row] = 0.0f;
    }
    states[row] = make_float2(log_s, v);
  }
}

template <bool kSmooth, bool kEmit>
void launch(float2* states, float2* zs, float* us, const PointTable& table,
            int num_points, int num_steps, uint32_t num_paths,
            const HestonParams& prm, uint32_t seed, uint32_t phase,
            cudaStream_t stream) {
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  heston_qe_kernel<kSmooth, kEmit><<<blocks, kThreads, 0, stream>>>(
      states, zs, us, table, num_points, num_steps, num_paths, prm, seed,
      phase);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  Pointers are device
// pointers; z and u may be null unless emit_noise is set.  dts is a host
// array of num_points floats (the per-substep dt of each point).
extern "C" int mcre_heston_qe_paths(void* states, void* z, void* u,
                                    const void* dts, int num_points,
                                    int num_steps, uint32_t num_paths,
                                    float spot, float sigma, float rate,
                                    float rho, float kappa, float theta,
                                    float v0, uint32_t seed, uint32_t phase,
                                    int smoothing, int emit_noise,
                                    void* stream) {
  if (num_points < 0 || num_points > kMaxPoints || num_steps < 1 ||
      num_paths == 0 || states == nullptr ||
      (emit_noise && (z == nullptr || u == nullptr || num_steps != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  PointTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.dt, dts, sizeof(float) * (size_t)num_points);
  const HestonParams prm{spot, sigma, rate, rho, kappa, theta, v0};
  auto* s = static_cast<float2*>(states);
  auto* zz = static_cast<float2*>(z);
  auto* uu = static_cast<float*>(u);
  auto st = static_cast<cudaStream_t>(stream);
  if (smoothing) {
    if (emit_noise) {
      launch<true, true>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase, st);
    } else {
      launch<true, false>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase, st);
    }
  } else {
    if (emit_noise) {
      launch<false, true>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase, st);
    } else {
      launch<false, false>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase, st);
    }
  }
  return (int)cudaGetLastError();
}
