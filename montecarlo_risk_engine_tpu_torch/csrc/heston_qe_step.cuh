// One Andersen-QE substep, shared by the Heston path kernel K1
// (heston_qe.cu) and the substep ladder (heston_ladder.cu), and the launch
// both take: 256-thread blocks, one thread per path, and the per-point dt
// table passed by value (the kernel parameter space is constant memory).
//
// The algebra of the TPU kernel's _heston_qe_substep
// (montecarlo_risk_engine_tpu/ops/pallas_paths.py:79), op for op as
// heston_qe_substep in ops/heston_qe.py repeats it: the scalars that depend
// only on (params, dt) once per timeline point (qe_scalars), then the
// per-path update (qe_update).  Built with -fmad=false, every expression
// rounds like the separate torch ops of the plain versions; moving K1's
// code here changed none of its operations or their order.

#pragma once

#include <stdint.h>
#include <string.h>

namespace mcre {

constexpr int kMaxPoints = 512;
constexpr int kThreads = 256;

struct PointTable {
  float dt[kMaxPoints];
};

// The table of a host array of num_points per-substep dts, zeros after them.
inline PointTable point_table(const void* dts, int num_points) {
  PointTable table;
  memset(&table, 0, sizeof(table));
  memcpy(table.dt, dts, sizeof(float) * (size_t)num_points);
  return table;
}

// The checks both C entry points make on the arguments they share.
inline bool valid_paths_launch(int num_points, int num_steps, uint32_t num_paths,
                               const void* states, const void* params) {
  return num_points >= 0 && num_points <= kMaxPoints && num_steps >= 1 && num_paths != 0 &&
         states != nullptr && params != nullptr;
}

constexpr float kQeEps = (float)1e-12;
constexpr float kQeClipP = (float)(1.0 - 1e-6);
constexpr float kInvSixTenths = (float)(1.0 / 0.6);

struct QeScalars {
  float ekt, c_m, c1, c2, k1, k2, k3, drift;
};

// m = c_m + v * ekt, s2 = v * c1 + c2, and the log-spot coefficients.
__device__ __forceinline__ QeScalars qe_scalars(float dt, float sigma, float rate,
                                                float rho, float kappa, float theta) {
  QeScalars s;
  s.ekt = expf(-kappa * dt);
  const float one_m_ekt = 1.0f - s.ekt;
  const float sig2 = sigma * sigma;
  s.c_m = theta * one_m_ekt;
  s.c1 = sig2 * s.ekt * one_m_ekt / kappa;
  s.c2 = theta * sig2 * one_m_ekt * one_m_ekt / (2.0f * kappa);
  const float k0 = -rho * kappa * theta / sigma * dt;
  s.k1 = (kappa * rho / sigma - 0.5f) * dt - rho / sigma;
  s.k2 = rho / sigma;
  s.k3 = (1.0f - rho * rho) * dt;
  s.drift = rate * dt + k0;
  return s;
}

// The per-path update of (log S, v) on the draws (z_s, z_v, u).
// kSmooth: the fuzzy branch indicators (widths 0.3 / 0.5) of the
// differentiated runs.  kAlgebra: the division-reduced update of
// benchmarks/kernel_decomposition.py:160 (hard branches only): no
// psi = s2 / m2; p = (s2 - m2) / (s2 + m2) and the branch s2 > 1.5 m2, the
// same map up to where the psi test rounds.
template <bool kSmooth, bool kAlgebra = false>
__device__ __forceinline__ void qe_update(const QeScalars& c, float z_s, float z_v, float u,
                                          float& log_s, float& v) {
  static_assert(!(kSmooth && kAlgebra), "the division-reduced update has hard branches only");
  const float m = c.c_m + v * c.ekt;
  const float s2 = v * c.c1 + c.c2;
  const float m2 = m * m + kQeEps;
  const float psi = kAlgebra ? 0.0f : s2 / m2;
  const float inv_psi = m2 / (s2 + kQeEps);

  const float tail = fmaxf(2.0f * inv_psi - 1.0f, 0.0f);
  const float b2 = fmaxf(tail + sqrtf(2.0f * inv_psi * tail), 0.0f);
  const float a = m / (1.0f + b2);
  const float sb2_z = sqrtf(b2) + z_v;
  const float v_quad = a * (sb2_z * sb2_z);

  const float p_raw = kAlgebra ? (s2 - m2) / (s2 + m2) : (psi - 1.0f) / (psi + 1.0f);
  const float p = fminf(fmaxf(p_raw, 0.0f), kQeClipP);
  const float one_m_p = 1.0f - p;
  const float v_tail = logf(fmaxf(one_m_p, kQeEps) / fmaxf(1.0f - u, kQeEps)) *
                       (m + kQeEps) / (one_m_p + kQeEps);
  float v_next;
  if (kSmooth) {
    const float w_mass = fminf(fmaxf((u - p + 0.3f) * kInvSixTenths, 0.0f), 1.0f);
    const float v_exp = w_mass * v_tail;
    const float wsw = fminf(fmaxf(psi - 1.0f, 0.0f), 1.0f);
    v_next = (1.0f - wsw) * v_quad + wsw * v_exp;
  } else {
    const float v_exp = (u > p) ? v_tail : 0.0f;
    const bool exp_branch = kAlgebra ? s2 > 1.5f * m2 : psi > 1.5f;
    v_next = exp_branch ? v_exp : v_quad;
  }
  const float vol = sqrtf(fmaxf(c.k3 * v, kQeEps));
  log_s = (log_s + c.drift) + c.k1 * v + c.k2 * v_next + vol * z_s;
  v = v_next;
}

}  // namespace mcre
