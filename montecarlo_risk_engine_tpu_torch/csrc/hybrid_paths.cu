// Hybrid-model path kernel for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel hybrid_paths
// (montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153) whole: the blocks
// bs, bs_multi, vasicek, cirpp, cirpp_det, hw and s2f, each in every scheme
// the TPU kernel gives it (pallas_hybrid.py:286-416), and the per-substep
// constants and initial state it computes in the kernel (_run_point :275,
// _init_cols :219).  The plain PyTorch version, op for op, is
// hybrid_paths_reference in ops/hybrid_paths.py (the table and the initial
// state: substep_table and initial_state there).
//
// What it computes: the joint paths of a standalone model or a ModelConfig.
// Per substep: sim_dim standard normals, w = L z through the static
// lower-triangular joint Cholesky factor, then each block's update.  Output
// [T, N, D] f32 in block order; exact bs / bs_multi keep log S and emit S
// (pallas_hybrid.py:465-468).
//
// Two kernels, launched back to back on the caller's stream, no host sync:
//   * table_kernel (mcre_hybrid_table): one thread per table row computes the
//     parameter-dependent columns in f64 from the device parameter vector
//     and the static host columns (dt, sqrt(dt), t1, lambda_mkt, f(0, t),
//     log F0, uploaded once per block list and timeline by the wrapper) and
//     rounds them once to f32: psi; decay and scale; alpha(t1),
//     alpha(t1 + dt); rho_c, std_x (with the kappa -> 0 guard), std_y.  Its
//     first threads also write the f32 parameter vector and the initial
//     state.  The op order is that of substep_table / initial_state, so the
//     table is bitwise the plain version's.
//   * hybrid_kernel (mcre_hybrid_paths), the paths:
//     - One thread per path, 256-thread blocks.  The state lives in
//       registers as one slot per noise factor, each slot holding at most two
//       state values a[s], b[s]: a bs_multi block is one slot per asset
//       (sharing the rate), vasicek / cirpp / cirpp_det / hw one slot (value,
//       log_B), and s2f two coupled slots (x with the derived log S, then y,
//       which reads the x slot's normal for its own rho).  A cirpp_det
//       slot's factor is drawn and not read, so the draw count matches the
//       TPU block layout.
//     - One library per block tuple: the slot count and each slot's role are
//       compile-time constants (-DMCRE_NS, -DMCRE_ROLES; ops/hybrid_paths.py
//       builds each tuple at its first use), so the role switch folds away
//       and every loop over slots, factors and Cholesky entries unrolls.  The
//       C entry refuses any other tuple.  Parameter indices, table columns,
//       output columns and the f32 Cholesky factor stay run-time values in a
//       struct passed by value; each slot's parameters are read once into
//       registers, and w = L z sums every entry of a row (a zero entry adds
//       an exact zero).
//     - Stores: each block stages its [256 x D] f32 tile of a point in shared
//       memory (two buffers, 2 * 256 * D * 4 bytes, at most 32 KB at D = 16)
//       and one thread writes the tile, contiguous in [T, N, D], with one
//       bulk copy (cp.async.bulk.global.shared::cta, the TMA engine).  The
//       copy of point t runs while the block draws point t + 1; before the
//       barrier that ends point t + 1 the issuing thread waits until the copy
//       of point t has read its buffer (cp.async.bulk.wait_group.read 0), so
//       the writes of point t + 2 into that buffer come after it.  A launch
//       whose tiles are not 16-byte aligned (N * D not a multiple of 4) and
//       the ragged last block of any launch store the same shared tile with
//       coalesced 4-byte stores by every thread instead.
//     - Draws: Philox4x32-10 keyed (seed, phase); call c at counter
//       (path, point * num_steps + k, c, 0) gives normals 4c .. 4c+3, each
//       word pair one Box-Muller pair (random.cuh).
//   * What bounds it: the SMs' issue slots.  At the north-star shapes
//     ([57, 1e6, 5]) the emission is 1.14 GB, 0.34 ms at 3.35 TB/s, while
//     the substep loop issues 284 instructions per path-substep (read from
//     the SASS by chip_smoke.py) over 5.6e7 path-substeps: 0.48 ms at one
//     warp instruction per scheduler per cycle; the launch takes 0.77 ms on
//     an H100 (700 W).  The design writes each state once, in whole
//     contiguous tiles, reads nothing per path, and keeps the substep to the
//     Philox calls, the Box-Muller pairs, the Cholesky sums and the slots'
//     updates.
//   * Local memory: with the bulk copy in the kernel, ptxas keeps the
//     7-word reduction array of sincosf's large-argument path in local
//     memory (32 bytes of stack).  The angles lie in [0, 2 pi), so that path
//     never runs; chip_smoke.py fails a build whose ptxas report shows a
//     spill in either kernel or a larger stack frame.
//   * Built with -fmad=false and without fast math: every expression rounds
//     like the separate torch ops of the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "random.cuh"

// The block tuple this library is built for (ops/hybrid_paths.py
// role_flags): MCRE_NS slots, slot s of role (MCRE_ROLES >> 4 s) & 15.
#if !defined(MCRE_NS) || !defined(MCRE_ROLES)
#error "build with -DMCRE_NS=<slots> -DMCRE_ROLES=<role of slot s in bits 4s..4s+3>"
#endif

namespace {

constexpr int kMaxSim = 8;             // slots = noise factors
constexpr int kMaxGroups = kMaxSim;    // every block draws at least one factor
constexpr int kMaxState = 2 * kMaxSim; // at most two state columns per slot
constexpr int kThreads = 256;
constexpr int kTableThreads = 128;
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

// Table column groups of the prologue (ops/hybrid_paths.py TAB_*): a block's
// parameter-dependent columns, read from the parameters at its base.
enum TableKind : int {
  kTabVasExact = 0,   // decay, scale; sigma = p[1], a = p[3]
  kTabCirpp = 1,      // psi(t1); kappa, theta, sigma, y0 = p[0 .. 3]; host lambda(t1)
  kTabCirppDet = 2,   // host lambda(t1), lambda(t1 + dt)
  kTabHwEuler = 3,    // alpha(t1), alpha(t1 + dt); sigma, a = p[0], p[1]; host f(0, .)
  kTabHwExact = 4,    // the same, then decay, scale
  kTabS2fEuler = 5,   // host log F0(t1 + dt), rho_c; rho = p[5]
  kTabS2fExact = 6,   // the same, then decay, std_x, std_y; kappa, sig_s, sig_l = p[1, 2, 4]
};

struct TableDesc {
  int rows;
  int host_width;
  int table_width;
  int num_params;
  int state_dim;
  int num_groups;
  double calibration_date;
  int kind[kMaxGroups];
  int pbase[kMaxGroups];
  int hcol[kMaxGroups];  // first host column of the group
  int tcol[kMaxGroups];  // first table column of the group
  int init_src[kMaxState];  // parameter index of the initial value, -1: init_const
  int init_log[kMaxState];  // 1: the log of the parameter (exact GBM)
  double init_const[kMaxState];
};

constexpr int kNs = MCRE_NS;
constexpr int kS = kNs <= 4 ? 4 : kMaxSim;  // register slots: a whole Philox call's normals
static_assert(kNs >= 1 && kNs <= kMaxSim, "MCRE_NS out of range");

__host__ __device__ constexpr int role_of(int s) { return (MCRE_ROLES >> (4 * s)) & 15; }

// Parameters each role reads from pa on (the switch in hybrid_kernel).
__host__ __device__ constexpr int params_of(int role) {
  return role == kVasEuler || role == kCirpp ? 3
         : role == kHwEuler || role == kS2fYEuler ? 2
         : role == kCirppDet || role == kHwExact || role == kS2fXExact ? 0 : 1;
}

struct Desc {
  int state_dim;
  int table_width;
  int pa[kMaxSim];
  int pb[kMaxSim];
  int tcol[kMaxSim];
  int oa[kMaxSim];
  int ob[kMaxSim];                // -1: the slot has no second value
  float chol[kMaxSim * kMaxSim];  // row-major, lower triangular
};

// Exact Ornstein-Uhlenbeck step: decay = exp(-a dt), scale =
// sqrt(sigma^2 / (2a) (1 - decay^2)).
__device__ __forceinline__ void ou_columns(double sigma, double a, double dt, float* col) {
  const double decay = exp(-a * dt);
  col[0] = (float)decay;
  col[1] = (float)sqrt((sigma * sigma / (2.0 * a)) * (1.0 - decay * decay));
}

__global__ void __launch_bounds__(kTableThreads)
table_kernel(float* __restrict__ table, float* __restrict__ prm32, float* __restrict__ init,
             const double* __restrict__ host, const double* __restrict__ prm, const TableDesc d) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < d.num_params) prm32[i] = (float)prm[i];
  if (i < d.state_dim) {
    const int src = d.init_src[i];
    const double v = src < 0 ? d.init_const[i] : (d.init_log[i] ? log(prm[src]) : prm[src]);
    init[i] = (float)v;
  }
  if (i >= d.rows) return;
  const double* h = host + (size_t)i * d.host_width;
  float* row = table + (size_t)i * d.table_width;
  const double dt = h[0];
  if (!(dt > 0.0)) {  // a zero-length point's rows are zeros
    for (int c = 0; c < d.table_width; ++c) row[c] = 0.0f;
    return;
  }
  const double t1 = h[2];
  row[0] = (float)dt;
  row[1] = (float)h[1];
  for (int g = 0; g < d.num_groups; ++g) {
    const double* p = prm + d.pbase[g];
    const double* hc = h + d.hcol[g];
    float* tc = row + d.tcol[g];
    switch (d.kind[g]) {
      case kTabVasExact:
        ou_columns(p[1], p[3], dt, tc);
        break;
      case kTabCirpp: {  // psi(t1) = lambda_mkt(t1) + D(t1) - y0 E(t1)
        const double kappa = p[0], theta = p[1], sigma = p[2], y0 = p[3];
        const double hh = sqrt(kappa * kappa + 2.0 * sigma * sigma);
        const double et = exp(hh * t1);
        const double den = 2.0 * hh + (kappa + hh) * (et - 1.0);
        const double d_term = (2.0 * kappa * theta / (sigma * sigma)) *
                              (0.5 * (kappa + hh) - hh * (kappa + hh) * et / den);
        const double e_term = 4.0 * hh * hh * et / (den * den);
        tc[0] = (float)(hc[0] + d_term - y0 * e_term);
        break;
      }
      case kTabCirppDet:
        tc[0] = (float)hc[0];
        tc[1] = (float)hc[1];
        break;
      case kTabHwEuler:
      case kTabHwExact: {  // alpha(t) = f(0, t) + sigma^2 / (2 a^2) (1 - exp(-a (t - t0)))^2
        const double sigma = p[0], a = p[1];
        const double s2a = sigma * sigma / (2.0 * a * a);
        const double d1 = t1 - d.calibration_date;
        const double d2 = d1 + dt;
        // One exp at a time: two interleaved f64 exps made ptxas spill.
#pragma unroll 1
        for (int j = 0; j < 2; ++j) {
          const double gj = 1.0 - exp(-a * (j == 0 ? d1 : d2));
          tc[j] = (float)(hc[j] + s2a * (gj * gj));
        }
        if (d.kind[g] == kTabHwExact) ou_columns(sigma, a, dt, tc + 2);
        break;
      }
      case kTabS2fEuler:
      case kTabS2fExact: {
        const double kappa = p[1], sig_s = p[2], sig_l = p[4], rho = p[5];
        tc[0] = (float)hc[0];
        tc[1] = (float)sqrt(fmax(1.0 - rho * rho, 0.0));
        if (d.kind[g] == kTabS2fExact) {
          const bool near0 = fabs(kappa) < 1e-12;  // pallas_hybrid.py:395-406
          const double k_safe = near0 ? 1.0 : kappa;
          const double decay = near0 ? 1.0 : exp(-kappa * dt);
          const double var_x = near0 ? sig_s * sig_s * dt
                                     : (sig_s * sig_s / (2.0 * k_safe)) * (1.0 - decay * decay);
          tc[2] = (float)decay;
          tc[3] = (float)sqrt(var_x);
          tc[4] = (float)(sig_l * h[1]);
        }
        break;
      }
    }
  }
}

__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, uint32_t bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(reinterpret_cast<uint64_t>(gmem)), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// kBulk: the tiles of this launch are 16-byte aligned, so full blocks store
// by bulk copy.  Four blocks per SM (at most 64 registers): left to itself
// ptxas gave the 7-slot tuple's coalesced instance 48 registers and spilled.
template <bool kBulk>
__global__ void __launch_bounds__(kThreads, 4)
hybrid_kernel(float* __restrict__ out, const float* __restrict__ prm,
              const float* __restrict__ table, const float* __restrict__ init, const Desc d,
              int num_points, int num_steps, uint32_t num_paths, uint32_t seed,
              uint32_t phase, uint32_t path_offset, uint32_t path_stride) {
  extern __shared__ __align__(128) float tiles[];  // [2][kThreads * state_dim]
  const uint32_t first = blockIdx.x * kThreads;
  const uint32_t path = first + threadIdx.x;  // may pass num_paths in the last block
  const uint32_t global_path = path_offset + path_stride * path;  // the Philox counter's
  const uint32_t rows = min(num_paths - first, (uint32_t)kThreads);
  const bool bulk = kBulk && rows == (uint32_t)kThreads;  // uniform in the block
  const int dim = d.state_dim;
  const uint2 key = make_uint2(seed, phase);
  constexpr int S = kS;

  // The state, and each slot's parameters (prm[pa], prm[pa + 1],
  // prm[pa + 2], prm[pb]) in registers for the whole run.
  float a[S], b[S], q0[S], q1[S], q2[S], qb[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s] = b[s] = q0[s] = q1[s] = q2[s] = qb[s] = 0.0f;
    if (s < kNs) {
      a[s] = __ldg(init + d.oa[s]);
      if (d.ob[s] >= 0) b[s] = __ldg(init + d.ob[s]);
      if (params_of(role_of(s)) > 0) q0[s] = __ldg(prm + d.pa[s]);
      if (params_of(role_of(s)) > 1) q1[s] = __ldg(prm + d.pa[s] + 1);
      if (params_of(role_of(s)) > 2) q2[s] = __ldg(prm + d.pa[s] + 2);
      qb[s] = __ldg(prm + d.pb[s]);
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
          const uint4 w4 = mcre::philox4x32_10(make_uint4(global_path, counter, (uint32_t)c, 0u),
                                                 key);
          const float2 p0 = mcre::box_muller(w4.x, w4.y);
          const float2 p1 = mcre::box_muller(w4.z, w4.w);
          z[4 * c] = p0.x;
          z[4 * c + 1] = p0.y;
          z[4 * c + 2] = p1.x;
          z[4 * c + 3] = p1.y;
        }
        // w = L z, each row's products summed left to right.
        float w[S];
#pragma unroll
        for (int i = 0; i < kNs; ++i) {
          w[i] = d.chol[i * kMaxSim] * z[0];
#pragma unroll
          for (int e = 1; e <= i; ++e) w[i] = w[i] + d.chol[i * kMaxSim + e] * z[e];
        }

#pragma unroll
        for (int s = 0; s < kNs; ++s) {
          const float* tc = row + d.tcol[s];
          const int xs = s > 0 ? s - 1 : 0;  // the x slot of an s2f y slot
          switch (role_of(s)) {
            case kGbmExact: {  // log S' = log S + (r - sigma^2/2) dt + sigma sqrt(dt) w
              const float sigma = q0[s], rate = qb[s];
              a[s] = a[s] + (rate - 0.5f * sigma * sigma) * dt + sigma * sqrt_dt * w[s];
              break;
            }
            case kGbmEuler: {  // S' = S (1 + r dt) + sigma S sqrt(dt) w
              const float sigma = q0[s], rate = qb[s];
              a[s] = a[s] * (1.0f + rate * dt) + sigma * a[s] * sqrt_dt * w[s];
              break;
            }
            case kVasExact: {  // log_B += r dt; r' = theta + (r - theta) decay + scale w
              const float theta = q0[s];
              b[s] = b[s] + a[s] * dt;
              a[s] = theta + (a[s] - theta) * __ldg(tc) + __ldg(tc + 1) * w[s];
              break;
            }
            case kVasEuler: {  // log_B += r dt; r' = r + a (theta - r) dt + sigma sqrt(dt) w
              const float sigma = q0[s], theta = q1[s], speed = q2[s];
              const float r = a[s];
              b[s] = b[s] + r * dt;
              a[s] = r + speed * (theta - r) * dt + sigma * sqrt_dt * w[s];
              break;
            }
            case kCirpp: {  // log_B += (y + psi) dt; full-truncation Euler on y
              const float kappa = q0[s], theta = q1[s], sigma = q2[s];
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
              if (role_of(s) == kHwExact) {
                x = x * __ldg(tc + 2) + __ldg(tc + 3) * w[s];
              } else {
                const float sigma = q0[s], speed = q1[s];
                x = x - speed * x * dt + sigma * sqrt_dt * w[s];
              }
              a[s] = x + __ldg(tc + 1);
              break;
            }
            case kS2fXExact:
              a[s] = a[s] * __ldg(tc + 2) + __ldg(tc + 3) * w[s];
              break;
            case kS2fXEuler: {
              const float kappa = q0[s], sig_s = qb[s];
              a[s] = a[s] - kappa * a[s] * dt + sig_s * sqrt_dt * w[s];
              break;
            }
            case kS2fYExact:
            case kS2fYEuler: {  // y' from rho w_x + rho_c w, then log S = log F0 + x' + y'
              const float mu = q0[s], rho = qb[s];
              const float drive = rho * w[xs] + __ldg(tc + 1) * w[s];
              if (role_of(s) == kS2fYExact) {
                a[s] = a[s] + mu * dt + __ldg(tc + 4) * drive;
              } else {
                a[s] = a[s] + mu * dt + q1[s] * sqrt_dt * drive;
              }
              b[xs] = __ldg(tc) + a[xs] + a[s];
              break;
            }
          }
        }
      }
    }

    // This thread's row of the point's tile, then the tile to [T, N, D].
    float* buf = tiles + (point & 1) * (kThreads * dim);
    float* mine = buf + threadIdx.x * dim;
#pragma unroll
    for (int s = 0; s < kNs; ++s) {
      mine[d.oa[s]] = role_of(s) == kGbmExact ? expf(a[s]) : a[s];
      if (d.ob[s] >= 0) mine[d.ob[s]] = b[s];
    }
    float* dst = out + ((size_t)point * num_paths + first) * dim;
    if (bulk) {
      fence_proxy_async_shared();  // the generic writes above, seen by the copy engine
      if (threadIdx.x == 0) bulk_wait_read_all();  // the other buffer's copy has read it
      __syncthreads();
      if (threadIdx.x == 0) bulk_store(dst, buf, (uint32_t)(kThreads * dim * sizeof(float)));
    } else {
      __syncthreads();
      for (uint32_t i = threadIdx.x; i < rows * dim; i += kThreads) dst[i] = buf[i];
    }
  }
  if (bulk && threadIdx.x == 0) bulk_wait_all();
}

template <bool kBulk>
int launch(float* out, const float* prm, const float* table, const float* init, const Desc& d,
           int num_points, int num_steps, uint32_t num_paths, uint32_t seed, uint32_t phase,
           uint32_t path_offset, uint32_t path_stride, cudaStream_t stream) {
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  const size_t smem = 2 * kThreads * d.state_dim * sizeof(float);  // <= 32 KB
  hybrid_kernel<kBulk><<<blocks, kThreads, smem, stream>>>(
      out, prm, table, init, d, num_points, num_steps, num_paths, seed, phase, path_offset,
      path_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  workspace, host and
// params are device pointers: workspace f32 [rows * table_width + num_params
// + state_dim] receives the table, the f32 parameters and the initial
// state; host f64 [rows, host_width] holds dt, sqrt(dt), t1 and the host
// curve columns; params f64 [num_params].  The group and initial-state
// arrays are host arrays.
extern "C" int mcre_hybrid_table(void* workspace, const void* host, const void* params,
                                 int rows, int host_width, int table_width, int num_params,
                                 int state_dim, int num_groups, const int* kind,
                                 const int* pbase, const int* hcol, const int* tcol,
                                 const int* init_src, const int* init_log,
                                 const double* init_const, double calibration_date,
                                 void* stream) {
  if (workspace == nullptr || host == nullptr || params == nullptr || rows < 1 ||
      host_width < 3 || table_width < 2 || num_params < 1 || state_dim < 1 ||
      state_dim > kMaxState || num_groups < 0 || num_groups > kMaxGroups) {
    return (int)cudaErrorInvalidValue;
  }
  TableDesc d = {};
  d.rows = rows;
  d.host_width = host_width;
  d.table_width = table_width;
  d.num_params = num_params;
  d.state_dim = state_dim;
  d.num_groups = num_groups;
  d.calibration_date = calibration_date;
  // Parameters each group reads from its base (p[1], p[3] of vasicek ...).
  constexpr int kGroupParams[] = {4, 4, 0, 2, 2, 6, 6};
  for (int g = 0; g < num_groups; ++g) {
    if (kind[g] < kTabVasExact || kind[g] > kTabS2fExact || pbase[g] < 0 ||
        pbase[g] + kGroupParams[kind[g]] > num_params || hcol[g] < 3 ||
        hcol[g] > host_width || tcol[g] < 2 || tcol[g] >= table_width) {
      return (int)cudaErrorInvalidValue;
    }
    d.kind[g] = kind[g];
    d.pbase[g] = pbase[g];
    d.hcol[g] = hcol[g];
    d.tcol[g] = tcol[g];
  }
  for (int j = 0; j < state_dim; ++j) {
    if (init_src[j] >= num_params) return (int)cudaErrorInvalidValue;
    d.init_src[j] = init_src[j];
    d.init_log[j] = init_log[j];
    d.init_const[j] = init_const[j];
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  float* table = static_cast<float*>(workspace);
  float* prm32 = table + (size_t)rows * table_width;
  float* init = prm32 + num_params;
  int n = rows > num_params ? rows : num_params;
  n = n > state_dim ? n : state_dim;
  table_kernel<<<(n + kTableThreads - 1) / kTableThreads, kTableThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      table, prm32, init, static_cast<const double*>(host), static_cast<const double*>(params),
      d);
  return (int)cudaGetLastError();
}

// Returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// for a block tuple other than the one this library was built for).  out,
// params, table and init are device pointers: out [num_points, num_paths,
// state_dim] f32, params [P] f32, table [num_points * num_steps,
// table_width] f32, init [state_dim] f32.  The slot arrays (length
// num_slots) and chol (num_slots^2, row-major) are host arrays.  Row i of
// out draws global path path_offset + path_stride * i (below 2^32): a rank
// of a path-sharded run writes its own paths as its own contiguous plane.
extern "C" int mcre_hybrid_paths(void* out, const void* params, const void* table,
                                 const void* init, int num_slots, const int* role,
                                 const int* pa, const int* pb, const int* tcol, const int* oa,
                                 const int* ob, const float* chol, int state_dim,
                                 int table_width, int num_points, int num_steps,
                                 uint32_t num_paths, uint32_t seed, uint32_t phase,
                                 uint32_t path_offset, uint32_t path_stride, void* stream) {
  if (num_slots != kNs || num_points < 0 || num_steps < 1 || num_paths == 0 ||
      !mcre::valid_path_stride(num_paths, path_offset, path_stride) ||
      out == nullptr || params == nullptr || table == nullptr || init == nullptr ||
      table_width < 2 || state_dim < 1 || state_dim > kMaxState) {
    return (int)cudaErrorInvalidValue;
  }
  Desc d = {};
  d.state_dim = state_dim;
  d.table_width = table_width;
  for (int s = 0; s < num_slots; ++s) {
    const bool y_slot = role[s] == kS2fYExact || role[s] == kS2fYEuler;
    if (role[s] != role_of(s) || (y_slot && s == 0) || oa[s] < 0 || oa[s] >= state_dim ||
        ob[s] >= state_dim || tcol[s] < 0 || tcol[s] >= table_width || pa[s] < 0 || pb[s] < 0) {
      return (int)cudaErrorInvalidValue;
    }
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
  // Bulk copies need 16-byte aligned tiles: every point's first row lies at
  // point * num_paths * state_dim floats from out.
  const bool bulk = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                    ((uint64_t)num_paths * state_dim) % 4 == 0;
  return bulk ? launch<true>(o, p, t, i0, d, num_points, num_steps, num_paths, seed, phase,
                             path_offset, path_stride, st)
              : launch<false>(o, p, t, i0, d, num_points, num_steps, num_paths, seed, phase,
                              path_offset, path_stride, st);
}
