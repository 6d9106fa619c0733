// Forward-mode path reconstruction for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The JAX package rebuilds the kernel's path on the
// frozen draws (montecarlo_risk_engine_tpu/ops/pallas_paths_ad.py
// _reconstruct) under jit, where XLA fuses the rebuild and its tangents.
// The port runs eagerly, and under vmap(jvp) the same rebuild was tens of
// thousands of small float64 kernels a run, whose host dispatch kept the card
// idle.  This kernel does one phase's rebuild, or its tangents for one sweep
// of c directions, in one launch.  The plain PyTorch version, op for op, is
// recon_planes_reference in ops/recon_tangents.py.
//
// What it computes: from the frozen standard normals z [T', N, S] of the
// substep-dense timeline, the coarse plane [T, N, D] (MCRE_C = 0) or its c
// tangent planes [c, T, N, D] (MCRE_C = c) of Vasicek, Black-Scholes and
// CIR++ Euler blocks.  Per dense step with length: noise = z L^T (each row's
// S products summed in index order), then each slot's Euler step in float64
// with every value's tangents beside it, each tangent by the rule
// torch.func.jvp applies to the op (Dual below).  L carries no tangent: the
// correlation of these blocks is static under EULER, so the noise has none.
//
// Design:
//   * One thread per path, 128-thread blocks.  The state (one slot per noise
//     factor, a value and its log_B where the block has one) and its c
//     tangents live in registers: 45 doubles for the north star's five
//     columns at c = 8.
//   * The parameters and their tangents, L, and the per-step columns (live,
//     dt, sqrt(dt), the coarse point it emits, CIR++'s psi and its tangents)
//     are the same for every path: they sit in shared memory and are read as
//     broadcasts.  The step columns are staged kChunk steps at a time.
//   * Stores: at each emitted point every plane's [128 x D] tile goes through
//     shared memory (two buffers, one barrier a plane) and out with coalesced
//     8-byte stores, contiguous in [T, N, D].
//   * One library per tuple of slot roles and tangent count (-DMCRE_NS,
//     -DMCRE_ROLES as K2's, -DMCRE_C; ops/recon_tangents.py load_builds): the
//     role switch folds away and every loop over slots, factors and tangents
//     unrolls.  The C entry refuses any other tuple or count.
//   * What bounds it: the bytes written.  At the north-star shapes ([57, 1e6,
//     5], c = 8) the tangent planes are 18.2 GB and the draws 1.4 GB, 5.9 ms
//     at 3.35 TB/s; the arithmetic is about 40 float64 operations a tangent a
//     slot-step, under 1 ms at the card's float64 rate.
//   * No host sync, no allocation: the wrapper allocates the planes and
//     launches on the current stream.  Built with -fmad=false and without
//     fast math: every expression rounds like the separate torch ops.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(MCRE_NS) || !defined(MCRE_ROLES) || !defined(MCRE_C)
#error "build with -DMCRE_NS=<slots> -DMCRE_ROLES=<role of slot s in bits 4s..4s+3> -DMCRE_C=<tangents>"
#endif

namespace {

constexpr int kThreads = 128;
constexpr double kYFloor = 1e-12;

// Slot roles (ops/hybrid_paths.py GBM_EULER, VAS_EULER, CIRPP).
enum Role : int {
  kGbmEuler = 1,  // a = S; sigma = prm[pa], rate = prm[pb]
  kVasEuler = 3,  // a = r, b = log_B; sigma, theta, speed = prm[pa .. pa + 2]
  kCirpp = 4,     // a = y, b = log_B; kappa, theta, sigma = prm[pa .. pa + 2]; psi column
};

constexpr int kNs = MCRE_NS;
constexpr int kC = MCRE_C;
constexpr int kT = kC > 0 ? kC : 1;  // tangent array length (unused at kC = 0)
constexpr int kPlanes = kC > 0 ? kC : 1;
static_assert(kNs >= 1 && kNs <= 8, "MCRE_NS out of range");
static_assert(kC >= 0 && kC <= 8, "MCRE_C out of range");

__host__ __device__ constexpr int role_of(int s) { return (MCRE_ROLES >> (4 * s)) & 15; }
__host__ __device__ constexpr bool has_b(int role) { return role != kGbmEuler; }

constexpr bool roles_valid() {
  for (int s = 0; s < kNs; ++s) {
    const int r = role_of(s);
    if (r != kGbmEuler && r != kVasEuler && r != kCirpp) return false;
  }
  return true;
}
static_assert(roles_valid(), "MCRE_ROLES holds a role this kernel does not rebuild");

constexpr int count_cirpp() {
  int k = 0;
  for (int s = 0; s < kNs; ++s) k += role_of(s) == kCirpp;
  return k;
}
constexpr int state_width() {
  int d = 0;
  for (int s = 0; s < kNs; ++s) d += has_b(role_of(s)) ? 2 : 1;
  return d;
}
// psi row of slot s: its rank among the CIR++ slots.
__host__ __device__ constexpr int psi_row(int s) {
  int k = 0;
  for (int i = 0; i < s; ++i) k += role_of(i) == kCirpp;
  return k;
}

constexpr int kK = count_cirpp();
constexpr int kD = state_width();
constexpr int kMaxP = 4 * kNs;                // every supported block has at most 4 parameters
constexpr int kW = 4 + (kK > 0 ? kK * (1 + kC) : 0);  // a staged step: live, dt, sqrt(dt), emit, psi
constexpr int kPsiW = kK > 0 ? kK : 1;
// Dense steps of the step columns staged at a time: as many as fit, up to
// 32, beside the parameters, L and the two tiles in 44 KB of static shared
// memory (at most 39 KB for those: 8 CIR++ slots, D = 16, kC = 8).
constexpr int kFixedBytes =
    ((1 + kC) * kMaxP + kNs * kNs + 2 * kThreads * kD) * (int)sizeof(double);
constexpr int kFit = (44 * 1024 - kFixedBytes) / (kW * (int)sizeof(double));
constexpr int kChunk = kFit < 1 ? 1 : kFit > 32 ? 32 : kFit;

struct Desc {
  int num_params;
  int pa[kNs];
  int pb[kNs];
  int oa[kNs];
  int ob[kNs];   // -1: none
  int init[kD];  // parameter index of each state column's start, -1: 0
};

// A float64 value and its kC tangents.  Each op's tangent is the rule
// torch.func.jvp applies: x * y: x' y + x y' (two products, summed); x * k
// with a constant k: x' k; x + y, x - y: x' + y', x' - y'; sqrt(x): x' /
// (2 sqrt(x)); clamp(x, min=m): x' where x >= m, else 0.
struct Dual {
  double v;
  double t[kT];
};

__device__ __forceinline__ Dual add(const Dual& x, const Dual& y) {
  Dual r;
  r.v = x.v + y.v;
#pragma unroll
  for (int j = 0; j < kC; ++j) r.t[j] = x.t[j] + y.t[j];
  return r;
}

__device__ __forceinline__ Dual sub(const Dual& x, const Dual& y) {
  Dual r;
  r.v = x.v - y.v;
#pragma unroll
  for (int j = 0; j < kC; ++j) r.t[j] = x.t[j] - y.t[j];
  return r;
}

__device__ __forceinline__ Dual mul(const Dual& x, const Dual& y) {
  Dual r;
  r.v = x.v * y.v;
#pragma unroll
  for (int j = 0; j < kC; ++j) r.t[j] = x.t[j] * y.v + x.v * y.t[j];
  return r;
}

__device__ __forceinline__ Dual mulc(const Dual& x, double k) {
  Dual r;
  r.v = x.v * k;
#pragma unroll
  for (int j = 0; j < kC; ++j) r.t[j] = x.t[j] * k;
  return r;
}

__device__ __forceinline__ Dual sqrt_(const Dual& x) {
  Dual r;
  r.v = sqrt(x.v);
  const double two_v = 2.0 * r.v;
#pragma unroll
  for (int j = 0; j < kC; ++j) r.t[j] = x.t[j] / two_v;
  return r;
}

// torch.clamp(x, min=m): a NaN stays NaN; the tangent passes where x >= m.
__device__ __forceinline__ Dual clamp_min(const Dual& x, double m) {
  Dual r;
  r.v = x.v < m ? m : x.v;
  const bool pass = x.v >= m;
#pragma unroll
  for (int j = 0; j < kC; ++j) r.t[j] = pass ? x.t[j] : 0.0;
  return r;
}

__global__ void __launch_bounds__(kThreads)
recon_kernel(double* __restrict__ out, const double* __restrict__ z,
             const double* __restrict__ steps, const double* __restrict__ prm,
             const double* __restrict__ prm_t, const double* __restrict__ psi,
             const double* __restrict__ psi_t, const double* __restrict__ chol, const Desc d,
             int num_dense, int num_coarse, uint32_t num_paths) {
  // Value, then tangent j at (1 + j) * kMaxP.
  __shared__ double s_prm[(1 + kC) * kMaxP];
  __shared__ double s_chol[kNs * kNs];
  __shared__ double s_rows[kChunk * kW];
  __shared__ double s_tile[2][kThreads * kD];

  for (int i = threadIdx.x; i < (1 + kC) * kMaxP; i += kThreads) {
    const int j = i / kMaxP, p = i % kMaxP;
    s_prm[i] = p >= d.num_params ? 0.0 : j == 0 ? prm[p] : prm_t[(j - 1) * d.num_params + p];
  }
  for (int i = threadIdx.x; i < kNs * kNs; i += kThreads) s_chol[i] = chol[i];
  __syncthreads();

  const uint32_t first = blockIdx.x * kThreads;
  const uint32_t path = first + threadIdx.x;  // may pass num_paths in the last block
  const bool mine = path < num_paths;
  const uint32_t rows = min(num_paths - first, (uint32_t)kThreads);

  auto param = [&](int p) {
    Dual x;
    x.v = s_prm[p];
#pragma unroll
    for (int j = 0; j < kC; ++j) x.t[j] = s_prm[(1 + j) * kMaxP + p];
    return x;
  };
  auto start = [&](int col) {  // a state column's parameter, or 0 with no tangent
    if (d.init[col] >= 0) return param(d.init[col]);
    Dual x;
    x.v = 0.0;
#pragma unroll
    for (int j = 0; j < kC; ++j) x.t[j] = 0.0;
    return x;
  };

  Dual a[kNs], b[kNs];
#pragma unroll
  for (int s = 0; s < kNs; ++s) {
    a[s] = start(d.oa[s]);
    if (has_b(role_of(s))) b[s] = start(d.ob[s]);
  }

  // This step's draws, the next step's loaded ahead.
  double zc[kNs], zn[kNs];
#pragma unroll
  for (int k = 0; k < kNs; ++k) zn[k] = mine ? __ldg(z + (size_t)path * kNs + k) : 0.0;
  int flip = 0;

  for (int i = 0; i < num_dense; ++i) {
    if (i % kChunk == 0) {  // stage the next kChunk steps' columns
      __syncthreads();
      const int n = min(kChunk, num_dense - i);
      for (int e = threadIdx.x; e < n * kW; e += kThreads) {
        const int r = e / kW, c = e % kW, step = i + r;
        double v;
        if (c < 4) {
          v = steps[(size_t)step * 4 + c];
        } else if (c < 4 + kK) {
          v = psi[(size_t)(c - 4) * num_dense + step];
        } else {  // tangent j of psi row k at column 4 + kK + j * kK + k
          const int jk = c - 4 - kK;
          v = psi_t == nullptr ? 0.0 : psi_t[((size_t)jk * num_dense) + step];
        }
        s_rows[e] = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kNs; ++k) {
      zc[k] = zn[k];
      const size_t next = ((size_t)(i + 1) * num_paths + path) * kNs + k;
      zn[k] = mine && i + 1 < num_dense ? __ldg(z + next) : 0.0;
    }
    const double* row = s_rows + (i % kChunk) * kW;
    if (row[0] != 0.0) {
      const double dt = row[1], sqrt_dt = row[2];
#pragma unroll
      for (int s = 0; s < kNs; ++s) {
        // noise = z L^T: row s of L against z, summed in index order.
        double noise = zc[0] * s_chol[s * kNs];
#pragma unroll
        for (int k = 1; k < kNs; ++k) noise = noise + zc[k] * s_chol[s * kNs + k];
        const int pa = d.pa[s];
        switch (role_of(s)) {
          case kGbmEuler: {  // S + r S dt + sigma S sqrt(dt) w
            const Dual sigma = param(pa), rate = param(d.pb[s]);
            const Dual x = a[s];
            a[s] = add(add(x, mulc(mul(rate, x), dt)),
                       mulc(mulc(mul(sigma, x), sqrt_dt), noise));
            break;
          }
          case kVasEuler: {  // log_B + r dt; r + a (theta - r) dt + sigma sqrt(dt) w
            const Dual sigma = param(pa), theta = param(pa + 1), speed = param(pa + 2);
            const Dual r = a[s];
            b[s] = add(b[s], mulc(r, dt));
            a[s] = add(add(r, mulc(mul(speed, sub(theta, r)), dt)),
                       mulc(mulc(sigma, sqrt_dt), noise));
            break;
          }
          case kCirpp: {  // full-truncation Euler on y; log_B + (y + psi) dt
            const Dual kappa = param(pa), theta = param(pa + 1), sigma = param(pa + 2);
            const Dual y = a[s];
            Dual shift;
            shift.v = row[4 + psi_row(s)];
#pragma unroll
            for (int j = 0; j < kC; ++j) shift.t[j] = row[4 + kK + j * kPsiW + psi_row(s)];
            const Dual sqrt_y = sqrt_(clamp_min(y, 0.0));
            const Dual y_next =
                add(add(y, mulc(mul(kappa, sub(theta, y)), dt)),
                    mulc(mulc(mul(sigma, sqrt_y), sqrt_dt), noise));
            b[s] = add(b[s], mulc(add(y, shift), dt));
            a[s] = clamp_min(y_next, kYFloor);
            break;
          }
        }
      }
    }
    const int emit = (int)row[3];
    if (emit >= 0) {  // every plane's tile of this point, through shared memory
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        double* buf = s_tile[flip];
        flip ^= 1;
        double* my = buf + threadIdx.x * kD;
#pragma unroll
        for (int s = 0; s < kNs; ++s) {
          my[d.oa[s]] = kC > 0 ? a[s].t[p] : a[s].v;
          if (has_b(role_of(s))) my[d.ob[s]] = kC > 0 ? b[s].t[p] : b[s].v;
        }
        __syncthreads();  // also: the buffer's copy two planes ago is done
        double* dst = out + (((size_t)p * num_coarse + emit) * num_paths + first) * kD;
        for (uint32_t e = threadIdx.x; e < rows * kD; e += kThreads) dst[e] = buf[e];
      }
    }
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// for another tuple of roles, another tangent count or bad arguments).  out,
// z, steps, params, params_t, psi, psi_t and chol are device pointers to
// float64: out [num_tangents or 1, num_coarse, num_paths,
// state_dim]; z [num_dense, num_paths, num_slots]; steps [num_dense, 4]
// (live, dt, sqrt(dt), emitted coarse point or -1); params [num_params];
// params_t [num_tangents, num_params]; psi [K, num_dense] and psi_t
// [num_tangents, K, num_dense] for the K CIR++ slots (psi_t may be null: no
// tangent); chol [num_slots, num_slots].  The slot arrays (length num_slots)
// and init (state_dim) are host arrays.
extern "C" int mcre_recon_tangents(void* out, const void* z, const void* steps,
                                   const void* params, const void* params_t, const void* psi,
                                   const void* psi_t, const void* chol, int num_slots,
                                   int num_tangents, const int* role,
                                   const int* pa, const int* pb, const int* oa, const int* ob,
                                   int state_dim, const int* init, int num_params, int num_dense,
                                   int num_coarse, uint32_t num_paths, void* stream) {
  if (num_slots != kNs || num_tangents != kC || state_dim != kD || num_params < 1 ||
      num_params > kMaxP || num_dense < 0 || num_coarse < 0 || num_paths == 0 ||
      out == nullptr || z == nullptr || steps == nullptr || params == nullptr ||
      chol == nullptr || (kC > 0 && params_t == nullptr) || (kK > 0 && psi == nullptr) ||
      (kC == 0 && (params_t != nullptr || psi_t != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Desc d = {};
  d.num_params = num_params;
  for (int s = 0; s < num_slots; ++s) {
    const bool two = has_b(role_of(s));
    const int last = pa[s] + (role[s] == kGbmEuler ? 0 : 2);  // the last parameter pa reads
    if (role[s] != role_of(s) || pa[s] < 0 || last >= num_params || pb[s] < 0 ||
        pb[s] >= num_params || oa[s] < 0 || oa[s] >= kD ||
        (two ? ob[s] < 0 || ob[s] >= kD : ob[s] != -1)) {
      return (int)cudaErrorInvalidValue;
    }
    d.pa[s] = pa[s];
    d.pb[s] = pb[s];
    d.oa[s] = oa[s];
    d.ob[s] = ob[s];
  }
  for (int c = 0; c < kD; ++c) {
    if (init[c] >= num_params) return (int)cudaErrorInvalidValue;
    d.init[c] = init[c];
  }
  if (num_coarse == 0 || num_dense == 0) return 0;
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  recon_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), static_cast<const double*>(z),
      static_cast<const double*>(steps), static_cast<const double*>(params),
      static_cast<const double*>(params_t), static_cast<const double*>(psi),
      static_cast<const double*>(psi_t), static_cast<const double*>(chol), d, num_dense,
      num_coarse, num_paths);
  return (int)cudaGetLastError();
}
