// Forward-mode Heston QE reconstruction for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The JAX package rebuilds the Heston path on the
// path kernel's emitted draws (montecarlo_risk_engine_tpu/ops/pallas_paths_ad.py
// _reconstruct) under jit, where XLA fuses the rebuild and its tangents.  The
// port runs eagerly, and under vmap(jvp) the same rebuild was ~14,000 small
// float64 kernels a run of the Heston greeks, whose host dispatch kept the
// card idle.  This kernel does the rebuild, or its tangents for one sweep of
// c directions, in one launch.  The plain PyTorch version, op for op, is
// qe_planes_reference in ops/qe_tangents.py.
//
// What it computes: from the frozen float32 draws z [T', N, 2] and u [T', N]
// of the substep-dense timeline, the coarse plane [T, N, 2] of (log S, v)
// (MCRE_C = 0) or its c tangent planes [c, T, N, 2] (MCRE_C = c).  Per dense
// step with length, HestonModel.step_qe with the fuzzy branches, op for op
// in torch's association order, in float64; each tangent by the rule
// torch.func.jvp applies to the op (qe_tangent below).  Under QE the noise
// transform is the identity, so the correlated noise is z.  The values that
// depend on the parameters and dt alone come in as a table [T', 12] with its
// c tangent tables (ops/qe_tangents.py COLUMNS), the initial (log S0, v0)
// with its tangents.
//
// Design:
//   * A thread per path, 128-thread blocks: the thread runs the primal step
//     (about 40 float64 values kept for the tangents) and carries its c
//     tangents' (log S, v) in registers: 206 registers at c = 7, no spill.
//     Splitting the tangents over threads, each recomputing the primal, was
//     slower at every split tried (2, 3 or 4 tangents a thread); capping the
//     registers for a third block an SM spills.
//   * The table rows are the same for every path: read as broadcasts
//     through the read-only cache, 16 bytes a load.
//   * Stores: at each emitted point a thread writes each of its planes'
//     (log S, v) as one 16-byte store; a warp's 32 paths are 512 contiguous
//     bytes.
//   * One library per tangent count (-DMCRE_C; ops/qe_tangents.py
//     load_builds): the loops over the tangents unroll.  The C entry refuses
//     any other count.
//   * What bounds it: the float64 arithmetic, the divisions most.  A tangent
//     of a path-step takes 12 quotients and 80 other operations, the
//     primal 8 divisions, 4 square roots and a log.  The tangents' divisors
//     are primal values, so each tangent quotient is qdiv's product with the
//     divisor's reciprocal and two exact corrections, the division's own
//     bits at about half its cost.  At the Heston greeks' shapes ([40, 2^20],
//     c = 7) the arithmetic takes ~0.9 ms at the card's float64 rate counted
//     one operation each (a division is some ten), the 1.17 GB of tangent
//     planes and 0.5 GB of draws 0.5 ms.
//   * No host sync, no allocation: the wrapper allocates the planes and
//     launches on the current stream.  Built with -fmad=false and without
//     fast math: every expression rounds like the separate torch ops.  As in
//     PyTorch's CUDA kernels, a division by a Python float is a product with
//     its reciprocal and a clamp keeps NaN.

#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(MCRE_C)
#error "build with -DMCRE_C=<tangents>"
#endif

namespace {

constexpr int kC = MCRE_C;
static_assert(kC >= 0 && kC <= 8, "MCRE_C out of range");
constexpr int kT = kC > 0 ? kC : 1;  // tangent array length (unused at kC = 0)
constexpr int kThreads = 128;
constexpr int kCols = 12;

constexpr double kEps = 1e-12;          // models/heston.py _EPS
constexpr double kPMax = 1.0 - 1e-6;    // the mass at zero's upper clamp
// x / (2 w) for the ramps of width w = 0.3 and 0.5: a product with the
// reciprocal, as PyTorch's div_true_kernel_cuda takes a Python float.
constexpr double kInvMass = 1.0 / (2.0 * 0.3);
constexpr double kInvSwitch = 1.0 / (2.0 * 0.5);

// A table row (ops/qe_tangents.py COLUMNS).
struct Cols {
  double e, ome, var_const, k0, k1, k2, k3, k4, rdt, theta, sigma, kappa;
};

__device__ __forceinline__ Cols load_cols(const double* __restrict__ row) {
  const double2* r = reinterpret_cast<const double2*>(row);
  const double2 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), d = __ldg(r + 3),
                e = __ldg(r + 4), f = __ldg(r + 5);
  return Cols{a.x, a.y, b.x, b.y, c.x, c.y, d.x, d.y, e.x, e.y, f.x, f.y};
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi) as PyTorch's CUDA
// kernels compute them: a NaN stays NaN.
__device__ __forceinline__ double clamp_min(double x, double lo) {
  return isnan(x) ? x : fmax(x, lo);
}
__device__ __forceinline__ double clamp_both(double x, double lo, double hi) {
  return isnan(x) ? x : fmin(fmax(x, lo), hi);
}

// The values of one step_qe update that its tangents read.
struct Primal {
  double d1, m, sa, sb, sc, se, den, psi, rec, tm, sq1, sq2, bs, opb, a, sbr, sbz, sq, vq,
      pp1, q, omp, mpe, beta, c2u, ratio, bpe, vt, wa, wm, ve, wb, w, omw, vn, vi, var_int,
      vol;
};

// step_qe (models/heston.py) with the fuzzy branches, op for op.
__device__ __forceinline__ double qe_primal(double ls, double v, double zs, double zv, double u,
                                            const Cols& c, Primal& p) {
  // CIR moments: m = theta + (v - theta) e; s2 = v sigma sigma e (1 - e) / kappa + const
  p.d1 = v - c.theta;
  p.m = c.theta + p.d1 * c.e;
  p.sa = v * c.sigma;
  p.sb = p.sa * c.sigma;
  p.sc = p.sb * c.e;
  p.se = (p.sc * c.ome) / c.kappa;
  const double s2 = p.se + c.var_const;
  p.den = p.m * p.m + kEps;
  p.psi = s2 / p.den;
  // quadratic branch: b2 = clamp(2/psi - 1 + sqrt(2/psi) sqrt(clamp(2/psi - 1, 0)), 0)
  p.rec = 1.0 / (p.psi + kEps);
  const double ti = (p.rec * 1.0) * 2.0;
  p.tm = ti - 1.0;
  const double tail = clamp_min(p.tm, 0.0);
  p.sq1 = sqrt(ti);
  p.sq2 = sqrt(tail);
  p.bs = p.tm + p.sq1 * p.sq2;
  const double b2 = clamp_min(p.bs, 0.0);
  p.opb = b2 + 1.0;
  p.a = p.m / p.opb;
  p.sbr = sqrt(b2);
  p.sbz = p.sbr + zv;
  p.sq = p.sbz * p.sbz;  // torch's pow(x, 2) on the card
  p.vq = p.a * p.sq;
  // exponential mixture with the width-0.3 mass ramp
  p.pp1 = p.psi + 1.0;
  p.q = (p.psi - 1.0) / p.pp1;
  const double pc = clamp_both(p.q, 0.0, kPMax);
  p.omp = 1.0 - pc;
  p.mpe = p.m + kEps;
  p.beta = p.omp / p.mpe;
  p.c2u = clamp_min(1.0 - u, kEps);
  p.ratio = clamp_min(p.omp, kEps) / p.c2u;
  p.bpe = p.beta + kEps;
  p.vt = log(p.ratio) / p.bpe;
  p.wa = ((u - pc) + 0.3) * kInvMass;
  p.wm = clamp_both(p.wa, 0.0, 1.0);
  p.ve = p.wm * p.vt;
  // the width-0.5 switch at psi = 1.5
  p.wb = ((p.psi - 1.5) + 0.5) * kInvSwitch;
  p.w = clamp_both(p.wb, 0.0, 1.0);
  p.omw = 1.0 - p.w;
  p.vn = p.omw * p.vq + p.w * p.ve;
  // K coefficients, var_int, vol, log S
  p.vi = c.k3 * v + c.k4 * p.vn;
  p.var_int = clamp_min(p.vi, 0.0);
  p.vol = sqrt(clamp_min(p.var_int, kEps));
  return ((((ls + c.rdt) + c.k0) + c.k1 * v) + c.k2 * p.vn) + p.vol * zs;
}

// x / y correctly rounded, as IEEE division gives it, from the reciprocal
// r = 1 / y: q = x r, then twice q += (x - q y) r with the residual exact by
// fma.  After the first correction q lies within an ulp of x / y, and r
// within half an ulp of 1 / y, so the second gives the correctly rounded
// quotient (Markstein's theorem).  The divisors are the step's primal
// values, the same for all of a thread's tangents: the compiler forms each
// reciprocal once a step, and a tangent's quotient costs a product and four
// fmas in place of a division.  The range test keeps every intermediate
// normal; outside it (y zero, infinite or extreme; x infinite or extreme) the
// quotient is x / y.  A nan goes through either way as nan.
__device__ __forceinline__ double qdiv(double x, double y) {
  const double r = 1.0 / y;
  const double ax = fabs(x), ay = fabs(y);
  if (ay <= 0x1p-500 || ay >= 0x1p500 || ax >= 0x1p500 || (ax <= 0x1p-500 && x != 0.0)) {
    return x / y;
  }
  double q = x * r;
  q = fma(fma(-q, y, x), r, q);
  return fma(fma(-q, y, x), r, q);
}

// One tangent of the update: (ls_t, v_t) of the state before the step in,
// after it out; t: the table row's tangent.  Each line is torch.func.jvp's
// rule for the primal op beside it: x * y: y' x + x' y; x / y = r:
// (x' - y' r) / y; 1 / x = r: -x' (r r); sqrt(x) = r: x' / (2 r); log(x):
// x' / x; x * x (pow 2): x' (2 x); clamp: x' where its bounds hold, ties
// included, else 0.  Every quotient is qdiv's, the division's own bits.
__device__ __forceinline__ void qe_tangent(const Primal& p, double v, double zs, const Cols& c,
                                           const Cols& t, double& ls_t, double& v_t) {
  const double v0_t = v_t;
  const double m_t = t.theta + (t.e * p.d1 + (v0_t - t.theta) * c.e);
  const double sa_t = t.sigma * v + v0_t * c.sigma;
  const double sb_t = t.sigma * p.sa + sa_t * c.sigma;
  const double sc_t = t.e * p.sb + sb_t * c.e;
  const double sd_t = t.ome * p.sc + sc_t * c.ome;
  const double s2_t = qdiv(sd_t - t.kappa * p.se, c.kappa) + t.var_const;
  const double mm_t = m_t * p.m + m_t * p.m;
  const double psi_t = qdiv(s2_t - mm_t * p.psi, p.den);
  const double ti_t = (((-psi_t) * (p.rec * p.rec)) * 1.0) * 2.0;
  const double tail_t = p.tm >= 0.0 ? ti_t : 0.0;
  const double sq1_t = qdiv(ti_t, 2.0 * p.sq1);
  const double sq2_t = qdiv(tail_t, 2.0 * p.sq2);
  const double b2_t = p.bs >= 0.0 ? ti_t + (sq2_t * p.sq1 + sq1_t * p.sq2) : 0.0;
  const double a_t = qdiv(m_t - b2_t * p.a, p.opb);
  const double sq_t = qdiv(b2_t, 2.0 * p.sbr) * (2.0 * p.sbz);
  const double vq_t = sq_t * p.a + a_t * p.sq;
  const double q_t = qdiv(psi_t - psi_t * p.q, p.pp1);
  const double p_t = p.q >= 0.0 && p.q <= kPMax ? q_t : 0.0;
  const double beta_t = qdiv(-p_t - m_t * p.beta, p.mpe);
  const double c1_t = p.omp >= kEps ? -p_t : 0.0;
  const double lg_t = qdiv(qdiv(c1_t, p.c2u), p.ratio);
  const double vt_t = qdiv(lg_t - beta_t * p.vt, p.bpe);
  const double wm_t = p.wa >= 0.0 && p.wa <= 1.0 ? (-p_t) * kInvMass : 0.0;
  const double ve_t = vt_t * p.wm + wm_t * p.vt;
  const double w_t = p.wb >= 0.0 && p.wb <= 1.0 ? psi_t * kInvSwitch : 0.0;
  const double vn_t = (vq_t * p.omw + (-w_t) * p.vq) + (ve_t * p.w + w_t * p.ve);
  const double vi_t = (v0_t * c.k3 + t.k3 * v) + (vn_t * c.k4 + t.k4 * p.vn);
  const double vc_t = p.var_int >= kEps && p.vi >= 0.0 ? vi_t : 0.0;
  const double vol_t = qdiv(vc_t, 2.0 * p.vol);
  ls_t = ((((ls_t + t.rdt) + t.k0) + (v0_t * c.k1 + t.k1 * v)) + (vn_t * c.k2 + t.k2 * p.vn)) +
         vol_t * zs;
  v_t = vn_t;
}

__global__ void __launch_bounds__(kThreads)
qe_tangents_kernel(double* __restrict__ out, const float* __restrict__ z,
                   const float* __restrict__ u, const int* __restrict__ steps,
                   const double* __restrict__ table, const double* __restrict__ table_t,
                   const double* __restrict__ init, const double* __restrict__ init_t,
                   int num_dense, int num_coarse, uint32_t num_paths) {
  const uint32_t path = blockIdx.x * kThreads + threadIdx.x;
  if (path >= num_paths) return;
  double ls = __ldg(init), v = __ldg(init + 1);
  double ls_t[kT], v_t[kT];
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    ls_t[j] = __ldg(init_t + 2 * j);
    v_t[j] = __ldg(init_t + 2 * j + 1);
  }
  const int2* step = reinterpret_cast<const int2*>(steps);
  for (int i = 0; i < num_dense; ++i) {
    const int2 s = __ldg(step + i);  // (live, emitted coarse point or -1)
    if (s.x != 0) {
      const size_t at = (size_t)i * num_paths + path;
      const float2 zz = __ldg(reinterpret_cast<const float2*>(z) + at);
      const double zs = zz.x;
      const Cols c = load_cols(table + (size_t)i * kCols);
      Primal p;
      const double ls_next = qe_primal(ls, v, zs, zz.y, __ldg(u + at), c, p);
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const Cols t = load_cols(table_t + ((size_t)j * num_dense + i) * kCols);
        qe_tangent(p, v, zs, c, t, ls_t[j], v_t[j]);
      }
      ls = ls_next;
      v = p.vn;
    }
    if (s.y >= 0) {
      if (kC == 0) {
        reinterpret_cast<double2*>(out)[(size_t)s.y * num_paths + path] = make_double2(ls, v);
      } else {
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          const size_t plane = (size_t)j * num_coarse + s.y;
          reinterpret_cast<double2*>(out)[plane * num_paths + path] =
              make_double2(ls_t[j], v_t[j]);
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success; cudaErrorInvalidValue
// for another tangent count or bad arguments).  Device pointers: out float64
// [num_tangents or 1, num_coarse, num_paths, 2]; z float32 [num_dense,
// num_paths, 2]; u float32 [num_dense, num_paths]; steps int32 [num_dense, 2]
// (live, emitted coarse point or -1); table float64 [num_dense, 12];
// table_t float64 [num_tangents, num_dense, 12]; init float64 [2] (log S0,
// v0); init_t float64 [num_tangents, 2].  table_t and init_t are null for
// the primal.  out, table and table_t are 16-byte aligned, z and steps
// 8-byte.
extern "C" int mcre_qe_tangents(void* out, const void* z, const void* u, const void* steps,
                                const void* table, const void* table_t, const void* init,
                                const void* init_t, int num_tangents, int num_dense,
                                int num_coarse, uint32_t num_paths, void* stream) {
  const bool tangents = table_t != nullptr && init_t != nullptr;
  if (num_tangents != kC || num_dense < 1 || num_coarse < 1 || num_paths == 0 ||
      out == nullptr || z == nullptr || u == nullptr || steps == nullptr || table == nullptr ||
      init == nullptr || (kC > 0) != tangents || (kC == 0 && (table_t || init_t)) ||
      !aligned(out, 16) || !aligned(table, 16) || !aligned(z, 8) || !aligned(steps, 8) ||
      (tangents && !aligned(table_t, 16))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  qe_tangents_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(out), static_cast<const float*>(z), static_cast<const float*>(u),
      static_cast<const int*>(steps), static_cast<const double*>(table),
      static_cast<const double*>(table_t), static_cast<const double*>(init),
      static_cast<const double*>(init_t), num_dense, num_coarse, num_paths);
  return (int)cudaGetLastError();
}
