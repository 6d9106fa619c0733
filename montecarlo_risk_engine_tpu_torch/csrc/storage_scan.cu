// Gas-storage LSM scan for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The JAX package runs the storage deals' event
// scans as lax.scan loops that XLA fuses; the port ran them eagerly, one
// bucket of same-shaped deals at a time, and each date of a bucket cost up to
// ~190 float64 launches on [P, N, S] tensors whose host dispatch kept the card
// idle.  This file runs a whole phase for every storage deal of a book in one
// launch: storage_fit_kernel is the backward induction on the pre-simulation
// paths (the regression fit and the DP step over every grid state at each
// event, last event first), storage_value_kernel the forward walk on the main
// paths.  The plain PyTorch version, op for op, is storage_fit_reference and
// storage_value_reference in ops/storage_scan.py; the torch scans it matches
// are the controller's _exercise_backward_scan / _exercise_forward_scan with
// Storage.scan_exercise_step.
//
// Inputs are flat per-deal tables (ops/storage_scan.py pack):
//   obs [U, N]: the distinct spot and numeraire rows the deals read;
//   rows [R, 3] int32: per event row its spot row and numeraire row in obs
//     and its exposure slot (-1: none);
//   consts [R, 9]: is_prod, prev_vmin, prev_vmax, next_vmin, next_vmax,
//     inj_cost, wd_cost, period, is_last (Storage.scan_event_extras);
//   curves [R, 4, K]: injection points and rates, withdrawal points and rates,
//     the first inj_k / wd_k entries of each row meaningful;
//   deals [D, 6] int32: first row, events, grid states, inj_k, wd_k, first
//     coefficient of the deal in coeffs.
// A deal's events are its dates and the exposure dates in time order; each
// deal reads only its own slice, so deals of any shapes share the launch.
//
// Design:
//   * Fit: one block per deal (100 blocks for the mixed book: one wave on 132
//     SMs), T = min(512, max(32, P2)) threads with P2 the path count padded to
//     a power of two.  Path n belongs to thread n mod T.  Per event: the
//     column scales (deg tree sums of A^2), then the unique Gram entries and
//     the right-hand sides (deg (deg + 1) / 2 + deg S tree sums), then the
//     ridge, a deg x deg LU with partial pivoting and the solve for the S
//     right-hand sides on one thread, the coefficients broadcast through
//     shared memory; then the DP step of every grid state of every path.
//   * Every tree sum adds in metrics.fixed_tree_sum's pairs (lsm_fit.cuh, the
//     helpers this kernel shares with exercise_scan.cu), so the Gram and the
//     right-hand sides have the torch scan's bits.
//   * The carry [S, N] (each grid state's future cashflows) is scratch in
//     device memory owned path by path: the thread that sums a path's
//     products is the one that steps it, so no barrier guards it.
//   * Value: one thread per path and deal; the realized state and the
//     deflated cashflow stay in registers across the deal's events, and a
//     step evaluates only the continuations it needs (the grid values around
//     each of the three candidate next states: six length-deg dot products).
//     Ties go to the first of (inject, hold, withdraw), a later action wins
//     only when strictly greater (storage.py _first_argmax_select).
//   * What bounds it: neither bytes nor operations.  At the mixed book's
//     shapes (100 deals, <= 50 events, S <= 10, N = 1,000) the fit is ~2e8
//     float64 operations and the tables ~25 MB; the fit's time is the chain
//     of block-wide reductions and one-thread solves, event after event.
//   * No host sync, no allocation: the wrapper allocates outputs and scratch
//     and launches on the current stream.  Built with -fmad=false and without
//     fast math: every expression rounds like the separate torch ops on the
//     card.  Where the torch scan divides by a Python number (the path count,
//     S - 1, deg), PyTorch's CUDA kernel multiplies by its reciprocal, and so
//     does this one (the CPU's divides: the plain version on CPU tensors has
//     the CPU's bits).  The deg x deg solve repeats cuBLAS's getrf and getrs
//     (torch.linalg.lu_factor_ex / lu_solve on the card) operation for
//     operation, fused multiply-adds where they fuse, so the coefficients too
//     are the torch scan's on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lsm_fit.cuh"

namespace {

using namespace mcre;

constexpr int kValueThreads = 128;
constexpr int kStackBudget = 160 * 1024;  // bytes of shared memory for the tree sums' stacks

enum Const : int {
  kIsProd, kPrevVmin, kPrevVmax, kNextVmin, kNextVmax, kInjCost, kWdCost, kPeriod, kIsLast,
  kConsts
};
enum DealField : int { kFirstRow, kEvents, kStates, kInjPoints, kWdPoints, kFirstCoef, kDealFields };
enum RowField : int { kSpotRow, kNumRow, kExpSlot, kRowFields };
enum Curve : int { kInjPts, kInjRates, kWdPts, kWdRates, kCurves };

// utils/maths.interp (jnp.interp's arithmetic) on one curve of k points.
__device__ double interp(double x, const double* xp, const double* fp, int k) {
  int lo = 0, hi = k;  // torch.searchsorted(right=True)
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(xp[mid] > x)) lo = mid + 1; else hi = mid;
  }
  int i = lo < 1 ? 1 : lo;
  i = i > k - 1 ? k - 1 : i;
  int i0 = (i - 1) % k;
  if (i0 < 0) i0 += k;
  const double xp0 = xp[i0], fp0 = fp[i0];
  const double dx = xp[i] - xp0;
  const bool flat = fabs(dx) <= 0x1p-104;  // np.spacing(float64 eps)
  double f = flat ? fp0 : fp0 + ((x - xp0) / dx) * (fp[i] - fp0);
  if (x < xp[0]) f = fp[0];
  if (x > xp[k - 1]) f = fp[k - 1];
  return f;
}

// Storage.lookup_state_values: linear between the integer states around s.
template <class Values>
__device__ double lookup(Values values, double s, int num_states) {
  const double bounded = tmin(tmax(s, 0.0), num_states - 1.0);
  const double lower = floor(bounded);
  const double upper = ceil(bounded);
  const double w = bounded - lower;
  const double lv = values((int)lower);
  const double uv = values((int)upper);
  return lv + w * (uv - lv);
}

struct Row {
  const double* c;       // consts row
  const double* curve;   // [kCurves, k_max]
  int k_max, inj_k, wd_k;
};

struct Step {
  double state, payoff;
};

// Storage.scan_exercise_step for one path and state; cont(s) is the
// interpolated continuation at the next state s.
template <class Cont>
__device__ Step storage_step(double state, double spot, const Row& row, int num_states,
                             Cont cont) {
  const double* c = row.c;
  const double s_minus_1 = num_states - 1.0;
  const double prev_span = c[kPrevVmax] - c[kPrevVmin];
  const double prev_vol = c[kPrevVmin] + state * prev_span * (1.0 / s_minus_1);
  const double next_span = tmax(c[kNextVmax] - c[kNextVmin], 1e-30);
  const double inj_rate = interp(prev_vol, row.curve + kInjPts * row.k_max,
                                 row.curve + kInjRates * row.k_max, row.inj_k);
  const double wd_rate = interp(prev_vol, row.curve + kWdPts * row.k_max,
                                row.curve + kWdRates * row.k_max, row.wd_k);
  double vols[3];
  vols[0] = tmin(prev_vol + inj_rate * c[kPeriod], c[kNextVmax]);
  vols[1] = tmin(tmax(prev_vol, c[kNextVmin]), c[kNextVmax]);
  vols[2] = tmax(prev_vol - wd_rate * c[kPeriod], c[kNextVmin]);
  const double buy = spot + c[kInjCost];
  const double sell = spot - c[kWdCost];
  const double keep = 1.0 - c[kIsLast];
  Step best = {0.0, 0.0};
  double best_value = 0.0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const double next = (vols[a] - c[kNextVmin]) * s_minus_1 / next_span;
    const double delta = vols[a] - prev_vol;
    const double price = a == 0 ? buy : a == 2 ? sell : (delta >= 0.0 ? buy : sell);
    const double payoff = -delta * price;
    const double value = payoff + keep * cont(next);
    if (a == 0 || value > best_value) {
      best_value = value;
      best = {next, payoff};
    }
  }
  return best;
}

__device__ __forceinline__ Row row_of(int r, const double* consts, const double* curves,
                                      const int* deal, int k_max) {
  return {consts + (size_t)r * kConsts, curves + (size_t)r * kCurves * k_max, k_max,
          deal[kInjPoints], deal[kWdPoints]};
}

template <int kDeg>
__global__ void __launch_bounds__(kMaxThreads)
storage_fit_kernel(double* __restrict__ coeffs, double* __restrict__ normal,
                   double* __restrict__ carry_all, const double* __restrict__ obs,
                   const int* __restrict__ rows, const double* __restrict__ consts,
                   const double* __restrict__ curves, const int* __restrict__ deals, int k_max,
                   int s_max, TreeShape shape) {
  constexpr int kGram = gram_entries<kDeg>();
  extern __shared__ double smem[];
  double* sums = smem;                                 // kGram + kDeg * kMaxStates
  double* scale = sums + kGram + kDeg * kMaxStates;    // kDeg column scales
  double* coef = scale + kDeg;                         // [kMaxStates, kDeg]
  double* stack = coef + kMaxStates * kDeg;            // [(log_leaves + 1), chunk, T]

  const int* deal = deals + (size_t)blockIdx.x * kDealFields;
  const int first_row = deal[kFirstRow], num_events = deal[kEvents], S = deal[kStates];
  const uint32_t N = shape.num_paths;
  const int nthreads = blockDim.x;
  double* carry = carry_all + (size_t)blockIdx.x * s_max * N;  // [S, N]
  double* deal_coeffs = coeffs + deal[kFirstCoef];             // [events, S, kDeg]

  for (uint32_t n = threadIdx.x; n < N; n += nthreads) {
    for (int s = 0; s < S; ++s) carry[(size_t)s * N + n] = 0.0;
  }
  for (int e = num_events - 1; e >= 0; --e) {
    const int r = first_row + e;
    const double* spot = obs + (size_t)rows[r * kRowFields + kSpotRow] * N;
    const double* num = obs + (size_t)rows[r * kRowFields + kNumRow] * N;

    // fit_least_squares: column scales, then the Gram and right-hand sides
    column_scales<kDeg>(spot, sums, scale, stack, shape);
    tree_sums(kGram + kDeg * S, [&](uint32_t n, int k0, int kc, double* vals) {
      const Basis<kDeg> b(spot[n]);
      double as[kDeg];
#pragma unroll
      for (int k = 0; k < kDeg; ++k) as[k] = b.a[k] / scale[k];
      const double nm = num[n];
      for (int c = 0; c < kc; ++c) {
        const int k = k0 + c;
        if (k < kGram) {
          int a, bb;
          gram_pair<kDeg>(k, a, bb);
          vals[c] = as[a] * as[bb];
        } else {
          const int a = (k - kGram) / S, s = (k - kGram) % S;
          vals[c] = as[a] * (nm * carry[(size_t)s * N + n]);
        }
      }
    }, sums, stack, shape);

    if (threadIdx.x == 0) {
      solve_normal_equations<kDeg>(
          sums, S, scale, coef, deal_coeffs + (size_t)e * S * kDeg,
          normal == nullptr ? nullptr : normal + (size_t)r * kDeg * (kDeg + s_max), s_max);
    }
    __syncthreads();

    const Row row = row_of(r, consts, curves, deal, k_max);
    if (row.c[kIsProd] != 0.0) {
      // the DP step of every grid state: carry <- cashflow + carry at the next state
      for (uint32_t n = threadIdx.x; n < N; n += nthreads) {
        const double x = spot[n], nm = num[n];
        const Basis<kDeg> b(x);
        double grid[kMaxStates], old[kMaxStates];
        for (int j = 0; j < S; ++j) {
          grid[j] = b.dot(coef + j * kDeg);
          old[j] = carry[(size_t)j * N + n];
        }
        for (int s = 0; s < S; ++s) {
          const Step st = storage_step((double)s, x, row, S, [&](double next) {
            return lookup([&](int j) { return grid[j]; }, next, S);
          });
          const double cf = st.payoff / nm;
          carry[(size_t)s * N + n] = cf + lookup([&](int j) { return old[j]; }, st.state, S);
        }
      }
    }
  }
}

template <int kDeg>
__global__ void __launch_bounds__(kValueThreads)
storage_value_kernel(double* __restrict__ cfs, double* __restrict__ exposures,
                     const double* __restrict__ coeffs, const double* __restrict__ obs,
                     const int* __restrict__ rows, const double* __restrict__ consts,
                     const double* __restrict__ curves, const int* __restrict__ deals,
                     int k_max, int num_exposures, uint32_t N) {
  const uint32_t n = blockIdx.x * kValueThreads + threadIdx.x;
  if (n >= N) return;
  const int d = blockIdx.y;
  const int* deal = deals + (size_t)d * kDealFields;
  const int first_row = deal[kFirstRow], num_events = deal[kEvents], S = deal[kStates];
  const double* deal_coeffs = coeffs + deal[kFirstCoef];
  double state = 0.0;  // Storage.get_initial_state()
  double cf = 0.0;
  for (int e = 0; e < num_events; ++e) {
    const int r = first_row + e;
    const int* rw = rows + r * kRowFields;
    const double x = obs[(size_t)rw[kSpotRow] * N + n];
    const double nm = obs[(size_t)rw[kNumRow] * N + n];
    const Basis<kDeg> b(x);
    const double* coef = deal_coeffs + (size_t)e * S * kDeg;
    auto grid = [&](int j) { return b.dot(coef + j * kDeg); };
    const Row row = row_of(r, consts, curves, deal, k_max);
    if (row.c[kIsProd] != 0.0) {
      const Step st = storage_step(state, x, row, S,
                                   [&](double next) { return lookup(grid, next, S); });
      state = st.state;
      cf = cf + st.payoff / nm;
    } else {
      cf = cf + 0.0;
    }
    if (exposures != nullptr && rw[kExpSlot] >= 0) {
      exposures[((size_t)d * num_exposures + rw[kExpSlot]) * N + n] = lookup(grid, state, S) / nm;
    }
  }
  cfs[(size_t)d * N + n] = cf;
}

template <int kDeg>
int launch_fit(double* coeffs, double* normal, double* carry, const double* obs, const int* rows,
               const double* consts, const double* curves, const int* deals, int num_deals,
               int k_max, int s_max, uint32_t num_paths, cudaStream_t stream) {
  uint32_t padded = 1;
  while (padded < num_paths) padded <<= 1;
  const int nthreads = padded < 32 ? 32 : padded > (uint32_t)kMaxThreads ? kMaxThreads : (int)padded;
  TreeShape shape;
  if (!tree_shape(num_paths, nthreads, kStackBudget / (8 * nthreads), &shape)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t fixed = gram_entries<kDeg>() + kDeg * kMaxStates + kDeg + kMaxStates * kDeg;
  const size_t smem = 8 * (fixed + stack_doubles(shape, nthreads));
  cudaError_t err = cudaFuncSetAttribute(storage_fit_kernel<kDeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  storage_fit_kernel<kDeg><<<num_deals, nthreads, smem, stream>>>(
      coeffs, normal, carry, obs, rows, consts, curves, deals, k_max, s_max, shape);
  return (int)cudaGetLastError();
}

template <int kDeg>
int launch_value(double* cfs, double* exposures, const double* coeffs, const double* obs,
                 const int* rows, const double* consts, const double* curves, const int* deals,
                 int num_deals, int k_max, int num_exposures, uint32_t num_paths,
                 cudaStream_t stream) {
  const dim3 grid((num_paths + kValueThreads - 1) / kValueThreads, num_deals);
  storage_value_kernel<kDeg><<<grid, kValueThreads, 0, stream>>>(
      cfs, exposures, coeffs, obs, rows, consts, curves, deals, k_max, num_exposures, num_paths);
  return (int)cudaGetLastError();
}

bool valid(int num_deals, int deg, int k_max, int s_max, uint32_t num_paths) {
  return num_deals >= 1 && num_deals <= 65535 && deg >= 1 && deg <= 4 && k_max >= 1 &&
         s_max >= 2 && s_max <= kMaxStates && num_paths >= 1 && num_paths <= (1u << 30);
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for arguments out of range).  Pointers are device
// pointers: coeffs float64 [sum over deals of events x states x deg]; normal
// float64 [rows, deg, deg + s_max] or null (the Gram and right-hand sides of
// every row, for the tests); carry float64 scratch [num_deals, s_max,
// num_paths]; obs float64 [U, num_paths]; rows int32 [R, 3]; consts float64
// [R, 9]; curves float64 [R, 4, k_max]; deals int32 [num_deals, 6] with every
// deal's states <= s_max.  cfs float64 [num_deals, num_paths]; exposures
// float64 [num_deals, num_exposures, num_paths] or null.
extern "C" int mcre_storage_fit(void* coeffs, void* normal, void* carry, const void* obs,
                                const void* rows, const void* consts, const void* curves,
                                const void* deals, int num_deals, int deg, int k_max, int s_max,
                                uint32_t num_paths, void* stream) {
  if (!valid(num_deals, deg, k_max, s_max, num_paths) || coeffs == nullptr ||
      carry == nullptr || obs == nullptr || rows == nullptr || consts == nullptr ||
      curves == nullptr || deals == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  auto* c = static_cast<double*>(coeffs);
  auto* g = static_cast<double*>(normal);
  auto* w = static_cast<double*>(carry);
  auto* o = static_cast<const double*>(obs);
  auto* r = static_cast<const int*>(rows);
  auto* k = static_cast<const double*>(consts);
  auto* v = static_cast<const double*>(curves);
  auto* d = static_cast<const int*>(deals);
  auto s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 1: return launch_fit<1>(c, g, w, o, r, k, v, d, num_deals, k_max, s_max, num_paths, s);
    case 2: return launch_fit<2>(c, g, w, o, r, k, v, d, num_deals, k_max, s_max, num_paths, s);
    case 3: return launch_fit<3>(c, g, w, o, r, k, v, d, num_deals, k_max, s_max, num_paths, s);
    default: return launch_fit<4>(c, g, w, o, r, k, v, d, num_deals, k_max, s_max, num_paths, s);
  }
}

extern "C" int mcre_storage_value(void* cfs, void* exposures, const void* coeffs, const void* obs,
                                  const void* rows, const void* consts, const void* curves,
                                  const void* deals, int num_deals, int deg, int k_max, int s_max,
                                  int num_exposures, uint32_t num_paths, void* stream) {
  if (!valid(num_deals, deg, k_max, s_max, num_paths) || cfs == nullptr || coeffs == nullptr ||
      obs == nullptr || rows == nullptr || consts == nullptr || curves == nullptr ||
      deals == nullptr || num_exposures < 0 || (exposures != nullptr && num_exposures == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();
  auto* f = static_cast<double*>(cfs);
  auto* x = static_cast<double*>(exposures);
  auto* c = static_cast<const double*>(coeffs);
  auto* o = static_cast<const double*>(obs);
  auto* r = static_cast<const int*>(rows);
  auto* k = static_cast<const double*>(consts);
  auto* v = static_cast<const double*>(curves);
  auto* d = static_cast<const int*>(deals);
  auto s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 1: return launch_value<1>(f, x, c, o, r, k, v, d, num_deals, k_max, num_exposures, num_paths, s);
    case 2: return launch_value<2>(f, x, c, o, r, k, v, d, num_deals, k_max, num_exposures, num_paths, s);
    case 3: return launch_value<3>(f, x, c, o, r, k, v, d, num_deals, k_max, num_exposures, num_paths, s);
    default: return launch_value<4>(f, x, c, o, r, k, v, d, num_deals, k_max, num_exposures, num_paths, s);
  }
}
