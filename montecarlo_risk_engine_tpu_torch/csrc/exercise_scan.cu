// Equity LSM exercise scan for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel.  The JAX package runs the Bermudan, American and
// FlexiCall scans of its family batches as lax.scan loops that XLA fuses; the
// port ran them eagerly (api/batching.py ExerciseEquityBatch.fit / evaluate),
// one batch of products with the same number of dates at a time, and each
// event of a batch cost ~20-85 float64 launches on [P, N, S] tensors whose
// host dispatch kept the card idle.  This file runs a whole phase for every
// ExerciseEquityBatch product of a book in one launch: exercise_fit_kernel is
// the backward induction on the pre-simulation paths (the regression fit and
// the exercise step of every state at each event, last event first),
// exercise_value_kernel the forward walk on the main paths.  The plain
// PyTorch version, op for op, is exercise_fit_reference and
// exercise_value_reference in ops/exercise_scan.py.
//
// Inputs are flat per-product tables (ops/exercise_scan.py pack):
//   obs [U, N]: the spot and numeraire rows the products read;
//   rows [R, 4] int32: per event row its spot row and numeraire row in obs,
//     whether it is one of the product's own dates, and its exposure slot
//     (-1: none);
//   strikes [R]: the strike of the row (0 at an exposure date);
//   options [P, 7] int32: first row, events, states, initial state, ITM gate,
//     FlexiCall, first coefficient of the product in coeffs;
//   carry_rows [P]: the product's first row in the fit's carry scratch;
//   signs [P]: +1 for a call, -1 for a put.
// A product's events are its dates and the exposure dates in time order,
// product dates first on ties; each product reads only its own slice, so
// products of any event count share the launch.
//
// Design:
//   * Fit: one block per product, T = min(512, max(32, P2 / 32)) threads with
//     P2 the path count padded to a power of two: one warp a product at the
//     mixed book's 1,000 paths (2,500 products, 16 resident an SM at 128
//     registers a thread), 512 threads from 16,384 paths on.  Per event: the column scales, then the
//     unique Gram entries and the right-hand sides as tree sums
//     (lsm_fit.cuh), the in-the-money weights on the dates of an ITM-gated
//     product; the ridge and the solve on one thread, the coefficients
//     broadcast through shared memory; then, on the product's own dates, the
//     exercise step of every state of every path: exercise where the
//     immediate payoff (plus, for a FlexiCall, the continuation one state
//     down) beats the continuation, never from state 0, and for an ITM-gated
//     product only in the money; carry <- payoff / numeraire + the carry of
//     the state it lands in.
//   * The carry [S, N] is scratch in device memory owned path by path: the
//     thread that sums a path's products is the one that steps it, so no
//     barrier guards it.
//   * Value: one thread per path and product; the state and the deflated
//     cashflow stay in registers across the product's events.  An event
//     needs the continuation at the held state and, for a FlexiCall, one
//     state down: two length-deg dot products; an exposure row writes the
//     continuation at the state after the step over the numeraire.
//   * What bounds it: neither bytes nor operations.  At the mixed book's
//     shapes (2,500 products, <= 48 events, S <= 4, N = 1,000) the fit is
//     ~3e9 float64 operations, ~1 % of the card's rate in its ~9 ms; its
//     time is the chain of tree sums and one-thread solves of the longest
//     product (48 events, ~200 us each on one warp).
//   * No host sync, no allocation: the wrapper allocates outputs and scratch
//     and launches on the current stream.  Built with -fmad=false and without
//     fast math, every expression rounds like the separate torch ops on the
//     card, and the solve repeats cuBLAS's getrf and getrs, so coefficients
//     and cashflows are the torch route's bits on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lsm_fit.cuh"

namespace {

using namespace mcre;

constexpr int kValueThreads = 128;
constexpr int kStackDoubles = 40;  // per thread: the tree sums' stack in shared memory

enum OptionField : int {
  kFirstRow, kEvents, kStates, kInitial, kItm, kFlexi, kFirstCoef, kOptionFields
};
enum RowField : int { kSpotRow, kNumRow, kIsProd, kExpSlot, kRowFields };

// ExerciseEquityBatch's exercise rule at state s > 0 (state 0 never
// exercises): the immediate payoff beats the continuation at s (plus, for a
// FlexiCall, the continuation at s - 1), and an ITM-gated product exercises
// only in the money.
__device__ __forceinline__ bool exercises(double immediate, double hold, double down, int s,
                                          bool flexi, bool itm) {
  const bool beats = flexi ? immediate + down > hold : immediate > hold;
  return s > 0 && beats && (!itm || immediate > 0.0);
}

template <int kDeg>
__global__ void __launch_bounds__(kMaxThreads)
exercise_fit_kernel(double* __restrict__ coeffs, double* __restrict__ carry_all,
                    const double* __restrict__ obs, const int* __restrict__ rows,
                    const double* __restrict__ strikes, const int* __restrict__ options,
                    const int* __restrict__ carry_rows, const double* __restrict__ signs,
                    TreeShape shape) {
  constexpr int kGram = gram_entries<kDeg>();
  extern __shared__ double smem[];
  double* sums = smem;                                 // kGram + kDeg * kMaxStates
  double* scale = sums + kGram + kDeg * kMaxStates;    // kDeg column scales
  double* coef = scale + kDeg;                         // [kMaxStates, kDeg]
  double* stack = coef + kMaxStates * kDeg;            // [(log_leaves + 1), chunk, T]

  const int p = blockIdx.x;
  const int* option = options + (size_t)p * kOptionFields;
  const int first_row = option[kFirstRow], num_events = option[kEvents], S = option[kStates];
  const bool itm = option[kItm] != 0, flexi = option[kFlexi] != 0;
  const double sign = signs[p];
  const uint32_t N = shape.num_paths;
  const int nthreads = blockDim.x;
  double* carry = carry_all + (size_t)carry_rows[p] * N;      // [S, N]
  double* product_coeffs = coeffs + option[kFirstCoef];       // [events, S, kDeg]

  for (uint32_t n = threadIdx.x; n < N; n += nthreads) {
    for (int s = 0; s < S; ++s) carry[(size_t)s * N + n] = 0.0;
  }
  for (int e = num_events - 1; e >= 0; --e) {
    const int r = first_row + e;
    const int* rw = rows + (size_t)r * kRowFields;
    const double* spot = obs + (size_t)rw[kSpotRow] * N;
    const double* num = obs + (size_t)rw[kNumRow] * N;
    const double strike = strikes[r];
    const bool is_prod = rw[kIsProd] != 0;
    const bool weighted = itm && is_prod;

    // fit_least_squares: column scales, then the Gram and right-hand sides
    // of the (on a gated product's dates, in-the-money) weighted fit
    column_scales<kDeg>(spot, sums, scale, stack, shape);
    tree_sums(kGram + kDeg * S, [&](uint32_t n, int k0, int kc, double* vals) {
      const double x = spot[n];
      const Basis<kDeg> b(x);
      const double w = weighted ? (sign * (x - strike) > 0.0 ? 1.0 : 0.0) : 1.0;
      double as[kDeg], aw[kDeg];
#pragma unroll
      for (int k = 0; k < kDeg; ++k) {
        as[k] = b.a[k] / scale[k];
        aw[k] = as[k] * w;
      }
      const double nm = num[n];
      for (int c = 0; c < kc; ++c) {
        const int k = k0 + c;
        if (k < kGram) {
          int a, bb;
          gram_pair<kDeg>(k, a, bb);
          vals[c] = aw[a] * as[bb];
        } else {
          const int a = (k - kGram) / S, s = (k - kGram) % S;
          vals[c] = aw[a] * (nm * carry[(size_t)s * N + n]);
        }
      }
    }, sums, stack, shape);
    if (threadIdx.x == 0) {
      solve_normal_equations<kDeg>(sums, S, scale, coef, product_coeffs + (size_t)e * S * kDeg,
                                   nullptr, S);
    }
    __syncthreads();

    if (is_prod) {
      // the exercise step of every state: carry <- payoff / numeraire + the
      // carry of the state it lands in
      for (uint32_t n = threadIdx.x; n < N; n += nthreads) {
        const double x = spot[n], nm = num[n];
        const Basis<kDeg> b(x);
        const double immediate = tmax(sign * (x - strike), 0.0);
        double grid[kMaxStates], old[kMaxStates];
        for (int j = 0; j < S; ++j) {
          grid[j] = b.dot(coef + j * kDeg);
          old[j] = carry[(size_t)j * N + n];
        }
        for (int s = 0; s < S; ++s) {
          const int down = s > 0 ? s - 1 : 0;
          const bool ex = exercises(immediate, grid[s], grid[down], s, flexi, itm);
          const double cf = immediate * (ex ? 1.0 : 0.0) / nm;
          carry[(size_t)s * N + n] = cf + (ex ? old[down] : old[s]);
        }
      }
    }
  }
}

template <int kDeg>
__global__ void __launch_bounds__(kValueThreads)
exercise_value_kernel(double* __restrict__ cfs, double* __restrict__ exposures,
                      const double* __restrict__ coeffs, const double* __restrict__ obs,
                      const int* __restrict__ rows, const double* __restrict__ strikes,
                      const int* __restrict__ options, const double* __restrict__ signs,
                      int num_products, int num_exposures, uint32_t N) {
  const uint32_t n = blockIdx.x * kValueThreads + threadIdx.x;
  if (n >= N) return;
  for (int p = blockIdx.y; p < num_products; p += gridDim.y) {
    const int* option = options + (size_t)p * kOptionFields;
    const int first_row = option[kFirstRow], num_events = option[kEvents], S = option[kStates];
    const bool itm = option[kItm] != 0, flexi = option[kFlexi] != 0;
    const double sign = signs[p];
    const double* product_coeffs = coeffs + option[kFirstCoef];
    int state = option[kInitial];
    double cf = 0.0;
    for (int e = 0; e < num_events; ++e) {
      const int r = first_row + e;
      const int* rw = rows + (size_t)r * kRowFields;
      const double x = obs[(size_t)rw[kSpotRow] * N + n];
      const double nm = obs[(size_t)rw[kNumRow] * N + n];
      const Basis<kDeg> b(x);
      const double* coef = product_coeffs + (size_t)e * S * kDeg;
      const double immediate = tmax(sign * (x - strikes[r]), 0.0);
      const double hold = b.dot(coef + state * kDeg);
      const double down = flexi ? b.dot(coef + (state > 0 ? state - 1 : 0) * kDeg) : 0.0;
      const bool ex = rw[kIsProd] != 0 && exercises(immediate, hold, down, state, flexi, itm);
      cf = cf + immediate * (ex ? 1.0 : 0.0) / nm;
      state -= ex ? 1 : 0;
      if (exposures != nullptr && rw[kExpSlot] >= 0) {
        exposures[((size_t)p * num_exposures + rw[kExpSlot]) * N + n] =
            b.dot(coef + state * kDeg) / nm;
      }
    }
    cfs[(size_t)p * N + n] = cf;
  }
}

template <int kDeg>
int launch_fit(double* coeffs, double* carry, const double* obs, const int* rows,
               const double* strikes, const int* options, const int* carry_rows,
               const double* signs, int num_products, uint32_t num_paths, cudaStream_t stream) {
  uint32_t padded = 1;
  while (padded < num_paths) padded <<= 1;
  const uint32_t per_warp = padded / 32;
  const int nthreads = per_warp < 32 ? 32 : per_warp > (uint32_t)kMaxThreads ? kMaxThreads
                                                                              : (int)per_warp;
  TreeShape shape;
  if (!tree_shape(num_paths, nthreads, kStackDoubles, &shape)) return (int)cudaErrorInvalidValue;
  const size_t fixed = gram_entries<kDeg>() + kDeg * kMaxStates + kDeg + kMaxStates * kDeg;
  const size_t smem = 8 * (fixed + stack_doubles(shape, nthreads));
  cudaError_t err = cudaFuncSetAttribute(exercise_fit_kernel<kDeg>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  exercise_fit_kernel<kDeg><<<num_products, nthreads, smem, stream>>>(
      coeffs, carry, obs, rows, strikes, options, carry_rows, signs, shape);
  return (int)cudaGetLastError();
}

template <int kDeg>
int launch_value(double* cfs, double* exposures, const double* coeffs, const double* obs,
                 const int* rows, const double* strikes, const int* options, const double* signs,
                 int num_products, int num_exposures, uint32_t num_paths, cudaStream_t stream) {
  const dim3 grid((num_paths + kValueThreads - 1) / kValueThreads,
                  num_products < 65535 ? num_products : 65535);
  exercise_value_kernel<kDeg><<<grid, kValueThreads, 0, stream>>>(
      cfs, exposures, coeffs, obs, rows, strikes, options, signs, num_products, num_exposures,
      num_paths);
  return (int)cudaGetLastError();
}

bool valid(int num_products, int deg, int s_max, uint32_t num_paths) {
  return num_products >= 1 && deg >= 1 && deg <= 4 && s_max >= 1 && s_max <= kMaxStates &&
         num_paths >= 1 && num_paths <= (1u << 30);
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for arguments out of range).  Pointers are device
// pointers: coeffs float64 [sum over products of events x states x deg];
// carry float64 scratch [sum over products of states, num_paths]; obs
// float64 [U, num_paths]; rows int32 [R, 4]; strikes float64 [R]; options
// int32 [num_products, 7] with every product's states <= s_max; carry_rows
// int32 [num_products]; signs float64 [num_products].  cfs float64
// [num_products, num_paths]; exposures float64 [num_products, num_exposures,
// num_paths] or null.
extern "C" int mcre_exercise_fit(void* coeffs, void* carry, const void* obs, const void* rows,
                                 const void* strikes, const void* options, const void* carry_rows,
                                 const void* signs, int num_products, int deg, int s_max,
                                 uint32_t num_paths, void* stream) {
  if (!valid(num_products, deg, s_max, num_paths) || coeffs == nullptr || carry == nullptr ||
      obs == nullptr || rows == nullptr || strikes == nullptr || options == nullptr ||
      carry_rows == nullptr || signs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  auto* c = static_cast<double*>(coeffs);
  auto* w = static_cast<double*>(carry);
  auto* o = static_cast<const double*>(obs);
  auto* r = static_cast<const int*>(rows);
  auto* k = static_cast<const double*>(strikes);
  auto* q = static_cast<const int*>(options);
  auto* cr = static_cast<const int*>(carry_rows);
  auto* g = static_cast<const double*>(signs);
  auto s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 1: return launch_fit<1>(c, w, o, r, k, q, cr, g, num_products, num_paths, s);
    case 2: return launch_fit<2>(c, w, o, r, k, q, cr, g, num_products, num_paths, s);
    case 3: return launch_fit<3>(c, w, o, r, k, q, cr, g, num_products, num_paths, s);
    default: return launch_fit<4>(c, w, o, r, k, q, cr, g, num_products, num_paths, s);
  }
}

extern "C" int mcre_exercise_value(void* cfs, void* exposures, const void* coeffs,
                                   const void* obs, const void* rows, const void* strikes,
                                   const void* options, const void* signs, int num_products,
                                   int deg, int s_max, int num_exposures, uint32_t num_paths,
                                   void* stream) {
  if (!valid(num_products, deg, s_max, num_paths) || cfs == nullptr || coeffs == nullptr ||
      obs == nullptr || rows == nullptr || strikes == nullptr || options == nullptr ||
      signs == nullptr || num_exposures < 0 || (exposures != nullptr && num_exposures == 0)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();
  auto* f = static_cast<double*>(cfs);
  auto* x = static_cast<double*>(exposures);
  auto* c = static_cast<const double*>(coeffs);
  auto* o = static_cast<const double*>(obs);
  auto* r = static_cast<const int*>(rows);
  auto* k = static_cast<const double*>(strikes);
  auto* q = static_cast<const int*>(options);
  auto* g = static_cast<const double*>(signs);
  auto s = static_cast<cudaStream_t>(stream);
  switch (deg) {
    case 1: return launch_value<1>(f, x, c, o, r, k, q, g, num_products, num_exposures, num_paths, s);
    case 2: return launch_value<2>(f, x, c, o, r, k, q, g, num_products, num_exposures, num_paths, s);
    case 3: return launch_value<3>(f, x, c, o, r, k, q, g, num_products, num_exposures, num_paths, s);
    default: return launch_value<4>(f, x, c, o, r, k, q, g, num_products, num_exposures, num_paths, s);
  }
}
