// The LSM fit's device helpers, shared by the storage scan (storage_scan.cu)
// and the equity exercise scan (exercise_scan.cu): the monomial basis, the
// path sums in metrics.fixed_tree_sum's pairs, and utils/regression's
// fit_least_squares solve (the ridge, then cuBLAS's getrf and getrs).
//
// Every tree sum adds in fixed_tree_sum's pairs: padded with +0.0 to P2 (the
// path count rounded up to a power of two), element i added to element
// i + P2 / 2, and so on.  Path n belongs to thread n mod T.  Strides >= T pair
// elements of one thread: each thread folds its P2 / T elements in
// bit-reversed order on a stack in shared memory, which adds the same pairs.
// Strides T / 2 .. 32 go through shared memory, strides below 32 through warp
// shuffles (lane i takes lane i + s: the same pairs).  So any block size T
// gives the torch fit's bits; the sums go in chunks sized so the stack fits
// the kernel's shared-memory budget.
//
// Built with -fmad=false: every expression rounds like the separate torch
// ops on the card.  Where torch divides by a Python number (the path count,
// deg), PyTorch's CUDA kernel multiplies by its reciprocal, and so do these.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace mcre {

constexpr int kMaxThreads = 512;
constexpr int kMaxStates = 16;
constexpr int kMaxChunk = 16;

// torch.minimum / maximum / clamp on values that are not NaN.
__device__ __forceinline__ double tmin(double a, double b) { return b < a ? b : a; }
__device__ __forceinline__ double tmax(double a, double b) { return a < b ? b : a; }

// The monomial basis as PolynomialRegression computes it (x ** k): 1, x,
// x * x, x * x * x.
template <int kDeg>
struct Basis {
  double a[kDeg];
  __device__ explicit Basis(double x) {
    a[0] = 1.0;
    if constexpr (kDeg > 1) a[1] = x;
    if constexpr (kDeg > 2) a[2] = x * x;
    if constexpr (kDeg > 3) a[3] = x * x * x;
  }
  // ops/noise.matmul_t: the products summed in index order.
  __device__ double dot(const double* c) const {
    double g = a[0] * c[0];
#pragma unroll
    for (int k = 1; k < kDeg; ++k) g = g + a[k] * c[k];
    return g;
  }
};

struct TreeShape {
  uint32_t num_paths;  // N
  uint32_t padded;     // P2: N rounded up to a power of two
  int log_leaves;      // log2 of the elements a thread folds (P2 / T when P2 >= T, else 1)
  int chunk;           // sums per pass
};

// The tree sums' shape for blocks of nthreads threads, each thread's stack
// at most stack_doubles doubles: false when not even one sum a pass fits.
inline bool tree_shape(uint32_t num_paths, int nthreads, int stack_doubles, TreeShape* shape) {
  uint32_t padded = 1;
  while (padded < num_paths) padded <<= 1;
  int log_leaves = 0;
  while (((uint32_t)nthreads << log_leaves) < padded) ++log_leaves;
  int chunk = stack_doubles / (log_leaves + 1);
  chunk = chunk > kMaxChunk ? kMaxChunk : chunk;
  *shape = {num_paths, padded, log_leaves, chunk};
  return chunk >= 1;
}

// Shared-memory doubles of the stacks of one block.
inline size_t stack_doubles(const TreeShape& shape, int nthreads) {
  return (size_t)(shape.log_leaves + 1) * shape.chunk * nthreads;
}

// out[k] = fixed_tree_sum over the paths of prod(n, k0, kc, vals) for k = 0 ..
// count - 1 (prod fills vals[c] with the product of sum k0 + c at path n).
// Called by every thread of the block; out is in shared memory.
template <class Prod>
__device__ void tree_sums(int count, Prod prod, double* out, double* stack,
                          const TreeShape& shape) {
  const int t = threadIdx.x, nthreads = blockDim.x;
  const int leaves = 1 << shape.log_leaves;
  const int width = shape.padded < (uint32_t)nthreads ? (int)shape.padded : nthreads;
  double* red = stack + (size_t)shape.log_leaves * shape.chunk * nthreads;
  for (int k0 = 0; k0 < count; k0 += shape.chunk) {
    const int kc = count - k0 < shape.chunk ? count - k0 : shape.chunk;
    __syncthreads();  // the stack's last pass is read
    if (t < width) {
      for (int q = 0; q < leaves; ++q) {
        // leaf q of the thread's own tree: its element j = bitreverse(q), so
        // the stack adds j and j + leaves / 2 first, as the halvings do
        const uint32_t j = shape.log_leaves ? __brev((uint32_t)q) >> (32 - shape.log_leaves) : 0u;
        const uint32_t n = (uint32_t)t + (uint32_t)nthreads * j;
        double vals[kMaxChunk];
        if (n < shape.num_paths) {
          prod(n, k0, kc, vals);
        } else {
          for (int c = 0; c < kc; ++c) vals[c] = 0.0;  // the halvings' +0.0 padding
        }
        for (int c = 0; c < kc; ++c) {
          double v = vals[c];
          int lvl = 0;
          for (; (q >> lvl) & 1; ++lvl) v = stack[((size_t)lvl * shape.chunk + c) * nthreads + t] + v;
          stack[((size_t)lvl * shape.chunk + c) * nthreads + t] = v;
        }
      }
    }
    for (int s = width / 2; s >= 32; s >>= 1) {
      __syncthreads();
      if (t < s) {
        for (int c = 0; c < kc; ++c) red[c * nthreads + t] = red[c * nthreads + t] + red[c * nthreads + t + s];
      }
    }
    __syncthreads();
    if (t < 32) {
      const int lanes = width < 32 ? width : 32;
      for (int c = 0; c < kc; ++c) {
        double v = t < lanes ? red[c * nthreads + t] : 0.0;
        for (int s = lanes / 2; s >= 1; s >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, s);
        if (t == 0) out[k0 + c] = v;
      }
    }
  }
  __syncthreads();
}

// fit_least_squares's column scales: scale[k] = max(sqrt(tree sum of
// basis_k(spot)^2 / N), 1e-30), in shared memory (sums: kDeg scratch
// doubles there).  Called by every thread of the block.
template <int kDeg>
__device__ void column_scales(const double* spot, double* sums, double* scale, double* stack,
                              const TreeShape& shape) {
  tree_sums(kDeg, [&](uint32_t n, int k0, int kc, double* vals) {
    const Basis<kDeg> b(spot[n]);
    for (int c = 0; c < kc; ++c) vals[c] = b.a[k0 + c] * b.a[k0 + c];
  }, sums, stack, shape);
  if (threadIdx.x == 0) {
    for (int k = 0; k < kDeg; ++k) scale[k] = tmax(sqrt(sums[k] * (1.0 / (double)shape.num_paths)), 1e-30);
  }
  __syncthreads();
}

// The Gram's unique entries in row order: (a, b), a <= b.
template <int kDeg>
__device__ __forceinline__ void gram_pair(int k, int& a, int& b) {
  a = 0;
  while (k >= kDeg - a) {
    k -= kDeg - a;
    ++a;
  }
  b = a + k;
}

template <int kDeg>
__host__ __device__ constexpr int gram_entries() { return kDeg * (kDeg + 1) / 2; }

// fit_least_squares's solve on one thread.  sums: the Gram's unique entries
// (gram_pair order), then the right-hand sides, sums[kGram + a * S + s] for
// basis column a and state s.  normal (or null): the Gram and right-hand
// sides before the ridge, [kDeg, kDeg + s_max].  Writes coefficient k of
// state s, divided by scale[k], to coef[s * kDeg + k] and out[s * kDeg + k].
template <int kDeg>
__device__ void solve_normal_equations(const double* sums, int S, const double* scale,
                                       double* coef, double* out, double* normal, int s_max) {
  constexpr int kGram = gram_entries<kDeg>();
  double g[kDeg][kDeg], rhs[kDeg][kMaxStates];
  for (int k = 0; k < kGram; ++k) {
    int a, b;
    gram_pair<kDeg>(k, a, b);
    g[a][b] = sums[k];
    g[b][a] = sums[k];
  }
  for (int a = 0; a < kDeg; ++a) {
    for (int s = 0; s < S; ++s) rhs[a][s] = sums[kGram + a * S + s];
  }
  if (normal != nullptr) {
    for (int a = 0; a < kDeg; ++a) {
      for (int b = 0; b < kDeg; ++b) normal[a * (kDeg + s_max) + b] = g[a][b];
      for (int s = 0; s < S; ++s) normal[a * (kDeg + s_max) + kDeg + s] = rhs[a][s];
    }
  }
  // the ridge: 1e-10 of the mean diagonal (+1e-30) on the diagonal; the
  // diagonal's sum as torch.sum adds it on the card, four accumulators
  // combined in pairs
  double d[4] = {0.0, 0.0, 0.0, 0.0};
  for (int a = 0; a < kDeg; ++a) d[a] = g[a][a];
  const double trace = (d[0] + d[2]) + (d[1] + d[3]);
  const double ridge = 1e-10 * (trace * (1.0 / kDeg)) + 1e-30;
  for (int a = 0; a < kDeg; ++a) {
    for (int b = 0; b < kDeg; ++b) g[a][b] = g[a][b] + ridge * (a == b ? 1.0 : 0.0);
  }
  // LU with partial pivoting (the first largest |pivot|), then the solve,
  // in the float operations of torch.linalg.lu_factor_ex and lu_solve on
  // the card (cuBLAS's getrf and getrs, batched or not): multipliers by the
  // pivot's reciprocal, fused multiply-adds in the eliminations, the back
  // substitution by columns dividing by the diagonal
  for (int k = 0; k < kDeg; ++k) {
    int p = k;
    for (int i = k + 1; i < kDeg; ++i) {
      if (fabs(g[i][k]) > fabs(g[p][k])) p = i;
    }
    if (p != k) {
      for (int j = 0; j < kDeg; ++j) {
        const double tmp = g[k][j];
        g[k][j] = g[p][j];
        g[p][j] = tmp;
      }
      for (int s = 0; s < S; ++s) {
        const double tmp = rhs[k][s];
        rhs[k][s] = rhs[p][s];
        rhs[p][s] = tmp;
      }
    }
    const double inv_pivot = 1.0 / g[k][k];
    for (int i = k + 1; i < kDeg; ++i) {
      const double l = g[i][k] * inv_pivot;
      for (int j = k + 1; j < kDeg; ++j) g[i][j] = fma(-l, g[k][j], g[i][j]);
      for (int s = 0; s < S; ++s) rhs[i][s] = fma(-l, rhs[k][s], rhs[i][s]);
    }
  }
  for (int s = 0; s < S; ++s) {
    double x[kDeg];
    for (int j = kDeg - 1; j >= 0; --j) {
      x[j] = rhs[j][s] / g[j][j];
      for (int i = 0; i < j; ++i) rhs[i][s] = fma(-g[i][j], x[j], rhs[i][s]);
    }
    for (int k = 0; k < kDeg; ++k) {
      const double cf = x[k] / scale[k];
      coef[s * kDeg + k] = cf;
      out[s * kDeg + k] = cf;
    }
  }
}

}  // namespace mcre
