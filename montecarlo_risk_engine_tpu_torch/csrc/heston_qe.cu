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
//   * What bounds it: the SMs' issue slots.  Per substep one Philox4x32-10
//     call, a Box-Muller pair (logf, sqrtf, one sincosf), the QE update
//     (IEEE divisions, sqrtf, logf; heston_qe_step.cuh, shared with the
//     substep ladder heston_ladder.cu, which splits this count by stage):
//     304 issued instructions outside the slow paths (read from the SASS
//     by ops/sass.py).  The scalars that depend only on (params, dt) are
//     computed once per timeline point, as
//     _heston_qe_substep hoists them; per-point dts come in a small table
//     passed by value (mcre::PointTable, heston_qe_step.cuh).
//   * No host sync: the seven parameters are a device f32 vector [spot,
//     sigma, rate, rho, kappa, theta, v0] (the wrapper's torch.stack, rounded
//     once from the caller's dtype), read once per thread.
//   * Draws: Philox4x32-10, key (seed, phase), counter
//     (path, point * num_steps + k, 0, 0), path the global index
//     path_offset + path_stride * i of the thread's row i (a rank of a
//     path-sharded run draws its own paths and writes them as its own
//     contiguous rows; (0, 1) is the whole run).  Words 0 and 1 give
//     the Box-Muller pair (z_s, z_v), word 2 the QE uniform, each mapped as
//     ((w >> 8) + 0.5) / 2^24 and clamped below 1 (random.cuh).
//   * Built with -fmad=false and without fast math: every expression rounds
//     like the separate torch ops of the plain version.
//   * Variants are template flags: kSmooth (fuzzy branch widths 0.3 / 0.5)
//     and kEmit (write the draws of each point's last substep; zeros at
//     zero-dt points).  The eq.-44 martingale correction is not implemented;
//     the Python side refuses such models.

#include <cuda_runtime.h>
#include <stdint.h>

#include "heston_qe_step.cuh"
#include "random.cuh"

namespace {

using mcre::kThreads;
using mcre::PointTable;

// The emitting instances take four blocks per SM (at most 64 registers):
// left to itself ptxas gave them 48 registers and spilled.
template <bool kSmooth, bool kEmit>
__global__ void __launch_bounds__(kThreads, kEmit ? 4 : 0)
heston_qe_kernel(float2* __restrict__ states, float2* __restrict__ zs,
                 float* __restrict__ us, const PointTable table, int num_points,
                 int num_steps, uint32_t num_paths, const float* __restrict__ prm,
                 uint32_t seed, uint32_t phase, uint32_t path_offset, uint32_t path_stride) {
  const uint32_t path = blockIdx.x * blockDim.x + threadIdx.x;
  if (path >= num_paths) return;
  const uint32_t global_path = path_offset + path_stride * path;
  const uint2 key = make_uint2(seed, phase);

  const float sigma = __ldg(prm + 1), rate = __ldg(prm + 2), rho = __ldg(prm + 3);
  const float kappa = __ldg(prm + 4), theta = __ldg(prm + 5);
  float log_s = logf(__ldg(prm));
  float v = __ldg(prm + 6);

  for (int point = 0; point < num_points; ++point) {
    const float dt = table.dt[point];
    const size_t row = (size_t)point * num_paths + path;
    if (dt > 0.0f) {
      const mcre::QeScalars c = mcre::qe_scalars(dt, sigma, rate, rho, kappa, theta);
      float z_s = 0.0f, z_v = 0.0f, u = 0.0f;
      for (int k = 0; k < num_steps; ++k) {
        const uint4 w = mcre::philox4x32_10(
            make_uint4(global_path, (uint32_t)(point * num_steps + k), 0u, 0u), key);
        const float2 zz = mcre::box_muller(w.x, w.y);
        u = mcre::uniform_from_word(w.z);
        z_s = zz.x;
        z_v = zz.y;
        mcre::qe_update<kSmooth>(c, z_s, z_v, u, log_s, v);
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
            const float* prm, uint32_t seed, uint32_t phase, uint32_t path_offset,
            uint32_t path_stride, cudaStream_t stream) {
  const unsigned blocks = (num_paths + kThreads - 1) / kThreads;
  heston_qe_kernel<kSmooth, kEmit><<<blocks, kThreads, 0, stream>>>(
      states, zs, us, table, num_points, num_steps, num_paths, prm, seed,
      phase, path_offset, path_stride);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  states, z, u and
// params are device pointers; z and u may be null unless emit_noise is set;
// params is f32 [7] (spot, sigma, rate, rho, kappa, theta, v0).  dts is a
// host array of num_points floats (the per-substep dt of each point).  Row
// i draws global path path_offset + path_stride * i, which must stay below
// 2^32.
extern "C" int mcre_heston_qe_paths(void* states, void* z, void* u,
                                    const void* dts, int num_points,
                                    int num_steps, uint32_t num_paths,
                                    const void* params, uint32_t seed,
                                    uint32_t phase, uint32_t path_offset,
                                    uint32_t path_stride, int smoothing,
                                    int emit_noise, void* stream) {
  if (!mcre::valid_paths_launch(num_points, num_steps, num_paths, states, params) ||
      !mcre::valid_path_stride(num_paths, path_offset, path_stride) ||
      (emit_noise && (z == nullptr || u == nullptr || num_steps != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  const PointTable table = mcre::point_table(dts, num_points);
  const auto* prm = static_cast<const float*>(params);
  auto* s = static_cast<float2*>(states);
  auto* zz = static_cast<float2*>(z);
  auto* uu = static_cast<float*>(u);
  auto st = static_cast<cudaStream_t>(stream);
  if (smoothing) {
    if (emit_noise) {
      launch<true, true>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase,
                        path_offset, path_stride, st);
    } else {
      launch<true, false>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase,
                        path_offset, path_stride, st);
    }
  } else {
    if (emit_noise) {
      launch<false, true>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase,
                        path_offset, path_stride, st);
    } else {
      launch<false, false>(s, zz, uu, table, num_points, num_steps, num_paths, prm, seed, phase,
                        path_offset, path_stride, st);
    }
  }
  return (int)cudaGetLastError();
}
