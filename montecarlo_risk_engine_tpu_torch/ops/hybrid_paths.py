"""Hybrid-model path generation: the CUDA kernel K2 and its plain version.

Replaces the TPU kernel ``hybrid_paths``
(montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153) for its Euler blocks
bs, vasicek and cirpp — the blocks of the north-star xVA book's ModelConfig.
What it computes: joint paths of the sub-models, [T, N, D] float32 in block
order.  Per substep ``sim_dim`` standard normals (Philox, the stream of
``rng.substep_normals``) are combined through the static lower-triangular
joint Cholesky factor, w = L z, and each block takes its Euler step:

  * bs:      S' = S (1 + r dt) + sigma S sqrt(dt) w             (emits S)
  * vasicek: log_B' = log_B + r dt; r' = r + a (theta - r) dt + sigma sqrt(dt) w
  * cirpp:   log_B' = log_B + (y + psi(t1)) dt;
             y' = max(y + kappa (theta - y) dt + sigma sqrt(max(y, 0)) sqrt(dt) w, 1e-12)

Kernel (``csrc/hybrid_paths.cu``, CUDA C++ for sm_90a, built by
ops/cuda_build): one thread per path with the whole state in registers,
block descriptors at run time, parameters as a device vector, the
per-substep scalars (dt, sqrt(dt), psi per cirpp block) in a device table
built here in torch — no host sync before the launch.  Bound by the bytes
of its emission; see the source's note.

:func:`hybrid_paths` dispatches on the device of ``params``: CUDA tensors
launch the kernel (or raise), CPU tensors run
:func:`hybrid_paths_reference`, which repeats the kernel's float32
arithmetic op for op from the same table.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.ops import cuda_build

# csrc/hybrid_paths.cu kMaxBlocks: every supported block has one noise factor, so
# this also bounds sim_dim.
MAX_BLOCKS = 8
_KINDS = {"bs": 0, "vasicek": 1, "cirpp": 2}
_WIDTHS = {"bs": 1, "vasicek": 2, "cirpp": 2}
_NUM_PARAMS = {"bs": 3, "vasicek": 4, "cirpp": 4}


@dataclass(frozen=True)
class KernelBlock:
    """One sub-model's slice of the joint kernel (pallas_hybrid.py:49-73).

    kind: "bs" | "vasicek" | "cirpp" (Euler); param_base: offset of the
    block's parameters in the flat vector; n_state / n_sim: state and noise
    widths; hazard_tenors / hazard_rates: the static market hazard curve of
    a cirpp block."""

    kind: str
    param_base: int
    n_state: int
    n_sim: int
    hazard_tenors: Tuple[float, ...] = field(default=())
    hazard_rates: Tuple[float, ...] = field(default=())

    def lambda_market(self, t: float) -> float:
        """Piecewise-constant hazard, flat beyond the last tenor, with the
        tenor comparison in float32 (pallas_hybrid.py:75-87): a substep that
        straddles a tenor only in float64 takes the segment the kernel's
        float32 time would."""
        t32 = np.float32(t)
        for tenor, rate in zip(self.hazard_tenors, self.hazard_rates):
            if t32 <= np.float32(tenor):
                return rate
        return self.hazard_rates[-1]


def _check_args(blocks, chol, params, num_paths, num_steps):
    if not 0 < len(blocks) <= MAX_BLOCKS:
        raise ValueError(f"hybrid_paths takes 1..{MAX_BLOCKS} blocks, got {len(blocks)}")
    for b in blocks:
        if b.kind not in _KINDS or b.n_state != _WIDTHS[b.kind] or b.n_sim != 1:
            raise ValueError(f"hybrid_paths has no {b.kind!r} block of widths "
                             f"({b.n_state}, {b.n_sim})")
    if np.asarray(chol).shape != (len(blocks), len(blocks)):
        raise ValueError("chol must be [sim_dim, sim_dim]")
    if any(b.param_base + _NUM_PARAMS[b.kind] > len(params) for b in blocks):
        raise ValueError("a block's parameters lie beyond the parameter vector")
    if num_steps < 1 or not 0 < num_paths < 2 ** 32:
        raise ValueError(f"bad num_steps={num_steps} / num_paths={num_paths}")


def substep_table(blocks: Sequence[KernelBlock], params, timeline: Sequence[float],
                  num_steps: int, calibration_date: float = 0.0) -> torch.Tensor:
    """[T * num_steps, 2 + n_cirpp] float32 on the device of ``params``: per
    substep dt, sqrt(dt) and psi(t1) of each cirpp block (zeros at the rows
    of a zero-length point, which draws nothing).

    dt and sqrt(dt) are host float64 values rounded once, as the TPU kernel
    bakes them (pallas_hybrid.py:193-204); psi(t1) = lambda_mkt(t1) + D(t1)
    - y0 E(t1) (pallas_hybrid.py:120-133) is computed in float64 on the
    device from ``params`` and rounded, so no parameter crosses to the host."""
    device = params[0].device
    t1s, rows = [], []
    t_prev = float(calibration_date)
    for t in timeline:
        interval = float(t) - t_prev
        for k in range(num_steps):
            if interval > 0.0:
                dt = interval / num_steps
                t1s.append(t_prev + k * dt)
                rows.append((dt, np.sqrt(dt)))
            else:
                t1s.append(0.0)
                rows.append((0.0, 0.0))
        t_prev = float(t)
    host = np.asarray(rows, dtype=np.float64).reshape(-1, 2)
    cirpp = [b for b in blocks if b.kind == "cirpp"]
    lam = np.asarray([[b.lambda_market(t1) for b in cirpp] for t1 in t1s],
                     dtype=np.float64).reshape(len(t1s), len(cirpp))
    host_t = torch.from_numpy(np.concatenate([host, np.asarray(t1s)[:, None], lam], axis=1))
    if device.type == "cuda":
        host_t = host_t.pin_memory()
    dev = host_t.to(device, non_blocking=True)
    cols = [dev[:, 0], dev[:, 1]]
    t1 = dev[:, 2]
    live = dev[:, 0] > 0.0
    for j, b in enumerate(cirpp):
        kappa, theta, sigma, y0 = (params[b.param_base + i].detach().to(torch.float64)
                                   for i in range(4))
        h = torch.sqrt(kappa * kappa + 2.0 * sigma * sigma)
        et = torch.exp(h * t1)
        den = 2.0 * h + (kappa + h) * (et - 1.0)
        d_t = (2.0 * kappa * theta / (sigma * sigma)) * (0.5 * (kappa + h) - h * (kappa + h) * et / den)
        e_t = 4.0 * h * h * et / (den * den)
        psi = dev[:, 3 + j] + d_t - y0 * e_t
        cols.append(torch.where(live, psi, torch.zeros_like(psi)))
    return torch.stack(cols, dim=1).to(torch.float32)


def _layout(blocks):
    """(state offsets, psi columns, state_dim) of a block list."""
    state_off, psi_col, off, n_cirpp = [], [], 0, 0
    for b in blocks:
        state_off.append(off)
        off += b.n_state
        if b.kind == "cirpp":
            psi_col.append(2 + n_cirpp)
            n_cirpp += 1
        else:
            psi_col.append(0)
    return state_off, psi_col, off


def _chol32(chol) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(chol, dtype=np.float64).astype(np.float32))


def correlate(chol, z: torch.Tensor) -> List[torch.Tensor]:
    """w = L z as the kernel forms it: per row, the products with the
    non-zero entries of ``chol`` (a host array) summed left to right."""
    w = []
    for i in range(z.shape[-1]):
        acc = None
        for e in range(i + 1):
            c = float(chol[i, e])
            if c != 0.0:
                acc = c * z[:, e] if acc is None else acc + c * z[:, e]
        w.append(acc)
    return w


def hybrid_substep(blocks: Sequence[KernelBlock], prm, s0, s1, w, dt, sqrt_dt, row):
    """One Euler substep of every block, the kernel's update op for op.

    ``prm``: the parameters (0-d tensors); ``s0``/``s1``: per block its
    first and second state column ([N] tensors; s1 unused by bs); ``w``:
    per block its correlated noise [N]; ``dt``/``sqrt_dt``/``row``: the
    substep's table entries (row[psi column] is a cirpp block's psi).
    Returns the new (s0, s1) lists."""
    _, psi_col, _ = _layout(blocks)
    s0, s1 = list(s0), list(s1)
    for bi, b in enumerate(blocks):
        p = prm[b.param_base:b.param_base + 4]
        if b.kind == "bs":
            sigma, rate = p[1], p[2]
            s = s0[bi]
            s0[bi] = s * (1.0 + rate * dt) + sigma * s * sqrt_dt * w[bi]
        elif b.kind == "vasicek":
            sigma, theta, a = p[1], p[2], p[3]
            r = s0[bi]
            s1[bi] = s1[bi] + r * dt
            s0[bi] = r + a * (theta - r) * dt + sigma * sqrt_dt * w[bi]
        else:
            kappa, theta, sigma = p[0], p[1], p[2]
            y = s0[bi]
            s1[bi] = s1[bi] + (y + row[psi_col[bi]]) * dt
            sqrt_y = torch.sqrt(torch.clamp(y, min=0.0))
            s0[bi] = torch.clamp(
                y + kappa * (theta - y) * dt + sigma * sqrt_y * sqrt_dt * w[bi], min=1e-12)
    return s0, s1


def hybrid_paths_reference(blocks: Sequence[KernelBlock], chol, params,
                           timeline: Sequence[float], num_paths: int, num_steps: int,
                           seed: int = 0, phase: int = 0, calibration_date: float = 0.0):
    """Plain PyTorch version of the kernel, float32 on the device of
    ``params``: the same Philox words, the same table, the same operations
    in the same order."""
    _check_args(blocks, chol, params, num_paths, num_steps)
    f32 = torch.float32
    device = params[0].device
    table = substep_table(blocks, params, timeline, num_steps, calibration_date)
    prm = [p.detach().to(f32) for p in params]
    c32 = _chol32(chol)
    sim_dim = len(blocks)

    s0: List[torch.Tensor] = []
    s1: List[torch.Tensor] = []
    for b in blocks:
        first = prm[b.param_base + 3] if b.kind == "cirpp" else prm[b.param_base]
        s0.append(first.expand(num_paths))
        s1.append(torch.zeros((num_paths,), dtype=f32, device=device))

    out = []
    t_prev = float(calibration_date)
    for point, t in enumerate(timeline):
        row0 = point * num_steps
        live, t_prev = float(t) > t_prev, float(t)
        if live:
            for k in range(num_steps):
                row = table[row0 + k]
                dt, sqrt_dt = row[0], row[1]
                z = rng.substep_normals(seed, phase, row0 + k, num_paths, sim_dim, f32, device)
                s0, s1 = hybrid_substep(blocks, prm, s0, s1, correlate(c32, z), dt, sqrt_dt, row)
        cols = []
        for bi, b in enumerate(blocks):
            cols.append(s0[bi])
            if b.kind != "bs":
                cols.append(s1[bi])
        out.append(torch.stack(cols, dim=-1))
    if not out:
        return torch.zeros((0, num_paths, _layout(blocks)[2]), dtype=f32, device=device)
    return torch.stack(out)


def _bind(lib: ctypes.CDLL):
    fn = lib.mcre_hybrid_paths
    int_p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # out, params, table
        ctypes.c_int, int_p, int_p, int_p, int_p,              # blocks, kinds, bases, offs, psi
        ctypes.POINTER(ctypes.c_float),                        # chol
        ctypes.c_int, ctypes.c_int,                            # state_dim, table_width
        ctypes.c_int, ctypes.c_int, ctypes.c_uint32,           # points, steps, paths
        ctypes.c_uint32, ctypes.c_uint32,                      # seed, phase
        ctypes.c_void_p,                                       # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(blocks, chol, params, timeline, num_paths, num_steps, seed, phase,
            calibration_date):
    fn = _bind(cuda_build.load_library("hybrid_paths").lib)
    device = params[0].device
    state_off, psi_col, state_dim = _layout(blocks)
    n_pts = len(timeline)
    out = torch.empty((n_pts, num_paths, state_dim), dtype=torch.float32, device=device)
    if n_pts == 0:
        return out
    table = substep_table(blocks, params, timeline, num_steps, calibration_date)
    prm = torch.stack([p.detach().to(torch.float32) for p in params]).contiguous()
    nb = len(blocks)
    ints = lambda xs: (ctypes.c_int * nb)(*xs)
    c32 = _chol32(chol).reshape(-1)
    with torch.cuda.device(device):
        rc = fn(
            out.data_ptr(), prm.data_ptr(), table.data_ptr(),
            nb, ints([_KINDS[b.kind] for b in blocks]), ints([b.param_base for b in blocks]),
            ints(state_off), ints(psi_col),
            (ctypes.c_float * c32.size)(*c32.tolist()),
            state_dim, table.shape[1], n_pts, num_steps, num_paths,
            seed & 0xFFFFFFFF, phase & 0xFFFFFFFF,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"hybrid_paths: CUDA launch failed with cudaError_t {rc}")
    hybrid_paths.launches += 1
    return out


def hybrid_paths(blocks: Sequence[KernelBlock], chol, params, timeline: Sequence[float],
                 num_paths: int, num_steps: int, seed: int = 0, phase: int = 0,
                 calibration_date: float = 0.0):
    """Joint states at timeline points: [T, N, D] float32 in block order.

    ``chol``: the static [sim_dim, sim_dim] lower-triangular joint factor
    (host array); ``params``: the flat parameter tuple of 0-d tensors.  CUDA
    ``params`` launch the kernel; CPU ``params`` run
    :func:`hybrid_paths_reference`."""
    _check_args(blocks, chol, params, num_paths, num_steps)
    device = params[0].device
    if device.type == "cpu":
        return hybrid_paths_reference(blocks, chol, params, timeline, num_paths, num_steps,
                                      seed=seed, phase=phase, calibration_date=calibration_date)
    if device.type != "cuda":
        raise ValueError(f"hybrid_paths: unsupported device {device}")
    return _launch(blocks, chol, params, timeline, num_paths, num_steps, seed, phase,
                   calibration_date)


hybrid_paths.launches = 0  # kernel launches
