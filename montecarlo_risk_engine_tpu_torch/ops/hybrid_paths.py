"""Hybrid-model path generation: the CUDA kernel K2 and its plain version.

Replaces the TPU kernel ``hybrid_paths``
(montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153) whole: every block
kind and scheme it implements.  What it computes: joint paths of the
sub-models, [T, N, D] float32 in block order.  Per substep ``sim_dim``
standard normals (Philox, the stream of ``rng.substep_normals``) are
combined through the static lower-triangular joint Cholesky factor,
w = L z, and each block takes its step (pallas_hybrid.py:286-416):

  * bs / bs_multi exact: log S' = log S + (r - sigma^2 / 2) dt + sigma sqrt(dt) w
    (the state is log S, emitted as S); Euler: S' = S (1 + r dt) + sigma S sqrt(dt) w
  * vasicek: log_B' = log_B + r dt; exact r' = theta + (r - theta) decay + scale w,
    Euler r' = r + a (theta - r) dt + sigma sqrt(dt) w
  * cirpp: log_B' = log_B + (y + psi(t1)) dt;
    y' = max(y + kappa (theta - y) dt + sigma sqrt(max(y, 0)) sqrt(dt) w, 1e-12)
  * cirpp_det: log_B' = log_B + lambda_mkt(t1) dt; y' = lambda_mkt(t1 + dt)
    (its noise factor is drawn and not read, as in the TPU block layout)
  * hw: log_B' = log_B + r dt; x = r - alpha(t1); exact x' = x decay + scale w,
    Euler x' = x - a x dt + sigma sqrt(dt) w; r' = x' + alpha(t1 + dt)
  * s2f: two raw normals (w, w2) correlated in the block with its own rho;
    exact x' = x decay + std_x w, y' = y + mu dt + std_y (rho w + rho_c w2),
    Euler with sigma sqrt(dt) in place of the exact std; log S' = log F0(t1 + dt) + x' + y'

Kernel (``csrc/hybrid_paths.cu``, CUDA C++ for sm_90a, built by
ops/cuda_build): one thread per path, the state in registers as one *slot*
per noise factor holding at most two state columns (:func:`kernel_slots`),
slot descriptors read at run time, parameters as a device vector, the
initial state as a device vector, and every per-substep constant (dt,
sqrt(dt), psi, decay, scale, alpha, lambda_mkt, log F0, rho_c, the s2f
stds) in a device table built here in torch from the device parameters:
no host sync before the launch.  Bound by the bytes of its emission; see
the source's note.

:func:`hybrid_paths` dispatches on the device of ``params``: CUDA tensors
launch the kernel (or raise), CPU tensors run
:func:`hybrid_paths_reference`, which repeats the kernel's float32
arithmetic op for op from the same table.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import rng
from montecarlo_risk_engine_tpu_torch.ops import cuda_build

# csrc/hybrid_paths.cu kMaxSim: the most noise factors (= register slots) a
# block list may have.
MAX_SIM = 8

# Slot roles (csrc/hybrid_paths.cu enum Role).
GBM_EXACT, GBM_EULER, VAS_EXACT, VAS_EULER, CIRPP, CIRPP_DET = 0, 1, 2, 3, 4, 5
HW_EXACT, HW_EULER, S2F_X_EXACT, S2F_X_EULER, S2F_Y_EXACT, S2F_Y_EULER = 6, 7, 8, 9, 10, 11

# kind -> number of parameters (None: 2 n_state + 1 for bs_multi).  Every
# kind takes the schemes "exact" and "euler"; cirpp and cirpp_det have one
# step for both, as in the TPU kernel.
_KINDS = {"bs": 3, "bs_multi": None, "vasicek": 4, "cirpp": 4, "cirpp_det": 4, "hw": 2, "s2f": 6}
_WIDTHS = {"bs": (1, 1), "vasicek": (2, 1), "cirpp": (2, 1), "cirpp_det": (2, 1),
           "hw": (2, 1), "s2f": (3, 2)}
# per-substep table columns of a block, after dt and sqrt(dt): (euler, exact)
_TABLE_COLS = {"vasicek": (0, 2), "cirpp": (1, 1), "cirpp_det": (2, 2), "hw": (2, 4),
               "s2f": (2, 5)}


@dataclass(frozen=True)
class KernelBlock:
    """One sub-model's slice of the joint kernel (pallas_hybrid.py:49-117).

    kind: "bs" | "bs_multi" | "vasicek" | "cirpp" | "cirpp_det" | "hw" | "s2f";
    scheme: "exact" | "euler" (cirpp, cirpp_det: one step for both); param_base:
    offset of the block's parameters in the flat vector; n_state / n_sim:
    state and noise widths (bs_multi: both the asset count, parameters
    [spots..., vols..., rate]); hazard_tenors / hazard_rates: the static
    market hazard curve of a cirpp block; curve_times / curve_vals: the
    static market curve of an hw block (pillars and the float64 segment
    forwards) or an s2f block (baseline forward values)."""

    kind: str
    scheme: str
    param_base: int
    n_state: int
    n_sim: int
    hazard_tenors: Tuple[float, ...] = field(default=())
    hazard_rates: Tuple[float, ...] = field(default=())
    curve_times: Tuple[float, ...] = field(default=())
    curve_vals: Tuple[float, ...] = field(default=())

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

    def hw_fwd0(self, t: float) -> float:
        """Market forward f(0, t) from the float64 segment-forward table
        (pallas_hybrid.py:89-108): right-continuous at pillars, the first and
        last segment beyond the ends, the segment chosen by comparing in
        float32 as the model's lookup does."""
        ts = np.asarray(self.curve_times, dtype=np.float32)
        idx = int(np.clip(np.searchsorted(ts, np.float32(t), side="right") - 1,
                          0, len(self.curve_vals) - 1))
        return float(self.curve_vals[idx])

    def s2f_logf0(self, t: float) -> float:
        """log F0(t) of the baseline forward curve, linear inside and flat
        beyond the ends (pallas_hybrid.py:110-117)."""
        return float(np.log(np.interp(t, np.asarray(self.curve_times),
                                      np.asarray(self.curve_vals))))


class Slot(NamedTuple):
    """One register slot of the kernel: a noise factor and the (at most
    two) state columns it updates.  ``pa``/``pb``: parameter indices the
    role reads; ``tcol``: its first table column; ``oa``/``ob``: the output
    columns of its two state values (-1: none)."""

    role: int
    pa: int
    pb: int
    tcol: int
    oa: int
    ob: int


def _check_blocks(blocks: Sequence[KernelBlock], num_params: int) -> None:
    if not blocks:
        raise ValueError("hybrid_paths needs at least one block")
    for b in blocks:
        if b.kind not in _KINDS or b.scheme not in ("exact", "euler"):
            raise ValueError(f"hybrid_paths has no {b.kind!r} block under {b.scheme!r}")
        widths = (b.n_state, b.n_state) if b.kind == "bs_multi" else _WIDTHS[b.kind]
        if (b.n_state, b.n_sim) != widths or b.n_state < 1:
            raise ValueError(f"hybrid_paths has no {b.kind!r} block of widths "
                             f"({b.n_state}, {b.n_sim})")
        n_par = _KINDS[b.kind] or 2 * b.n_state + 1
        if b.param_base < 0 or b.param_base + n_par > num_params:
            raise ValueError(f"the {b.kind!r} block's parameters lie beyond the parameter vector")
        if b.kind in ("cirpp", "cirpp_det") and not b.hazard_rates:
            raise ValueError(f"a {b.kind!r} block needs its hazard curve")
        if b.kind in ("hw", "s2f") and not b.curve_vals:
            raise ValueError(f"a {b.kind!r} block needs its market curve")
    sim_dim = sum(b.n_sim for b in blocks)
    if sim_dim > MAX_SIM:
        raise ValueError(f"hybrid_paths takes at most {MAX_SIM} noise factors, got {sim_dim}")


def kernel_slots(blocks: Sequence[KernelBlock]):
    """(slots, state_dim, table_width) of a block list: the kernel's
    register layout, one slot per noise factor in block order."""
    slots: List[Slot] = []
    off, tcol = 0, 2
    for b in blocks:
        base, exact = b.param_base, b.scheme == "exact"
        if b.kind in ("bs", "bs_multi"):
            n = b.n_state
            rate = base + (2 if b.kind == "bs" else 2 * n)
            for d in range(n):
                sigma = base + (1 if b.kind == "bs" else n + d)
                slots.append(Slot(GBM_EXACT if exact else GBM_EULER, sigma, rate, 0, off + d, -1))
        elif b.kind == "vasicek":
            slots.append(Slot(VAS_EXACT, base + 2, 0, tcol, off, off + 1) if exact
                         else Slot(VAS_EULER, base + 1, 0, 0, off, off + 1))
        elif b.kind == "cirpp":
            slots.append(Slot(CIRPP, base, 0, tcol, off, off + 1))
        elif b.kind == "cirpp_det":
            slots.append(Slot(CIRPP_DET, 0, 0, tcol, off, off + 1))
        elif b.kind == "hw":
            slots.append(Slot(HW_EXACT if exact else HW_EULER, base, 0, tcol, off, off + 1))
        else:  # s2f: state [log S, x, y]; slot x carries log S, slot y follows it
            slots.append(Slot(S2F_X_EXACT if exact else S2F_X_EULER, base + 1, base + 2, tcol,
                              off + 1, off))
            slots.append(Slot(S2F_Y_EXACT if exact else S2F_Y_EULER, base + 3, base + 5, tcol,
                              off + 2, -1))
        off += b.n_state
        tcol += _TABLE_COLS.get(b.kind, (0, 0))[b.scheme == "exact"]
    return slots, off, tcol


def _substeps(timeline: Sequence[float], num_steps: int, calibration_date: float):
    """Per table row (t1, dt): num_steps rows per point; a zero-length
    point's rows have dt = 0 (it draws nothing)."""
    rows = []
    t_prev = float(calibration_date)
    for t in timeline:
        interval = float(t) - t_prev
        for k in range(num_steps):
            if interval > 0.0:
                dt = interval / num_steps
                rows.append((t_prev + k * dt, dt))
            else:
                rows.append((0.0, 0.0))
        t_prev = float(t)
    return rows


def substep_table(blocks: Sequence[KernelBlock], params, timeline: Sequence[float],
                  num_steps: int, calibration_date: float = 0.0) -> torch.Tensor:
    """[T * num_steps, table_width] float32 on the device of ``params``: per
    substep dt, sqrt(dt), then each block's columns (zeros at the rows of
    a zero-length point):

      * vasicek exact: decay = exp(-a dt), scale = sqrt(sigma^2 / (2a) (1 - decay^2))
      * cirpp: psi(t1) = lambda_mkt(t1) + D(t1) - y0 E(t1) (pallas_hybrid.py:120-133)
      * cirpp_det: lambda_mkt(t1), lambda_mkt(t1 + dt)
      * hw: alpha(t1), alpha(t1 + dt) with alpha(t) = f(0, t) + sigma^2 / (2 a^2)
        (1 - exp(-a (t - t0)))^2; exact adds decay, scale
      * s2f: log F0(t1 + dt), rho_c = sqrt(max(1 - rho^2, 0)); exact adds decay,
        std_x (the kappa -> 0 guard of pallas_hybrid.py:395-406), std_y = sigma_l sqrt(dt)

    Host values (dt, the market curves) are float64; the parameter-dependent
    ones are computed in float64 on the device from ``params`` and rounded
    once, so no parameter crosses to the host."""
    device = params[0].device
    rows = _substeps(timeline, num_steps, calibration_date)
    t1 = np.asarray([r[0] for r in rows], dtype=np.float64)
    dt = np.asarray([r[1] for r in rows], dtype=np.float64)
    host = [dt, np.sqrt(dt), t1]
    for b in blocks:  # host curve values of every block, in block order
        if b.kind == "cirpp":
            host.append(np.asarray([b.lambda_market(t) for t in t1]))
        elif b.kind == "cirpp_det":
            host.append(np.asarray([b.lambda_market(t) for t in t1]))
            host.append(np.asarray([b.lambda_market(t + h) for t, h in zip(t1, dt)]))
        elif b.kind == "hw":
            host.append(np.asarray([b.hw_fwd0(t) for t in t1]))
            host.append(np.asarray([b.hw_fwd0(t + h) for t, h in zip(t1, dt)]))
        elif b.kind == "s2f":
            host.append(np.asarray([b.s2f_logf0(t + h) for t, h in zip(t1, dt)]))
    host_t = torch.from_numpy(np.stack(host, axis=1).reshape(len(rows), len(host)))
    if device.type == "cuda":
        host_t = host_t.pin_memory()
    dev = host_t.to(device, non_blocking=True)
    d_t, t1_t = dev[:, 0], dev[:, 2]
    live = d_t > 0.0
    one = torch.ones_like(d_t)
    cols = [dev[:, 0], dev[:, 1]]
    hc = 3  # next host column

    def p(b, i):
        return params[b.param_base + i].detach().to(torch.float64)

    for b in blocks:
        if b.kind == "vasicek" and b.scheme == "exact":
            sigma, a = p(b, 1), p(b, 3)
            decay = torch.exp(-a * d_t)
            cols += [decay, torch.sqrt((sigma * sigma / (2.0 * a)) * (1.0 - decay * decay))]
        elif b.kind == "cirpp":
            kappa, theta, sigma, y0 = (p(b, i) for i in range(4))
            h = torch.sqrt(kappa * kappa + 2.0 * sigma * sigma)
            et = torch.exp(h * t1_t)
            den = 2.0 * h + (kappa + h) * (et - 1.0)
            d_term = (2.0 * kappa * theta / (sigma * sigma)) * (0.5 * (kappa + h)
                                                               - h * (kappa + h) * et / den)
            e_term = 4.0 * h * h * et / (den * den)
            cols.append(dev[:, hc] + d_term - y0 * e_term)
            hc += 1
        elif b.kind == "cirpp_det":
            cols += [dev[:, hc], dev[:, hc + 1]]
            hc += 2
        elif b.kind == "hw":
            sigma, a = p(b, 0), p(b, 1)
            s2a = sigma * sigma / (2.0 * a * a)
            d1 = t1_t - calibration_date
            d2 = d1 + d_t
            cols += [dev[:, hc] + s2a * (1.0 - torch.exp(-a * d1)) ** 2,
                     dev[:, hc + 1] + s2a * (1.0 - torch.exp(-a * d2)) ** 2]
            hc += 2
            if b.scheme == "exact":
                decay = torch.exp(-a * d_t)
                cols += [decay, torch.sqrt((sigma * sigma / (2.0 * a)) * (1.0 - decay * decay))]
        elif b.kind == "s2f":
            kappa, sig_s, sig_l, rho = p(b, 1), p(b, 2), p(b, 4), p(b, 5)
            cols += [dev[:, hc], torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * one]
            hc += 1
            if b.scheme == "exact":
                near0 = torch.abs(kappa) < 1e-12
                k_safe = torch.where(near0, torch.ones_like(kappa), kappa)
                decay = torch.where(near0, one, torch.exp(-kappa * d_t))
                var_x = torch.where(near0, sig_s * sig_s * d_t,
                                    (sig_s * sig_s / (2.0 * k_safe)) * (1.0 - decay * decay))
                cols += [decay, torch.sqrt(var_x), sig_l * dev[:, 1]]
    table = torch.stack(cols, dim=1)
    table = torch.where(live[:, None], table, torch.zeros_like(table))
    return table.to(torch.float32)


def initial_state(blocks: Sequence[KernelBlock], params, calibration_date: float = 0.0):
    """[state_dim] float32 on the device of ``params``: the kernel's internal
    state at the calibration date (pallas_hybrid.py:219-273): log(spot) for
    exact bs / bs_multi, spot for Euler, r0 and 0 for vasicek, y0 and 0 for
    cirpp, lambda_mkt(t0) and 0 for cirpp_det, f(0, t0) and 0 for hw,
    [log F0(t0), 0, 0] for s2f."""
    device = params[0].device
    vals: List[torch.Tensor] = []
    const = lambda v: torch.full((), float(v), dtype=torch.float64, device=device)
    p = lambda b, i: params[b.param_base + i].detach().to(torch.float64)
    t0 = float(calibration_date)
    for b in blocks:
        if b.kind in ("bs", "bs_multi"):
            spots = [p(b, d) for d in range(b.n_state)]
            vals += [torch.log(s) for s in spots] if b.scheme == "exact" else spots
        elif b.kind == "vasicek":
            vals += [p(b, 0), const(0.0)]
        elif b.kind == "cirpp":
            vals += [p(b, 3), const(0.0)]
        elif b.kind == "cirpp_det":
            vals += [const(b.lambda_market(t0)), const(0.0)]
        elif b.kind == "hw":
            vals += [const(b.hw_fwd0(t0)), const(0.0)]
        else:
            vals += [const(b.s2f_logf0(t0)), const(0.0), const(0.0)]
    return torch.stack(vals).to(torch.float32)


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


def hybrid_substep(slots: Sequence[Slot], prm, a, b, w, row):
    """One substep of every slot, the kernel's update op for op.

    ``prm``: the parameters (0-d tensors); ``a``/``b``: per slot its first
    and second state value ([N] tensors; b is None where the slot has
    one); ``w``: per slot its correlated noise [N]; ``row``: the substep's
    table row (dt, sqrt(dt), then the block columns).  Returns the new
    (a, b) lists."""
    a, b = list(a), list(b)
    dt, sqrt_dt = row[0], row[1]
    for s, sl in enumerate(slots):
        r, c = sl.role, sl.tcol
        if r in (GBM_EXACT, GBM_EULER):
            sigma, rate = prm[sl.pa], prm[sl.pb]
            if r == GBM_EXACT:
                a[s] = a[s] + (rate - 0.5 * sigma * sigma) * dt + sigma * sqrt_dt * w[s]
            else:
                a[s] = a[s] * (1.0 + rate * dt) + sigma * a[s] * sqrt_dt * w[s]
        elif r == VAS_EXACT:
            theta = prm[sl.pa]
            b[s] = b[s] + a[s] * dt
            a[s] = theta + (a[s] - theta) * row[c] + row[c + 1] * w[s]
        elif r == VAS_EULER:
            sigma, theta, am = prm[sl.pa], prm[sl.pa + 1], prm[sl.pa + 2]
            rr = a[s]
            b[s] = b[s] + rr * dt
            a[s] = rr + am * (theta - rr) * dt + sigma * sqrt_dt * w[s]
        elif r == CIRPP:
            kappa, theta, sigma = prm[sl.pa], prm[sl.pa + 1], prm[sl.pa + 2]
            y = a[s]
            b[s] = b[s] + (y + row[c]) * dt
            sqrt_y = torch.sqrt(torch.clamp(y, min=0.0))
            a[s] = torch.clamp(y + kappa * (theta - y) * dt + sigma * sqrt_y * sqrt_dt * w[s],
                               min=1e-12)
        elif r == CIRPP_DET:
            b[s] = b[s] + row[c] * dt
            a[s] = row[c + 1].expand_as(b[s])
        elif r in (HW_EXACT, HW_EULER):
            b[s] = b[s] + a[s] * dt
            x = a[s] - row[c]
            if r == HW_EXACT:
                x = x * row[c + 2] + row[c + 3] * w[s]
            else:
                sigma, am = prm[sl.pa], prm[sl.pa + 1]
                x = x - am * x * dt + sigma * sqrt_dt * w[s]
            a[s] = x + row[c + 1]
        elif r == S2F_X_EXACT:
            a[s] = a[s] * row[c + 2] + row[c + 3] * w[s]
        elif r == S2F_X_EULER:
            kappa, sig_s = prm[sl.pa], prm[sl.pb]
            a[s] = a[s] - kappa * a[s] * dt + sig_s * sqrt_dt * w[s]
        else:  # S2F_Y_*: the factor rho w + rho_c w2, then log S into slot s - 1
            mu_l, rho = prm[sl.pa], prm[sl.pb]
            drive = rho * w[s - 1] + row[c + 1] * w[s]
            if r == S2F_Y_EXACT:
                a[s] = a[s] + mu_l * dt + row[c + 4] * drive
            else:
                sig_l = prm[sl.pa + 1]
                a[s] = a[s] + mu_l * dt + sig_l * sqrt_dt * drive
            b[s - 1] = row[c] + a[s - 1] + a[s]
    return a, b


def hybrid_paths_reference(blocks: Sequence[KernelBlock], chol, params,
                           timeline: Sequence[float], num_paths: int, num_steps: int,
                           seed: int = 0, phase: int = 0, calibration_date: float = 0.0):
    """Plain PyTorch version of the kernel, float32 on the device of
    ``params``: the same Philox words, the same table and initial state,
    the same operations in the same order."""
    _check_args(blocks, chol, params, num_paths, num_steps)
    f32 = torch.float32
    device = params[0].device
    slots, state_dim, _ = kernel_slots(blocks)
    table = substep_table(blocks, params, timeline, num_steps, calibration_date)
    init = initial_state(blocks, params, calibration_date)
    prm = [p.detach().to(f32) for p in params]
    c32 = _chol32(chol)

    a = [init[sl.oa].expand(num_paths) for sl in slots]
    b = [init[sl.ob].expand(num_paths) if sl.ob >= 0 else None for sl in slots]
    out = []
    t_prev = float(calibration_date)
    for point, t in enumerate(timeline):
        row0 = point * num_steps
        live, t_prev = float(t) > t_prev, float(t)
        if live:
            for k in range(num_steps):
                z = rng.substep_normals(seed, phase, row0 + k, num_paths, len(slots), f32, device)
                a, b = hybrid_substep(slots, prm, a, b, correlate(c32, z), table[row0 + k])
        cols = [None] * state_dim
        for s, sl in enumerate(slots):
            cols[sl.oa] = torch.exp(a[s]) if sl.role == GBM_EXACT else a[s]
            if sl.ob >= 0:
                cols[sl.ob] = b[s]
        out.append(torch.stack([c.expand(num_paths) for c in cols], dim=-1))
    if not out:
        return torch.zeros((0, num_paths, state_dim), dtype=f32, device=device)
    return torch.stack(out)


def _check_args(blocks, chol, params, num_paths, num_steps):
    _check_blocks(blocks, len(params))
    sim_dim = sum(b.n_sim for b in blocks)
    if np.asarray(chol).shape != (sim_dim, sim_dim):
        raise ValueError("chol must be [sim_dim, sim_dim]")
    if num_steps < 1 or not 0 < num_paths < 2 ** 32:
        raise ValueError(f"bad num_steps={num_steps} / num_paths={num_paths}")


def _bind(lib: ctypes.CDLL):
    fn = lib.mcre_hybrid_paths
    int_p = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # out, params, table
        ctypes.c_void_p,                                       # init
        ctypes.c_int, int_p, int_p, int_p, int_p, int_p, int_p,  # slots: role, pa, pb, tcol, oa, ob
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
    slots, state_dim, _ = kernel_slots(blocks)
    n_pts = len(timeline)
    out = torch.empty((n_pts, num_paths, state_dim), dtype=torch.float32, device=device)
    if n_pts == 0:
        return out
    table = substep_table(blocks, params, timeline, num_steps, calibration_date)
    init = initial_state(blocks, params, calibration_date)
    prm = torch.stack(params).detach().to(torch.float32)
    ns = len(slots)
    ints = lambda xs: (ctypes.c_int * ns)(*xs)
    c32 = _chol32(chol).reshape(-1)
    with torch.cuda.device(device):
        rc = fn(
            out.data_ptr(), prm.data_ptr(), table.data_ptr(), init.data_ptr(),
            ns, *(ints([sl[i] for sl in slots]) for i in range(6)),
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
