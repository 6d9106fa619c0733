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

Kernels (``csrc/hybrid_paths.cu``, CUDA C++ for sm_90a, built by
ops/cuda_build), launched back to back with no host sync:

  * the table prologue (:func:`hybrid_table`): one thread per substep
    computes every parameter-dependent constant (psi, decay, scale, alpha,
    rho_c, the s2f stds) in float64 from the device parameters and the
    static host columns (dt, sqrt(dt), t1, lambda_mkt, f(0, t), log F0),
    rounds it once to float32, and writes the float32 parameters and the
    initial state.  The static half (:func:`table_inputs`) is built once
    per block list, timeline, substep count, calibration date and device
    and kept in a small cache, so a call makes one ``torch.stack`` of the
    parameters and two launches;
  * the paths: one thread per path, the state in registers as one *slot*
    per noise factor holding at most two state columns
    (:func:`kernel_slots`), each point's [256 x D] tile staged in shared
    memory and stored contiguously (a TMA bulk copy where the tiles are
    16-byte aligned).  One library per block tuple: the slot roles are
    compile-time constants (:func:`role_flags`), built at the tuple's first
    use.  See the source's note.  Row i of the output draws global path
    ``path_offset + path_stride * i`` (Philox counter word 0): a rank of a
    path-sharded run (parallel/mesh.py, ops/path_shard.py) launches at
    (rank, world size) and writes its own paths as its own contiguous
    [T, N / R, D] plane, so the tiles and their bulk stores are unchanged;
    (0, 1) is the whole run.  The table prologue does not depend on the
    paths.

:func:`hybrid_paths` dispatches on the device of ``params``: CUDA tensors
launch the kernel (or raise), CPU tensors run
:func:`hybrid_paths_reference`, which repeats the kernel's float32
arithmetic op for op from the same table.
"""

from __future__ import annotations

import ctypes
import functools
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

# Table column groups of the prologue (csrc/hybrid_paths.cu enum TableKind).
TAB_VAS_EXACT, TAB_CIRPP, TAB_CIRPP_DET, TAB_HW_EULER, TAB_HW_EXACT = 0, 1, 2, 3, 4
TAB_S2F_EULER, TAB_S2F_EXACT = 5, 6

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


def _host_columns(blocks: Sequence[KernelBlock], timeline: Sequence[float], num_steps: int,
                  calibration_date: float) -> np.ndarray:
    """[T * num_steps, H] float64: dt, sqrt(dt), t1, then each block's host
    curve values in block order (cirpp: lambda_mkt(t1); cirpp_det:
    lambda_mkt(t1), lambda_mkt(t1 + dt); hw: f(0, t1), f(0, t1 + dt); s2f:
    log F0(t1 + dt))."""
    rows = _substeps(timeline, num_steps, calibration_date)
    t1 = np.asarray([r[0] for r in rows], dtype=np.float64)
    dt = np.asarray([r[1] for r in rows], dtype=np.float64)
    host = [dt, np.sqrt(dt), t1]
    for b in blocks:
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
    return np.stack(host, axis=1).reshape(len(rows), len(host))


def _table_groups(blocks: Sequence[KernelBlock]):
    """Per block with table columns: (TAB_* kind, param_base, first host
    column, first table column), the layout of :func:`substep_table`."""
    groups, hc, tc = [], 3, 2
    for b in blocks:
        exact = b.scheme == "exact"
        kind = {"vasicek": TAB_VAS_EXACT if exact else None, "cirpp": TAB_CIRPP,
                "cirpp_det": TAB_CIRPP_DET, "hw": TAB_HW_EXACT if exact else TAB_HW_EULER,
                "s2f": TAB_S2F_EXACT if exact else TAB_S2F_EULER}.get(b.kind)
        if kind is not None:
            groups.append((kind, b.param_base, hc, tc))
        hc += {"cirpp": 1, "cirpp_det": 2, "hw": 2, "s2f": 1}.get(b.kind, 0)
        tc += _TABLE_COLS.get(b.kind, (0, 0))[exact]
    return groups


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
    once, so no parameter crosses to the host.  The plain version of the
    table prologue of csrc/hybrid_paths.cu."""
    device = params[0].device
    dev = cuda_build.upload(_host_columns(blocks, timeline, num_steps, calibration_date), device)
    return table_columns(blocks, dev, params, calibration_date)


def table_columns(blocks: Sequence[KernelBlock], host: torch.Tensor, params,
                  calibration_date: float = 0.0) -> torch.Tensor:
    """:func:`substep_table` from its host columns (``host``, [rows, H]
    float64 on the device of ``params``, as :func:`table_inputs` keeps
    them): the parameter-dependent columns in float64 torch ops, rounded
    once to float32."""
    d_t, t1_t = host[:, 0], host[:, 2]
    live = d_t > 0.0
    one = torch.ones_like(d_t)
    cols = [host[:, 0], host[:, 1]]

    def p(base, i):
        return params[base + i].detach().to(torch.float64)

    for kind, base, hc, _ in _table_groups(blocks):
        if kind == TAB_VAS_EXACT:
            sigma, a = p(base, 1), p(base, 3)
            decay = torch.exp(-a * d_t)
            cols += [decay, torch.sqrt((sigma * sigma / (2.0 * a)) * (1.0 - decay * decay))]
        elif kind == TAB_CIRPP:
            kappa, theta, sigma, y0 = (p(base, i) for i in range(4))
            h = torch.sqrt(kappa * kappa + 2.0 * sigma * sigma)
            et = torch.exp(h * t1_t)
            den = 2.0 * h + (kappa + h) * (et - 1.0)
            d_term = (2.0 * kappa * theta / (sigma * sigma)) * (0.5 * (kappa + h)
                                                               - h * (kappa + h) * et / den)
            e_term = 4.0 * h * h * et / (den * den)
            cols.append(host[:, hc] + d_term - y0 * e_term)
        elif kind == TAB_CIRPP_DET:
            cols += [host[:, hc], host[:, hc + 1]]
        elif kind in (TAB_HW_EULER, TAB_HW_EXACT):
            sigma, a = p(base, 0), p(base, 1)
            s2a = sigma * sigma / (2.0 * a * a)
            d1 = t1_t - calibration_date
            d2 = d1 + d_t
            cols += [host[:, hc] + s2a * (1.0 - torch.exp(-a * d1)) ** 2,
                     host[:, hc + 1] + s2a * (1.0 - torch.exp(-a * d2)) ** 2]
            if kind == TAB_HW_EXACT:
                decay = torch.exp(-a * d_t)
                cols += [decay, torch.sqrt((sigma * sigma / (2.0 * a)) * (1.0 - decay * decay))]
        else:  # s2f
            kappa, sig_s, sig_l, rho = p(base, 1), p(base, 2), p(base, 4), p(base, 5)
            cols += [host[:, hc], torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0)) * one]
            if kind == TAB_S2F_EXACT:
                near0 = torch.abs(kappa) < 1e-12
                k_safe = torch.where(near0, torch.ones_like(kappa), kappa)
                decay = torch.where(near0, one, torch.exp(-kappa * d_t))
                var_x = torch.where(near0, sig_s * sig_s * d_t,
                                    (sig_s * sig_s / (2.0 * k_safe)) * (1.0 - decay * decay))
                cols += [decay, torch.sqrt(var_x), sig_l * host[:, 1]]
    table = torch.stack(cols, dim=1)
    table = torch.where(live[:, None], table, torch.zeros_like(table))
    return table.to(torch.float32)


def _initial_columns(blocks: Sequence[KernelBlock], calibration_date: float):
    """Per state column: (parameter index or -1, take its log, host
    constant), the layout of :func:`initial_state`."""
    cols = []
    t0 = float(calibration_date)
    for b in blocks:
        base = b.param_base
        if b.kind in ("bs", "bs_multi"):
            cols += [(base + d, b.scheme == "exact", 0.0) for d in range(b.n_state)]
        elif b.kind == "vasicek":
            cols += [(base, False, 0.0), (-1, False, 0.0)]
        elif b.kind == "cirpp":
            cols += [(base + 3, False, 0.0), (-1, False, 0.0)]
        elif b.kind == "cirpp_det":
            cols += [(-1, False, b.lambda_market(t0)), (-1, False, 0.0)]
        elif b.kind == "hw":
            cols += [(-1, False, b.hw_fwd0(t0)), (-1, False, 0.0)]
        else:
            cols += [(-1, False, b.s2f_logf0(t0)), (-1, False, 0.0), (-1, False, 0.0)]
    return cols


def initial_state(blocks: Sequence[KernelBlock], params, calibration_date: float = 0.0):
    """[state_dim] float32 on the device of ``params``: the kernel's internal
    state at the calibration date (pallas_hybrid.py:219-273): log(spot) for
    exact bs / bs_multi, spot for Euler, r0 and 0 for vasicek, y0 and 0 for
    cirpp, lambda_mkt(t0) and 0 for cirpp_det, f(0, t0) and 0 for hw,
    [log F0(t0), 0, 0] for s2f."""
    device = params[0].device
    vals: List[torch.Tensor] = []
    for src, log, const in _initial_columns(blocks, calibration_date):
        if src < 0:
            vals.append(torch.full((), float(const), dtype=torch.float64, device=device))
        else:
            p = params[src].detach().to(torch.float64)
            vals.append(torch.log(p) if log else p)
    return torch.stack(vals).to(torch.float32)


class TableInputs(NamedTuple):
    """The static half of K2's inputs for one key: the host columns on the
    device and the prologue's descriptors as ctypes arrays."""

    rows: int
    table_width: int
    state_dim: int
    host: torch.Tensor  # [rows, H] float64 (:func:`_host_columns`)
    groups: tuple       # (kind, pbase, hcol, tcol) int arrays and their count
    init: tuple         # (src, log) int arrays, the constants as a double array


@functools.lru_cache(maxsize=32)
def table_inputs(blocks: Tuple[KernelBlock, ...], timeline: Tuple[float, ...], num_steps: int,
                 calibration_date: float, device: torch.device) -> TableInputs:
    """The cached static half of the table prologue's inputs: computed once
    per (blocks, timeline, num_steps, calibration_date, device), none of
    which is a parameter."""
    host = _host_columns(blocks, timeline, num_steps, calibration_date)
    _, state_dim, table_width = kernel_slots(blocks)
    groups = _table_groups(blocks)
    ints = lambda xs: (ctypes.c_int * max(len(xs), 1))(*xs)
    init = _initial_columns(blocks, calibration_date)
    return TableInputs(
        host.shape[0], table_width, state_dim, cuda_build.upload(host, device),
        (len(groups), *(ints([g[i] for g in groups]) for i in range(4))),
        (ints([c[0] for c in init]), ints([int(c[1]) for c in init]),
         (ctypes.c_double * state_dim)(*(float(c[2]) for c in init))))


@functools.lru_cache(maxsize=64)
def _role_flags(blocks: Tuple[KernelBlock, ...]) -> Tuple[str, ...]:
    roles = [sl.role for sl in kernel_slots(blocks)[0]]
    return (f"-DMCRE_NS={len(roles)}",
            f"-DMCRE_ROLES={sum(r << (4 * s) for s, r in enumerate(roles)):#x}")


def role_flags(blocks: Sequence[KernelBlock]) -> Tuple[str, ...]:
    """The nvcc flags of K2's build for a block tuple: its slot count and
    each slot's role (4 bits per slot), compile-time constants of
    csrc/hybrid_paths.cu."""
    return _role_flags(tuple(blocks))


def _library(blocks: Sequence[KernelBlock]) -> ctypes.CDLL:
    """K2's build for this block tuple (compiled at its first use)."""
    return cuda_build.load_library("hybrid_paths", role_flags(blocks)).lib


@functools.lru_cache(maxsize=32)
def slot_inputs(blocks: Tuple[KernelBlock, ...], chol: bytes):
    """The main kernel's slot descriptors (role, pa, pb, tcol, oa, ob int
    arrays) and its float32 Cholesky factor (``chol``: float64 bytes of the
    [sim_dim, sim_dim] factor), as ctypes arrays."""
    slots, _, _ = kernel_slots(blocks)
    ns = len(slots)
    c32 = np.frombuffer(chol, dtype=np.float64).astype(np.float32)
    return (ns, *((ctypes.c_int * ns)(*(sl[i] for sl in slots)) for i in range(6)),
            (ctypes.c_float * c32.size)(*c32.tolist()))


def _chol32(chol) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(chol, dtype=np.float64).astype(np.float32))


def correlate(chol, z: torch.Tensor) -> List[torch.Tensor]:
    """w = L z as the kernel forms it: per row, the products with the
    entries of ``chol`` (a host array) on and below the diagonal summed left
    to right."""
    w = []
    for i in range(z.shape[-1]):
        acc = float(chol[i, 0]) * z[:, 0]
        for e in range(1, i + 1):
            acc = acc + float(chol[i, e]) * z[:, e]
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
                           seed: int = 0, phase: int = 0, calibration_date: float = 0.0,
                           path_offset: int = 0, path_stride: int = 1):
    """Plain PyTorch version of the kernel, float32 on the device of
    ``params``: the same Philox words, the same table and initial state,
    the same operations in the same order."""
    _check_args(blocks, chol, params, num_paths, num_steps, path_offset, path_stride)
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
                z = rng.substep_normals(seed, phase, row0 + k, num_paths, len(slots), f32, device,
                                        path_offset, path_stride)
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


def _check_args(blocks, chol, params, num_paths, num_steps, path_offset=0, path_stride=1):
    _check_blocks(blocks, len(params))
    sim_dim = sum(b.n_sim for b in blocks)
    if np.asarray(chol).shape != (sim_dim, sim_dim):
        raise ValueError("chol must be [sim_dim, sim_dim]")
    if num_steps < 1 or not 0 < num_paths < 2 ** 32:
        raise ValueError(f"bad num_steps={num_steps} / num_paths={num_paths}")
    rng.check_path_stride(num_paths, path_offset, path_stride)


_INT_P = ctypes.POINTER(ctypes.c_int)
# mcre_hybrid_paths's arguments.
_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # out, params, table
    ctypes.c_void_p,                                       # init
    ctypes.c_int, _INT_P, _INT_P, _INT_P,                  # slots: role, pa, pb,
    _INT_P, _INT_P, _INT_P,                                # tcol, oa, ob
    ctypes.POINTER(ctypes.c_float),                        # chol
    ctypes.c_int, ctypes.c_int,                            # state_dim, table_width
    ctypes.c_int, ctypes.c_int, ctypes.c_uint32,           # points, steps, paths
    ctypes.c_uint32, ctypes.c_uint32,                      # seed, phase
    ctypes.c_uint32, ctypes.c_uint32,                      # path offset, stride
    ctypes.c_void_p,                                       # stream
)
# mcre_hybrid_table's arguments.
_TABLE_ARGS = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,     # workspace, host, params
    ctypes.c_int, ctypes.c_int, ctypes.c_int,              # rows, host_width, table_width
    ctypes.c_int, ctypes.c_int,                            # num_params, state_dim
    ctypes.c_int, _INT_P, _INT_P, _INT_P, _INT_P,          # groups: kind, pbase, hcol, tcol
    _INT_P, _INT_P, ctypes.POINTER(ctypes.c_double),       # init: src, log, const
    ctypes.c_double, ctypes.c_void_p,                      # calibration date, stream
)


def kernel_inputs(blocks: Sequence[KernelBlock], params, timeline: Sequence[float],
                  num_steps: int, calibration_date: float = 0.0):
    """What the table prologue takes: (the cached :func:`table_inputs`, the
    parameters as a float64 vector on their own device).  No parameter is
    read to the host."""
    tab = table_inputs(tuple(blocks), tuple(float(t) for t in timeline), num_steps,
                       float(calibration_date), params[0].device)
    return tab, torch.stack(params).detach().to(torch.float64)


def _slots_of(blocks: Sequence[KernelBlock], chol):
    chol64 = np.ascontiguousarray(np.asarray(chol, dtype=np.float64))
    return slot_inputs(tuple(blocks), chol64.tobytes())


def _run_table(lib: ctypes.CDLL, tab: TableInputs, params64: torch.Tensor,
               calibration_date: float):
    """Launch the prologue of K2's build ``lib``: (table, float32
    parameters, initial state)."""
    fn = cuda_build.bind(lib, "mcre_hybrid_table", _TABLE_ARGS)
    n_par = params64.shape[0]
    size = tab.rows * tab.table_width
    ws = torch.empty(size + n_par + tab.state_dim, dtype=torch.float32, device=params64.device)
    rc = fn(ws.data_ptr(), tab.host.data_ptr(), params64.data_ptr(), tab.rows,
            tab.host.shape[1], tab.table_width, n_par, tab.state_dim, *tab.groups, *tab.init,
            calibration_date, torch.cuda.current_stream(ws.device).cuda_stream)
    cuda_build.check(rc, "hybrid_table")
    hybrid_table.launches += 1
    return ws[:size].view(tab.rows, tab.table_width), ws[size:size + n_par], ws[size + n_par:]


def hybrid_table(blocks: Sequence[KernelBlock], params, timeline: Sequence[float],
                 num_steps: int, calibration_date: float = 0.0):
    """K2's per-call inputs: (table [T * num_steps, W], parameters [P],
    initial state [D]), float32 on the device of ``params``.  CUDA
    ``params`` launch the table prologue; CPU ``params`` run its plain
    version (:func:`substep_table`, :func:`initial_state`)."""
    _check_blocks(blocks, len(params))
    device = params[0].device
    if device.type == "cpu":
        return (substep_table(blocks, params, timeline, num_steps, calibration_date),
                torch.stack(params).detach().to(torch.float32),
                initial_state(blocks, params, calibration_date))
    if device.type != "cuda":
        raise ValueError(f"hybrid_table: unsupported device {device}")
    tab, params64 = kernel_inputs(blocks, params, timeline, num_steps, calibration_date)
    with torch.cuda.device(device):
        return _run_table(_library(blocks), tab, params64, float(calibration_date))


hybrid_table.launches = 0  # prologue launches


def _launch(blocks, chol, params, timeline, num_paths, num_steps, seed, phase,
            calibration_date, path_offset=0, path_stride=1):
    lib = _library(blocks)
    fn = cuda_build.bind(lib, "mcre_hybrid_paths", _ARGS)
    tab, params64 = kernel_inputs(blocks, params, timeline, num_steps, calibration_date)
    slots = _slots_of(blocks, chol)
    device = params64.device
    n_pts = len(timeline)
    out = torch.empty((n_pts, num_paths, tab.state_dim), dtype=torch.float32, device=device)
    if n_pts == 0:
        return out
    with torch.cuda.device(device):
        table, prm, init = _run_table(lib, tab, params64, float(calibration_date))
        rc = fn(
            out.data_ptr(), prm.data_ptr(), table.data_ptr(), init.data_ptr(), *slots,
            tab.state_dim, tab.table_width, n_pts, num_steps, num_paths,
            seed & 0xFFFFFFFF, phase & 0xFFFFFFFF, path_offset, path_stride,
            torch.cuda.current_stream(device).cuda_stream,
        )
    cuda_build.check(rc, "hybrid_paths")
    hybrid_paths.launches += 1
    return out


def hybrid_paths(blocks: Sequence[KernelBlock], chol, params, timeline: Sequence[float],
                 num_paths: int, num_steps: int, seed: int = 0, phase: int = 0,
                 calibration_date: float = 0.0, path_offset: int = 0, path_stride: int = 1):
    """Joint states at timeline points: [T, N, D] float32 in block order.

    ``chol``: the static [sim_dim, sim_dim] lower-triangular joint factor
    (host array); ``params``: the flat parameter tuple of 0-d tensors.  Row
    i is global path ``path_offset + path_stride * i``.  CUDA ``params``
    launch the kernel; CPU ``params`` run :func:`hybrid_paths_reference`."""
    _check_args(blocks, chol, params, num_paths, num_steps, path_offset, path_stride)
    device = params[0].device
    if device.type == "cpu":
        return hybrid_paths_reference(blocks, chol, params, timeline, num_paths, num_steps,
                                      seed=seed, phase=phase, calibration_date=calibration_date,
                                      path_offset=path_offset, path_stride=path_stride)
    if device.type != "cuda":
        raise ValueError(f"hybrid_paths: unsupported device {device}")
    return _launch(blocks, chol, params, timeline, num_paths, num_steps, seed, phase,
                   calibration_date, path_offset, path_stride)


hybrid_paths.launches = 0  # kernel launches
