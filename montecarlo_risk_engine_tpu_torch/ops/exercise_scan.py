"""The equity LSM exercise scans of a whole book: the CUDA kernel and its plain version.

Replaces no TPU kernel.  The JAX package runs the scans of its Bermudan,
American and FlexiCall family batches as ``lax.scan`` loops that XLA fuses.
The port ran them eagerly, one ``ExerciseEquityBatch`` (products with the same
number of dates) at a time, and each event of a batch cost ~20-85 float64
launches on [P, N, S] tensors: their host dispatch, not their arithmetic, set
the pace (PERF.md section 5).  ``csrc/exercise_scan.cu`` runs a whole phase
for every ``ExerciseEquityBatch`` product of a book in one launch: the fit
(the backward induction on the pre-simulation paths) and the valuation (the
forward walk on the main paths).

The products need not share shapes: each reads its own slice of flat tables
(:func:`pack`), with its own events (the batch's event order: its dates and
the exposure dates in time order, product dates first on ties) and states.
Per event row: the spot and numeraire rows it reads in one observation table
``obs`` [U, N] (the resolved row blocks the batches read, in their order),
whether it is one of the product's dates, its exposure slot and its strike;
per product its sign, ITM gate, initial state, states and FlexiCall flag.

What the kernel computes is :func:`exercise_fit_reference` and
:func:`exercise_value_reference`: the batches' arithmetic on those tables,
product by product, op for op (``fit_least_squares`` with the in-the-money
weights of a gated product's dates, then the exercise step of
``ExerciseEquityBatch._hypothetical_step`` on its dates), with the float
operations PyTorch's CUDA kernels perform.  On CPU tensors the plain version
has the CPU's bits.

:func:`exercise_fit` and :func:`exercise_value` dispatch on the device: CPU
tensors run the plain version, CUDA tensors launch the kernel (counted in
``launches``) or raise.  :class:`BookOptions` is the controller's executor of
a book's equity exercise batches: it owns their tables on the host and on the
device, and its ``route`` is the route rule, whose one test seam is
:data:`_KERNEL_DEVICES`.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import tracing
from montecarlo_risk_engine_tpu_torch.api.batching import ExerciseEquityBatch, ObservableTables
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.noise import matmul_t
from montecarlo_risk_engine_tpu_torch.ops.storage_scan import MAX_BASIS, engages, gradient_flows
from montecarlo_risk_engine_tpu_torch.utils.regression import fit_least_squares

# csrc/exercise_scan.cu: the most states a product may have.
MAX_STATES = 16

# The columns of ``options`` and ``rows``.
FIRST_ROW, EVENTS, STATES, INITIAL, ITM, FLEXI, FIRST_COEF = range(7)
SPOT_ROW, NUM_ROW, IS_PROD, EXP_SLOT = range(4)

# Device types on which the kernel takes a book's exercise batches: the one
# test seam of the route (the CPU tests add "cpu" to run its glue on the plain
# version; an empty tuple forces the torch batches).
_KERNEL_DEVICES = ("cuda",)

launches = collections.Counter()  # kernel launches by phase ("fit", "value")


class Packed(NamedTuple):
    """A book's equity exercise products as flat tables (host arrays).

    ``options`` int32 [P, 7]: first row, events, states, initial state, ITM
    gate, FlexiCall, first coefficient in the flat coefficients; ``rows``
    int32 [R, 4]: the row's spot and numeraire rows in ``obs``, whether it is
    one of the product's dates, its exposure slot (-1: none); ``strikes``
    float64 [R]; ``signs`` float64 [P]; ``carry_rows`` int32 [P]: the
    product's first row of the fit's carry scratch; ``deg``: basis columns;
    ``num_exposures``: exposure slots."""

    options: np.ndarray
    rows: np.ndarray
    strikes: np.ndarray
    signs: np.ndarray
    carry_rows: np.ndarray
    deg: int
    num_exposures: int

    @property
    def num_products(self) -> int:
        return self.options.shape[0]

    @property
    def max_states(self) -> int:
        return int(self.options[:, STATES].max())

    @property
    def max_events(self) -> int:
        return int(self.options[:, EVENTS].max())

    @property
    def coef_size(self) -> int:
        return int((self.options[:, EVENTS] * self.options[:, STATES]).sum()) * self.deg

    @property
    def carry_size(self) -> int:
        return int(self.options[:, STATES].sum())


def pack(batches: Sequence[ExerciseEquityBatch], exposure_times: Sequence[float], deg: int):
    """(the batches' products as :class:`Packed`, the (kind, asset, time
    indices, times) blocks of resolved rows that ``obs`` stacks in order).
    The rows and blocks are those each batch's ``_event_tables`` gathers
    (``ExerciseEquityBatch.observation_rows``), so ``obs`` holds the torch
    route's own resolved rows."""
    options, rows, strikes, signs, carry_rows, blocks = [], [], [], [], [], []
    first_row = first_coef = first_carry = first_block_row = 0
    for batch in batches:
        h, batch_blocks, spot_rows, num_rows = batch.observation_rows(tuple(exposure_times))
        num_products, events = spot_rows.shape
        slots = np.full((num_products, events), -1, dtype=np.int64)
        for slot, prod_rows in enumerate(h["exp_rows"]):
            slots[np.arange(num_products), prod_rows] = slot
        states = np.array([p.get_num_states() for p in batch.products])
        first_rows = first_row + events * np.arange(num_products)
        coef_sizes = events * states * deg
        options.append(np.stack([first_rows, np.full(num_products, events), states, h["init"],
                                 h["itm"], np.full(num_products, batch.is_flexi),
                                 first_coef + np.cumsum(coef_sizes) - coef_sizes], axis=1))
        carry_rows.append(first_carry + np.cumsum(states) - states)
        rows.append(np.stack([first_block_row + spot_rows, first_block_row + num_rows,
                              h["is_prod"].T, slots], axis=2).reshape(-1, 4))
        strikes.append(h["strikes"].T.reshape(-1))
        signs.append(h["signs"])
        blocks += batch_blocks
        first_row += events * num_products
        first_coef += int(coef_sizes.sum())
        first_carry += int(states.sum())
        first_block_row += sum(len(b[2]) for b in batch_blocks)
    packed = Packed(np.concatenate(options).astype(np.int32), np.concatenate(rows).astype(np.int32),
                    np.concatenate(strikes).astype(np.float64),
                    np.concatenate(signs).astype(np.float64),
                    np.concatenate(carry_rows).astype(np.int32), int(deg), len(exposure_times))
    return packed, blocks


class Tables(NamedTuple):
    """:class:`Packed` with its tables on a device."""

    packed: Packed
    options: torch.Tensor
    rows: torch.Tensor
    strikes: torch.Tensor
    signs: torch.Tensor
    carry_rows: torch.Tensor


def product_coefficients(packed: Packed, coeffs: torch.Tensor) -> List[torch.Tensor]:
    """Each product's coefficients [events, states, deg]: views of ``coeffs``."""
    out = []
    for _, events, states, _, _, _, first in packed.options.tolist():
        out.append(coeffs[first:first + events * states * packed.deg].view(events, states,
                                                                            packed.deg))
    return out


# -- the route rule -------------------------------------------------------------------


class BookOptions:
    """The kernel's executor of a book's equity exercise products, built
    once per controller: every product of the book's ``ExerciseEquityBatch``
    ``batches``, whatever its number of dates.

    It packs the products' tables at its first route (the batches' host
    event tables depend on the exposure dates only) and uploads them to
    ``device``, with each product's netting set (``seg``), at the first
    :meth:`fit`.  :meth:`route` is the route rule; :meth:`fit` and
    :meth:`value` are one launch each over every product, in an ``exercise``
    span (route "kernel").  As with the torch batches, the products'
    ``regression_coeffs`` are not set: the flat coefficients go from
    :meth:`fit` to :meth:`value` (:func:`product_coefficients` views them)."""

    def __init__(self, batches: Sequence[ExerciseEquityBatch], exposure_times: Sequence[float],
                 regression_function, device, sharding):
        self.batches = list(batches)
        self.products = [p for b in self.batches for p in b.products]
        self._exposure_times = tuple(exposure_times)
        self._regression_function = regression_function
        self._device, self._sharding = torch.device(device), sharding
        self.packed: Optional[Packed] = None
        self.blocks: List[tuple] = []  # the resolved row blocks of the observation table
        self.tables: Optional[Tables] = None
        self.seg: Optional[torch.Tensor] = None

    def route(self, batches, tables):
        """(these products if the kernel takes them, else None; the batches
        left to their own executors).  The kernel takes every equity exercise
        batch where :func:`storage_scan.engages` holds (on this module's
        :data:`_KERNEL_DEVICES`), every product has at
        most :data:`MAX_STATES` states, the observations come from the state
        plane (``ObservableTables``, not the streaming route's emissions) and
        no derivative flows through them (:func:`gradient_flows`)."""
        if (not self.products or type(tables) is not ObservableTables
                or any(p.get_num_states() > MAX_STATES for p in self.products)
                or not engages(self._device, self._regression_function, self._sharding,
                               _KERNEL_DEVICES)):
            return None, batches
        self._pack()
        if gradient_flows(self._rows(tables)):
            return None, batches
        taken = set(map(id, self.batches))
        return self, [b for b in batches if id(b) not in taken]

    def _pack(self) -> Packed:
        if self.packed is None:
            self.packed, self.blocks = pack(self.batches, self._exposure_times,
                                            self._regression_function.get_degree())
        return self.packed

    def device_tables(self) -> Tables:
        """The products' tables on the device, uploaded at the first call
        through pinned memory on a card."""
        if self.tables is None:
            packed = self._pack()
            self.tables = Tables(packed, *(cuda_build.upload(a, self._device) for a in (
                packed.options, packed.rows, packed.strikes, packed.signs, packed.carry_rows)))
            self.seg = torch.as_tensor(np.concatenate([b.ns_idx for b in self.batches]),
                                       device=self._device)
        return self.tables

    def _rows(self, tables: ObservableTables) -> List[torch.Tensor]:
        return [tables.rows(*block) for block in self.blocks]

    def observations(self, tables: ObservableTables) -> torch.Tensor:
        """The products' observation table [U, N] of one phase."""
        return torch.cat(self._rows(tables))

    def _span(self, phase: str):
        return tracing.span("exercise", kind="ExerciseEquityBatch",
                            products=self.packed.num_products, steps=self.packed.max_events,
                            phase=phase, route="kernel")

    def fit(self, tables: ObservableTables) -> torch.Tensor:
        """The fit of every product on the pre-simulation: the flat
        coefficients."""
        device_tables = self.device_tables()
        obs = self.observations(tables)
        with self._span("fit"):
            return exercise_fit(device_tables, obs)

    def value(self, tables: ObservableTables, coeffs: torch.Tensor, want_exposures: bool):
        """Every product on the main simulation: (cashflows [P, N], exposure
        profiles [P, T_exp, N] or None)."""
        obs = self.observations(tables)
        with self._span("value"):
            return exercise_value(self.tables, obs, coeffs, want_exposures)


# -- the plain version ----------------------------------------------------------------


def _shift_down(values):
    """values[..., s] -> values[..., max(s - 1, 0)] along the state axis."""
    return torch.cat([values[..., :1], values[..., :-1]], dim=-1)


def _take(grid, state):
    return torch.gather(grid, -1, state[:, None])[:, 0]


def _row(packed: Packed, obs, r: int):
    spot_row, num_row, is_prod, slot = packed.rows[r].tolist()
    return obs[spot_row], obs[num_row], float(packed.strikes[r]), bool(is_prod), slot


def exercise_fit_reference(tables: Tables, obs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fit: the coefficients [sum of events x
    states x deg], flat as :func:`product_coefficients` reads them.

    Per product, last event first: ``fit_least_squares`` of the numeraire
    times each state's carry on the basis [1, x, x^2, ...] of the row's spot
    x, weighted by the in-the-money mask on an ITM-gated product's own
    dates; then, on its own dates, the exercise step of every state (the
    FlexiCall's shift-down rule, the ITM gate) and the carry <- deflated
    payoff + the carry of the state it lands in."""
    packed = tables.packed
    deg, n = packed.deg, obs.shape[1]
    dtype, device = obs.dtype, obs.device
    coeffs = torch.empty(packed.coef_size, dtype=dtype, device=device)
    for p, (first_row, events, states, _, itm, flexi, first) in enumerate(packed.options.tolist()):
        sign = float(packed.signs[p])
        carry = torch.zeros((n, states), dtype=dtype, device=device)
        s_positive = torch.arange(states, device=device) > 0
        for e in reversed(range(events)):
            x, num, strike, is_prod, _ = _row(packed, obs, first_row + e)
            basis = torch.stack([x ** k for k in range(deg)], dim=-1)  # PolynomialRegression
            weights = ((sign * (x - strike) > 0.0).to(dtype) if itm and is_prod else None)
            coef = fit_least_squares(basis, num[:, None] * carry, weights=weights)  # [S, deg]
            coeffs[first + e * states * deg:first + (e + 1) * states * deg] = coef.reshape(-1)
            if is_prod:
                grid = matmul_t(basis, coef)  # [N, S]
                immediate = torch.clamp(sign * (x - strike), min=0.0)[:, None]
                beats = immediate + _shift_down(grid) > grid if flexi else immediate > grid
                exercised = beats & s_positive
                if itm:
                    exercised = exercised & (immediate > 0.0)
                carry = (immediate * exercised.to(dtype) / num[:, None]
                         + torch.where(exercised, _shift_down(carry), carry))
    return coeffs


def exercise_value_reference(tables: Tables, obs: torch.Tensor, coeffs: torch.Tensor,
                             want_exposures: bool = False):
    """Plain PyTorch version of the valuation: (deflated cashflows [P, N],
    continuation exposures [P, exposure slots, N] or None).  Per product,
    first event first, from its initial state: on its own dates the exercise
    rule at the held state with the fitted continuation, the deflated payoff
    summed and the state decremented on exercise; on each exposure row the
    continuation at the state after the step / numeraire."""
    packed = tables.packed
    n = obs.shape[1]
    dtype, device = obs.dtype, obs.device
    cfs = torch.empty((packed.num_products, n), dtype=dtype, device=device)
    want_exposures = want_exposures and packed.num_exposures > 0
    exposures = (torch.empty((packed.num_products, packed.num_exposures, n), dtype=dtype,
                             device=device) if want_exposures else None)
    per_product = product_coefficients(packed, coeffs)
    for p, (first_row, events, _, initial, itm, flexi, _) in enumerate(packed.options.tolist()):
        sign = float(packed.signs[p])
        state = torch.full((n,), initial, dtype=torch.long, device=device)
        cf = torch.zeros(n, dtype=dtype, device=device)
        for e in range(events):
            x, num, strike, is_prod, slot = _row(packed, obs, first_row + e)
            basis = torch.stack([x ** k for k in range(packed.deg)], dim=-1)
            grid = matmul_t(basis, per_product[p][e])  # [N, S]
            hold = _take(grid, state)
            immediate = torch.clamp(sign * (x - strike), min=0.0)
            if flexi:
                beats = immediate + _take(grid, torch.clamp(state - 1, min=0)) > hold
            else:
                beats = immediate > hold
            exercised = beats & (state > 0) & is_prod
            if itm:
                exercised = exercised & (immediate > 0.0)
            cf = cf + immediate * exercised.to(dtype) / num
            state = state - exercised.long()
            if exposures is not None and slot >= 0:
                exposures[p, slot] = _take(grid, state) / num
        cfs[p] = cf
    return cfs, exposures


# -- the kernel -----------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
# The arguments of mcre_exercise_fit and mcre_exercise_value.
_FIT_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_uint32, _P)
_VALUE_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32, _P)


def _check(tables: Tables, obs: torch.Tensor):
    packed = tables.packed
    if obs.dim() != 2 or obs.dtype != torch.float64:
        raise ValueError(f"exercise_scan takes float64 observations [U, N], not "
                         f"{tuple(obs.shape)} {obs.dtype}")
    if packed.rows.size and int(packed.rows[:, :2].max()) >= obs.shape[0]:
        raise ValueError("exercise_scan: a row reads beyond the observation table")
    if not 1 <= packed.max_states <= MAX_STATES or not 1 <= packed.deg <= MAX_BASIS:
        raise ValueError(f"exercise_scan takes 1 .. {MAX_STATES} states and 1 .. {MAX_BASIS} "
                         "basis columns")
    if any(t.device != obs.device for t in tables[1:]):
        raise ValueError("exercise_scan: the tables and the observations lie on different "
                         "devices")


def _kernel(symbol: str, args, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"exercise_scan: unsupported device {device}")
    return cuda_build.bind(cuda_build.load_library("exercise_scan").lib, symbol, args)


def exercise_fit(tables: Tables, obs: torch.Tensor) -> torch.Tensor:
    """The fit of every product (arguments and result as
    :func:`exercise_fit_reference`): the plain version on CPU tensors, one
    kernel launch on CUDA tensors."""
    _check(tables, obs)
    if obs.device.type == "cpu":
        return exercise_fit_reference(tables, obs)
    fit = _kernel("mcre_exercise_fit", _FIT_ARGS, obs.device)
    packed, obs = tables.packed, obs.contiguous()
    n = obs.shape[1]
    with torch.cuda.device(obs.device):
        coeffs = torch.empty(packed.coef_size, dtype=torch.float64, device=obs.device)
        carry = torch.empty((packed.carry_size, n), dtype=torch.float64, device=obs.device)
        rc = fit(coeffs.data_ptr(), carry.data_ptr(), obs.data_ptr(), tables.rows.data_ptr(),
                 tables.strikes.data_ptr(), tables.options.data_ptr(),
                 tables.carry_rows.data_ptr(), tables.signs.data_ptr(), packed.num_products,
                 packed.deg, packed.max_states, n,
                 torch.cuda.current_stream(obs.device).cuda_stream)
    cuda_build.check(rc, "exercise_scan fit")
    launches["fit"] += 1
    return coeffs


def exercise_value(tables: Tables, obs: torch.Tensor, coeffs: torch.Tensor,
                   want_exposures: bool = False):
    """The valuation of every product (arguments and result as
    :func:`exercise_value_reference`): the plain version on CPU tensors, one
    kernel launch on CUDA tensors."""
    _check(tables, obs)
    packed = tables.packed
    if coeffs.shape != (packed.coef_size,) or coeffs.dtype != torch.float64:
        raise ValueError(f"exercise_scan: coefficients {tuple(coeffs.shape)}, not "
                         f"({packed.coef_size},) float64")
    if obs.device.type == "cpu":
        return exercise_value_reference(tables, obs, coeffs, want_exposures)
    value = _kernel("mcre_exercise_value", _VALUE_ARGS, obs.device)
    obs, coeffs = obs.contiguous(), coeffs.contiguous()
    p, n = packed.num_products, obs.shape[1]
    want_exposures = want_exposures and packed.num_exposures > 0
    with torch.cuda.device(obs.device):
        cfs = torch.empty((p, n), dtype=torch.float64, device=obs.device)
        exposures = (torch.empty((p, packed.num_exposures, n), dtype=torch.float64,
                                 device=obs.device) if want_exposures else None)
        rc = value(cfs.data_ptr(), cuda_build.ptr(exposures), coeffs.data_ptr(), obs.data_ptr(),
                   tables.rows.data_ptr(), tables.strikes.data_ptr(), tables.options.data_ptr(),
                   tables.signs.data_ptr(), p, packed.deg, packed.max_states,
                   packed.num_exposures, n, torch.cuda.current_stream(obs.device).cuda_stream)
    cuda_build.check(rc, "exercise_scan value")
    launches["value"] += 1
    return cfs, exposures
