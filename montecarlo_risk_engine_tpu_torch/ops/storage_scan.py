"""The gas-storage LSM scan of a whole book: the CUDA kernel and its plain version.

Replaces no TPU kernel.  The JAX package runs each storage bucket's event
scans as ``lax.scan`` loops that XLA fuses.  The port ran them eagerly, one
bucket of same-shaped deals at a time (the controller's
``_exercise_backward_scan`` / ``_exercise_forward_scan`` over
``Storage.scan_exercise_step``), and each date of a bucket cost up to ~190
float64 launches on [P, N, S] tensors: their host dispatch, not their
arithmetic, set the pace (PERF.md section 5).  ``csrc/storage_scan.cu`` runs a
whole phase for every storage deal of a book in one launch: the fit (the
backward induction on the pre-simulation paths) and the valuation (the
forward walk on the main paths).

The deals need not share shapes: each reads its own slice of flat tables
(:func:`pack`), with its own events (its dates and the exposure dates in time
order), grid states and curve lengths.  Per event row: the spot and numeraire
rows it reads in one observation table ``obs`` [U, N] (the distinct rows the
deals read), its exposure slot, the step's constants
(``Storage.scan_event_extras``: :data:`CONSTS`) and its injection and
withdrawal curves.

What the kernel computes is :func:`storage_fit_reference` and
:func:`storage_value_reference`: the torch scans' arithmetic on those tables,
deal by deal, op for op (the fit's normal equations with column equilibration
and the ridge of ``fit_least_squares``, every path sum a ``fixed_tree_sum``;
the DP step of ``Storage.scan_exercise_step`` with its tie rule), with the
float operations PyTorch's CUDA kernels perform: a division by a Python
number is a product with its reciprocal there, and the deg x deg solve is
cuBLAS's getrf and getrs (``torch.linalg.lu_factor_ex`` / ``lu_solve``).  On
CPU tensors the plain version has the CPU's bits (true divisions, LAPACK).

:func:`storage_fit` and :func:`storage_value` dispatch on the device: CPU
tensors run the plain version, CUDA tensors launch the kernel (counted in
``launches``) or raise.  :class:`BookDeals` is the controller's executor of
a book's deals: it owns their tables on the host and on the device, and its
``route`` is the route rule (:func:`engages` and :func:`gradient_flows`),
whose one test seam is :data:`_KERNEL_DEVICES`.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Callable, Hashable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch import tracing
from montecarlo_risk_engine_tpu_torch.config import real_dtype
from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.noise import matmul_t
from montecarlo_risk_engine_tpu_torch.products.storage import Storage, _first_argmax_select
from montecarlo_risk_engine_tpu_torch.utils.maths import interp
from montecarlo_risk_engine_tpu_torch.utils.regression import PolynomialRegression

# csrc/storage_scan.cu: the most grid states a deal may have and the most
# basis columns (a degree-3 polynomial).
MAX_STATES = 16
MAX_BASIS = 4

# The step's constants per event row, in the kernel's column order.
CONSTS = ("is_prod", "prev_vmin", "prev_vmax", "next_vmin", "next_vmax", "inj_cost", "wd_cost",
          "period", "is_last")
(IS_PROD, PREV_VMIN, PREV_VMAX, NEXT_VMIN, NEXT_VMAX, INJ_COST, WD_COST, PERIOD,
 IS_LAST) = range(len(CONSTS))
CURVES = ("inj_pts", "inj_rates", "wd_pts", "wd_rates")
# The columns of ``deals`` and ``rows``.
FIRST_ROW, EVENTS, STATES, INJ_POINTS, WD_POINTS, FIRST_COEF = range(6)
SPOT_ROW, NUM_ROW, EXP_SLOT = range(3)

# Device types on which the kernel takes a book's deals: the one test seam of
# the route (the CPU tests add "cpu" to run its glue on the plain version; an
# empty tuple forces the torch scans).
_KERNEL_DEVICES = ("cuda",)

launches = collections.Counter()  # kernel launches by phase ("fit", "value")


class Packed(NamedTuple):
    """A book's storage deals as flat tables (host arrays).

    ``deals`` int32 [D, 6]: first row, events, grid states, injection and
    withdrawal curve points, first coefficient in the flat coefficients;
    ``rows`` int32 [R, 3]: the row's spot and numeraire rows in ``obs`` and
    its exposure slot (-1: none); ``consts`` float64 [R, 9] (:data:`CONSTS`);
    ``curves`` float64 [R, 4, K] (:data:`CURVES`, the first points of each
    row meaningful); ``prod_rows``: per deal, the rows of its own dates
    (local indices); ``deg``: basis columns; ``num_exposures``: exposure
    slots."""

    deals: np.ndarray
    rows: np.ndarray
    consts: np.ndarray
    curves: np.ndarray
    prod_rows: Tuple[np.ndarray, ...]
    deg: int
    num_exposures: int

    @property
    def num_deals(self) -> int:
        return self.deals.shape[0]

    @property
    def max_states(self) -> int:
        return int(self.deals[:, STATES].max())

    @property
    def max_events(self) -> int:
        return int(self.deals[:, EVENTS].max())

    @property
    def coef_size(self) -> int:
        return int((self.deals[:, EVENTS] * self.deals[:, STATES]).sum()) * self.deg


def kernel_deal(product) -> bool:
    """Whether the kernel values this product: a ``Storage`` of at most
    :data:`MAX_STATES` grid states."""
    return isinstance(product, Storage) and product.get_num_states() <= MAX_STATES


def pack(products: Sequence[Storage], exposure_timeline: Sequence[float], deg: int,
         observation_keys: Callable[[Storage, float, Optional[int]], Tuple[Hashable, Hashable]]
         ) -> Tuple[Packed, List[Hashable]]:
    """The deals' tables and the keys of the rows of ``obs`` in order.

    Each deal's rows are its dates and the exposure dates in time order, as
    the controller's event tables; a row that is only an exposure date takes
    the constants of the deal's first date (the step is masked there).
    ``observation_keys(product, t, i)`` gives the (spot, numeraire) keys of
    the row at time t (i: the product's date index, None at an exposure
    date); each distinct key is one row of ``obs``."""
    exposure = set(exposure_timeline)
    keys: dict = {}
    deals, rows, consts, curves, prod_rows = [], [], [], [], []
    first_coef, slots = 0, 0
    for product in products:
        extras = product.scan_event_extras()
        prod_idx = {t: i for i, t in enumerate(product.product_timeline)}
        times = sorted(set(product.product_timeline) | exposure)
        deals.append((len(rows), len(times), product.get_num_states(),
                      extras["inj_pts"].shape[1], extras["wd_pts"].shape[1], first_coef))
        first_coef += len(times) * product.get_num_states() * deg
        slot, own = 0, []
        for e, t in enumerate(times):
            i = prod_idx.get(t)
            x = 0 if i is None else i
            if i is not None:
                own.append(e)
            spot, num = (keys.setdefault(k, len(keys)) for k in observation_keys(product, t, i))
            rows.append((spot, num, slot if t in exposure else -1))
            slot += t in exposure
            row = [float(i is not None)] + [float(extras[k][x]) for k in CONSTS[1:]]
            consts.append(row)
            curves.append([extras[k][x] for k in CURVES])
        slots = slot
        prod_rows.append(np.asarray(own, dtype=np.int64))
    k_max = max(c.shape[0] for r in curves for c in r)
    curve_table = np.zeros((len(curves), len(CURVES), k_max))
    for r, row in enumerate(curves):
        for j, c in enumerate(row):
            curve_table[r, j, :c.shape[0]] = c
    packed = Packed(np.asarray(deals, dtype=np.int32), np.asarray(rows, dtype=np.int32),
                    np.asarray(consts, dtype=np.float64), curve_table, tuple(prod_rows), int(deg),
                    slots if exposure else 0)
    return packed, list(keys)


class Tables(NamedTuple):
    """:class:`Packed` with its tables on a device."""

    packed: Packed
    deals: torch.Tensor
    rows: torch.Tensor
    consts: torch.Tensor
    curves: torch.Tensor


def deal_coefficients(packed: Packed, coeffs: torch.Tensor) -> List[torch.Tensor]:
    """Each deal's coefficients [events, states, deg]: views of ``coeffs``."""
    out = []
    for _, events, states, _, _, first in packed.deals.tolist():
        out.append(coeffs[first:first + events * states * packed.deg].view(events, states,
                                                                            packed.deg))
    return out


# -- the route rule -------------------------------------------------------------------


def gradient_flows(tensors: Sequence) -> bool:
    """Whether a derivative flows through any of these tensors: one that
    ``torch.func`` wraps (a ``jvp`` or ``vmap`` level) or, with grad mode
    on, one that requires grad."""
    grad = torch.is_grad_enabled()
    return any(isinstance(t, torch.Tensor) and (torch._C._functorch.is_functorch_wrapped_tensor(t)
                                                or (grad and t.requires_grad))
               for t in tensors)


def engages(device, regression_function, sharding, devices=None) -> bool:
    """Whether the controller's storage deals may take the kernel: a CUDA
    device (one of ``devices``, by default :data:`_KERNEL_DEVICES`), no path
    sharding, the float64 working dtype and a polynomial basis of at most
    :data:`MAX_BASIS` columns.  The controller also keeps the torch scan
    where a derivative flows through the deals' observations
    (:func:`gradient_flows`)."""
    devices = _KERNEL_DEVICES if devices is None else devices
    return (torch.device(device).type in devices and sharding is None
            and real_dtype() == torch.float64
            and type(regression_function) is PolynomialRegression
            and regression_function.get_degree() <= MAX_BASIS)


class BookDeals:
    """The kernel's executor of a book's storage deals, built once per
    controller: the deals among ``products`` (the book's exercise-scan
    products) that the kernel takes (:func:`kernel_deal`), each in its
    netting set ``ns_of``.  ``observation_keys`` is :func:`pack`'s.

    It packs the deals' tables at its first use (the request handles exist
    then) and uploads them to ``device``, with each deal's netting set
    (``seg``) and the rows of its own dates, at the first :meth:`fit`.
    :meth:`route` is the route rule; :meth:`fit` and :meth:`value` are one
    launch each over every deal, in an ``exercise`` span (route
    "kernel")."""

    def __init__(self, products, ns_of: Sequence[int], exposure_timeline: Sequence[float],
                 regression_function, observation_keys, device, sharding):
        taken = [kernel_deal(p) for p in products]
        self.products = [p for p, t in zip(products, taken) if t]
        self._ns_of = [ns for ns, t in zip(ns_of, taken) if t]
        self._exposure_timeline = exposure_timeline
        self._regression_function = regression_function
        self._observation_keys = observation_keys
        self._device, self._sharding = torch.device(device), sharding
        self.packed: Optional[Packed] = None
        self.handles: List[Hashable] = []  # the rows of the observation table
        self.tables: Optional[Tables] = None
        self.seg: Optional[torch.Tensor] = None
        self._prod_rows: List[Optional[torch.Tensor]] = []  # None: all of the deal's rows

    def route(self, buckets, resolved):
        """(these deals if the kernel takes them, else None; the scan
        buckets left to the torch scans).  The kernel takes every deal where
        :func:`engages` holds and no derivative flows through the deals'
        observations in the pre-simulation's ``resolved`` handles
        (:func:`gradient_flows`)."""
        if not self.products or not engages(self._device, self._regression_function,
                                            self._sharding):
            return None, buckets
        self._pack()
        if gradient_flows([resolved[0][h] for h in self.handles]):
            return None, buckets
        return self, [b for b in buckets if not kernel_deal(b[0])]

    def _pack(self) -> Packed:
        if self.packed is None:
            self.packed, self.handles = pack(self.products, self._exposure_timeline,
                                             self._regression_function.get_degree(),
                                             self._observation_keys)
        return self.packed

    def device_tables(self) -> Tables:
        """The deals' tables on the device, uploaded at the first call
        through pinned memory on a card (they depend on the deals and the
        exposure dates only)."""
        if self.tables is None:
            packed = self._pack()
            self.tables = Tables(packed, *(cuda_build.upload(a, self._device) for a in (
                packed.deals, packed.rows, packed.consts, packed.curves)))
            self.seg = torch.as_tensor(self._ns_of, device=self._device)
            self._prod_rows = [None if len(rows) == events
                               else torch.as_tensor(rows, device=self._device)
                               for rows, events in zip(packed.prod_rows, packed.deals[:, EVENTS])]
        return self.tables

    def observations(self, resolved, num_paths: int) -> torch.Tensor:
        """The deals' observation table [U, N] of one phase."""
        return torch.stack([torch.broadcast_to(resolved[0][h], (num_paths,))
                            for h in self.handles])

    def _span(self, phase: str):
        return tracing.span("exercise", kind="Storage", products=self.packed.num_deals,
                            steps=self.packed.max_events, phase=phase, route="kernel")

    def fit(self, resolved, num_paths: int) -> torch.Tensor:
        """The fit of every deal on the pre-simulation: the flat
        coefficients; each deal's ``regression_coeffs`` are its own dates'
        rows of them."""
        tables = self.device_tables()
        obs = self.observations(resolved, num_paths)
        with self._span("fit"):
            coeffs, _ = storage_fit(tables, obs)
        views = deal_coefficients(self.packed, coeffs)
        for product, view, rows in zip(self.products, views, self._prod_rows):
            product.regression_coeffs = view if rows is None else view.index_select(0, rows)
        return coeffs

    def value(self, resolved, coeffs: torch.Tensor, num_paths: int, want_exposures: bool):
        """Every deal on the main simulation: (cashflows [D, N], exposure
        profiles [D, T_exp, N] or None)."""
        obs = self.observations(resolved, num_paths)
        with self._span("value"):
            return storage_value(self.tables, obs, coeffs, want_exposures)


# -- the plain version ----------------------------------------------------------------


def _lookup(values, states, num_states: int):
    """Storage.lookup_state_values: ``values`` [N, S] at the continuous
    ``states`` [N, K], linear between the integer states around each."""
    bounded = torch.clamp(states, 0.0, num_states - 1.0)
    lower = torch.floor(bounded).long()
    upper = torch.ceil(bounded).long()
    weight = bounded - lower.to(values.dtype)
    lower_vals = torch.gather(values, -1, lower)
    return lower_vals + weight * (torch.gather(values, -1, upper) - lower_vals)


def _step(state, spot, c, curve, inj_k: int, wd_k: int, num_states: int, grid):
    """Storage.scan_exercise_step at ``state`` [N, K] with ``spot`` [N, 1],
    the row's constants ``c`` [9] and curves ``curve`` [4, K'], continuations
    interpolated in ``grid`` [N, S]: (next state, payoff), the first of
    (inject, hold, withdraw) at the first largest value."""
    s_minus_1 = num_states - 1.0
    prev_span = c[PREV_VMAX] - c[PREV_VMIN]
    prev_vol = c[PREV_VMIN] + state * prev_span / s_minus_1
    next_span = torch.clamp(c[NEXT_VMAX] - c[NEXT_VMIN], min=1e-30)
    inj_rate = interp(prev_vol, curve[0, :inj_k], curve[1, :inj_k])
    wd_rate = interp(prev_vol, curve[2, :wd_k], curve[3, :wd_k])
    vols = (torch.minimum(prev_vol + inj_rate * c[PERIOD], c[NEXT_VMAX]),
            torch.minimum(torch.maximum(prev_vol, c[NEXT_VMIN]), c[NEXT_VMAX]),
            torch.maximum(prev_vol - wd_rate * c[PERIOD], c[NEXT_VMIN]))
    buy, sell = spot + c[INJ_COST], spot - c[WD_COST]
    states = [(vol - c[NEXT_VMIN]) * s_minus_1 / next_span for vol in vols]
    deltas = [vol - prev_vol for vol in vols]
    payoffs = [-deltas[0] * buy, -deltas[1] * torch.where(deltas[1] >= 0.0, buy, sell),
               -deltas[2] * sell]
    values = [p + (1.0 - c[IS_LAST]) * _lookup(grid, s, num_states)
              for p, s in zip(payoffs, states)]
    return _first_argmax_select(values, *zip(states, payoffs))


def _row(packed: Packed, tables: Tables, obs, r: int):
    spot_row, num_row, _ = packed.rows[r].tolist()
    return obs[spot_row], obs[num_row], tables.consts[r], tables.curves[r]


def storage_fit_reference(tables: Tables, obs: torch.Tensor, want_normal: bool = False):
    """Plain PyTorch version of the fit: (coefficients [sum of events x
    states x deg], flat as :func:`deal_coefficients` reads them; the Gram
    and right-hand sides of every row [R, deg, deg + max states] or None).

    Per deal, last event first: the basis [1, x, x^2, ...] of the row's spot
    x, column scales sqrt(tree sum of A^2 / N), the Gram and right-hand
    sides (the numeraire times each state's carry) as tree sums of the
    scaled products, the ridge and the solve (``fit_least_squares``); then,
    on the deal's own dates, the DP step of every grid state and the carry
    <- deflated cashflow + carry at the next state."""
    packed = tables.packed
    deg, n = packed.deg, obs.shape[1]
    dtype, device = obs.dtype, obs.device
    coeffs = torch.empty(packed.coef_size, dtype=dtype, device=device)
    normal = (torch.zeros((packed.rows.shape[0], deg, deg + packed.max_states), dtype=dtype,
                          device=device) if want_normal else None)
    eye = torch.eye(deg, dtype=dtype, device=device)
    for first_row, events, states, inj_k, wd_k, first in packed.deals.tolist():
        carry = torch.zeros((n, states), dtype=dtype, device=device)
        grid_states = torch.arange(states, dtype=dtype, device=device).expand(n, states)
        for e in reversed(range(events)):
            r = first_row + e
            x, num, c, curve = _row(packed, tables, obs, r)
            basis = torch.stack([x ** k for k in range(deg)], dim=-1)  # PolynomialRegression
            col_scale = torch.clamp(torch.sqrt(fixed_tree_sum(basis * basis, 0) / n), min=1e-30)
            scaled = basis / col_scale
            cols = torch.cat([scaled, num[:, None] * carry], dim=-1)
            both = fixed_tree_sum(scaled[:, :, None] * cols[:, None, :], 0)  # [deg, deg + S]
            if normal is not None:
                normal[r, :, :deg + states] = both
            gram, rhs = both[:, :deg], both[:, deg:]
            ridge = 1e-10 * (torch.diagonal(gram).sum(-1) / deg) + 1e-30
            lu, pivots, _ = torch.linalg.lu_factor_ex(gram + ridge * eye)
            coef = (torch.linalg.lu_solve(lu, pivots, rhs) / col_scale[:, None]).mT  # [S, deg]
            coeffs[first + e * states * deg:first + (e + 1) * states * deg] = coef.reshape(-1)
            if packed.consts[r, IS_PROD]:
                nxt, payoff = _step(grid_states, x[:, None], c, curve, inj_k, wd_k, states,
                                    matmul_t(basis, coef))
                carry = payoff / num[:, None] + _lookup(carry, nxt, states)
    return coeffs, normal


def storage_value_reference(tables: Tables, obs: torch.Tensor, coeffs: torch.Tensor,
                            want_exposures: bool = False):
    """Plain PyTorch version of the valuation: (deflated cashflows [D, N],
    continuation exposures [D, exposure slots, N] or None).  Per deal, first
    event first, from grid state 0: on its own dates the DP step at the
    realized state with the fitted continuation, its cashflow / numeraire
    summed; on each exposure date the continuation at the realized state /
    numeraire."""
    packed = tables.packed
    deg, n = packed.deg, obs.shape[1]
    dtype, device = obs.dtype, obs.device
    cfs = torch.empty((packed.num_deals, n), dtype=dtype, device=device)
    want_exposures = want_exposures and packed.num_exposures > 0
    exposures = (torch.empty((packed.num_deals, packed.num_exposures, n), dtype=dtype,
                             device=device) if want_exposures else None)
    per_deal = deal_coefficients(packed, coeffs)
    for d, (first_row, events, states, inj_k, wd_k, _) in enumerate(packed.deals.tolist()):
        state = torch.zeros((n, 1), dtype=dtype, device=device)
        cf = torch.zeros(n, dtype=dtype, device=device)
        for e in range(events):
            r = first_row + e
            x, num, c, curve = _row(packed, tables, obs, r)
            basis = torch.stack([x ** k for k in range(deg)], dim=-1)
            grid = matmul_t(basis, per_deal[d][e])  # [N, S]
            if packed.consts[r, IS_PROD]:
                state, payoff = _step(state, x[:, None], c, curve, inj_k, wd_k, states, grid)
                cf = cf + (payoff / num[:, None])[:, 0]
            else:
                cf = cf + torch.zeros_like(cf)
            slot = int(packed.rows[r, EXP_SLOT])
            if exposures is not None and slot >= 0:
                exposures[d, slot] = _lookup(grid, state, states)[:, 0] / num
        cfs[d] = cf
    return cfs, exposures


# -- the kernel -----------------------------------------------------------------------


_P, _I = ctypes.c_void_p, ctypes.c_int
# The arguments of mcre_storage_fit and mcre_storage_value.
_FIT_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_uint32, _P)
_VALUE_ARGS = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_uint32, _P)


def _check(tables: Tables, obs: torch.Tensor):
    packed = tables.packed
    if obs.dim() != 2 or obs.dtype != torch.float64:
        raise ValueError(f"storage_scan takes float64 observations [U, N], not {tuple(obs.shape)} "
                         f"{obs.dtype}")
    if packed.rows.size and int(packed.rows[:, :2].max()) >= obs.shape[0]:
        raise ValueError("storage_scan: a row reads beyond the observation table")
    if not 2 <= packed.max_states <= MAX_STATES or not 1 <= packed.deg <= MAX_BASIS:
        raise ValueError(f"storage_scan takes 2 .. {MAX_STATES} grid states and 1 .. {MAX_BASIS} "
                         "basis columns")
    if any(t.device != obs.device for t in (tables.deals, tables.rows, tables.consts,
                                            tables.curves)):
        raise ValueError("storage_scan: the tables and the observations lie on different devices")


def _kernel(symbol: str, args, device: torch.device):
    if device.type != "cuda":
        raise ValueError(f"storage_scan: unsupported device {device}")
    return cuda_build.bind(cuda_build.load_library("storage_scan").lib, symbol, args)


def storage_fit(tables: Tables, obs: torch.Tensor, want_normal: bool = False):
    """The fit of every deal (arguments and result as
    :func:`storage_fit_reference`): the plain version on CPU tensors, one
    kernel launch on CUDA tensors."""
    _check(tables, obs)
    if obs.device.type == "cpu":
        return storage_fit_reference(tables, obs, want_normal)
    fit = _kernel("mcre_storage_fit", _FIT_ARGS, obs.device)
    packed, obs = tables.packed, obs.contiguous()
    d, s_max, n = packed.num_deals, packed.max_states, obs.shape[1]
    with torch.cuda.device(obs.device):
        coeffs = torch.empty(packed.coef_size, dtype=torch.float64, device=obs.device)
        normal = (torch.zeros((packed.rows.shape[0], packed.deg, packed.deg + s_max),
                              dtype=torch.float64, device=obs.device) if want_normal else None)
        carry = torch.empty((d, s_max, n), dtype=torch.float64, device=obs.device)
        rc = fit(coeffs.data_ptr(), cuda_build.ptr(normal), carry.data_ptr(), obs.data_ptr(),
                 tables.rows.data_ptr(), tables.consts.data_ptr(), tables.curves.data_ptr(),
                 tables.deals.data_ptr(), d, packed.deg, packed.curves.shape[2], s_max, n,
                 torch.cuda.current_stream(obs.device).cuda_stream)
    cuda_build.check(rc, "storage_scan fit")
    launches["fit"] += 1
    return coeffs, normal


def storage_value(tables: Tables, obs: torch.Tensor, coeffs: torch.Tensor,
                  want_exposures: bool = False):
    """The valuation of every deal (arguments and result as
    :func:`storage_value_reference`): the plain version on CPU tensors, one
    kernel launch on CUDA tensors."""
    _check(tables, obs)
    packed = tables.packed
    if coeffs.shape != (packed.coef_size,) or coeffs.dtype != torch.float64:
        raise ValueError(f"storage_scan: coefficients {tuple(coeffs.shape)}, not "
                         f"({packed.coef_size},) float64")
    if obs.device.type == "cpu":
        return storage_value_reference(tables, obs, coeffs, want_exposures)
    value = _kernel("mcre_storage_value", _VALUE_ARGS, obs.device)
    obs, coeffs = obs.contiguous(), coeffs.contiguous()
    d, n = packed.num_deals, obs.shape[1]
    want_exposures = want_exposures and packed.num_exposures > 0
    with torch.cuda.device(obs.device):
        cfs = torch.empty((d, n), dtype=torch.float64, device=obs.device)
        exposures = (torch.empty((d, packed.num_exposures, n), dtype=torch.float64,
                                 device=obs.device) if want_exposures else None)
        rc = value(cfs.data_ptr(), cuda_build.ptr(exposures), coeffs.data_ptr(), obs.data_ptr(),
                   tables.rows.data_ptr(), tables.consts.data_ptr(), tables.curves.data_ptr(),
                   tables.deals.data_ptr(), d, packed.deg, packed.curves.shape[2],
                   packed.max_states, packed.num_exposures, n,
                   torch.cuda.current_stream(obs.device).cuda_stream)
    cuda_build.check(rc, "storage_scan value")
    launches["value"] += 1
    return cfs, exposures
