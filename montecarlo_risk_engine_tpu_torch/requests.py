"""Observable requests: declaration, static deduplication, resolution.

Counterpart of ``montecarlo_risk_engine_tpu/requests.py``.  Deduplication
and handle assignment run once on the host.  Plane mode:
:meth:`RequestPlan.resolve_requests` turns the [T, N, D] state plane into
flat handle-indexed lists.  Streaming mode: :meth:`RequestPlan.
build_emission_schedule` makes the static per-point tables from which the
engine resolves each point's rows against the live state
(engine/engine.py), and :meth:`RequestPlan.resolve_from_emissions` turns
the emitted rows into the same handle-indexed lists.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from montecarlo_risk_engine_tpu_torch.ops.gather import RowSelection


class AtomicRequestType(enum.Enum):
    SPOT = 1
    DISCOUNT_FACTOR = 2
    NUMERAIRE = 3
    FORWARD_RATE = 4
    LIBOR_RATE = 5
    SURVIVAL_PROBABILITY = 6
    CONDITIONAL_SURVIVAL_PROBABILITY = 7


class AtomicRequest:
    """A single model observable at a simulation time point.

    Hashable on (type, id, time1, time2) with a mutable integer ``handle``
    assigned during deduplication (reference request_types.py:19-43).
    """

    __slots__ = ("request_type", "id", "time1", "time2", "handle")

    def __init__(
        self,
        request_type: AtomicRequestType,
        time1: Optional[float] = None,
        time2: Optional[float] = None,
        id: Optional[int] = None,
    ):
        self.request_type = request_type
        self.id = id
        self.time1 = None if time1 is None else float(time1)
        self.time2 = None if time2 is None else float(time2)
        self.handle: Optional[int] = None

    def set_handle(self, idx: int) -> None:
        self.handle = idx

    def key(self):
        return (self.request_type, self.id, self.time1, self.time2)

    def __eq__(self, other):
        return isinstance(other, AtomicRequest) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return f"AtomicRequest({self.request_type.name}, t1={self.time1}, t2={self.time2})"


class UnderlyingRequest:
    """Composite request wrapping a Product observed at a date
    (reference request_types.py:45-68)."""

    def __init__(self, underlying_asset):
        self.underlying_asset = underlying_asset

    def set_handle(self, idx: int) -> None:
        self.underlying_asset.composite_req_handle = idx

    def get_handle(self) -> int:
        return self.underlying_asset.composite_req_handle

    def get_atomic_requests(self):
        return self.underlying_asset.get_atomic_requests_for_underlying()

    def get_value(self, resolved_atomic_requests):
        return self.underlying_asset.get_value(resolved_atomic_requests)

    def key(self):
        return self.underlying_asset

    def __eq__(self, other):
        return isinstance(other, UnderlyingRequest) and self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


def _underlying_order(req: UnderlyingRequest):
    ua = req.underlying_asset
    return (
        type(ua).__name__,
        tuple(getattr(ua, "asset_ids", ()) or ()),
        tuple(float(t) for t in getattr(ua, "modeling_timeline", ()) or ()),
    )


def _req_order(req: AtomicRequest):
    """Deterministic sort key for hash-ordered request sets, so handle order
    does not follow PYTHONHASHSEED."""
    return (
        req.request_type.value,
        -1.0 if req.time1 is None else float(req.time1),
        -1.0 if req.time2 is None else float(req.time2),
    )


class EmissionGroup:
    """Static per-(asset, kind) emission table of the streaming engine.

    ``K`` is the largest number of same-kind requests at one time point;
    ``t1_tab``/``t2_tab`` are dense [num_points, K] host arrays.  Padding
    rows repeat the group's first request times; their rows are never read
    (requests.py:114-130)."""

    __slots__ = ("asset_id", "kind", "K", "t1_tab", "t2_tab")

    def __init__(self, asset_id, kind, K, t1_tab, t2_tab):
        self.asset_id = asset_id
        self.kind = kind
        self.K = K
        self.t1_tab = t1_tab
        self.t2_tab = t2_tab


class EmissionSchedule:
    """Observable schedule for resolution inside the path loop
    (requests.py:133-162): the engine emits O(request rows x paths) instead
    of the O(T x D x paths) state plane."""

    def __init__(self, groups, handle_loc, kind_lookup, num_points,
                 ambiguous_kinds=frozenset()):
        self.groups: List[EmissionGroup] = groups
        # handle -> (group index, flat row = time_idx * K + k)
        self.handle_loc: Dict[int, Tuple[int, int]] = handle_loc
        # (time_idx, asset_id, kind) -> handle, absent when ambiguous
        self.kind_lookup: Dict[Tuple[int, str, AtomicRequestType], int] = kind_lookup
        # keys dropped from kind_lookup because several requests share the
        # (time_idx, asset, kind) with different (t1, t2)
        self.ambiguous_kinds = frozenset(ambiguous_kinds)
        self.num_points = num_points

    def num_emitted_rows(self) -> int:
        return sum(self.num_points * g.K for g in self.groups)


class EmittedRows:
    """The [T*K, N] (or [T*K]) rows of one schedule group, kept as the pieces
    they were emitted in (whole points, in time order) instead of one
    concatenated tensor, whose copy would double the rows' memory at the
    moment it is made.  Reads by flat row, ``index_select`` along rows,
    ``to`` and :meth:`tensor` (the concatenation, for inspection)."""

    def __init__(self, pieces):
        self.pieces = list(pieces)
        self._starts = np.cumsum([0] + [p.shape[0] for p in self.pieces])
        self.shape = (int(self._starts[-1]),) + tuple(self.pieces[0].shape[1:])
        self.device = self.pieces[0].device
        self.dtype = self.pieces[0].dtype

    def dim(self) -> int:
        return len(self.shape)

    def _locate(self, row: int):
        piece = int(np.searchsorted(self._starts, row, side="right")) - 1
        return piece, row - int(self._starts[piece])

    def __getitem__(self, row: int) -> torch.Tensor:
        piece, local = self._locate(int(row))
        return self.pieces[piece][local]

    def index_select(self, dim: int, index) -> torch.Tensor:
        if dim != 0:
            raise ValueError("EmittedRows selects along the row axis only")
        return torch.stack([self[int(r)] for r in torch.as_tensor(index).tolist()])

    def to(self, *args, **kwargs) -> "EmittedRows":
        return EmittedRows([p.to(*args, **kwargs) for p in self.pieces])

    def tensor(self) -> torch.Tensor:
        return torch.cat(self.pieces)


class RequestPlan:
    """Collects, deduplicates and indexes all requests, then resolves them
    against simulated states (reference request_interface.py:22-130)."""

    def __init__(self, model):
        self.model = model
        self.num_atomic_requests = 0
        self.num_composite_requests = 0
        # (time_idx, asset_id) -> set of AtomicRequest
        self.atomic_by_label: Dict[Tuple[int, str], set] = defaultdict(set)
        # time_idx -> set of UnderlyingRequest
        self.composite_by_time: Dict[int, set] = defaultdict(set)

    def collect_and_index_requests(
        self,
        products: Sequence,
        simulation_timeline: Sequence[float],
        exposure_requests: Dict[Tuple[float, str], set],
        exposure_timeline: Sequence[float],
    ) -> None:
        time_to_index = {float(t): idx for idx, t in enumerate(simulation_timeline)}
        atomic_handles: Dict[tuple, int] = {}
        composite_handles: Dict[tuple, int] = {}

        def register_atomic(req: AtomicRequest, time_idx: int, asset_id: str) -> None:
            key = (time_idx, asset_id, req)
            if key not in atomic_handles:
                atomic_handles[key] = len(atomic_handles)
            req.set_handle(atomic_handles[key])
            self.atomic_by_label[(time_idx, asset_id)].add(req)

        def register_composite(req: UnderlyingRequest, time_idx: int) -> None:
            key = (time_idx, req)
            if key not in composite_handles:
                composite_handles[key] = len(composite_handles)
            req.set_handle(composite_handles[key])
            self.composite_by_time[time_idx].add(req)

        for prod in products:
            # Composite (underlying) requests and the atomics they imply
            # (reference request_interface.py:41-58).
            for local_t, und_reqs in prod.get_underlying_requests().items():
                time_idx = time_to_index[float(prod.modeling_timeline[local_t])]
                for und_req in sorted(und_reqs, key=_underlying_order):
                    register_composite(und_req, time_idx)
                    for label, reqs in und_req.get_atomic_requests().items():
                        asset_id = label[1]
                        for req in sorted(reqs, key=_req_order):
                            register_atomic(req, time_idx, asset_id)

            # The product's own atomic requests (request_interface.py:61-74).
            for (local_t, asset_id), reqs in prod.get_atomic_requests().items():
                time_idx = time_to_index[float(prod.modeling_timeline[local_t])]
                for req in sorted(reqs, key=_req_order):
                    register_atomic(req, time_idx, asset_id)

        # Controller/metric exposure requests (request_interface.py:77-92):
        # integer keys index the metric exposure timeline, float keys are
        # absolute times.
        for (t, asset_id), reqs in exposure_requests.items():
            exposure_time = float(exposure_timeline[t]) if isinstance(t, int) else float(t)
            time_idx = time_to_index[exposure_time]
            for req in sorted(reqs, key=_req_order):
                register_atomic(req, time_idx, asset_id)

        self.num_atomic_requests = len(atomic_handles)
        self.num_composite_requests = len(composite_handles)

    def _groups(self) -> Dict[Tuple[str, AtomicRequestType], list]:
        groups: Dict[Tuple[str, AtomicRequestType], list] = defaultdict(list)
        for (time_idx, asset_id), reqs in self.atomic_by_label.items():
            for req in sorted(reqs, key=_req_order):
                groups[(asset_id, req.request_type)].append((time_idx, req))
        return groups

    def _resolve_composites(self, resolved) -> list:
        resolved_composite = [None] * self.num_composite_requests
        for _, comp_reqs in self.composite_by_time.items():
            for req in sorted(comp_reqs, key=lambda r: r.get_handle()):
                resolved_composite[req.get_handle()] = req.get_value(resolved)
        return [resolved, resolved_composite]

    def build_emission_schedule(self, num_points: int) -> EmissionSchedule:
        """Static per-point resolution tables for the streaming engine
        (requests.py:237-276), groups in a PYTHONHASHSEED-free order."""
        out_groups: List[EmissionGroup] = []
        handle_loc: Dict[int, Tuple[int, int]] = {}
        kind_lookup: Dict[Tuple[int, str, AtomicRequestType], int] = {}
        ambiguous = set()
        for (asset_id, kind), rows in sorted(self._groups().items(),
                                             key=lambda kv: (kv[0][0] or "", kv[0][1].value)):
            per_time: Dict[int, list] = defaultdict(list)
            for time_idx, req in rows:
                per_time[time_idx].append(req)
            K = max(len(v) for v in per_time.values())
            first = rows[0][1]
            t1_tab = np.full((num_points, K), 0.0 if first.time1 is None else first.time1)
            t2_tab = np.full((num_points, K), 0.0 if first.time2 is None else first.time2)
            g_idx = len(out_groups)
            for time_idx, reqs_t in per_time.items():
                for k, req in enumerate(reqs_t):
                    t1_tab[time_idx, k] = 0.0 if req.time1 is None else req.time1
                    t2_tab[time_idx, k] = 0.0 if req.time2 is None else req.time2
                    handle_loc[req.handle] = (g_idx, time_idx * K + k)
                    key = (time_idx, asset_id, kind)
                    if key in kind_lookup:
                        ambiguous.add(key)
                    else:
                        kind_lookup[key] = req.handle
            out_groups.append(EmissionGroup(asset_id, kind, K, t1_tab, t2_tab))
        for key in ambiguous:
            kind_lookup.pop(key, None)
        return EmissionSchedule(out_groups, handle_loc, kind_lookup, num_points,
                                ambiguous_kinds=ambiguous)

    def resolve_from_emissions(self, schedule: EmissionSchedule, emissions) -> list:
        """Handle-indexed lists from the engine's emissions (one [T*K, N] or
        [T*K] tensor or :class:`EmittedRows` per schedule group), the structure of
        :meth:`resolve_requests` (requests.py:278-293)."""
        resolved = [None] * self.num_atomic_requests
        for handle, (g_idx, flat_row) in schedule.handle_loc.items():
            resolved[handle] = emissions[g_idx][flat_row]
        return self._resolve_composites(resolved)

    def resolve_requests(self, params, states: torch.Tensor) -> list:
        """Resolve every request against the state plane: a [T, N, D]
        tensor or a sequence of T [N, D] states.

        Returns ``[resolved_atomics, resolved_composites]``, lists indexed by
        handle; each entry broadcasts against [N] (state-independent
        observables stay 0-d).  Resolution is batched by (asset, kind): all
        requests of one kind on one asset become one vectorised closed form
        over their rows, gathered column by column (ops/gather.RowSelection).
        """
        resolved = [None] * self.num_atomic_requests
        for (asset_id, kind), rows in self._groups().items():
            tidx = [r[0] for r in rows]
            t1s = torch.tensor([0.0 if r[1].time1 is None else r[1].time1 for r in rows],
                               dtype=states[0].dtype, device=states[0].device)
            t2s = torch.tensor([0.0 if r[1].time2 is None else r[1].time2 for r in rows],
                               dtype=states[0].dtype, device=states[0].device)
            states_sel = RowSelection(states, tidx)
            out = self.model.resolve_request_rows(params, kind, asset_id, t1s, t2s, states_sel)
            for i, (_, req) in enumerate(rows):
                resolved[req.handle] = out[i]
        return self._resolve_composites(resolved)
