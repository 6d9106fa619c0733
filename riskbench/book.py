"""Build a risk run of the port from a configuration and a traffic file.

A configuration (``riskbench/configs/<name>.json``) is data: the model, the
netting sets with their products, the metrics, the scheme.  A product entry
may stand for many products: ``{"type": ..., "count": n, "fields": {...}}``,
where a field given as a list is cycled, product ``i`` taking item
``i % len``.  A value is read by its shape (:func:`_convert`), so a new
product, enum or model needs no edit here.  A traffic file
(``riskbench/traffic/<config>.<traffic>.json``) holds the run's
parameters: path counts, first-order greeks or not, the route switches.
This module turns both into one
``SimulationController`` of the port and reads a run's results back as flat
arrays; nothing here is specific to one book.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np


def expand_products(entry: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The products one entry stands for, each as its type and fields."""
    count = int(entry.get("count", 1))
    fields = entry.get("fields", {})
    out = []
    for i in range(count):
        row = {k: (v[i % len(v)] if isinstance(v, list) else v) for k, v in fields.items()}
        out.append({"type": entry["type"], **row})
    return out


def netting_set_products(cfg: Dict[str, Any]) -> List[List[Dict[str, Any]]]:
    """Per netting set of the configuration, its products' fields."""
    return [[p for e in ns["products"] for p in expand_products(e)] for ns in cfg["netting_sets"]]


def _numeric(value) -> bool:
    return isinstance(value, (int, float)) and not isinstance(value, bool)


def _is_number(text: str) -> bool:
    try:
        float(text)
    except ValueError:
        return False
    return True


def _convert(mt, value):
    """A field's value as the port takes it, by its shape alone:
    ``{"enum": E, "value": V}`` is the port's enum member ``E[V]``; an
    object with a ``"type"`` is that class of the port, built from its
    other fields; a list of equally long lists of numbers is a float64
    matrix; an object keyed by numbers maps floats to floats; a list takes
    each item so."""
    if isinstance(value, dict):
        if set(value) == {"enum", "value"}:
            return getattr(mt, value["enum"])[value["value"]]
        if "type" in value:
            return _make(mt, value)
        if value and all(_is_number(k) and _numeric(v) for k, v in value.items()):
            return {float(k): float(v) for k, v in value.items()}
        return value
    if isinstance(value, list):
        if value and all(isinstance(row, list) and row and all(map(_numeric, row))
                         and len(row) == len(value[0]) for row in value):
            return np.asarray(value, dtype=np.float64)
        return [_convert(mt, v) for v in value]
    return value


def _make(mt, spec: Dict[str, Any]):
    """The port's class ``spec["type"]`` built from the other fields."""
    return getattr(mt, spec["type"])(**{k: _convert(mt, v) for k, v in spec.items()
                                        if k != "type"})


def build_controller(mt, cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, device):
    """One controller of the port for the configuration under the traffic."""
    model = _make(mt, cfg["model"])
    netting_sets = []
    for ns, products in zip(cfg["netting_sets"], netting_set_products(cfg)):
        kw = {k: v for k, v in ns.items() if k not in ("name", "products")}
        netting_sets.append(mt.NettingSet(name=ns["name"], products=[_make(mt, p) for p in products],
                                          **kw))
    metrics = mt.RiskMetrics([_make(mt, s) for s in cfg["metrics"]["metrics"]],
                             exposure_timeline=exposure_timeline(cfg))
    kw = dict(traffic.get("controller", {}))
    return mt.SimulationController(
        netting_sets, model, metrics, int(traffic["num_paths"]), int(traffic["num_paths_presim"]),
        int(cfg["num_steps"]), mt.SimulationScheme[cfg["scheme"]],
        differentiate=bool(traffic["differentiate"]), root_seed=seed, device=device, **kw)


def exposure_timeline(cfg: Dict[str, Any]) -> Optional[np.ndarray]:
    """The metrics' dates: a list, or {"start", "stop", "num"} for numpy's
    linspace, or None."""
    timeline = cfg["metrics"].get("exposure_timeline")
    if isinstance(timeline, dict):
        return np.linspace(timeline["start"], timeline["stop"], timeline["num"])
    return None if timeline is None else np.asarray(timeline, dtype=np.float64)


class RunOutput(NamedTuple):
    """One risk run's answers on the host: ``names[v]`` is
    "netting set/metric/evaluation index"; ``jac`` is [V, P] or None."""

    seed: int
    names: List[str]
    values: np.ndarray
    errors: np.ndarray
    jac: Optional[np.ndarray]
    param_names: List[str]


def read_results(results, seed: int, differentiated: bool) -> RunOutput:
    """Flatten a run's ``SimulationResults`` through its public getters."""
    names, values, errors, jac = [], [], [], []
    params = list(results.get_model_param_names()) if differentiated else []
    for ns_i, ns in enumerate(results.get_netting_set_names()):
        for m_i, metric in enumerate(results.get_metric_names()):
            for e in range(len(results.results[ns_i][m_i])):
                names.append(f"{ns}/{metric}/{e}")
                values.append(float(results.get_results(ns, metric, evaluation_idx=e)))
                errors.append(float(results.get_mc_error(ns, metric, evaluation_idx=e)))
                if differentiated:
                    d = results.get_derivatives(ns, metric, evaluation_idx=e)
                    jac.append([float(d[p]) for p in params])
    return RunOutput(seed, names, np.asarray(values), np.asarray(errors),
                     np.asarray(jac) if differentiated else None, params)
