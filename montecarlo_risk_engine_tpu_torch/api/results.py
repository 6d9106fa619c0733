"""SimulationResults: named access to values, MC errors, and derivatives.

Counterpart of ``montecarlo_risk_engine_tpu/api/results.py`` (numpy only,
as there) and of reference ``src/controller/simulation_results.py``
(simulation_results.py:5-338): nested results are converted to numpy, netting
sets / metrics / model parameters are addressable by name or index
(case-insensitive), legacy keyword aliases (``prod_idx``, ``metric_idx``, ...)
are accepted, and Hessians support named row/column access.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class SimulationResults:
    def __init__(
        self,
        results,
        derivatives,
        second_derivatives,
        netting_set_names: Optional[List[str]] = None,
        metric_names: Optional[List[str]] = None,
        model_param_names: Optional[List[str]] = None,
        product_names: Optional[List[str]] = None,
    ):
        self.results = self._to_numpy(results)
        self.derivatives = self._to_numpy(derivatives)
        self.second_derivatives = self._to_numpy(second_derivatives)

        num_netting_sets = len(self.results)
        num_metrics = len(self.results[0]) if num_netting_sets else 0

        if (
            netting_set_names is not None
            and product_names is not None
            and netting_set_names != product_names
        ):
            raise ValueError(
                "Provide either 'netting_set_names' or legacy alias 'product_names', "
                "not conflicting values."
            )
        names = netting_set_names if netting_set_names is not None else product_names
        self.netting_set_names = names if names is not None else [
            f"netting_set_{i}" for i in range(num_netting_sets)
        ]
        self.product_names = self.netting_set_names
        self.metric_names = metric_names if metric_names is not None else [
            f"metric_{i}" for i in range(num_metrics)
        ]
        self.model_param_names = model_param_names or []

        self._ns_idx = {n.lower(): i for i, n in enumerate(self.netting_set_names)}
        self._metric_idx = {n.lower(): i for i, n in enumerate(self.metric_names)}
        self._param_idx = {n.lower(): i for i, n in enumerate(self.model_param_names)}

    # -- helpers ---------------------------------------------------------------

    def _to_numpy(self, obj):
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._to_numpy(x) for x in obj)
        if obj is None or isinstance(obj, (int, float, np.ndarray)):
            return obj
        return np.asarray(obj)

    @staticmethod
    def _pop_legacy(kwargs, aliases):
        value = None
        for name in aliases:
            if name in kwargs:
                candidate = kwargs.pop(name)
                if value is None:
                    value = candidate
                elif candidate != value:
                    raise ValueError(f"Conflicting values for legacy alias '{name}'.")
        return value

    def _resolve_args(self, netting_set, metric, evaluation_idx, kwargs):
        legacy_ns = self._pop_legacy(kwargs, ("prod_idx", "product", "product_idx"))
        legacy_metric = self._pop_legacy(kwargs, ("metric_idx", "metric_set_idx"))
        legacy_eval = self._pop_legacy(kwargs, ("evaluation_index",))
        if kwargs:
            raise TypeError(f"Unexpected keyword argument(s): {', '.join(sorted(kwargs))}")
        if netting_set is None:
            netting_set = legacy_ns
        if metric is None:
            metric = legacy_metric
        if evaluation_idx is None:
            evaluation_idx = legacy_eval
        return self._ns(netting_set), self._metric(metric), evaluation_idx

    def _ns(self, key):
        if isinstance(key, str):
            if key.lower() not in self._ns_idx:
                raise KeyError(
                    f"Unknown netting set name '{key}'. Available: {self.netting_set_names}"
                )
            return self._ns_idx[key.lower()]
        return key

    def _metric(self, key):
        if isinstance(key, str):
            if key.lower() not in self._metric_idx:
                raise KeyError(f"Unknown metric name '{key}'. Available: {self.metric_names}")
            return self._metric_idx[key.lower()]
        return key

    def _param(self, key):
        if isinstance(key, str):
            if key.lower() not in self._param_idx:
                raise KeyError(
                    f"Unknown model parameter name '{key}'. Available: {self.model_param_names}"
                )
            return self._param_idx[key.lower()]
        return key

    # -- public accessors --------------------------------------------------------

    def get_netting_set_names(self):
        return list(self.netting_set_names)

    def get_product_names(self):
        return list(self.netting_set_names)

    def get_metric_names(self):
        return list(self.metric_names)

    def get_model_param_names(self):
        return list(self.model_param_names)

    def get_results(self, netting_set=None, metric=None, evaluation_idx=None, **kwargs):
        ns, m, ev = self._resolve_args(netting_set, metric, evaluation_idx, kwargs)
        values = np.array([pair[0] for pair in self.results[ns][m]])
        return values if ev is None else values[ev]

    def get_mc_error(self, netting_set=None, metric=None, evaluation_idx=None, **kwargs):
        ns, m, ev = self._resolve_args(netting_set, metric, evaluation_idx, kwargs)
        errors = np.array([pair[1] for pair in self.results[ns][m]])
        return errors if ev is None else errors[ev]

    def get_derivatives(self, netting_set=None, metric=None, param=None,
                        evaluation_idx=None, **kwargs):
        ns, m, ev = self._resolve_args(netting_set, metric, evaluation_idx, kwargs)
        derivatives = self.derivatives[ns][m]
        if param is None and ev is None:
            return derivatives
        if ev is not None:
            row = derivatives[ev]
            if param is None:
                return {name: row[i] for i, name in enumerate(self.model_param_names)}
            return row[self._param(param)]
        p = self._param(param)
        return np.array([evaluation[p] for evaluation in derivatives])

    def get_second_derivatives(self, netting_set=None, metric=None, param1=None,
                               param2=None, evaluation_idx=None, **kwargs):
        ns, m, ev = self._resolve_args(netting_set, metric, evaluation_idx, kwargs)
        second = self.second_derivatives[ns][m]

        if param1 is None and param2 is None and ev is None:
            return second

        def row_dict(row):
            return {name: row[i] for i, name in enumerate(self.model_param_names)}

        if ev is not None:
            hessian = second[ev]
            if param1 is None and param2 is None:
                return {name: row_dict(hessian[i]) for i, name in enumerate(self.model_param_names)}
            if param1 is not None and param2 is None:
                return row_dict(hessian[self._param(param1)])
            if param1 is None and param2 is not None:
                col = self._param(param2)
                return {name: hessian[i][col] for i, name in enumerate(self.model_param_names)}
            return hessian[self._param(param1)][self._param(param2)]

        if param1 is not None and param2 is not None:
            r, c = self._param(param1), self._param(param2)
            return np.array([evaluation[r][c] for evaluation in second])

        raise ValueError("When evaluation_idx is omitted, provide both param1 and param2 or neither.")
