"""montecarlo_risk_engine_tpu_torch — the PyTorch / CUDA port of the engine.

A second package beside ``montecarlo_risk_engine_tpu`` (the JAX reference,
which it never imports).  This slice covers the Heston-QE European book
through ``SimulationController``, forward and differentiated, with the path
kernel written in CUDA for Hopper (``ops/heston_qe.py``,
``csrc/heston_qe.cu``).
"""

from montecarlo_risk_engine_tpu_torch.api.controller import SimulationController
from montecarlo_risk_engine_tpu_torch.api.results import SimulationResults
from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, resolve_device
from montecarlo_risk_engine_tpu_torch.metrics.metrics import (
    Metric,
    MetricType,
    PVMetric,
    RiskMetrics,
)
from montecarlo_risk_engine_tpu_torch.models.base import params_from_numpy
from montecarlo_risk_engine_tpu_torch.models.heston import HestonModel
from montecarlo_risk_engine_tpu_torch.products.base import OptionType, Product, ProductFamily
from montecarlo_risk_engine_tpu_torch.products.equity import Equity
from montecarlo_risk_engine_tpu_torch.products.european_option import EuropeanOption
from montecarlo_risk_engine_tpu_torch.products.netting_set import NettingSet

__all__ = [name for name in dir() if not name.startswith("_")]
