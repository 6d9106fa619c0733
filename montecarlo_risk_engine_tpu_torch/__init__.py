"""montecarlo_risk_engine_tpu_torch — the PyTorch / CUDA port of the engine.

A second package beside ``montecarlo_risk_engine_tpu`` (the JAX reference,
which it never imports).  Ported so far: the Heston-QE European book, the
north-star xVA book (a ModelConfig of Vasicek, Black-Scholes and CIR++
models; swaps and options; LSM exposures, MPoR collateral, CVA, EPE, PFE)
the BS-multi European and basket books, and the mixed book of every
product family: binary, Asian and barrier options, and the exercise products
(Bermudan and American options, FlexiCall, gas storage) by Longstaff-Schwartz,
with the Black-Scholes, BS-multi, Vasicek, CIR++ (stochastic and
deterministic), Hull-White and Schwartz-2F models each on their own or in a
ModelConfig, through ``SimulationController``, forward, differentiated and
with Hessians, and with analytic PV evaluation, with the path kernels
written in CUDA for Hopper (``ops/heston_qe.py`` + ``csrc/heston_qe.cu``,
``ops/hybrid_paths.py`` + ``csrc/hybrid_paths.cu``).  The samplers
(antithetic pairs, scrambled Sobol with the Brownian bridge, ``ops/sobol.py``)
and the streaming route (requests resolved inside the path loop, the
streaming metric pipeline ``api/streaming_metrics.py``, kernel-streaming
AD) are the controller's keywords, as in the JAX package.
"""

from montecarlo_risk_engine_tpu_torch.api.controller import SimulationController
from montecarlo_risk_engine_tpu_torch.api.results import SimulationResults
from montecarlo_risk_engine_tpu_torch.config import SimulationScheme, resolve_device, set_real_dtype
from montecarlo_risk_engine_tpu_torch.metrics.metrics import (
    CEMetric,
    CVAMetric,
    EEPEMetric,
    ENEMetric,
    EPEMetric,
    Metric,
    MetricType,
    PFEMetric,
    PVMetric,
    RiskMetrics,
)
from montecarlo_risk_engine_tpu_torch.models.base import params_from_numpy
from montecarlo_risk_engine_tpu_torch.models.black_scholes import BlackScholesModel
from montecarlo_risk_engine_tpu_torch.models.black_scholes_multi import BlackScholesMulti
from montecarlo_risk_engine_tpu_torch.models.cirpp import CIRPPModel
from montecarlo_risk_engine_tpu_torch.models.heston import HestonModel
from montecarlo_risk_engine_tpu_torch.models.hull_white import HullWhiteModel
from montecarlo_risk_engine_tpu_torch.models.hybrid import ModelConfig
from montecarlo_risk_engine_tpu_torch.models.schwartz_two_factor import SchwartzTwoFactorModel
from montecarlo_risk_engine_tpu_torch.models.vasicek import VasicekModel
from montecarlo_risk_engine_tpu_torch.products.asian_option import AsianAveragingType, AsianOption
from montecarlo_risk_engine_tpu_torch.products.barrier_option import BarrierOption, BarrierOptionType
from montecarlo_risk_engine_tpu_torch.products.base import (
    OptionType,
    Product,
    ProductFamily,
    SettlementType,
)
from montecarlo_risk_engine_tpu_torch.products.basket_option import BasketOption, BasketOptionType
from montecarlo_risk_engine_tpu_torch.products.bermudan_option import AmericanOption, BermudanOption
from montecarlo_risk_engine_tpu_torch.products.binary_option import BinaryOption
from montecarlo_risk_engine_tpu_torch.products.bond import Bond
from montecarlo_risk_engine_tpu_torch.products.equity import Equity
from montecarlo_risk_engine_tpu_torch.products.european_option import EuropeanOption
from montecarlo_risk_engine_tpu_torch.products.flexicall import FlexiCall
from montecarlo_risk_engine_tpu_torch.products.netting_set import NettingSet
from montecarlo_risk_engine_tpu_torch.products.storage import Storage, StorageAction
from montecarlo_risk_engine_tpu_torch.products.storage_config import StorageConfig
from montecarlo_risk_engine_tpu_torch.products.swap import InterestRateSwap, IRSType
from montecarlo_risk_engine_tpu_torch.utils.regression import (
    PolynomialRegression,
    PolyomialRegression,
)

__all__ = [name for name in dir() if not name.startswith("_")]
