"""The benchmark's mixed PV book (riskbench/configs/mixed_pv_book.json)
against its plain reference (riskbench/reference/mixed_pv_book.py), family
by family on the CPU at a few products and 512 + 512 paths; a fault planted
in the reference's input reads above the cell's limit; the configuration
expands to the upstream book, field for field what the bring-up smoke's
``build_book`` makes."""

import copy
import json
import random
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
import montecarlo_risk_engine_tpu_torch as mt

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from riskbench import book, spec  # noqa: E402
from riskbench.reference import mixed_pv_book as ref  # noqa: E402

CELL = spec.load_cell("mixed_pv_book.pv_1k")
LIMIT = CELL.traffic["limits"]["pv_gap"]
TRAFFIC = {**CELL.traffic, "num_paths": 512, "num_paths_presim": 512}
SEED = 2 ** 31 + 7919
PER_FAMILY = 5
FAMILIES = {"EuropeanOption": "european", "BinaryOption": "binary", "BasketOption": "basket",
            "AsianOption": "asian", "BarrierOption": "barrier", "AmericanOption": "american",
            "FlexiCall": "flexicall", "Storage": "storage"}


def family_book(kind, count=PER_FAMILY, cfg=None):
    """The configuration with one family's first ``count`` products alone."""
    cfg = copy.deepcopy(cfg or CELL.config)
    entries = [e for e in cfg["netting_sets"][0]["products"] if e["type"] == kind]
    for e in entries:
        e["count"] = count
    cfg["netting_sets"][0]["products"] = entries
    return cfg


def port_pv(cfg):
    c = book.build_controller(mt, cfg, TRAFFIC, SEED, "cpu")
    return book.read_results(c.run_simulation(), SEED, False)


def fields(cfg, kind):
    return next(e for e in cfg["netting_sets"][0]["products"] if e["type"] == kind)["fields"]


def _strike_up(cfg, kind):
    fields(cfg, kind)["strike"][0] += 1.0


def _payment_up(cfg, kind):
    fields(cfg, kind)["payment_amount"][0] += 1.0


def _basket_geometric(cfg, kind):
    fields(cfg, kind)["basket_option_type"][1]["value"] = "GEOMETRIC"


def _asian_geometric(cfg, kind):
    fields(cfg, kind)["averaging_type"][1]["value"] = "GEOMETRIC"


def _barrier_up(cfg, kind):
    fields(cfg, kind)["barrier1"][0] += 1.0


def _one_more_right(cfg, kind):
    f = fields(cfg, kind)
    f["num_exercise_rights"][0] += 1  # a FlexiCall of 3 calls with 2 rights, not 1


def _withdrawal_cost_sign(cfg, kind):
    costs = fields(cfg, kind)["storage_config"][0]["withdrawal_costs"]
    costs[0][1] = -costs[0][1]


# one fault in the reference's input per family; none moves a date, so the
# paths stay the run's
FAULTS = {"EuropeanOption": _strike_up, "BinaryOption": _payment_up,
          "BasketOption": _basket_geometric, "AsianOption": _asian_geometric,
          "BarrierOption": _barrier_up, "AmericanOption": _strike_up,
          "FlexiCall": _one_more_right, "Storage": _withdrawal_cost_sign}


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_the_port_agrees_with_the_reference_and_a_planted_fault_does_not(kind):
    cfg = family_book(kind)
    run = port_pv(cfg)
    sound = ref.check(cfg, TRAFFIC, [run], "cpu")["pv_gap"]
    assert sound <= LIMIT / 100, sound
    faulty = copy.deepcopy(cfg)
    FAULTS[kind](faulty, kind)
    assert ref.timeline(faulty) == ref.timeline(cfg)
    planted = ref.check(faulty, TRAFFIC, [run], "cpu")["pv_gap"]
    assert planted > 1000 * LIMIT, planted


def test_the_reference_draws_the_ports_paths():
    """Both phases' float32 states, date for date, as the port's kernel route
    draws them (its plain version on the CPU)."""
    cfg = family_book("Storage", 2)
    c = book.build_controller(mt, cfg, TRAFFIC, SEED, "cpu")
    params = c.model.initial_params(device=c.device, dtype=torch.float64)
    times = ref.timeline(cfg)
    assert tuple(times) == c.simulation_timeline
    assert c._kernel_active
    for phase in (mt.rng.PHASE_PRESIM, mt.rng.PHASE_MAINSIM):
        port = c.model.kernel_paths(params, c.simulation_scheme, times, 512, 1, SEED, phase)
        mine = ref.paths(SEED & 0xFFFFFFFF, phase, 512, cfg, times, "cpu")
        assert torch.equal(port, mine)


def _state(obj):
    """An object's fields as plain values, its requests and run state left out."""
    skip = {"spot_requests", "numeraire_requests", "libor_requests", "underlying_requests",
            "composite_req_handle", "product_id", "regression_coeffs", "bridge_source",
            "path_sharding"}
    if isinstance(obj, (list, tuple)):
        return [_state(x) for x in obj]
    if hasattr(obj, "name") and hasattr(obj, "value") and type(obj).__module__.startswith(
            "montecarlo_risk_engine_tpu_torch"):
        return f"{type(obj).__name__}.{obj.name}"
    if hasattr(obj, "__dict__"):
        return [type(obj).__name__, {k: _state(v) for k, v in sorted(vars(obj).items())
                                     if k not in skip}]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (float, np.floating)):
        return float(obj)
    return obj


def test_the_configuration_is_the_upstream_book():
    cfg = CELL.config
    assert cfg["reduced"] == [] and cfg["precision"] == {"paths": "float32",
                                                         "valuation": "float64"}
    (ns,) = book.netting_set_products(cfg)
    assert Counter(FAMILIES[p["type"]] for p in ns) == chip_smoke.MIXED_COUNTS
    assert [FAMILIES[p["type"]] for p in ns] == [
        f for f, n in chip_smoke.MIXED_COUNTS.items() for _ in range(n)]
    upstream = [p for ps in chip_smoke.build_book(list(chip_smoke.ASSETS),
                                                  chip_smoke.MIXED_COUNTS).values() for p in ps]
    assert len(upstream) == len(ns) == 50_000
    model = book._make(mt, cfg["model"])
    smoke = chip_smoke.bs_multi_model()
    assert _state(model) == _state(smoke)
    # a seeded sample, each family's first cycle and every storage deal
    first = {}
    for i, p in enumerate(ns):
        first.setdefault(p["type"], i)
    picks = set(random.Random(SEED).sample(range(len(ns)), 500))
    picks |= {i for start in first.values() for i in range(start, start + 12)}
    picks |= set(range(first["Storage"], len(ns)))
    for i in sorted(picks):
        assert _state(book._make(mt, ns[i])) == _state(upstream[i]), i


def test_distinct_products_count_the_book():
    distinct = ref.distinct_products(CELL.config)
    assert sum(n for _, n in distinct) == 50_000
    assert len(distinct) < 500  # the book cycles its fields
    assert json.dumps(distinct[0][0], sort_keys=True) == json.dumps(
        book.netting_set_products(CELL.config)[0][0], sort_keys=True)
