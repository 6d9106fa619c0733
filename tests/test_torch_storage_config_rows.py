"""``StorageConfig`` from rows of numbers: the four storage shapes of the
benchmark's mixed book (riskbench/configs/mixed_pv_book.json) built from
keyword rows equal those built by ``add_*`` calls (the bring-up smoke's
``make_storage``), window, curve and cost, before and after the volume
windows are propagated; without rows the configuration is empty."""

import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
import montecarlo_risk_engine_tpu_torch as mt

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from riskbench import book, spec  # noqa: E402

ROWS = ("volume_constraints", "injection_flexibility", "withdrawal_flexibility",
        "injection_costs", "withdrawal_costs")
SCHEDULES = ("initial_volume_constraints", "volume_constraints", "injection_flexibility",
             "withdrawal_flexibility", "injection_costs", "withdrawal_costs")


def storage_fields():
    cfg = spec.load_cell("mixed_pv_book.pv_1k").config
    entry = next(e for e in cfg["netting_sets"][0]["products"] if e["type"] == "Storage")
    return entry["fields"]


def schedules(c):
    return {name: getattr(c, name) for name in SCHEDULES}


@pytest.mark.parametrize("as_lists", [False, True], ids=["matrices", "lists"])
@pytest.mark.parametrize("shape", range(4))
def test_rows_equal_add_calls(shape, as_lists):
    f = storage_fields()
    spec_rows = f["storage_config"][shape]
    maturity = [1.0, 1.5, 2.0, 2.5][shape]
    initial, rollout = f["initial_amount"][shape], f["rollout_interval"][shape % 3]
    smoke = chip_smoke.make_storage(
        "asset_0", maturity, [18.0, 26.0, 34.0, 42.0][shape], initial, 0.10 + 0.02 * shape,
        0.08 + 0.015 * shape, 6 + shape, rollout).storage_config
    rows = {k: (spec_rows[k] if as_lists else book._convert(mt, spec_rows[k])) for k in ROWS}
    if not as_lists:
        assert all(isinstance(v, np.ndarray) and v.dtype == np.float64 for v in rows.values())
    built = mt.StorageConfig(**rows)
    assert built.volume_constraints == []
    by_calls = mt.StorageConfig()  # the same rows by add_* calls, before propagation
    for row in spec_rows["volume_constraints"]:
        by_calls.add_volume_constraint(*row)
    for row in spec_rows["injection_flexibility"]:
        by_calls.add_injection_flexibility(*row)
    for row in spec_rows["withdrawal_flexibility"]:
        by_calls.add_withdrawal_flexibility(*row)
    for row in spec_rows["injection_costs"]:
        by_calls.add_variable_injection_cost(*row)
    for row in spec_rows["withdrawal_costs"]:
        by_calls.add_variable_withdrawal_cost(*row)
    assert schedules(built) == schedules(by_calls)
    built.optimize_volume_constraints(0.0, maturity, rollout, initial)
    assert schedules(built) == schedules(smoke)
    assert len(built.volume_constraints) > 2


def test_no_rows_is_empty():
    c = mt.StorageConfig()
    assert all(getattr(c, name) == [] for name in SCHEDULES)
    with pytest.raises(ValueError):
        c.get_volume_constraint(0.0)
