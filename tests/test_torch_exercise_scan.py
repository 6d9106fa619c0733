"""The equity exercise scan kernel (ops/exercise_scan.py,
csrc/exercise_scan.cu) and its route in the controller.

On the CPU the kernel's plain version stands in for it: on the packed
per-product tables of the controller's executor (``BookOptions``) it is held
bitwise to the family batches' torch scans (``ExerciseEquityBatch.fit`` /
``evaluate``) for Americans of the mixed book's six date counts (some
in-the-money gated), Bermudan puts and calls and FlexiCalls of three, four
and five dates with one to three rights, all in one pack, with and without
exposure dates; the route's glue (tables, observation rows, coefficients as
rows of one buffer, netting) is run on it by adding the CPU to the kernel's
devices (``_KERNEL_DEVICES``, the route's one test seam)
(tests/test_torch_exercise.py holds that route to the JAX package).  The
route engages only on the state plane's observations, where no derivative
flows, without a path sharding, in float64, with the polynomial basis, on a
CUDA device.  The card tests (``gpu``) hold the kernel's coefficients,
cashflows and exposures bitwise to the torch batches on the card, and the
mixed book's PV to the torch route.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import rng, tracing
from montecarlo_risk_engine_tpu_torch.config import set_real_dtype
from montecarlo_risk_engine_tpu_torch.ops import exercise_scan
from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathMesh, PathSharding

torch.set_num_threads(1)

NUM_PATHS = 200  # not a power of two: the tree sums' padding
EXPOSURES = np.linspace(0.0, 2.5, 6)  # on (t = 0, 1.5) and between the products' dates


def options(americans=12, flexicalls=6):
    """Americans and FlexiCalls of the mixed book (chip_smoke.build_book:
    8-48 dates, maturities 0.75-3, puts and calls; FlexiCalls of 3-5 dates
    and 1-3 rights), every fourth American gated in the money, and three
    Bermudans (a put, a gated call, a call)."""
    return chip_smoke.mixed_exercise_options({"american": americans, "flexicall": flexicalls})


def controller(products=None, exposures=False, num_paths=NUM_PATHS, device="cpu", **kw):
    return mt.SimulationController(
        chip_smoke.two_netting_sets(options() if products is None else products),
        chip_smoke.bs_multi_model(),
        mt.RiskMetrics([mt.PVMetric(), mt.EPEMetric()] if exposures else [mt.PVMetric()],
                       exposure_timeline=EXPOSURES if exposures else None),
        num_paths, num_paths, 1, mt.SimulationScheme.ANALYTICAL, device=device, **kw)


def both_phases(c):
    """The pre- and main-simulation observable tables as a run builds them."""
    c._ensure_plan()
    params = c.model.initial_params(device=c.device, dtype=torch.float64)
    with torch.no_grad():
        _, pre = c._simulate_and_resolve(params, c.num_paths_presim, rng.PHASE_PRESIM)
        _, main = c._simulate_and_resolve(params, c.num_paths_mainsim, rng.PHASE_MAINSIM)
    return pre, main


def torch_batches(c, pre, main):
    """Per product, in the executor's order: (coefficients [E, S, deg],
    cashflows [N], exposures [T_exp, N] or None) of the torch batches."""
    ctx = c._exposure_ctx()
    out = []
    with torch.no_grad():
        for batch in c._book_options.batches:
            batch.fit(pre, ctx)
            cfs, exposures = batch.evaluate(main, ctx)
            for j, product in enumerate(batch.products):
                out.append((batch._coeffs[:, j, :product.get_num_states()], cfs[j],
                            None if exposures is None else exposures[:, j]))
    return out


def kernel_arithmetic(c, pre, main):
    """The plain version (CPU) or the kernel (CUDA) on the route's tables:
    (per-product coefficient views, cashflows [P, N], exposures or None)."""
    book = c._book_options
    tables = book.device_tables()
    coeffs = exercise_scan.exercise_fit(tables, book.observations(pre))
    want = c.risk_metrics.requires_exposure_profiles()
    cfs, exposures = exercise_scan.exercise_value(tables, book.observations(main), coeffs, want)
    return exercise_scan.product_coefficients(tables.packed, coeffs), cfs, exposures


def assert_same(a, b):
    assert a.shape == b.shape and torch.equal(a, b), (a - b).abs().max()


def assert_kernel_is_torch_batches(c, pre, main, exposures):
    ref = torch_batches(c, pre, main)
    views, cfs, exp = kernel_arithmetic(c, pre, main)
    assert len(views) == len(ref) == len(c.products)
    for p, (coeffs_ref, cfs_ref, exp_ref) in enumerate(ref):
        assert_same(views[p], coeffs_ref)
        assert_same(cfs[p], cfs_ref)
        if exposures:
            assert_same(exp[p], exp_ref)
    assert exp is None if not exposures else exp.shape == (len(ref), len(EXPOSURES),
                                                           c.num_paths_mainsim)


def exercise_spans(records):
    return [r for r in records if r.name == "exercise"]


def traced(run):
    tracing.enable()
    try:
        out = run()
        return out, tracing.take()
    finally:
        tracing.disable()


# -- the plain version against the torch batches (CPU) ----------------------------------


@pytest.mark.parametrize("exposures", [False, True], ids=["pv", "exposure_rows"])
def test_plain_version_matches_exercise_batches_bitwise(exposures):
    c = controller(exposures=exposures)
    batches = c._book_options.batches
    assert sorted(len(b.products[0].product_timeline) for b in batches) == [
        3, 3, 4, 5, 8, 12, 18, 24, 36, 48]
    assert {b.is_flexi for b in batches} == {False, True}
    assert {p.itm_only_regression for p in c.products} == {False, True}
    pre, main = both_phases(c)
    assert_kernel_is_torch_batches(c, pre, main, exposures)


def test_packed_tables_follow_the_event_tables():
    """Observation rows, strikes, product dates, exposure slots, states and
    coefficient offsets of the packed tables against each batch's event
    tables."""
    c = controller(exposures=True)
    pre, _ = both_phases(c)
    book = c._book_options
    packed = book.device_tables().packed
    obs = book.observations(pre)
    ctx = c._exposure_ctx()
    p, first = 0, 0
    for batch in book.batches:
        spots, nums, strikes, is_prod, signs, h = batch._event_tables(pre, ctx)
        for j, product in enumerate(batch.products):
            row0, events, states, initial, itm, flexi, coef0 = packed.options[p].tolist()
            assert (events, states, initial, coef0) == (
                spots.shape[0], product.get_num_states(), product.get_initial_state(), first)
            assert (bool(itm), bool(flexi)) == (product.itm_only_regression, batch.is_flexi)
            first += events * states * packed.deg
            rows = packed.rows[row0:row0 + events]
            assert_same(obs[rows[:, exercise_scan.SPOT_ROW]], spots[:, j])
            assert_same(obs[rows[:, exercise_scan.NUM_ROW]], nums[:, j])
            assert list(rows[:, exercise_scan.IS_PROD].astype(bool)) == is_prod[:, j].tolist()
            assert list(packed.strikes[row0:row0 + events]) == strikes[:, j].tolist()
            assert packed.signs[p] == float(signs[j])
            slots = rows[:, exercise_scan.EXP_SLOT]
            assert list(np.flatnonzero(slots >= 0)) == list(h["exp_rows"][:, j])
            assert list(slots[slots >= 0]) == list(range(len(EXPOSURES)))
            p += 1
    assert packed.coef_size == first and p == packed.num_products


# -- the route (CPU, on the plain version) ---------------------------------------------


def run_values(c):
    r = c.run_simulation()
    return np.array([v for ns in r.results for metric in ns for v, _ in metric])


@pytest.mark.parametrize("exposures", [False, True], ids=["pv", "exposure_rows"])
def test_route_glue_on_the_plain_version(monkeypatch, exposures):
    """With the CPU among the kernel's devices the run takes the route: one
    ``exercise`` span per phase with route "kernel" over every product and
    no torch batch's span, the values the torch route's to the last bits of
    the netting's order of addition."""
    ref_c = controller(exposures=exposures)
    ref, ref_spans = traced(lambda: run_values(ref_c))
    assert {s.attrs["route"] for s in exercise_spans(ref_spans)} == {"torch"}
    monkeypatch.setattr(exercise_scan, "_KERNEL_DEVICES", ("cuda", "cpu"))
    c = controller(exposures=exposures)
    exercise_scan.launches.clear()
    values, spans = traced(lambda: run_values(c))
    kernel = exercise_spans(spans)
    products = len(c.products)
    assert [(s.attrs["kind"], s.attrs["route"], s.attrs["phase"], s.attrs["products"])
            for s in kernel] == [("ExerciseEquityBatch", "kernel", "fit", products),
                                 ("ExerciseEquityBatch", "kernel", "value", products)]
    assert kernel[0].attrs["steps"] == 48 + (len(EXPOSURES) if exposures else 0)
    assert not exercise_scan.launches  # the plain version ran
    np.testing.assert_allclose(values, ref, rtol=1e-13, atol=1e-15)


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo process group of one rank, for a sharded run in this process."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


class ShiftedPolynomial(mt.PolynomialRegression):
    """A basis that is not ``PolynomialRegression`` itself: the monomials
    of x - 100."""

    def get_regression_matrix(self, explanatory):
        return super().get_regression_matrix(explanatory - 100.0)


def many_rights_flexicall():
    """A FlexiCall of 17 states (16 rights on 16 dates), past the kernel's
    MAX_STATES."""
    unds = [mt.EuropeanOption(mt.Equity("asset_0"), 0.1 * (k + 1), 95.0, mt.OptionType.CALL,
                              asset_id="asset_0") for k in range(16)]
    return mt.FlexiCall(unds, num_exercise_rights=16, asset_id="asset_0")


@pytest.mark.parametrize("case", ["plain", "reverse", "forward", "sharding", "float32",
                                  "basis", "states", "streaming"])
def test_route_rule(monkeypatch, request, case):
    """With the CPU among the kernel's devices, the run takes the kernel
    ("plain") but keeps the torch batches where a derivative flows (reverse
    and forward mode), under a path sharding, in float32, with another
    basis than ``PolynomialRegression``, with a product of more than
    MAX_STATES states and on the streaming route's emitted rows: only what
    the run observes keeps the kernel out."""
    monkeypatch.setattr(exercise_scan, "_KERNEL_DEVICES", ("cuda", "cpu"))
    products = options(americans=2, flexicalls=3)
    kw = {}
    if case in ("reverse", "forward"):
        kw = {"differentiate": True, "grad_mode": "rev" if case == "reverse" else "fwd"}
    elif case == "sharding":
        request.getfixturevalue("group_of_one")
        kw = {"path_sharding": PathSharding(PathMesh(0, 1, torch.device("cpu")))}
    elif case == "float32":
        set_real_dtype(torch.float32)
        request.addfinalizer(lambda: set_real_dtype(None))
    elif case == "basis":
        kw = {"regression_function": ShiftedPolynomial(2)}
    elif case == "states":
        products.append(many_rights_flexicall())
    elif case == "streaming":
        kw = {"streaming": True, "metric_streaming": False}
    c = controller(products, num_paths=64, **kw)
    _, spans = traced(c.run_simulation)
    if case == "streaming":
        assert c._emission_schedule is not None
    routes = {(s.attrs["kind"] == "ExerciseEquityBatch", s.attrs["route"])
              for s in exercise_spans(spans)}
    assert routes == ({(True, "kernel")} if case == "plain" else {(False, "torch")})


# -- the card ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the exercise scan kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("exposures", [False, True], ids=["pv", "exposure_rows"])
def test_kernel_matches_torch_batches_bitwise(cuda_device, exposures):
    """The mixed book's 1,800 Americans (every fourth gated in the money)
    and 700 FlexiCalls with three Bermudans at 1,000 paths: the kernel's
    coefficients, per-product deflated cashflows and exposures are the
    torch batches' bits on the card (their float operations, cuBLAS's solve
    included), in one launch a phase."""
    c = controller(options(americans=1800, flexicalls=700), exposures=exposures,
                   num_paths=1000, device="cuda")
    pre, main = both_phases(c)
    exercise_scan.launches.clear()
    assert_kernel_is_torch_batches(c, pre, main, exposures)
    assert exercise_scan.launches == {"fit": 1, "value": 1}


@pytest.mark.gpu
def test_mixed_book_pv_kernel_route_equals_torch_route(cuda_device, monkeypatch):
    """The whole 50,000-product mixed book at 1,000 + 1,000 paths: the PV
    on the kernel route (one fit and one value launch a run) against the
    torch route (the kernel's devices emptied) within 1e-15 relative (the
    netting's index_add adds the products in another order)."""
    def pv(kernel):
        c = mt.SimulationController(*chip_smoke.mixed_book_parts(chip_smoke.MIXED_COUNTS),
                                    1000, 1000, 1, mt.SimulationScheme.ANALYTICAL,
                                    device="cuda")
        if not kernel:
            monkeypatch.setattr(exercise_scan, "_KERNEL_DEVICES", ())
        exercise_scan.launches.clear()
        value = float(c.run_simulation().get_results("mixed_book", "pv", evaluation_idx=0))
        assert exercise_scan.launches == ({"fit": 1, "value": 1} if kernel else {})
        return value

    on, off = pv(True), pv(False)
    print(f"[mixed book pv] kernel route {on!r}, torch route {off!r}, "
          f"gap {abs(on - off) / abs(off):.3e}")
    assert abs(on - off) <= 1e-15 * abs(off)
