"""The storage scan kernel (ops/storage_scan.py, csrc/storage_scan.cu) and its
route in the controller.

On the CPU the kernel's plain version stands in for it: on the packed
per-deal tables of the controller's storage executor (``BookDeals``) it is
held bitwise to the controller's bucketed torch scans
(``_fit_exercise_bucket`` / ``_evaluate_exercise_bucket``) for storage deals
of the mixed book's shapes (6-10 grid states, rollouts 0.05 / 0.1 / 0.125,
end dates 1-2.5), with and without exposure rows; the route's glue (tables,
observation rows, coefficients as rows of one buffer, netting) is run on it
by adding the CPU to the kernel's devices (``_KERNEL_DEVICES``, the route's
one test seam) (tests/test_torch_exercise.py
holds that route to the JAX package on its gas books).  The route engages
only where no derivative flows, without a path sharding, on a CUDA device.
The card tests (``gpu``) hold the kernel's Gram and right-hand sides
bitwise to the plain version's, its coefficients, cashflows, exposures and
the mixed book's PV to the torch scan, and its route on the JAX tests' gas
books to the CPU's torch route.  This file imports no JAX.
"""

import numpy as np
import pytest
import torch
from torch.func import jvp

import chip_smoke
import montecarlo_risk_engine_tpu_torch as mt
from gas_books import compare, compare_coeffs, exposure_book, pv_book
from montecarlo_risk_engine_tpu_torch import rng, tracing
from montecarlo_risk_engine_tpu_torch.config import set_real_dtype
from montecarlo_risk_engine_tpu_torch.ops import storage_scan
from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathMesh, PathSharding

torch.set_num_threads(1)

NUM_PATHS = 200  # not a power of two: the tree sums' padding
EXPOSURES = np.linspace(0.0, 2.5, 11)  # dates on and between the deals' own


def storage_deals(count):
    """The first ``count`` storage deals of the mixed book (chip_smoke's
    builder: grid states 6 + i % 5, rollouts 0.05 / 0.1 / 0.125, end dates
    1-2.5, four assets)."""
    counts = {family: 0 for family in chip_smoke.MIXED_COUNTS}
    counts["storage"] = count
    return chip_smoke.build_book(list(chip_smoke.ASSETS), counts)["storage"]


def controller(count=10, exposures=False, num_paths=NUM_PATHS, device="cpu", **kw):
    metrics = ([mt.PVMetric(), mt.EPEMetric()] if exposures else [mt.PVMetric()])
    return mt.SimulationController(
        [mt.NettingSet(name="storage", products=storage_deals(count))],
        chip_smoke.bs_multi_model(),
        mt.RiskMetrics(metrics, exposure_timeline=EXPOSURES if exposures else None),
        num_paths, num_paths, 1, mt.SimulationScheme.ANALYTICAL, device=device, **kw)


def both_phases(c):
    """The pre- and main-simulation requests resolved as a run resolves them."""
    c._ensure_plan()
    params = c.model.initial_params(device=c.device, dtype=torch.float64)
    with torch.no_grad():
        pre, _ = c._simulate_and_resolve(params, c.num_paths_presim, rng.PHASE_PRESIM)
        main, _ = c._simulate_and_resolve(params, c.num_paths_mainsim, rng.PHASE_MAINSIM)
    return pre, main


def torch_scans(c, pre, main):
    """Per deal, in bucket order: (coefficients [E, S, deg], cashflows [N],
    exposures [T_exp, N] or None) of the bucketed torch scans."""
    buckets, _ = c._exercise_scan_groups()
    out = []
    with torch.no_grad():
        for bucket in buckets:
            coeffs = c._fit_exercise_bucket(bucket, pre)
            cfs, exposures = c._evaluate_exercise_bucket(bucket, coeffs, main)
            for i in range(len(bucket)):
                out.append((coeffs[i], cfs[i], None if exposures is None else exposures[i]))
    return [p for b in buckets for p in b], out


def book_deals(c, deals):
    """The controller's storage executor, whose deals are ``deals``."""
    book = c._book_deals
    assert book.products == deals
    return book


def kernel_arithmetic(c, deals, pre, main):
    """The plain version (CPU) or the kernel (CUDA) on the route's tables:
    (per-deal coefficient views, cashflows [D, N], exposures or None)."""
    book = book_deals(c, deals)
    tables = book.device_tables()
    coeffs, _ = storage_scan.storage_fit(tables, book.observations(pre, c.num_paths_presim))
    want = c.risk_metrics.requires_exposure_profiles()
    cfs, exposures = storage_scan.storage_value(
        tables, book.observations(main, c.num_paths_mainsim), coeffs, want)
    return storage_scan.deal_coefficients(tables.packed, coeffs), cfs, exposures


def assert_same(a, b):
    assert a.shape == b.shape and torch.equal(a, b), (a - b).abs().max()


def exercise_spans(records):
    return [r for r in records if r.name == "exercise"]


def traced(run):
    tracing.enable()
    try:
        out = run()
        return out, tracing.take()
    finally:
        tracing.disable()


# -- the plain version against the torch scans (CPU) ----------------------------------


@pytest.mark.parametrize("exposures", [False, True], ids=["pv", "exposure_rows"])
def test_plain_version_matches_bucketed_scan_bitwise(exposures):
    c = controller(exposures=exposures)
    pre, main = both_phases(c)
    deals, ref = torch_scans(c, pre, main)
    assert sorted({p.get_num_states() for p in deals}) == [6, 7, 8, 9, 10]
    assert sorted({p.rollout_interval for p in deals}) == [0.05, 0.1, 0.125]
    views, cfs, exp = kernel_arithmetic(c, deals, pre, main)
    for d, (coeffs_ref, cfs_ref, exp_ref) in enumerate(ref):
        assert_same(views[d], coeffs_ref)
        assert_same(cfs[d], cfs_ref)
        if exposures:
            assert_same(exp[d], exp_ref)
    assert exp is None if not exposures else exp.shape == (10, len(EXPOSURES), NUM_PATHS)


def test_packed_tables_follow_the_event_tables():
    """Rows, exposure slots, states and coefficient offsets of the packed
    tables against the controller's event tables of each deal."""
    c = controller(exposures=True)
    pre, _ = both_phases(c)
    deals = [p for b in c._exercise_scan_groups()[0] for p in b]
    book = book_deals(c, deals)
    packed = book.device_tables().packed
    obs = book.observations(pre, NUM_PATHS)
    first = 0
    for d, product in enumerate(deals):
        tables = c._exercise_event_tables([product], pre, NUM_PATHS)
        row0, events, states, _, _, coef0 = packed.deals[d].tolist()
        assert (events, states, coef0) == (tables["expl"].shape[1], product.get_num_states(),
                                           first)
        first += events * states * packed.deg
        rows = packed.rows[row0:row0 + events]
        assert_same(obs[rows[:, storage_scan.SPOT_ROW]], tables["expl"][0])
        assert_same(obs[rows[:, storage_scan.NUM_ROW]], tables["num"][0])
        slots = rows[:, storage_scan.EXP_SLOT]
        assert list(np.flatnonzero(slots >= 0)) == list(tables["exp_rows"][0])
        assert list(slots[slots >= 0]) == list(range(len(EXPOSURES)))
        assert list(packed.prod_rows[d]) == list(tables["prod_rows"][0])
        is_prod = packed.consts[row0:row0 + events, storage_scan.IS_PROD]
        assert list(is_prod.astype(bool)) == tables["is_prod"][0].tolist()
    assert packed.coef_size == first


# -- the route (CPU, on the plain version) ---------------------------------------------


def run_values(c):
    r = c.run_simulation()
    return np.array([v for ns in r.results for metric in ns for v, _ in metric])


@pytest.mark.parametrize("exposures", [False, True], ids=["pv", "exposure_rows"])
def test_route_glue_on_the_plain_version(monkeypatch, exposures):
    """With the CPU among the kernel's devices the run takes the route: one
    ``exercise`` span per phase with route "kernel" over every deal, each
    deal's ``regression_coeffs`` the torch route's rows, the values the
    torch route's to the last bits of the netting's order of addition."""
    ref_c = controller(exposures=exposures)
    ref, ref_spans = traced(lambda: run_values(ref_c))
    assert {s.attrs["route"] for s in exercise_spans(ref_spans)} == {"torch"}
    monkeypatch.setattr(storage_scan, "_KERNEL_DEVICES", ("cuda", "cpu"))
    c = controller(exposures=exposures)
    values, spans = traced(lambda: run_values(c))
    kernel = exercise_spans(spans)
    assert [(s.attrs["route"], s.attrs["phase"], s.attrs["products"]) for s in kernel] == [
        ("kernel", "fit", 10), ("kernel", "value", 10)]
    assert kernel[0].attrs["steps"] == max(
        len(set(p.product_timeline) | (set(EXPOSURES) if exposures else set()))
        for p in c.products)
    np.testing.assert_allclose(values, ref, rtol=1e-13, atol=1e-15)
    for p, q in zip(c.products, ref_c.products):
        assert_same(p.regression_coeffs, q.regression_coeffs)


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


@pytest.mark.parametrize("case", ["cpu", "reverse", "forward", "sharding"])
def test_torch_scan_where_the_kernel_does_not_engage(monkeypatch, request, case):
    """The torch scans stay the route on the CPU, with gradients on (reverse
    mode), under forward-mode tangents and under a path sharding: the last
    three with the CPU among the kernel's devices, so only what the run
    observes keeps the kernel out."""
    kw = {}
    if case != "cpu":
        monkeypatch.setattr(storage_scan, "_KERNEL_DEVICES", ("cuda", "cpu"))
    if case in ("reverse", "forward"):
        kw = {"differentiate": True, "grad_mode": "rev" if case == "reverse" else "fwd"}
    if case == "sharding":
        request.getfixturevalue("group_of_one")
        kw = {"path_sharding": PathSharding(PathMesh(0, 1, torch.device("cpu")))}
    c = controller(count=3, num_paths=64, **kw)
    _, spans = traced(c.run_simulation)
    routes = [(s.attrs["kind"], s.attrs["route"]) for s in exercise_spans(spans)]
    assert routes and set(routes) == {("Storage", "torch")}


def wrapped_under_jvp():
    out = []
    jvp(lambda x: out.append(x) or x, (torch.ones(3),), (torch.ones(3),))
    return out[0]


@pytest.mark.parametrize("case,engages", [
    ("plain", True), ("cpu", False), ("sharding", False), ("float32", False),
    ("degree_4", False), ("requires_grad", False), ("requires_grad_no_grad_mode", True),
    ("jvp", False),
])
def test_route_rule(case, engages):
    """The route rule of ``BookDeals.route``: ``engages`` on the device,
    sharding, dtype and basis, and no derivative through the deals'
    observations."""
    device = torch.device("cpu" if case == "cpu" else "cuda")
    regression = mt.PolynomialRegression(4 if case == "degree_4" else 2)
    sharding = PathSharding(PathMesh(0, 1, torch.device("cpu"))) if case == "sharding" else None
    x = torch.ones(3, requires_grad=case.startswith("requires_grad"))
    tensors = [torch.ones(3), wrapped_under_jvp() if case == "jvp" else x]
    if case == "float32":
        set_real_dtype(torch.float32)
    try:
        with torch.set_grad_enabled(case != "requires_grad_no_grad_mode"):
            assert (storage_scan.engages(device, regression, sharding)
                    and not storage_scan.gradient_flows(tensors)) is engages
    finally:
        set_real_dtype(None)


# -- the card ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the storage scan kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_normal_equations_match_plain_version_bitwise(cuda_device):
    """At the mixed book's shapes (100 deals, 1,000 paths) the kernel's
    tree-summed Gram and right-hand sides of every row, and its
    coefficients, are the plain version's bits (both on the card)."""
    c = controller(count=100, exposures=True, num_paths=1000, device="cuda")
    pre, _ = both_phases(c)
    deals = [p for b in c._exercise_scan_groups()[0] for p in b]
    book = book_deals(c, deals)
    tables = book.device_tables()
    obs = book.observations(pre, 1000)
    storage_scan.launches.clear()
    coeffs, normal = storage_scan.storage_fit(tables, obs, want_normal=True)
    assert storage_scan.launches == {"fit": 1}
    ref_coeffs, ref_normal = storage_scan.storage_fit_reference(tables, obs, True)
    torch.cuda.synchronize()
    assert_same(normal, ref_normal)
    assert_same(coeffs, ref_coeffs)


@pytest.mark.gpu
@pytest.mark.parametrize("exposures", [False, True], ids=["pv", "exposure_rows"])
def test_kernel_matches_torch_scan(cuda_device, exposures):
    """Coefficients, per-deal deflated cashflows and exposures at the
    realized states of the 100 deals: the bucketed torch scan's bits on the
    card (its float operations, cuBLAS's solve included)."""
    c = controller(count=100, exposures=exposures, num_paths=1000, device="cuda")
    pre, main = both_phases(c)
    deals, ref = torch_scans(c, pre, main)
    storage_scan.launches.clear()
    views, cfs, exp = kernel_arithmetic(c, deals, pre, main)
    assert storage_scan.launches == {"fit": 1, "value": 1}
    for d, (coeffs_ref, cfs_ref, exp_ref) in enumerate(ref):
        assert_same(views[d], coeffs_ref)
        assert_same(cfs[d], cfs_ref)
        if exposures:
            assert_same(exp[d], exp_ref)


@pytest.mark.gpu
def test_mixed_book_pv_kernel_route_equals_torch_route(cuda_device, monkeypatch):
    """The whole 50,000-product mixed book at 1,000 + 1,000 paths: the PV
    on the kernel route against the torch route (the kernel's devices
    emptied) within 1e-13 relative (the netting's index_add adds in the
    card's atomic order)."""
    def pv(kernel):
        c = mt.SimulationController(*chip_smoke.mixed_book_parts(chip_smoke.MIXED_COUNTS),
                                    1000, 1000, 1, mt.SimulationScheme.ANALYTICAL,
                                    device="cuda")
        if not kernel:
            monkeypatch.setattr(storage_scan, "_KERNEL_DEVICES", ())
        storage_scan.launches.clear()
        value = float(c.run_simulation().get_results("mixed_book", "pv", evaluation_idx=0))
        assert storage_scan.launches == ({"fit": 1, "value": 1} if kernel else {})
        return value

    on, off = pv(True), pv(False)
    print(f"[mixed book pv] kernel route {on!r}, torch route {off!r}, "
          f"gap {abs(on - off) / abs(off):.3e}")
    assert abs(on - off) <= 1e-13 * abs(off)


def seeded_normals(phase, sim_dim, num_paths):
    """counter -> (normals [num_paths, sim_dim], None), the same on every
    device: drawn on the CPU from a seed of the phase and counter."""
    def source(counter):
        gen = torch.Generator().manual_seed(1000 * phase + counter)
        return torch.randn((num_paths, sim_dim), generator=gen, dtype=torch.float64), None

    return source


@pytest.mark.gpu
@pytest.mark.parametrize("book", [pv_book, exposure_book], ids=["pv", "exposures"])
def test_kernel_route_on_the_jax_tests_gas_books(cuda_device, book):
    """The gas books that tests/test_torch_exercise.py holds to the JAX
    package (s2f storages with two-point curves, initial amounts 3 and 4;
    with and without exposure rows), at 512 paths and the same normals: the
    card's kernel route (one launch a phase over the storages) against the
    CPU's torch route, at that test's tolerances (values and errors 1e-9
    relative, coefficients 1e-8)."""
    n = 512
    noise = {phase: seeded_normals(phase, 2, n) for phase in (rng.PHASE_PRESIM,
                                                                rng.PHASE_MAINSIM)}

    def run(device):
        c = mt.SimulationController(*book(mt), n, n, 1, mt.SimulationScheme.ANALYTICAL,
                                    device=device, noise_source=noise, batch_products=False)
        storage_scan.launches.clear()
        result, spans = traced(c.run_simulation)
        routes = {s.attrs["route"] for s in exercise_spans(spans) if s.attrs["kind"] == "Storage"}
        return c, result, routes, dict(storage_scan.launches)

    ref_c, ref, ref_routes, _ = run("cpu")
    c, result, routes, launched = run("cuda")
    assert ref_routes == {"torch"} and routes == {"kernel"}
    assert launched == {"fit": 1, "value": 1}
    compare(result, ref, False)
    compare_coeffs(c.products, [p.regression_coeffs.numpy() for p in ref_c.products], 10.0)
