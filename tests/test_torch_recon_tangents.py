"""The forward-mode reconstruction kernel (ops/recon_tangents.py,
csrc/recon_tangents.cu) and its route.

On the CPU the kernel's plain version stands in for it: it is held to
``jvp`` under ``vmap`` of the torch reconstruction (ops/paths_ad.py
``_reconstruct``) for the north-star ModelConfig and each supported block
alone, at c = 1, 3 and 8 tangents, on a timeline with a zero-length point
and three substeps a point, and on paths forced onto CIR++'s 1e-12 floor
(a tie included) and onto y <= 0 under the square root.  The route engages
only where the controller sees forward mode, no Hessian, float64, no
emission schedule, recovered draws and those blocks, and gives the jacobian
of the torch rebuild.  The card tests (``gpu``) hold the kernel to its plain
version bitwise at the north-star shapes and gate its ptxas report.  This
file imports no JAX.
"""

import re

import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import SimulationScheme, tracing
from montecarlo_risk_engine_tpu_torch.api.controller import SimulationController
from montecarlo_risk_engine_tpu_torch.ops import paths_ad
from montecarlo_risk_engine_tpu_torch.ops import recon_tangents as rt
from montecarlo_risk_engine_tpu_torch.ops.sass import ptxas_frames
from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathMesh, PathSharding

torch.set_num_threads(1)

E = SimulationScheme.EULER
CP = "counterparty"
HAZARDS = {1.0: 0.02, 2.0: 0.022, 3.0: 0.025, 5.0: 0.028, 10.0: 0.02}
TIMELINE = (0.25, 0.5, 0.5, 1.1, 2.0, 3.5)  # a zero-length point
NUM_STEPS = 3
NUM_PATHS = 96


def vasicek():
    return mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                           volatility=0.012, asset_id="irs")


def black_scholes():
    return mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq")


def cirpp():
    return mt.CIRPPModel(0.0, asset_id=CP, hazard_rates=HAZARDS, kappa=0.1, theta=0.01,
                         volatility=0.02, y0=0.0001)


def north_star_model():
    return mt.ModelConfig([vasicek(), black_scholes(), cirpp()],
                          inter_asset_correlation_matrix=[np.array([[0.25]]), np.array([[0.4]]),
                                                          np.array([[0.15]])])


MODELS = {"north_star": north_star_model, "vasicek": vasicek, "bs": black_scholes,
          "cirpp": cirpp, "cirpp_in_config": lambda: mt.ModelConfig([cirpp()])}


def draws(model, seed=0, num_paths=NUM_PATHS, timeline=TIMELINE, num_steps=NUM_STEPS):
    dense, _ = paths_ad.dense_timeline(model.calibration_date, timeline, num_steps)
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((len(dense), num_paths, model.simulation_dim), generator=gen,
                       dtype=torch.float64)


def torch_rebuild(model, z, timeline=TIMELINE, num_steps=NUM_STEPS):
    """params -> the coarse plane, by ops/paths_ad.py's torch reconstruction."""
    dense, orig = paths_ad.dense_timeline(model.calibration_date, timeline, num_steps)
    slots = paths_ad._coarse_slots(len(dense), orig)
    return lambda p: paths_ad._reconstruct(model, E, dense, slots, len(orig), z.shape[1], p, z)


def kernel_rebuild(model, z, timeline=TIMELINE, num_steps=NUM_STEPS):
    fn = rt.reconstruction(model, E, timeline, num_steps)
    return lambda p: fn(p, z)


def sweep(fn, params, tangents):
    """(primal, tangents [c, T, N, D]) of ``fn`` for c tangent rows."""
    primal, tan = vmap(lambda t: jvp(fn, (params,), (tuple(t.unbind(0)),)))(tangents)
    return primal[0], tan


def directions(num_params, c, seed=1):
    return torch.randn((c, num_params), generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float64)


def assert_same(actual, expected):
    torch.testing.assert_close(actual, expected, rtol=1e-12,
                               atol=1e-12 * float(expected.nan_to_num().abs().max()),
                               equal_nan=True)


# -- the plain version against the torch rebuild ------------------------------------


@pytest.mark.parametrize("c", [1, 3, 8])
@pytest.mark.parametrize("name", list(MODELS))
def test_plain_version_matches_the_torch_rebuild(name, c):
    model = MODELS[name]()
    params = model.initial_params(dtype=torch.float64)
    z = draws(model)
    tangents = directions(len(params), c)
    primal, tan = sweep(kernel_rebuild(model, z), params, tangents)
    ref_primal, ref_tan = sweep(torch_rebuild(model, z), params, tangents)
    assert tan.shape == (c, len(TIMELINE), NUM_PATHS, model.state_dim)
    assert_same(primal, ref_primal)
    assert_same(tan, ref_tan)


@pytest.mark.parametrize("case", ["floor", "floor_tie", "zero_y", "negative_y"])
def test_plain_version_at_the_floor_and_under_the_root(case):
    """Paths on CIR++'s 1e-12 floor (a tie: y0 = theta = 1e-12 and a zero
    draw give y_next = 1e-12 exactly), and y = 0 or y < 0 under the square
    root, where jvp's tangent is inf or nan: the same values either way."""
    model = north_star_model()
    params = list(model.initial_params(dtype=torch.float64))
    z = draws(model, seed=3)
    if case == "floor":  # a wide volatility floors many paths
        params[9] = torch.tensor(0.5, dtype=torch.float64)
    elif case == "floor_tie":
        params[8] = params[10] = torch.tensor(1e-12, dtype=torch.float64)
        z[:, :5] = 0.0  # no noise on these paths
    else:
        params[10] = torch.tensor(0.0 if case == "zero_y" else -1e-3, dtype=torch.float64)
    params = tuple(params)
    tangents = directions(len(params), 8, seed=4)
    primal, tan = sweep(kernel_rebuild(model, z), params, tangents)
    ref_primal, ref_tan = sweep(torch_rebuild(model, z), params, tangents)
    y = ref_primal[..., 3]
    if case.startswith("floor"):
        assert bool((y == 1e-12).any())
    if case == "floor_tie":
        assert bool((y[:, :5] == 1e-12).all())
    if case == "zero_y":  # the first step's sqrt(0): an infinite or nan tangent
        assert not bool(ref_tan.isfinite().all())
    assert_same(primal, ref_primal)
    assert_same(tan, ref_tan)


def test_tangent_arithmetic_is_autograd_of_the_primal():
    """The written-out tangents against torch.func.jvp through the plain
    version's own primal ops, psi's tangents included; an L that carries a
    tangent is refused, since the kernel carries none."""
    model = north_star_model()
    params = model.initial_params(dtype=torch.float64)
    layout, steps, times = rt.model_plan(model, E, TIMELINE, NUM_STEPS)
    steps, times = torch.from_numpy(steps), torch.tensor(times, dtype=torch.float64)
    z = draws(model, seed=5)
    pvec, chol = torch.stack(params), model.noise_transform(params, E)
    psi_of = lambda p: rt.psi_columns(model, E, tuple(p.unbind(0)), times)
    primal = lambda p: rt.recon_planes_reference(layout, steps, z, p, psi_of(p), chol)
    params_t = directions(len(params), 3, seed=6)
    ref = vmap(lambda pt: jvp(primal, (pvec,), (pt,))[1])(params_t)
    psi_t = vmap(lambda pt: jvp(psi_of, (pvec,), (pt,))[1])(params_t)
    out = rt.recon_planes(layout, steps, z, pvec, psi_of(pvec), chol, params_t, psi_t)
    assert_same(out, ref)
    with_l = lambda p, L: rt._Recon.apply(p, psi_of(p), L, z, steps, layout)
    with pytest.raises(ValueError, match="carry no tangent"):
        jvp(with_l, (pvec, chol), (params_t[0], torch.eye(3, dtype=torch.float64)))


def test_layout_and_refusals():
    model = north_star_model()
    layout, steps, times = rt.model_plan(model, E, TIMELINE, NUM_STEPS)
    assert rt.Layout.of_flat(layout.flat()) == layout
    assert layout.state_dim == 5 and layout.num_coarse == len(TIMELINE)
    assert steps.shape == (len(times), 4) and int(steps[:, 0].sum()) == 5 * NUM_STEPS
    assert list(steps[steps[:, 3] >= 0, 3]) == list(range(len(TIMELINE)))
    assert not rt.supported(mt.ModelConfig([vasicek(), mt.HullWhiteModel(
        0.0, [0.0, 1.0, 3.0], [1.0, 0.97, 0.9], volatility=0.01, mean_reversion=0.4,
        asset_id="hw")]).kernel_blocks())
    assert not rt.supported([vasicek().kernel_block(SimulationScheme.ANALYTICAL)])
    with pytest.raises(ValueError):
        rt.model_plan(mt.ModelConfig([cirpp(), mt.CIRPPModel(
            0.0, "cp2", HAZARDS, 0.1, 0.01, 0.02, 1e-4, deterministic=True)]), E, TIMELINE, 1)
    z = draws(model)
    params = torch.stack(model.initial_params(dtype=torch.float64))
    psi = torch.zeros((1, steps.shape[0]), dtype=torch.float64)
    with pytest.raises(ValueError):  # z of another step count
        rt.recon_planes(layout, torch.from_numpy(steps), z[1:], params, psi, torch.eye(3,
                        dtype=torch.float64))
    with pytest.raises(ValueError):
        rt.recon_planes(layout, torch.from_numpy(steps), z.float(), params, psi,
                        torch.eye(3, dtype=torch.float64))


# -- the route ------------------------------------------------------------------------


def book_parts():
    """One netting set of a swap and a European, CVA and EPE on 13 dates."""
    products = [mt.InterestRateSwap(0.0, 2.0, 1.0, 0.028, 0.5, 0.5, mt.IRSType.PAYER,
                                    asset_id="irs"),
                mt.EuropeanOption(mt.Equity("eq"), 1.5, 100.0, mt.OptionType.CALL,
                                  asset_id="eq")]
    ns = mt.NettingSet(name="ns", products=products, counterparty_id=CP,
                       margin_period_of_risk=10 / 252)
    metrics = mt.RiskMetrics([mt.CVAMetric(CP, 0.4), mt.EPEMetric()],
                             exposure_timeline=np.linspace(0.0, 3.0, 13))
    return [ns], metrics


def book(model=None, num_paths=256, device="cpu", **kw):
    """The book on the north-star model (P = 11 <= V = 14: forward mode)."""
    netting_sets, metrics = book_parts()
    return mt.SimulationController(netting_sets, model or north_star_model(), metrics, num_paths,
                                   num_paths, 1, E, differentiate=True, device=device, **kw)


def hessian_book():
    """A swap's CVA and EPE on Vasicek and CIR++ (P = 8 > V = 6, forward
    mode forced), for a Hessian that stays short."""
    ns = mt.NettingSet(name="ns", products=[mt.InterestRateSwap(
        0.0, 2.0, 1.0, 0.028, 0.5, 0.5, mt.IRSType.PAYER, asset_id="irs")], counterparty_id=CP)
    metrics = mt.RiskMetrics([mt.CVAMetric(CP, 0.4), mt.EPEMetric()],
                             exposure_timeline=np.linspace(0.0, 2.0, 5))
    return mt.SimulationController([ns], mt.ModelConfig([vasicek(), cirpp()]), metrics, 64, 64,
                                   1, E, differentiate=True, grad_mode="fwd", device="cpu")


def heston_book():
    model = mt.HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0,
                           theta=0.06, v0=0.04, asset_id="eq")
    netting_sets = [mt.NettingSet(name=f"call_{t:g}", products=[
        mt.EuropeanOption(mt.Equity("eq"), t, 100.0, mt.OptionType.CALL, asset_id="eq")])
        for t in (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)]
    return mt.SimulationController(netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), 256, 0,
                                   2, SimulationScheme.QE, differentiate=True, device="cpu")


def hull_white_model():
    return mt.ModelConfig([vasicek(), black_scholes(), cirpp(), mt.HullWhiteModel(
        0.0, [0.0, 1.0, 3.0], [1.0, 0.97, 0.9], volatility=0.01, mean_reversion=0.4,
        asset_id="hw")])


ROUTE_CASES = {
    "forward": (lambda: book(), "recon_kernel"),
    "sharded_world_of_one": (lambda: book(path_sharding=PathSharding(
        PathMesh(0, 1, torch.device("cpu")))), "recon_kernel"),  # a gloo group of one
    "reverse": (lambda: book(grad_mode="rev"), "recon"),
    "hessian": (lambda: hessian_book(), "recon"),
    "emission_schedule": (lambda: book(streaming=True), "recon_rows"),
    "emitted_noise": (heston_book, "recon_kernel"),  # ops/qe_tangents.py's kernel, not this one
    "unsupported_block": (lambda: book(model=hull_white_model()), "recon"),
    "float32": (lambda: book(), "recon"),  # set_real_dtype(torch.float32)
}


@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of the kernel's plain version (the CPU's launches), each by
    its tangent count (0: the primal)."""
    calls = []
    real = rt.recon_planes_reference

    def counted(*args, **kw):
        params_t = kw.get("params_t", args[6] if len(args) > 6 else None)
        calls.append(0 if params_t is None else params_t.shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(rt, "recon_planes_reference", counted)
    return calls


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


@pytest.fixture
def float32():
    mt.set_real_dtype(torch.float32)
    try:
        yield
    finally:
        mt.set_real_dtype(None)


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_choice(case, plain_calls, request):
    make, route = ROUTE_CASES[case]
    if case.startswith("sharded"):
        request.getfixturevalue("group_of_one")
    if case == "float32":
        request.getfixturevalue("float32")
    c = make()
    assert c._kernel_active
    if case == "hessian":
        c.compute_higher_derivatives()
    tracing.enable()
    try:
        c.run_simulation()
        spans = tracing.take()
    finally:
        tracing.disable()
    routes = [s.attrs["route"] for s in spans if s.name == "paths"]
    assert routes and set(routes) == {route}
    if route == "recon_kernel" and case != "emitted_noise":
        # two phases x two sweeps (P = 11, 8 tangents a sweep): a primal
        # and a tangent call each, the tangent call for the sweep's c at once
        assert c._grad_mode_resolved == "fwd" and len(routes) == 4
        assert sorted(plain_calls) == [0] * 4 + [3] * 2 + [8] * 2
    else:
        assert plain_calls == []


def values_and_jacobian(results):
    vals, jac = [], []
    for metric in ("cva[counterparty]", "epe"):
        n = 1 if metric.startswith("cva") else 13
        for i in range(n):
            vals.append(results.get_results("ns", metric, evaluation_idx=i))
            jac.append(list(results.get_derivatives("ns", metric, evaluation_idx=i).values()))
    return torch.tensor(vals), torch.tensor(jac)


def test_jacobian_with_the_route_on_and_off(monkeypatch):
    on = values_and_jacobian(book(num_paths=512).run_simulation())
    monkeypatch.setattr(SimulationController, "_recon_kernel", lambda self: None)
    off = values_and_jacobian(book(num_paths=512).run_simulation())
    assert bool(off[1].abs().max() > 0)
    for a, b in zip(on, off):
        assert_same(a, b)


# -- the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the reconstruction kernel has no CPU mode")
    return torch.device("cuda")


NS_PATHS = 1_000_000


def north_star_inputs(device, num_paths, seed=11):
    """The north-star book's plan on its simulation timeline (57 dense
    steps), its parameters, psi and L, and standard normals z."""
    c = mt.SimulationController(
        book_parts()[0], north_star_model(), mt.RiskMetrics(
            [mt.CVAMetric(CP, 0.4), mt.EPEMetric(), mt.PFEMetric(0.95)],
            exposure_timeline=np.linspace(0.0, 7.0, 29)), num_paths, num_paths, 1, E,
        differentiate=True, device=device)
    model, params = c.model, c.model.initial_params(device=device, dtype=torch.float64)
    layout, steps, times = rt.model_plan(model, E, c.simulation_timeline, 1)
    steps = torch.from_numpy(steps).to(device)
    times = torch.tensor(times, dtype=torch.float64, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((steps.shape[0], num_paths, 3), generator=gen, dtype=torch.float64,
                    device=device)
    pvec = torch.stack(params)
    psi_of = lambda p: rt.psi_columns(model, E, tuple(p.unbind(0)), times)
    return layout, steps, z, pvec, psi_of, model.noise_transform(params, E)


@pytest.mark.gpu
def test_kernel_builds_without_spills(cuda_device):
    layout = rt.model_plan(north_star_model(), E, TIMELINE, 1)[0]
    for (_, flags), built in rt.load_builds(layout, [0, 3, 8]).items():
        frames = ptxas_frames(built.log)
        assert sorted(frames) == ["recon_kernel"], flags
        for kernel, frame in frames.items():
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", frame)
            assert m and m.groups() == ("0", "0", "0"), (flags, kernel, frame)


@pytest.mark.gpu
@pytest.mark.parametrize("lo,hi", [(0, 8), (8, 11)])
def test_kernel_matches_plain_version_at_north_star_shapes(cuda_device, lo, hi):
    layout, steps, z, pvec, psi_of, chol = north_star_inputs(cuda_device, NS_PATHS)
    psi = psi_of(pvec)
    assert tuple(z.shape) == (57, NS_PATHS, 3)
    if lo == 0:
        out = rt.recon_planes(layout, steps, z, pvec, psi, chol)
        ref = rt.recon_planes_reference(layout, steps, z, pvec, psi, chol)
        assert out.shape == (57, NS_PATHS, 5) and torch.equal(out, ref)
        del out, ref
    basis = torch.eye(11, dtype=torch.float64, device=cuda_device)[lo:hi]
    psi_t = vmap(lambda t: jvp(psi_of, (pvec,), (t,))[1])(basis)
    rt.recon_planes.launches.clear()
    out = rt.recon_planes(layout, steps, z, pvec, psi, chol, basis, psi_t)
    assert rt.recon_planes.launches == {hi - lo: 1}
    ref = rt.recon_planes_reference(layout, steps, z, pvec, psi, chol, basis, psi_t)
    torch.cuda.synchronize()
    assert out.shape == (hi - lo, 57, NS_PATHS, 5)
    assert torch.equal(out, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 9])
def test_kernel_ragged_and_past_one_launch(cuda_device, c):
    """A launch whose last block is ragged, and more tangents than a launch
    carries (9: launches of 8 and 1)."""
    layout, steps, z, pvec, psi_of, chol = north_star_inputs(cuda_device, 1000, seed=12)
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    params_t = torch.randn((c, 11), generator=gen, dtype=torch.float64, device=cuda_device)
    psi_t = vmap(lambda t: jvp(psi_of, (pvec,), (t,))[1])(params_t)
    args = (layout, steps, z, pvec, psi_of(pvec), chol, params_t, psi_t)
    rt.recon_planes.launches.clear()
    assert torch.equal(rt.recon_planes(*args), rt.recon_planes_reference(*args))
    assert rt.recon_planes.launches == ({1: 1} if c == 1 else {8: 1, 1: 1})


@pytest.mark.gpu
def test_route_on_the_card(cuda_device):
    """The route's launches in a run by tangent count (two phases x two
    sweeps of 8 and 3 tangents, a primal and a tangent launch each) and its
    jacobian against the torch rebuild's."""
    def run(on):
        c = book(num_paths=4096, device="cuda")
        if not on:
            c._recon_kernel = lambda: None
        return values_and_jacobian(c.run_simulation())

    rt.recon_planes.launches.clear()
    on = run(True)
    assert rt.recon_planes.launches == {0: 4, 8: 2, 3: 2}
    off = run(False)
    assert rt.recon_planes.launches == {0: 4, 8: 2, 3: 2}
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12 * float(b.abs().max()))
