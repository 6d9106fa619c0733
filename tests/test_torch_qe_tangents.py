"""The forward-mode Heston QE reconstruction kernel (ops/qe_tangents.py,
csrc/qe_tangents.cu) and its route.

On the CPU the kernel's plain version stands in for it: it is held to
``jvp`` under ``vmap`` of the torch reconstruction (ops/paths_ad.py
``_reconstruct`` running ``HestonModel.step_qe`` with the fuzzy branches)
at the Heston surface's model and at a vol-of-vol of 1.0, where psi reaches
sigma^2 / (2 kappa theta) = 4.17, so the exponential branch and both ramps
carry weight, v goes below zero onto the clamp of ``var_int``, and jvp's
tangent of sqrt(b2) at b2 = 0 is nan on some paths; on a timeline with a
zero-length point and four substeps a point.  The route engages only where
the controller sees forward mode, no Hessian, float64, no emission schedule
and draws emitted with the fuzzy branches, and gives the jacobian of the
torch rebuild.  The card tests (``gpu``) hold the kernel to its plain
version at the surface's shapes and gate its ptxas report.  This file
imports no JAX.
"""

import re
from collections import Counter

import pytest
import torch
from torch.func import jvp, vmap

import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import SimulationScheme, tracing
from montecarlo_risk_engine_tpu_torch.api.controller import SimulationController
from montecarlo_risk_engine_tpu_torch.ops import paths_ad
from montecarlo_risk_engine_tpu_torch.ops.cuda_build import ulps_apart
from montecarlo_risk_engine_tpu_torch.ops import qe_tangents as qt
from montecarlo_risk_engine_tpu_torch.ops.sass import ptxas_frames
from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathMesh, PathSharding

torch.set_num_threads(1)

QE = SimulationScheme.QE
TIMELINE = (0.25, 0.5, 0.5, 1.0, 2.0)  # a zero-length point
NUM_STEPS = 4
NUM_PATHS = 400
SURFACE_DATES = tuple(round(0.1 * k, 10) for k in range(1, 11))  # the Heston surface's dates


def heston(sigma=0.5):
    """The Heston surface's model (vol-of-vol 0.5), fuzzy as under AD."""
    model = mt.HestonModel(0.0, spot=100.0, rate=0.03, sigma=sigma, rho=-0.7, kappa=2.0,
                           theta=0.06, v0=0.04, asset_id="eq")
    model.perform_smoothing = True
    return model


def draws(num_dense, num_paths=NUM_PATHS, seed=0, device="cpu"):
    """Float32 normals z [T', N, 2] and uniforms u [T', N] in (0, 1), as the
    path kernel emits them."""
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn((num_dense, num_paths, 2), generator=gen, device=device)
    u = torch.rand((num_dense, num_paths), generator=gen, device=device)
    return z, u


def torch_rebuild(model, z, u, timeline=TIMELINE, num_steps=NUM_STEPS):
    """params -> the coarse plane, by ops/paths_ad.py's torch reconstruction."""
    dense, orig = paths_ad.dense_timeline(model.calibration_date, timeline, num_steps)
    slots = paths_ad._coarse_slots(len(dense), orig)
    return lambda p: paths_ad._reconstruct(model, QE, dense, slots, len(orig), z.shape[1], p,
                                           z, u)


def kernel_rebuild(model, z, u, timeline=TIMELINE, num_steps=NUM_STEPS):
    fn = qt.reconstruction(model, QE, timeline, num_steps, chunk=8)
    return lambda p: fn(p, (z, u))


def sweep(fn, params, tangents):
    """(primal, tangents [c, T, N, 2]) of ``fn`` for c tangent rows."""
    primal, tan = vmap(lambda t: jvp(fn, (params,), (tuple(t.unbind(0)),)))(tangents)
    return primal[0], tan


def directions(c, seed=1):
    return torch.randn((c, 7), generator=torch.Generator().manual_seed(seed), dtype=torch.float64)


def assert_same(actual, expected, rtol=1e-14):
    """Equal to ~1e-14 of the largest finite value, nan where nan."""
    torch.testing.assert_close(actual, expected, rtol=rtol,
                               atol=rtol * float(expected.nan_to_num(0, 0, 0).abs().max()),
                               equal_nan=True)


def num_dense(timeline=TIMELINE, num_steps=NUM_STEPS):
    return len(paths_ad.dense_timeline(0.0, timeline, num_steps)[0])


# -- the plain version against the torch rebuild ------------------------------------


@pytest.mark.parametrize("c", [1, 7, 8])
@pytest.mark.parametrize("sigma", [0.5, 1.0], ids=["surface", "vol_of_vol_1"])
def test_plain_version_matches_the_torch_rebuild(sigma, c):
    model = heston(sigma)
    params = model.initial_params(dtype=torch.float64)
    z, u = draws(num_dense())
    tangents = directions(c)
    primal, tan = sweep(kernel_rebuild(model, z, u), params, tangents)
    ref_primal, ref_tan = sweep(torch_rebuild(model, z, u), params, tangents)
    assert primal.shape == (len(TIMELINE), NUM_PATHS, 2)
    assert tan.shape == (c, len(TIMELINE), NUM_PATHS, 2)
    assert bool(ref_primal.isfinite().all())
    assert_same(primal, ref_primal)
    assert_same(tan, ref_tan)
    finite = ref_tan.isfinite()
    if sigma == 1.0:  # v under zero (var_int's clamp), psi > 2: b2 = 0, a nan tangent
        assert bool((ref_primal[..., 1] < 0).any()) and not bool(finite.all())
    assert bool(finite.any())


def test_every_branch_and_clamp_is_taken_at_a_vol_of_vol_of_one():
    """The plain version's own primal values at a vol-of-vol of 1.0: psi
    below the ramps (< 1), inside them and past the quadratic branch's b2 =
    0 (> 2), and v below zero, where var_int's clamp holds."""
    model = heston(1.0)
    params = model.initial_params(dtype=torch.float64)
    steps, dts, num_coarse = qt.plan(0.0, TIMELINE, NUM_STEPS)
    table, init = qt.columns(model, params, torch.from_numpy(dts))
    z, u = draws(num_dense())
    seen, (ls, v) = Counter(), (init[0].expand(NUM_PATHS), init[1].expand(NUM_PATHS))
    for i, (live, _) in enumerate(steps.tolist()):
        if not live:
            continue
        theta, sigma, kappa = table[i, 9:].unbind(0)
        e, ome, var_const = table[i, :3].unbind(0)
        m = theta + (v - theta) * e
        psi = (v * sigma * sigma * e * ome / kappa + var_const) / (m * m + 1e-12)
        seen["psi<1"] += int((psi < 1.0).sum())
        seen["1<psi<2"] += int(((psi > 1.0) & (psi < 2.0)).sum())
        seen["psi>2"] += int((psi > 2.0).sum())
        seen["v<0"] += int((v < 0).sum())
        ls, v, _, _ = qt._qe_step(ls, v, z[i, :, 0].double(), z[i, :, 1].double(),
                                  u[i].double(), table[i].unbind(0))
    assert all(seen[k] > 0 for k in ("psi<1", "1<psi<2", "psi>2", "v<0")), seen


def test_tangent_arithmetic_is_autograd_of_the_primal():
    """The written-out tangents against torch.func.jvp through the plain
    version's own primal ops and the table's columns; draws that carry a
    tangent are refused."""
    model = heston()
    params = model.initial_params(dtype=torch.float64)
    steps, dts, num_coarse = qt.plan(0.0, TIMELINE, NUM_STEPS)
    steps, dts = torch.from_numpy(steps), torch.from_numpy(dts)
    z, u = draws(num_dense(), seed=5)
    pvec = torch.stack(params)
    cols = lambda p: qt.columns(model, tuple(p.unbind(0)), dts)
    primal = lambda p: qt.qe_planes_reference(steps, z, u, *cols(p), num_coarse)
    params_t = directions(3, seed=6)
    ref = vmap(lambda pt: jvp(primal, (pvec,), (pt,))[1])(params_t)
    table_t, init_t = vmap(lambda pt: jvp(cols, (pvec,), (pt,))[1])(params_t)
    out = qt.qe_planes(steps, z, u, *cols(pvec), num_coarse, table_t, init_t)
    assert_same(out, ref, rtol=1e-12)
    with_z = lambda p, zz: qt._QE.apply(*cols(p), zz, u, steps, num_coarse)
    with pytest.raises(ValueError, match="carry no tangent"):
        jvp(with_z, (pvec, z), (params_t[0], torch.ones_like(z)))


def test_plan_and_refusals():
    steps, dts, num_coarse = qt.plan(0.0, TIMELINE, NUM_STEPS)
    assert num_coarse == len(TIMELINE) and steps.shape == (num_dense(), 2)
    assert int(steps[:, 0].sum()) == 4 * NUM_STEPS and list(steps[steps[:, 1] >= 0, 1]) == [
        0, 1, 2, 3, 4]
    assert float(dts[steps[:, 0] == 0].sum()) == 0.0 and bool((dts[steps[:, 0] == 1] > 0).all())
    model = heston()
    table, init = qt.columns(model, model.initial_params(dtype=torch.float64),
                             torch.from_numpy(dts))
    z, u = draws(num_dense())
    steps = torch.from_numpy(steps)
    with pytest.raises(ValueError):  # float64 draws: the kernel reads K1's float32
        qt.qe_planes(steps, z.double(), u, table, init, num_coarse)
    with pytest.raises(ValueError):  # draws of another step count
        qt.qe_planes(steps, z[1:], u[1:], table, init, num_coarse)
    with pytest.raises(ValueError):  # a tangent table without the initial state's
        qt.qe_planes(steps, z, u, table, init, num_coarse, table[None], None)
    hard = heston()
    hard.perform_smoothing = False
    assert qt.model_supported(heston(), QE) and not qt.model_supported(hard, QE)
    corrected = mt.HestonModel(0.0, 100.0, 0.03, 0.5, -0.7, 2.0, 0.06, 0.04, asset_id="eq",
                               martingale_correction=True)
    corrected.perform_smoothing = True
    assert not qt.model_supported(corrected, QE)
    assert not qt.model_supported(mt.BlackScholesModel(0.0, 100.0, 0.03, 0.2),
                                  SimulationScheme.EULER)
    with pytest.raises(ValueError):
        qt.reconstruction(hard, QE, TIMELINE, NUM_STEPS, chunk=8)


# -- the route ------------------------------------------------------------------------


EXPIRIES = (0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)


def heston_book(num_paths=256, device="cpu", sigma=0.5, **kw):
    """Eight calls, each its own netting set: P = 7 <= V = 8, forward mode."""
    model = mt.HestonModel(0.0, spot=100.0, rate=0.03, sigma=sigma, rho=-0.7, kappa=2.0,
                           theta=0.06, v0=0.04, asset_id="eq")
    netting_sets = [mt.NettingSet(name=f"call_{t:g}", products=[
        mt.EuropeanOption(mt.Equity("eq"), t, 100.0, mt.OptionType.CALL, asset_id="eq")])
        for t in EXPIRIES]
    return mt.SimulationController(netting_sets, model, mt.RiskMetrics([mt.PVMetric()]),
                                   num_paths, 0, 2, QE, differentiate=True, device=device, **kw)


def values_and_jacobian(results):
    vals, jac = [], []
    for t in EXPIRIES:
        vals.append(results.get_results(f"call_{t:g}", "pv", evaluation_idx=0))
        jac.append(list(results.get_derivatives(f"call_{t:g}", "pv", evaluation_idx=0).values()))
    return torch.tensor(vals), torch.tensor(jac)


ROUTE_CASES = {
    "forward": (lambda: heston_book(), "recon_kernel"),
    "sharded_world_of_one": (lambda: heston_book(path_sharding=PathSharding(
        PathMesh(0, 1, torch.device("cpu")))), "recon_kernel"),  # a gloo group of one
    "two_sweeps": (lambda: heston_book(grad_chunk_size=4), "recon_kernel"),
    "reverse": (lambda: heston_book(grad_mode="rev"), "recon"),
    "hessian": (lambda: heston_book(num_paths=64), "recon"),  # compute_higher_derivatives
    "emission_schedule": (lambda: heston_book(streaming=True), "recon_rows"),
    "float32": (lambda: heston_book(), "recon"),  # set_real_dtype(torch.float32)
}
# The plain version's calls a run, by tangent count (0: the primal): a
# primal and a tangent call a sweep.
ROUTE_CALLS = {"forward": [0, 7], "sharded_world_of_one": [0, 7], "two_sweeps": [0, 0, 3, 4]}


@pytest.fixture
def plain_calls(monkeypatch):
    """Calls of the kernel's plain version (the CPU's launches), each by
    its tangent count (0: the primal)."""
    calls = []
    real = qt.qe_planes_reference

    def counted(*args):
        calls.append(0 if args[6] is None else args[6].shape[0])
        return real(*args)

    monkeypatch.setattr(qt, "qe_planes_reference", counted)
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
    assert c._recon_kernel() is (qt if route == "recon_kernel" else None)
    assert sorted(plain_calls) == ROUTE_CALLS.get(case, [])


@pytest.mark.parametrize("sigma", [0.5, 1.0], ids=["surface", "vol_of_vol_1"])
def test_jacobian_with_the_route_on_and_off(monkeypatch, sigma):
    on = values_and_jacobian(heston_book(num_paths=512, sigma=sigma).run_simulation())
    monkeypatch.setattr(SimulationController, "_recon_kernel", lambda self: None)
    off = values_and_jacobian(heston_book(num_paths=512, sigma=sigma).run_simulation())
    assert bool(off[1].nan_to_num().abs().max() > 0) or sigma == 1.0
    for a, b in zip(on, off):
        assert_same(a, b, rtol=1e-13)


# -- the card -------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the reconstruction kernel has no CPU mode")
    return torch.device("cuda")


SURFACE_PATHS = 1 << 20


def surface_inputs(device, num_paths, c, seed=11, sigma=0.5):
    """The Heston surface's plan (10 dates x 4 substeps: 40 dense steps),
    its table and initial state with c tangents (the unit directions, then
    random ones), and float32 draws."""
    model = heston(sigma)
    params = model.initial_params(device=device, dtype=torch.float64)
    steps, dts, num_coarse = qt.plan(0.0, SURFACE_DATES, 4)
    steps, dts = torch.from_numpy(steps).to(device), torch.from_numpy(dts).to(device)
    pvec = torch.stack(params)
    cols = lambda p: qt.columns(model, tuple(p.unbind(0)), dts)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    basis = torch.cat([torch.eye(7, dtype=torch.float64),
                       torch.randn((max(c - 7, 0), 7), generator=gen, dtype=torch.float64)])
    table_t, init_t = vmap(lambda t: jvp(cols, (pvec,), (t,))[1])(basis[:c].to(device))
    z, u = draws(steps.shape[0], num_paths, seed, device)
    return (steps, z, u, *cols(pvec), num_coarse), table_t, init_t


@pytest.mark.gpu
def test_kernel_builds_without_spills(cuda_device):
    """No build spills; a build may keep a small stack frame (8 bytes where
    a thread carries one tangent), which is no spill."""
    for (_, flags), built in qt.load_builds(range(qt.MAX_TANGENTS + 1)).items():
        frames = ptxas_frames(built.log)
        assert sorted(frames) == ["qe_tangents_kernel"], flags
        for kernel, frame in frames.items():
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", frame)
            assert m and int(m.group(1)) <= 16 and m.groups()[1:] == ("0", "0"), (flags, frame)


@pytest.mark.gpu
def test_kernel_matches_plain_version_at_surface_shapes(cuda_device):
    args, table_t, init_t = surface_inputs(cuda_device, SURFACE_PATHS, 7)
    assert tuple(args[1].shape) == (40, SURFACE_PATHS, 2)
    qt.qe_planes.launches.clear()
    out = qt.qe_planes(*args)
    ref = qt.qe_planes_reference(*args)
    assert out.shape == (10, SURFACE_PATHS, 2) and ulps_apart(out, ref) <= 2
    del out, ref
    out = qt.qe_planes(*args, table_t, init_t)
    ref = qt.qe_planes_reference(*args, table_t, init_t)
    torch.cuda.synchronize()
    assert qt.qe_planes.launches == {0: 1, 7: 1}
    assert out.shape == (7, 10, SURFACE_PATHS, 2) and ulps_apart(out, ref) <= 2


@pytest.mark.gpu
@pytest.mark.parametrize("c", list(range(1, qt.MAX_TANGENTS + 2)))
def test_kernel_ragged_and_every_tangent_count(cuda_device, c):
    """A launch whose last block is ragged, at a vol-of-vol of 1.0 (both
    branches, nan tangents), for 1-8 tangents and 9 (launches of 8 and 1)."""
    args, table_t, init_t = surface_inputs(cuda_device, 1000, c, seed=12, sigma=1.0)
    qt.qe_planes.launches.clear()
    out = qt.qe_planes(*args, table_t, init_t)
    assert ulps_apart(out, qt.qe_planes_reference(*args, table_t, init_t)) <= 2
    assert qt.qe_planes.launches == ({c: 1} if c <= 8 else {8: 1, 1: 1})
    assert ulps_apart(qt.qe_planes(*args), qt.qe_planes_reference(*args)) <= 2


@pytest.mark.gpu
def test_route_on_the_card(cuda_device):
    """The route's launches in a run (one sweep of 7 tangents: a primal and
    a 7-tangent launch) and its jacobian against the torch rebuild's."""
    def run(on):
        c = heston_book(num_paths=4096, device="cuda")
        if not on:
            c._recon_kernel = lambda: None
        return values_and_jacobian(c.run_simulation())

    qt.qe_planes.launches.clear()
    on = run(True)
    assert qt.qe_planes.launches == {0: 1, 7: 1}
    off = run(False)
    assert qt.qe_planes.launches == {0: 1, 7: 1}
    for a, b in zip(on, off):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12 * float(b.abs().max()))
