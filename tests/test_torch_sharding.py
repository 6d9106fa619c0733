"""Path-axis sharding in the port: ``SimulationController(path_sharding=...)``
on 2 and 4 ranks against the port's own run on one rank.

The ranks are real processes joined by gloo through a ``FileStore``: each
test module's fixture starts ``python tests/test_torch_sharding.py --rank r
--world R --store <file> --out <dir>`` once per R, every rank runs every case
of ``CASES`` on its share of the paths and writes what it returns, and the
tests compare each rank's numbers with the same case run here on one rank:

  * metric values bitwise and standard errors within 1 ulp, the contract of
    the JAX package (metrics/metrics.py:53-76, tests/test_sharding.py:
    112-131): the all-seven-metrics Vasicek x CIR++ swap book on the plane,
    on the streaming engine and through the streaming metric fold, K2's and
    K1's plain versions on the kernel route, the Sobol sampler with its
    bridge and antithetic pairs;
  * jacobians within rtol 1e-8 in both modes (tests/test_sharding.py:49-61)
    and Hessian entries within 1e-7 (tests/test_sharding_hard_paths.py:
    84-116), on the Heston-QE + Bermudan + MPoR CVA book (whose values the
    JAX test holds to 1e-9; here too they are bitwise), the European call,
    K2's recovered noise (kernel-streaming AD too), K1's emitted noise;
  * every rank returns the same numbers, bitwise.

The layout itself (path_shard.shard_paths, the kernels' plain versions at a
path offset and stride, the fixed tree sum of cyclic shards) and the
validation errors are held on one process.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import montecarlo_risk_engine_tpu_torch as mt  # noqa: E402
from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum  # noqa: E402
from montecarlo_risk_engine_tpu_torch.parallel.mesh import PathMesh, PathSharding  # noqa: E402

torch.set_num_threads(1)

CP = "cp"
WORLDS = (1, 2, 4)  # one rank: a sharded run's code against one process's
RANK_TIMEOUT_S = 600


# -- books ------------------------------------------------------------------------


def swap_model(pkg=mt):
    rates = pkg.VasicekModel(0.0, rate=0.03, mean=0.05, mean_reversion_speed=0.1,
                             volatility=0.01, asset_id="irs")
    credit = pkg.CIRPPModel(0.0, asset_id=CP, hazard_rates={1.0: 0.01, 3.0: 0.015, 5.0: 0.02},
                            kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)
    return pkg.ModelConfig([rates, credit], inter_asset_correlation_matrix=[np.array([[0.3]])])


def seven_metrics_book(pv=True, bisect=1024, pkg=mt):
    """tests/test_sharding.py:64-109: a payer swap, every metric; a second
    PFE takes the bisection order statistic.  ``pkg``: the port or the JAX
    package, whose public names are the same."""
    irs = pkg.InterestRateSwap(0.0, 1.0, notional=1.0, fixed_rate=0.03, tenor_fixed=0.5,
                               tenor_float=0.5, irs_type=pkg.IRSType.PAYER, asset_id="irs")
    metrics = ([pkg.PVMetric()] if pv else []) + [
        pkg.CEMetric(), pkg.EPEMetric(), pkg.ENEMetric(), pkg.EEPEMetric(), pkg.PFEMetric(0.95),
        pkg.PFEMetric(0.99, bisect_threshold=bisect),
        pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4)]
    ns = pkg.NettingSet(name="ns", products=[irs], counterparty_id=CP)
    return [ns], swap_model(pkg), pkg.RiskMetrics(metrics,
                                                  exposure_timeline=np.array([0.0, 0.5, 1.0]))


def euro_book(pkg=mt):
    """tests/test_sharding.py:28-45: one Black-Scholes call, PV, EPE, PFE."""
    model = pkg.BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2, asset_id="eq")
    call = pkg.EuropeanOption(pkg.Equity("eq"), 1.0, 100.0, pkg.OptionType.CALL, asset_id="eq")
    metrics = pkg.RiskMetrics([pkg.PVMetric(), pkg.EPEMetric(), pkg.PFEMetric(0.95)],
                              exposure_timeline=np.array([0.0, 0.5, 1.0]))
    return [pkg.NettingSet(name="ns", products=[call])], model, metrics


def hard_book(pkg=mt):
    """tests/test_sharding_hard_paths.py:40-71: Vasicek, Heston (QE) and
    CIR++, a swap and a Bermudan put, MPoR 0.25, CVA, EPE, PFE."""
    rates = pkg.VasicekModel(0.0, rate=0.03, mean=0.04, mean_reversion_speed=0.5,
                             volatility=0.01, asset_id="irs")
    equity = pkg.HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0,
                             theta=0.06, v0=0.04, asset_id="eq")
    credit = pkg.CIRPPModel(0.0, asset_id=CP, hazard_rates={1.0: 0.02, 3.0: 0.025, 5.0: 0.03},
                            kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)
    model = pkg.ModelConfig([rates, equity, credit], inter_asset_correlation_matrix=[
        np.array([[0.3, 0.0]]), np.array([[0.2]]), np.array([[0.4], [0.0]])])
    swap = pkg.InterestRateSwap(0.0, 2.0, notional=1.0, fixed_rate=0.03, tenor_fixed=0.5,
                                tenor_float=0.5, irs_type=pkg.IRSType.PAYER, asset_id="irs")
    bermudan = pkg.BermudanOption(pkg.Equity("eq"), [0.5, 1.0, 1.5], 100.0, pkg.OptionType.PUT,
                                  asset_id="eq")
    ns = pkg.NettingSet(name="book", products=[swap, bermudan], counterparty_id=CP,
                        margin_period_of_risk=0.25)
    metrics = pkg.RiskMetrics([pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4),
                               pkg.EPEMetric(), pkg.PFEMetric(0.95)],
                              exposure_timeline=np.linspace(0.0, 2.0, 5))
    return [ns], model, metrics


def north_star_book():
    """benchmarks/north_star.py:47-96 at two products: a swap and a call on
    Vasicek, Black-Scholes and CIR++, MPoR 10/252, CVA, EPE, PFE."""
    model = mt.ModelConfig(
        [mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012,
                         asset_id="irs"),
         mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq"),
         mt.CIRPPModel(0.0, asset_id=CP, hazard_rates={1.0: 0.02, 3.0: 0.025, 5.0: 0.028},
                       kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001)],
        inter_asset_correlation_matrix=[np.array([[0.25]]), np.array([[0.4]]),
                                        np.array([[0.15]])])
    products = [mt.InterestRateSwap(0.0, 2.0, 1.0, 0.03, 0.5, 0.5, mt.IRSType.PAYER,
                                    asset_id="irs"),
                mt.EuropeanOption(mt.Equity("eq"), 1.5, 100.0, mt.OptionType.CALL,
                                  asset_id="eq")]
    ns = mt.NettingSet(name="ns", products=products, counterparty_id=CP,
                       margin_period_of_risk=10 / 252)
    metrics = mt.RiskMetrics([mt.CVAMetric(CP, 0.4), mt.EPEMetric(), mt.PFEMetric(0.95)],
                             exposure_timeline=np.linspace(0.0, 2.0, 5))
    return [ns], model, metrics


def heston_book():
    """Two Heston-QE calls (chip_smoke.slice_book at two maturities), PV."""
    model = mt.HestonModel(0.0, spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0,
                           theta=0.06, v0=0.04, asset_id="eq")
    sets = [mt.NettingSet(name=f"T{t}", products=[mt.EuropeanOption(
        mt.Equity("eq"), t, 100.0, mt.OptionType.CALL, asset_id="eq")]) for t in (0.5, 1.0)]
    return sets, model, mt.RiskMetrics([mt.PVMetric()])


def bs_multi_book():
    """Two correlated Black-Scholes assets, a call on each, PV."""
    model = mt.BlackScholesMulti(0.0, rate=0.03, asset_ids=["a1", "a2"], spots=[100.0, 90.0],
                                 volatilities=[0.2, 0.3],
                                 correlation_matrix=np.array([[1.0, 0.4], [0.4, 1.0]]))
    calls = [mt.EuropeanOption(mt.Equity(a), 1.0, 95.0, mt.OptionType.CALL, asset_id=a)
             for a in ("a1", "a2")]
    return [mt.NettingSet(name="book", products=calls)], model, mt.RiskMetrics([mt.PVMetric()])


def controller(parts, n, presim, steps, scheme, sharding, **kw):
    return mt.SimulationController(*parts, n, presim, steps, mt.SimulationScheme[scheme],
                                   device="cpu", path_sharding=sharding, **kw)


def flat(results):
    """{values, errors[, jac][, hess]}: every result of a run, flattened."""
    out = {"values": [], "errors": [], "jac": [], "hess": []}
    for i, ns in enumerate(results.results):
        for j, metric in enumerate(ns):
            for k, (value, err) in enumerate(metric):
                out["values"].append(value)
                out["errors"].append(err)
                if len(results.derivatives):
                    out["jac"].append(results.derivatives[i][j][k])
                if len(results.second_derivatives):
                    out["hess"].append(results.second_derivatives[i][j][k])
    return {key: np.asarray(v, dtype=np.float64) for key, v in out.items() if len(v)}


def run_case(name, sharding):
    """One book of ``CASES`` on this process's share of the paths."""
    book, n, presim, steps, scheme, kw, hessian = CASES[name]
    c = controller(book(), n, presim, steps, scheme, sharding, **kw)
    if hessian:
        c.compute_higher_derivatives()
    r = flat(c.run_simulation())
    r["kernel"] = np.asarray([c._kernel_active])
    return r


# name: (book, main paths, presim paths, substeps, scheme, keywords, Hessian)
CASES = {
    "seven_plane": (seven_metrics_book, 4096, 4096, 1, "EULER", dict(streaming=False), False),
    "seven_streaming": (seven_metrics_book, 4096, 4096, 1, "EULER",
                        dict(streaming=True, metric_streaming=False), False),
    "six_metric_fold": (lambda: seven_metrics_book(pv=False), 4096, 4096, 1, "EULER",
                        dict(streaming=True, metric_streaming=True), False),
    "euro_fwd": (euro_book, 4096, 4096, 1, "ANALYTICAL",
                 dict(differentiate=True, grad_mode="fwd"), False),
    "euro_rev": (euro_book, 4096, 4096, 1, "ANALYTICAL",
                 dict(differentiate=True, grad_mode="rev"), False),
    "hard_rev": (hard_book, 512, 512, 1, "QE", dict(differentiate=True), False),
    "hard_fwd": (hard_book, 512, 512, 1, "QE", dict(differentiate=True, grad_mode="fwd"), False),
    "hard_hessian": (hard_book, 256, 256, 1, "QE", dict(differentiate=True), True),
    "k2_forward": (north_star_book, 2048, 2048, 1, "EULER", dict(use_kernel=True), False),
    "k2_fwd": (north_star_book, 1024, 1024, 1, "EULER",
               dict(use_kernel=True, differentiate=True, grad_mode="fwd"), False),
    "k2_rev": (north_star_book, 1024, 1024, 1, "EULER",
               dict(use_kernel=True, differentiate=True, grad_mode="rev"), False),
    "k2_streaming_ad": (north_star_book, 1024, 1024, 1, "EULER",
                        dict(use_kernel=True, differentiate=True, streaming=True), False),
    "k1_differentiated": (heston_book, 2048, 0, 4, "QE",
                          dict(use_kernel=True, differentiate=True), False),
    "sobol_bridge": (heston_book, 2048, 0, 4, "QE",
                     dict(sampler="sobol", qmc_bridge=True), False),
    "antithetic": (bs_multi_book, 4096, 0, 1, "ANALYTICAL",
                   dict(antithetic=True, differentiate=True), False),
}


# -- the ranks --------------------------------------------------------------------


def rank_main(argv):
    """One rank: every case of ``--cases`` on this rank's paths, written to
    ``<out>/<case>.rank<r>.npz``."""
    import torch.distributed as dist

    from montecarlo_risk_engine_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args(argv)
    sharding = distributed.initialize_and_make_sharding(
        args.rank, args.world, store=dist.FileStore(args.store, args.world), device="cpu")
    assert dist.get_backend() == "gloo" and sharding.device == torch.device("cpu")
    try:
        for name in args.cases.split(","):
            np.savez(os.path.join(args.out, f"{name}.rank{args.rank}.npz"),
                     **run_case(name, sharding))
    finally:
        dist.destroy_process_group()


def launch_ranks(world, cases, out_dir, script=__file__, extra=()):
    """Start ``world`` rank processes of ``script`` on ``cases`` (with the
    arguments ``extra``) and wait for all of them; a rank that fails fails
    the caller, and no rank outlives the call."""
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, script, "--rank", str(r), "--world", str(world), "--store", store,
         "--out", out_dir, "--cases", ",".join(cases), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world} failed (exit {p.returncode}):\n{log}"


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"R{w}")
def sharded(request, tmp_path_factory):
    """(world size, {case: [each rank's results]})."""
    world = request.param
    out = str(tmp_path_factory.mktemp(f"ranks{world}"))
    launch_ranks(world, list(CASES), out)
    return world, {name: [dict(np.load(os.path.join(out, f"{name}.rank{r}.npz")))
                          for r in range(world)] for name in CASES}


_single = {}


def single(name):
    """The case on one process, without a sharding (computed once)."""
    if name not in _single:
        _single[name] = run_case(name, None)
    return _single[name]


def assert_within_ulps(a, b, ulps, what):
    a, b = np.asarray(a), np.asarray(b)
    gap = np.abs(a - b)
    allowed = ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(gap <= allowed), f"{what}: {gap.max()} beyond {ulps} ulp"


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_controller_matches_one_rank(sharded, name):
    world, results = sharded
    ranks, one = results[name], single(name)
    for r, res in enumerate(ranks[1:], start=1):  # every rank the same numbers
        for key in res:
            np.testing.assert_array_equal(res[key], ranks[0][key], err_msg=f"rank {r} {key}")
    got = ranks[0]
    assert got.keys() == one.keys()
    assert got["kernel"][0] == one["kernel"][0]
    assert one["kernel"][0] or not name.startswith("k")  # the kernel cases take the kernel
    np.testing.assert_array_equal(got["values"], one["values"], err_msg="values")
    assert_within_ulps(got["errors"], one["errors"], 1, "errors")
    if "jac" in one:
        np.testing.assert_allclose(got["jac"], one["jac"], rtol=1e-8, atol=1e-12, err_msg="jac")
        assert np.abs(one["jac"]).max() > 0.0
    if "hess" in one:
        np.testing.assert_allclose(got["hess"], one["hess"], rtol=1e-7, atol=1e-7, err_msg="hess")
        assert np.isfinite(one["hess"]).all() and np.abs(one["hess"]).max() > 0.0


# -- the layout, on one process -----------------------------------------------------


def fake_sharding(rank, world):
    return PathSharding(PathMesh(rank, world, torch.device("cpu")))


def test_shard_paths_layout():
    """The generic form (cf. tests/test_sharding.py:134-179): rank r's
    output row i is global path r + R i, so the ranks' planes interleave
    into the whole run's."""
    from montecarlo_risk_engine_tpu_torch.ops.path_shard import shard_paths

    def path_fn(params, local, offset, stride):
        return (offset + stride * torch.arange(local, dtype=torch.float64))[None, :, None] + params

    n, world = 48, 4
    whole = shard_paths(path_fn, 0.25, None, n)
    planes = [shard_paths(path_fn, 0.25, fake_sharding(r, world), n) for r in range(world)]
    for r, plane in enumerate(planes):
        assert plane.shape == (1, n // world, 1)
        torch.testing.assert_close(plane, whole[:, r::world], rtol=0, atol=0)


@pytest.mark.parametrize("offset,stride", [(0, 2), (1, 2), (1, 4), (3, 4)])
def test_kernel_plain_versions_at_offset_and_stride(offset, stride):
    """K1's and K2's plain versions at (offset, stride) are the strided
    columns of the whole launch, bitwise (the kernels' own check is the
    smoke's, on the card)."""
    from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths
    from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import hybrid_paths

    n = 512
    heston = mt.params_from_numpy([100.0, 0.5, 0.03, -0.7, 2.0, 0.06, 0.04], dtype=torch.float32)
    timeline = (0.25, 0.5, 1.0)
    for emit in (False, True):
        whole = heston_qe_paths(heston, timeline, n, 1, seed=3, phase=43, emit_noise=emit)
        part = heston_qe_paths(heston, timeline, n // stride, 1, seed=3, phase=43,
                               emit_noise=emit, path_offset=offset, path_stride=stride)
        for w, p in zip(whole if emit else (whole,), part if emit else (part,)):
            torch.testing.assert_close(p, w[:, offset::stride], rtol=0, atol=0)
    model = north_star_book()[1]
    blocks, chol = model.kernel_blocks(), np.linalg.cholesky(model.static_joint_correlation())
    params = model.initial_params(dtype=torch.float32)
    whole = hybrid_paths(blocks, chol, params, timeline, n, 2, seed=3, phase=42)
    part = hybrid_paths(blocks, chol, params, timeline, n // stride, 2, seed=3, phase=42,
                        path_offset=offset, path_stride=stride)
    torch.testing.assert_close(part, whole[:, offset::stride], rtol=0, atol=0)


@pytest.mark.parametrize("n", [1000, 4096])
@pytest.mark.parametrize("world", [2, 4, 8])
def test_tree_sum_of_cyclic_shards_is_the_whole_sum(n, world):
    """Each rank's tree sum of its cyclic share, then the tree sum of the R
    partials, is the unsharded fixed tree sum bitwise (float32 and
    float64); a contiguous split is not held to it."""
    rng = np.random.default_rng(n + world)
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(rng.standard_normal((n, 3)) * 10.0 ** rng.integers(-3, 4, (n, 3)),
                            dtype=dtype)
        partials = torch.stack([fixed_tree_sum(x[r::world]) for r in range(world)])
        rows = partials
        while rows.shape[0] > 1:
            rows = rows[:rows.shape[0] // 2] + rows[rows.shape[0] // 2:]
        torch.testing.assert_close(rows[0], fixed_tree_sum(x), rtol=0, atol=0)


@pytest.mark.parametrize("n", [1000, 4096])
def test_tree_sum_derivatives_are_the_halvings(n):
    """A tree sum recorded for reverse mode (a Function whose backward
    broadcasts the cotangent) has the bits of the plain halvings' gradient
    under ``autograd.grad``, ``vjp`` under ``vmap`` and ``jvp`` of that
    (the controller's reverse mode and Hessian rows), and its value's."""
    from torch.func import jvp, vjp, vmap

    from montecarlo_risk_engine_tpu_torch.metrics import metrics

    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.standard_normal((n, 3)), dtype=torch.float64)
    p = torch.tensor([0.7, 1.3], dtype=torch.float64)
    eye, t = torch.eye(3, dtype=torch.float64), torch.tensor([1.0, 0.5], dtype=torch.float64)

    def book(tree_sum):
        return lambda q: tree_sum(torch.sin(q[0] * x) * q[1] + x * x * q[0], 0)

    def checks(tree_sum):
        q = p.clone().requires_grad_(True)
        value = book(tree_sum)(q)
        jacrev = lambda r: vmap(vjp(book(tree_sum), r)[1])(eye)[0]
        return [value, torch.autograd.grad(value.sum(), q)[0], jacrev(p),
                jvp(jacrev, (p,), (t,))[1]]

    for got, want in zip(checks(metrics._tree_sum), checks(metrics._halvings)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_validation_errors():
    from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths

    book = seven_metrics_book()
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        controller(book, 4098, 4096, 1, "EULER", fake_sharding(0, 4))
    with pytest.raises(ValueError, match="not divisible by 4 devices"):
        controller(book, 4096, 1030, 1, "EULER", fake_sharding(0, 4))
    with pytest.raises(ValueError, match="antithetic"):  # N / 2 = 2050 on 4 ranks
        controller(bs_multi_book(), 4100, 0, 1, "ANALYTICAL", fake_sharding(1, 4),
                   antithetic=True)
    with pytest.raises(ValueError, match="power-of-two"):
        fake_sharding(0, 3)
    with pytest.raises(ValueError, match="path_offset"):
        heston_qe_paths(
            mt.params_from_numpy([100.0, 0.5, 0.03, -0.7, 2.0, 0.06, 0.04]), (1.0,), 4, 1,
            path_offset=2 ** 32 - 2, path_stride=1)
    with pytest.raises(ValueError, match="lives on"):
        mt.SimulationController(*book, 4096, 4096, 1, mt.SimulationScheme.EULER, device="cpu",
                                path_sharding=PathSharding(PathMesh(0, 2, torch.device("cuda"))))


def test_antithetic_ranks_hold_pairs():
    """Under antithetic pairs a rank's base paths are r + R i < N / 2 and its
    mirrors are those + N / 2: its local axis is [base draws, mirrors]."""
    from montecarlo_risk_engine_tpu_torch.engine.engine import simulate_paths

    parts = bs_multi_book()
    model, n, world = parts[1], 64, 4
    params = model.initial_params()
    whole = simulate_paths(model, params, mt.SimulationScheme.ANALYTICAL, (1.0,), n, 1, 43,
                           antithetic=True, device="cpu")
    for r in range(world):
        mine = simulate_paths(model, params, mt.SimulationScheme.ANALYTICAL, (1.0,), n, 1, 43,
                              antithetic=True, device="cpu", path_sharding=fake_sharding(r, world))
        torch.testing.assert_close(mine, whole[:, r::world], rtol=0, atol=0)


if __name__ == "__main__":
    rank_main(sys.argv[1:])
