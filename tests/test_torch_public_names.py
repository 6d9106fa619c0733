"""The public names the port took last from the JAX package, against their
JAX counterparts on the same seeded inputs: ``ops.quantile.quantile_bisect``
(tests/test_quantile.py's cases), ``utils.maths.sigmoid_smoothing``,
``CIRPPModel.lambda_t`` and ``credit_spread``,
``VasicekModel.compute_bond_price`` (all at 1e-12),
``SimulationController.run_simulation(profile_dir=)`` (a torch.profiler
trace, values unchanged bit for bit) and ``parallel.distributed.initialize()``
with no rank (the launcher's environment, as torchrun sets it; a world of one
without it)."""

import glob
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu as mj
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu.ops import quantile as jax_quantile
from montecarlo_risk_engine_tpu.utils import maths as jax_maths
from montecarlo_risk_engine_tpu_torch.ops import quantile as port_quantile
from montecarlo_risk_engine_tpu_torch.parallel.distributed import LAUNCHER_VARIABLES as LAUNCHER
from montecarlo_risk_engine_tpu_torch.utils import maths as port_maths

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
HAZARDS = {1.0: 0.02, 2.0: 0.022, 3.0: 0.025, 5.0: 0.028, 10.0: 0.02}


def to_port(params):
    return tuple(torch.tensor(float(p), dtype=torch.float64) for p in params)


@pytest.mark.parametrize("n", [10, 1000, 4096])
@pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
def test_quantile_bisect_matches_jax(n, q):
    values = np.random.default_rng(0).standard_normal(n)
    got = port_quantile.quantile_bisect(torch.from_numpy(values), q)
    assert float(got) == float(jax_quantile.quantile_bisect(jnp.asarray(values), q))
    assert float(got) == float(port_quantile.quantile_order_statistic(torch.from_numpy(values), q))


def test_quantile_bisect_with_ties_matches_jax():
    values = np.maximum(np.random.default_rng(1).standard_normal(2000), 0.0)
    for q in (0.2, 0.5, 0.95):
        assert float(port_quantile.quantile_bisect(torch.from_numpy(values), q)) == float(
            jax_quantile.quantile_bisect(jnp.asarray(values), q))
    for vals in ([5.0] * 8, [100.0] * 6 + [100.5, 101.0]):
        assert float(port_quantile.quantile_bisect(torch.tensor(vals, dtype=torch.float64), 0.5)) \
            == float(jax_quantile.quantile_bisect(jnp.asarray(vals), 0.5))


def test_sigmoid_smoothing_matches_jax():
    x = np.random.default_rng(2).standard_normal(1000) * 0.02
    for beta in (500.0, 50.0, 1.0):
        np.testing.assert_allclose(port_maths.sigmoid_smoothing(torch.from_numpy(x), beta).numpy(),
                                   np.asarray(jax_maths.sigmoid_smoothing(jnp.asarray(x), beta)),
                                   rtol=1e-12, atol=1e-300)
    assert port_maths.sigmoid_smoothing(0.0).dtype == torch.float64
    assert float(port_maths.sigmoid_smoothing(0.0)) == float(jax_maths.sigmoid_smoothing(0.0))


@pytest.mark.parametrize("deterministic", [False, True])
def test_cirpp_lambda_t_and_credit_spread_match_jax(deterministic):
    kw = dict(asset_id="cp", hazard_rates=HAZARDS, kappa=0.4, theta=0.02, volatility=0.06,
              y0=0.015, deterministic=deterministic)
    jm, pm = mj.CIRPPModel(0.0, **kw), mt.CIRPPModel(0.0, **kw)
    jp = jm.initial_params()
    pp = to_port(jp)
    rs = np.random.default_rng(3)
    y = 0.015 + 0.01 * rs.random(257)
    for t in (0.0, 0.3, 1.0, 2.5, 7.0, 12.0):
        np.testing.assert_allclose(pm.lambda_t(pp, t, torch.from_numpy(y)).numpy(),
                                   np.asarray(jm.lambda_t(jp, t, jnp.asarray(y))), rtol=1e-12)
        for T, delta in ((t + 0.5, 0.4), (t + 3.0, 0.4), (t + 1.0, 0.0), (t, 0.4)):
            np.testing.assert_allclose(
                pm.credit_spread(pp, t, T, torch.from_numpy(y), delta).numpy(),
                np.asarray(jm.credit_spread(jp, t, T, jnp.asarray(y), delta)),
                rtol=1e-12, atol=1e-15, err_msg=f"t={t} T={T} delta={delta}")
    # a tensor of times, elementwise (the JAX form traces t)
    times = np.array([0.1, 1.0, 1.5, 4.0, 11.0])
    np.testing.assert_allclose(pm.lambda_t(pp, torch.from_numpy(times), torch.from_numpy(y[:5]))
                               .numpy(),
                               np.asarray(jm.lambda_t(jp, jnp.asarray(times), jnp.asarray(y[:5]))),
                               rtol=1e-12)


def test_vasicek_compute_bond_price_matches_jax():
    kw = dict(rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012, asset_id="irs")
    jm, pm = mj.VasicekModel(0.0, **kw), mt.VasicekModel(0.0, **kw)
    jp = jm.initial_params()
    pp = to_port(jp)
    r = 0.03 + 0.01 * np.random.default_rng(4).standard_normal(300)
    for t1, t2 in ((0.0, 1.0), (0.5, 5.0), (2.0, 2.25), (1.0, 1.0)):
        got = pm.compute_bond_price(pp, t1, t2, torch.from_numpy(r))
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jm.compute_bond_price(jp, t1, t2, jnp.asarray(r))),
                                   rtol=1e-12)
        assert torch.equal(got, pm.bond_price(pp, t1, t2, torch.from_numpy(r)))


def test_run_simulation_profile_dir_writes_a_trace_and_changes_nothing(tmp_path):
    def make():
        model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
        option = mt.EuropeanOption(mt.Equity("eq"), 1.0, 100.0, mt.OptionType.CALL,
                                   asset_id="eq")
        return mt.SimulationController(
            [mt.NettingSet(name="opt", products=[option])], model,
            mt.RiskMetrics([mt.PVMetric(), mt.EPEMetric()], exposure_timeline=[0.0, 0.5]),
            1024, 1024, 1, mt.SimulationScheme.ANALYTICAL, differentiate=True, device="cpu")

    plain = make().run_simulation()
    traced = make().run_simulation(profile_dir=str(tmp_path / "trace"))
    files = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    # the run's spans are on for that run, each a range of its name
    names = {e.get("name") for e in events}
    assert {"run", "value"} <= names
    from montecarlo_risk_engine_tpu_torch import tracing
    assert not tracing.enabled()
    for metric in ("pv", "epe"):
        assert np.array_equal(traced.get_results("opt", metric), plain.get_results("opt", metric))
        assert np.array_equal(traced.get_mc_error("opt", metric),
                              plain.get_mc_error("opt", metric))
        assert np.array_equal(np.asarray(traced.get_derivatives("opt", metric)),
                              np.asarray(plain.get_derivatives("opt", metric)))


# -- initialize() with no rank: torchrun's environment -------------------------


RANK_CODE = """
import json, numpy as np, torch, torch.distributed as dist
import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch.parallel import distributed

torch.set_num_threads(1)
sharding = distributed.initialize_and_make_sharding(device="cpu")

def pv(path_sharding):
    model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    option = mt.EuropeanOption(mt.Equity("eq"), 1.0, 100.0, mt.OptionType.CALL, asset_id="eq")
    c = mt.SimulationController([mt.NettingSet(name="opt", products=[option])], model,
                                mt.RiskMetrics([mt.PVMetric()]), 1024, 0, 1,
                                mt.SimulationScheme.ANALYTICAL, device="cpu",
                                path_sharding=path_sharding)
    r = c.run_simulation()
    return [float(r.get_results("opt", "pv", evaluation_idx=0)),
            float(r.get_mc_error("opt", "pv", evaluation_idx=0))]

try:
    x = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(x)
    print(json.dumps({"backend": dist.get_backend(), "rank": dist.get_rank(),
                      "world": dist.get_world_size(), "local": sharding.rank,
                      "sum": x.item(), "sharded": pv(sharding), "one": pv(None)}))
finally:
    dist.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_reads_the_launcher_environment():
    """Two gloo ranks started as torchrun starts them: every rank finds its
    rank, the world size and the address in its environment, and the
    sharded run gives one process's bits."""
    world, port = 2, free_port()
    base = {k: v for k, v in os.environ.items() if k not in LAUNCHER}
    base.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, "-c", RANK_CODE], cwd=REPO,
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
        got = json.loads(out.strip().splitlines()[-1])
        assert (got["backend"], got["rank"], got["world"], got["local"], got["sum"]) == \
            ("gloo", r, world, r, 3.0)
        assert got["sharded"] == got["one"]


def test_initialize_without_a_launcher_is_a_world_of_one(monkeypatch):
    import torch.distributed as dist

    from montecarlo_risk_engine_tpu_torch.parallel import distributed

    for name in LAUNCHER:
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize(device="cpu") is None
    assert distributed.initialize_and_make_sharding(device="cpu") is None
    assert not dist.is_initialized()
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        distributed.initialize(device="cpu")
    with pytest.raises(ValueError, match="world size"):
        distributed.initialize(0, device="cpu")
