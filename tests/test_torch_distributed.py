"""The port's collectives under every transform, and its sharded controller
against the JAX package's, on real gloo ranks.

Ranks are started as ``python tests/test_torch_distributed.py --rank r
--world R --store <file> --out <dir> --cases ...`` (test_torch_sharding.
launch_ranks), each with one thread and a ``FileStore``.

  * ``parallel/collectives.py`` on two ranks: ``torch.autograd.grad``,
    ``torch.func.jvp`` and jvp of jvp, ``vmap`` over a tangent batch, ``vjp``
    under ``jvp`` (the reverse branch of the Hessian rows), integer counts and
    extrema, a sum of signed zeros, each equal to the same reduction on one
    process;
  * the all-seven-metrics swap book (forward), the European Black-Scholes
    book (differentiated, both jacobian modes) and the Heston-QE + Bermudan
    + MPoR CVA book (differentiated) on 2 and 4 ranks, fed the JAX
    engine's threefry draws sliced at each rank's global path indices through
    ``noise_source``, against JAX's ``SimulationController(path_sharding=
    NamedSharding(...))`` on the 8-device CPU mesh of tests/conftest.py:
    values 1e-10, jacobians 1e-8 (the port's JAX-parity tolerances).
"""

import argparse
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_sharding as ts  # noqa: E402
from montecarlo_risk_engine_tpu_torch.parallel import collectives  # noqa: E402

torch.set_num_threads(1)

PHASES = (42, 43)


# -- collectives under transforms ----------------------------------------------------


def _book_fn(p, x, sharding):
    """A replicated fit from every rank's paths feeds every rank's paths again
    (the shape of an LSM fit), then a second reduction: [2] values."""
    from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum

    a, b = p
    fit = fixed_tree_sum(torch.sin(a * x) * b, sharding=sharding)
    second = fixed_tree_sum(torch.cos(fit * a * x) + b * b * x, sharding=sharding)
    return torch.stack([second, fit * b])


def _order_fn(p, x, sharding):
    """Integer counts and extrema across the ranks, and the selection's
    derivative."""
    a, b = p
    v = a * x
    count = collectives.rank_sum((v.detach() <= 0.1).sum(), sharding)
    low = collectives.rank_min(v.amin(), sharding)
    high = collectives.rank_max(v.amax(), sharding)
    return torch.stack([low * b, high * b, count.to(v.dtype) * b])


def _checks(sharding, x_all):
    """{check: (sharded result, one-process result)} for every transform."""
    from torch.func import jvp, vjp, vmap

    from montecarlo_risk_engine_tpu_torch.metrics.metrics import fixed_tree_sum

    world = 1 if sharding is None else sharding.world_size
    mine = x_all[(0 if sharding is None else sharding.rank)::world]
    p = (torch.tensor(0.7, dtype=torch.float64), torch.tensor(1.3, dtype=torch.float64))
    t = (torch.tensor(1.0, dtype=torch.float64), torch.tensor(0.5, dtype=torch.float64))
    eye = torch.eye(2, dtype=torch.float64)

    def both(check):
        return (check(lambda q: _book_fn(q, mine, sharding), sharding),
                check(lambda q: _book_fn(q, x_all, None), None))

    def grad(fn, sh):
        q = tuple(v.clone().requires_grad_(True) for v in p)
        out = fn(q)
        seed = torch.ones_like(out) if sh is None or sh.rank == 0 else torch.zeros_like(out)
        return collectives.sum_over_ranks(torch.stack(torch.autograd.grad(out, q, seed)), sh)

    def jacrev(fn, sh, at):
        _, vjp_fn = vjp(fn, at)
        cot = eye if sh is None or sh.rank == 0 else torch.zeros_like(eye)
        (g,) = vmap(vjp_fn)(cot)
        return collectives.sum_over_ranks(torch.stack(g), sh)

    out = {
        "value": both(lambda fn, sh: fn(p)),
        "autograd.grad": both(grad),
        "jvp": both(lambda fn, sh: jvp(fn, (p,), (t,))[1]),
        "jvp of jvp": both(lambda fn, sh: jvp(lambda q: jvp(fn, (q,), (t,))[1], (p,), (t,))[1]),
        "vmap of jvp": both(lambda fn, sh: vmap(
            lambda u, v: jvp(fn, (p,), ((u, v),))[1])(eye[0], eye[1])),
        "vjp under vmap": both(lambda fn, sh: jacrev(fn, sh, p)),
        "jvp of vjp": both(lambda fn, sh: jvp(lambda q: jacrev(fn, sh, q), (p,), (t,))[1]),
    }
    # a sum of -0.0s is -0.0 on one process; the gathered partials keep it
    zeros_all = torch.full((8,), -0.0, dtype=torch.float64)
    zeros = zeros_all[(0 if sharding is None else sharding.rank)::world]
    out["signed zeros"] = (
        torch.signbit(fixed_tree_sum(zeros, sharding=sharding)).to(torch.float64),
        torch.signbit(fixed_tree_sum(zeros_all)).to(torch.float64))
    out["counts and extrema"] = (
        vmap(lambda u, v: jvp(lambda q: _order_fn(q, mine, sharding), (p,), ((u, v),)))(
            eye[0], eye[1]),
        vmap(lambda u, v: jvp(lambda q: _order_fn(q, x_all, None), (p,), ((u, v),)))(
            eye[0], eye[1]))
    return out


def collectives_case(sharding):
    x_all = torch.as_tensor(np.random.default_rng(7).standard_normal(1000), dtype=torch.float64)
    res = {}
    for name, (got, want) in _checks(sharding, x_all).items():
        got, want = (torch.stack(v) if isinstance(v, tuple) else v for v in (got, want))
        res[name] = np.stack([got.detach().numpy(), want.detach().numpy()])
    return res


def test_collectives_under_every_transform(tmp_path):
    ts.launch_ranks(2, ["collectives"], str(tmp_path), script=__file__)
    for r in range(2):
        res = np.load(os.path.join(tmp_path, f"collectives.rank{r}.npz"))
        assert sorted(res.files) == sorted([
            "value", "autograd.grad", "jvp", "jvp of jvp", "vmap of jvp", "vjp under vmap",
            "jvp of vjp", "signed zeros", "counts and extrema"])
        for name in res.files:
            got, want = res[name]
            if name in ("value", "jvp", "jvp of jvp", "vmap of jvp", "signed zeros",
                        "counts and extrema"):
                np.testing.assert_array_equal(got, want, err_msg=f"rank {r} {name}")
            else:  # the ranks' gradient shares add in another order than one backward
                np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14,
                                           err_msg=f"rank {r} {name}")
            assert np.isfinite(want).all() and np.abs(want).max() > 0.0, name


def test_initialize_picks_the_backend_from_its_arguments(tmp_path):
    """gloo for CPU ranks and ranks that share a card, NCCL for ranks on
    cards of their own; an initialised group is kept for its own rank and
    world size and refused for others; the mesh is the group's."""
    import torch.distributed as dist

    from montecarlo_risk_engine_tpu_torch.parallel import distributed, mesh

    assert distributed.backend_for(torch.device("cpu"), False) == "gloo"
    assert distributed.backend_for(torch.device("cuda", 0), True) == "gloo"
    assert distributed.backend_for(torch.device("cuda", 0), False) == "nccl"
    with pytest.raises(RuntimeError, match="not initialised"):
        mesh.make_path_mesh(device="cpu")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    with pytest.raises(ValueError, match="exactly one"):
        distributed.initialize(0, 1, device="cpu")
    try:
        sharding = distributed.initialize_and_make_sharding(0, 1, store=store, device="cpu")
        assert (sharding.rank, sharding.world_size, sharding.device) == (0, 1, torch.device("cpu"))
        assert distributed.initialize(0, 1, store=store, device="cpu") == "gloo"
        with pytest.raises(RuntimeError, match="already initialised"):
            distributed.initialize(1, 2, store=store, device="cpu")
        x = torch.arange(6.0).reshape(2, 3)
        torch.testing.assert_close(collectives.gather(x, sharding), x[None], rtol=0, atol=0)
        torch.testing.assert_close(sharding.global_indices(8), torch.arange(8))
    finally:
        dist.destroy_process_group()


# -- against the JAX package's sharded controller --------------------------------------

# name: (book of test_torch_sharding, paths (main and presim), scheme, noise
# dimension, the scheme draws a uniform, controller keywords)
JAX_CASES = {
    "jax_seven": ("seven_metrics_book", 2048, "EULER", 2, False, dict()),
    "jax_euro_fwd": ("euro_book", 2048, "ANALYTICAL", 1, False,
                     dict(differentiate=True, grad_mode="fwd")),
    "jax_euro_rev": ("euro_book", 2048, "ANALYTICAL", 1, False,
                     dict(differentiate=True, grad_mode="rev")),
    "jax_hard": ("hard_book", 512, "QE", 4, True, dict(differentiate=True)),
}


def port_jax_case(name, sharding, draws):
    """A JAX_CASES book on this rank, its draws sliced at its global paths."""
    book, n, scheme, _, uniform, kw = JAX_CASES[name]
    world = 1 if sharding is None else sharding.world_size
    rank = 0 if sharding is None else sharding.rank
    mine = lambda key: torch.from_numpy(np.ascontiguousarray(draws[key][:, rank::world]))
    noise = {}
    for phase in PHASES:
        z, u = mine(f"{name}.{phase}.z"), mine(f"{name}.{phase}.u") if uniform else None
        noise[phase] = (lambda z, u: lambda c: (z[c], None if u is None else u[c]))(z, u)
    c = ts.controller(getattr(ts, book)(), n, n, 1, scheme, sharding, noise_source=noise, **kw)
    return ts.flat(c.run_simulation())


def jax_run(name):
    """(the JAX package's sharded results flattened, {name.phase.z|u: draws})."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    import montecarlo_risk_engine_tpu as mj
    from test_torch_samplers import jax_full_draws

    book, n, scheme, sim_dim, _, kw = JAX_CASES[name]
    mesh = Mesh(np.array(jax.devices()), ("paths",))
    jc = mj.SimulationController(*getattr(ts, book)(pkg=mj), n, n, 1, mj.SimulationScheme[scheme],
                                 path_sharding=NamedSharding(mesh, PartitionSpec("paths")),
                                 use_pallas=False, **kw)
    jr = jc.run_simulation()
    draws, counters = {}, range(len(jc.simulation_timeline))
    for phase in PHASES:
        source = jax_full_draws(phase, len(counters), n, sim_dim)
        draws[f"{name}.{phase}.z"] = np.stack([source(c)[0].numpy() for c in counters])
        draws[f"{name}.{phase}.u"] = np.stack([source(c)[1].numpy() for c in counters])
    return ts.flat(jr), draws


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """{name: JAX results} and the draws file the ranks read."""
    out = tmp_path_factory.mktemp("jax")
    results, draws = {}, {}
    for name in JAX_CASES:
        results[name], d = jax_run(name)
        draws.update(d)
    path = os.path.join(out, "draws.npz")
    np.savez(path, **draws)
    return results, path


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_controller_matches_jax_sharded_controller(jax_reference, world, tmp_path):
    results, draws = jax_reference
    ts.launch_ranks(world, list(JAX_CASES), str(tmp_path), script=__file__,
                    extra=["--draws", draws])
    for name, want in results.items():
        for r in range(world):
            got = np.load(os.path.join(tmp_path, f"{name}.rank{r}.npz"))
            np.testing.assert_allclose(got["values"], want["values"], rtol=1e-10, atol=1e-13,
                                       err_msg=f"{name} rank {r} values")
            if "jac" in want:
                np.testing.assert_allclose(got["jac"], want["jac"], rtol=1e-8, atol=1e-12,
                                           err_msg=f"{name} rank {r} jacobian")


def rank_main(argv):
    import torch.distributed as dist

    from montecarlo_risk_engine_tpu_torch.parallel import distributed

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--store", "--out", "--cases"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--draws")
    args = ap.parse_args(argv)
    sharding = distributed.initialize_and_make_sharding(
        args.rank, args.world, store=dist.FileStore(args.store, args.world), device="cpu")
    draws = None if args.draws is None else dict(np.load(args.draws))
    try:
        for name in args.cases.split(","):
            res = (collectives_case(sharding) if name == "collectives"
                   else port_jax_case(name, sharding, draws))
            np.savez(os.path.join(args.out, f"{name}.rank{args.rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank_main(sys.argv[1:])
