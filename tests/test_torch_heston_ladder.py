"""The Heston-QE substep ladder (K3) of the PyTorch port.

The JAX script (``benchmarks/kernel_decomposition.py``) draws from the TPU
hardware PRNG, which does not run off the chip.  So it is loaded as it is,
and the one test that runs its substeps replaces its draw functions with a
fixed source of numpy words, the words the port's substeps take too.  The
rest holds the plain rungs to the port's own K1 plain version and to each
other.  The test that needs a card takes the ``cuda_device`` fixture, which
skips without one.
"""

import importlib.util
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlo_risk_engine_tpu_torch import params_from_numpy, rng
from montecarlo_risk_engine_tpu_torch.ops import heston_ladder as ladder
from montecarlo_risk_engine_tpu_torch.ops.heston_ladder import (
    RUNGS,
    heston_ladder_paths,
    heston_ladder_paths_reference,
    heston_qe_substep_algebra,
    ladder_substep,
    normal_icdf,
    point_words,
)
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import heston_qe_paths, heston_qe_paths_reference
from montecarlo_risk_engine_tpu_torch.tools import kernel_decomposition as decomposition

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "benchmarks" / "kernel_decomposition.py"
PARAMS = decomposition.PARAMS  # spot, sigma, rate, rho, kappa, theta, v0: the script's
TIMELINE = decomposition.TIMELINE
# The script's substep function of each rung (its main(), :281-291).
SCRIPT_SUBSTEPS = dict(zip(RUNGS, (
    "substep_none", "substep_bits", "substep_box_muller", "substep_icdf", "substep_qe",
    "substep_qe_icdf", "substep_qe_batched_prng", "substep_qe_algebra", "substep_qe_combined")))


@pytest.fixture(scope="module")
def script():
    """The JAX script as a module (it puts '.' on sys.path; restored)."""
    path = list(sys.path)
    try:
        spec = importlib.util.spec_from_file_location("kernel_decomposition_script", SCRIPT)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = path
    return module


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _uniforms(words):
    """The port's uniforms of uint32 words, float32 numpy."""
    return rng.uniform_from_word(torch.as_tensor(words.astype(np.int64)), torch.float32).numpy()


def _state(n=20000, seed=0):
    rs = np.random.default_rng(seed)
    log_s = (np.log(100.0) + 0.3 * rs.standard_normal(n)).astype(np.float32)
    v = rs.gamma(2.0, 0.02, n).astype(np.float32)
    return log_s, v


def test_normal_icdf_matches_script(script):
    """Both tails, the centre and the extreme words: 0 and 2^32 - 1 give
    0.5 / 2^24 and the top uniform code (1 - 0.5 / 2^24, which rounds to 1
    in float32 and is clamped below 1).  The two evaluate the same float32
    ops; their logs and square roots may round apart by an ulp, which the
    polynomial carries to a few 1e-7 relative (2.4e-7 on these inputs)."""
    rs = np.random.default_rng(1)
    words = np.concatenate([
        rs.integers(0, 2 ** 32, 20000, dtype=np.uint64),
        np.array([0, 255, 256, 2 ** 31, 2 ** 32 - 257, 2 ** 32 - 256, 2 ** 32 - 1], np.uint64),
        rs.integers(0, 2 ** 20, 2000, dtype=np.uint64),                    # lower tail
        2 ** 32 - 1 - rs.integers(0, 2 ** 20, 2000, dtype=np.uint64),      # upper tail
    ])
    u = _uniforms(words)
    assert u.min() == np.float32(0.5 / 2 ** 24) and u.max() == np.float32(rng.U_MAX)
    port = normal_icdf(torch.as_tensor(u)).numpy()
    ref = np.asarray(script._normal_icdf(jnp.asarray(u)))
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=0)
    assert np.abs(port).max() > 5.0  # the tails were reached (|z| ~ 5.3 at the extreme words)


@pytest.mark.parametrize("dtype,jdtype,rtol", [
    (torch.float64, jnp.float64, 1e-10),
    (torch.float32, jnp.float32, 1e-5),
])
def test_algebra_substep_matches_script(script, dtype, jdtype, rtol):
    rs = np.random.default_rng(2)
    n = 20000
    log_s = np.log(100.0) + 0.3 * rs.standard_normal(n)
    v = rs.gamma(2.0, 0.02, n)
    z = rs.standard_normal((n, 2))
    u = rs.uniform(size=n)
    dt = 0.025
    _, sigma, rate, rho, kappa, theta, _ = params_from_numpy(PARAMS, dtype=dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    port = heston_qe_substep_algebra(t(log_s), t(v), t(z[:, 0]), t(z[:, 1]), t(u), dt,
                                     sigma, rate, rho, kappa, theta)
    j = lambda a: jnp.asarray(a, jdtype)
    ref = script._heston_qe_substep_algebra(j(log_s), j(v), j(z[:, 0]), j(z[:, 1]), j(u), dt,
                                            *(j(p) for p in PARAMS[1:6]))
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.double().numpy(), np.asarray(b, np.float64), rtol=rtol, atol=0)


@pytest.mark.parametrize("rung", RUNGS)
def test_rung_substep_matches_script_on_given_draws(script, monkeypatch, rung):
    """One substep of each rung from a given state, on three given words:
    the script's draw functions (``pltpu``'s bits, ``_uniforms``,
    ``_normal_pair``, ``_uniforms_batched3``) take them from a fixed numpy
    source, in the order each substep asks for them, with the port's
    mapping of words to uniforms.  The words stay below the top uniform
    code, where only the port clamps.  Tolerance: float32 on both sides,
    logs, square roots, sines and cosines rounding apart by an ulp."""
    n, dt = 20000, 0.025
    log_s, v = _state(n)
    words = np.random.default_rng(3).integers(0, 2 ** 32 - 256, (3, n), dtype=np.uint64)
    source = iter(words)
    take_u = lambda: jnp.asarray(_uniforms(next(source)))

    def normal_pair(shape):  # pallas_paths._normal_pair on the source's uniforms
        u1, u2 = take_u(), take_u()
        r = jnp.sqrt(-2.0 * jnp.log(u1))
        return r * jnp.cos(2.0 * np.pi * u2), r * jnp.sin(2.0 * np.pi * u2)

    pltpu = types.SimpleNamespace(
        prng_random_bits=lambda shape: jnp.asarray(next(source).astype(np.uint32)),
        bitcast=lambda x, dtype: jax.lax.bitcast_convert_type(x, dtype))
    monkeypatch.setattr(script, "pltpu", pltpu)
    monkeypatch.setattr(script, "_uniforms", lambda shape: take_u())
    monkeypatch.setattr(script, "_normal_pair", normal_pair)
    monkeypatch.setattr(script, "_uniforms_batched3", lambda shape: (take_u(), take_u(), take_u()))

    p = jnp.asarray(PARAMS, jnp.float32)
    ref = getattr(script, SCRIPT_SUBSTEPS[rung])((n,), jnp.asarray(log_s), jnp.asarray(v), dt, p)
    if rung != "no-draws":
        assert next(source, None) is None  # the substep took all three words
    _, sigma, rate, rho, kappa, theta, _ = params_from_numpy(PARAMS, dtype=torch.float32)
    port = ladder_substep(rung, torch.as_tensor(log_s), torch.as_tensor(v),
                          tuple(torch.as_tensor(w.astype(np.int64)) for w in words), dt,
                          sigma, rate, rho, kappa, theta)
    for a, b in zip(port, ref):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_plain_qe_full_is_plain_k1():
    n = 4096
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    states = heston_ladder_paths_reference("qe-full", params, TIMELINE, n, 4, seed=7, phase=43)
    k1 = heston_qe_paths_reference(params, TIMELINE, n, 4, seed=7, phase=43, smoothing=False)
    assert states.shape == (10, n, 2) and states.dtype == torch.float32
    assert torch.equal(states, k1)


@pytest.mark.parametrize("rung", RUNGS)
def test_generations_draw_different_streams(rung):
    """Generation g is the key's seed word plus g; every rung with draws
    moves with it, no-draws does not."""
    n = 256
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    run = lambda seed, g: heston_ladder_paths_reference(rung, params, TIMELINE[:3], n, 4,
                                                        seed=seed, phase=43, generation=g)
    g0, g1 = run(7, 0), run(7, 1)
    assert torch.isfinite(g0).all() and torch.isfinite(g1).all()
    assert torch.equal(g1, run(8, 0))
    assert torch.equal(g0, g1) == (rung == "no-draws")


@pytest.mark.parametrize("algebra,full", [("qe-algebra", "qe-full"),
                                          ("qe-combined", "qe-batched-prng")])
def test_algebra_rungs_match_their_division_rungs(algebra, full):
    """Same draws, the update's psi test and p rounded apart: states to
    float32 rounding on every path at this size (the smoke holds 99.99 % of
    1e6 paths, where a psi within an ulp of 1.5 may switch branch), the
    terminal means to 1e-6."""
    n = 4096
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    a = heston_ladder_paths_reference(algebra, params, TIMELINE, n, 4, seed=7, phase=43)
    b = heston_ladder_paths_reference(full, params, TIMELINE, n, 4, seed=7, phase=43)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    mean_a, mean_b = a[-1].double().mean(0), b[-1].double().mean(0)
    assert float(((mean_a - mean_b).abs() / mean_b.abs()).max()) <= 1e-6


def test_batched_rungs_read_the_batched_lane():
    """Substep k of a point takes words 3k .. 3k+2 of its calls at counter
    (path, point, call, LANE_BATCHED): ceil(3 * 5 / 4) = 4 calls for 5
    substeps."""
    n, point, steps = 64, 2, 5
    words = point_words("qe-batched-prng", 7, 43, 1, point, steps, n, "cpu")
    paths = torch.arange(n, dtype=torch.int64)
    word = lambda x: torch.tensor(x, dtype=torch.int64)
    calls = [rng.philox4x32_10((paths, word(point), word(c), word(ladder.LANE_BATCHED)), (8, 43))
             for c in range(4)]
    flat = [w for call in calls for w in call]
    assert len(words) == steps
    for k in range(steps):
        for a, b in zip(words[k], flat[3 * k:3 * k + 3]):
            assert torch.equal(a, b)
    k1_words = point_words("qe-full", 7, 43, 1, point, steps, n, "cpu")
    assert not torch.equal(words[0][0], k1_words[0][0])


def test_dispatcher_runs_plain_version_on_cpu():
    params = params_from_numpy(PARAMS, dtype=torch.float32)
    before = dict(heston_ladder_paths.rung_launches)
    for rung in ("no-draws", "qe-combined"):
        a = heston_ladder_paths(rung, params, TIMELINE, 300, 4, seed=1, phase=43, generation=2)
        b = heston_ladder_paths_reference(rung, params, TIMELINE, 300, 4, seed=1, phase=43,
                                          generation=2)
        assert a.shape == (10, 300, 2) and torch.equal(a, b)
    assert heston_ladder_paths.rung_launches == before
    with pytest.raises(ValueError):
        heston_ladder_paths("qe-fast", params, TIMELINE, 300, 4)
    meta = tuple(torch.zeros((), device="meta") for _ in range(7))
    with pytest.raises(ValueError):
        heston_ladder_paths("qe-full", meta, TIMELINE, 300, 4)


def test_decomposition_refuses_to_run_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        decomposition.main()


# -- on the card ------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_rungs_match_plain_versions(cuda_device):
    """Every rung bitwise against its plain version (-fmad=false), ragged
    last block included; qe-full bitwise K1's states."""
    n = 50_001
    params = params_from_numpy(PARAMS, device=cuda_device, dtype=torch.float32)
    for rung in RUNGS:
        before = heston_ladder_paths.rung_launches[rung]
        out = heston_ladder_paths(rung, params, TIMELINE, n, 4, seed=7, phase=43, generation=3)
        torch.cuda.synchronize()
        assert heston_ladder_paths.rung_launches[rung] == before + 1
        ref = heston_ladder_paths_reference(rung, params, TIMELINE, n, 4, seed=7, phase=43,
                                            generation=3)
        assert torch.equal(out, ref), rung
    k1 = heston_qe_paths(params, TIMELINE, n, 4, seed=7, phase=43)
    assert torch.equal(heston_ladder_paths("qe-full", params, TIMELINE, n, 4, seed=7, phase=43), k1)
