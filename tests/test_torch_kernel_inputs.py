"""The inputs of the path kernels K1 and K2 as their wrappers prepare them.

K2's table prologue (csrc/hybrid_paths.cu) takes a static half, cached per
block list, timeline, substep count, calibration date and device
(``table_inputs``), and the parameters as a device float64 vector; its
plain version is ``substep_table`` / ``initial_state``.  These tests hold
the cached half plus the plain parameter-dependent columns to that plain
version exactly for every (kind, scheme) of K2, check the cache's keys,
show that neither wrapper reads a parameter to the host while it prepares
a launch, and that K2 is built once per tuple of slot roles."""

import dataclasses

import numpy as np
import pytest
import torch

import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import SimulationScheme
from montecarlo_risk_engine_tpu_torch.ops import cuda_build, heston_qe
from montecarlo_risk_engine_tpu_torch.ops import hybrid_paths as hp

A, E = SimulationScheme.ANALYTICAL, SimulationScheme.EULER
HAZARDS = {1.0: 0.02, 2.0: 0.022, 5.0: 0.028}
HW_TIMES, HW_DFS = [0.0, 1.0, 3.0, 5.0], [1.0, 0.97, 0.90, 0.84]
CAL = 0.1
TIMELINE = (0.1, 0.4, 0.4, 1.3, 2.0)  # two zero-length points
STEPS = 3
CASES = [("bs", A), ("bs", E), ("bs_multi", A), ("bs_multi", E), ("vasicek", A), ("vasicek", E),
         ("cirpp", E), ("cirpp_det", E), ("hw", A), ("hw", E), ("s2f", A), ("s2f", E)]


def model(name):
    corr = np.full((3, 3), 0.35)
    np.fill_diagonal(corr, 1.0)
    return {
        "bs": lambda: mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq"),
        "bs_multi": lambda: mt.BlackScholesMulti(
            0.0, rate=0.03, asset_ids=["a0", "a1", "a2"], spots=[95.0, 102.5, 110.0],
            volatilities=[0.18, 0.21, 0.24], correlation_matrix=corr),
        "vasicek": lambda: mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                                           volatility=0.012, asset_id="irs"),
        "cirpp": lambda: mt.CIRPPModel(0.0, "cp", HAZARDS, kappa=0.5, theta=0.03,
                                       volatility=0.05, y0=0.03),
        "cirpp_det": lambda: mt.CIRPPModel(0.0, "cp", HAZARDS, kappa=0.5, theta=0.03,
                                           volatility=0.05, y0=0.03, deterministic=True),
        "hw": lambda: mt.HullWhiteModel(0.0, HW_TIMES, HW_DFS, volatility=0.01,
                                        mean_reversion=0.4, asset_id="hw"),
        "s2f": lambda: mt.SchwartzTwoFactorModel(
            0.0, [0.0, 1.0, 3.0], [50.0, 52.0, 55.0], rate=0.03, short_term_mean_reversion=1.2,
            short_term_vol=0.3, long_term_drift=0.01, long_term_vol=0.15, rho=0.35,
            asset_id="gas"),
    }[name]()


def case(name, scheme, dtype=torch.float64):
    """(blocks, params, chol) of one model as the one block of K2."""
    m = model(name)
    return ([m.kernel_block(scheme)], tuple(m.initial_params(dtype=dtype)),
            np.linalg.cholesky(m.kernel_correlation()))


def joint(dtype=torch.float64):
    """Every kind but bs_multi in one block list (seven noise factors),
    each block's parameters at its offset of one flat vector."""
    blocks, params = [], []
    for name, scheme in (("bs", A), ("vasicek", A), ("cirpp", E), ("cirpp_det", E), ("hw", A),
                         ("s2f", A)):
        (b,), p, _ = case(name, scheme, dtype)
        blocks.append(dataclasses.replace(b, param_base=len(params)))
        params += p
    return blocks, tuple(params), np.eye(sum(b.n_sim for b in blocks))


def init_from_descriptors(tab, params64):
    """The initial state as the prologue forms it from its descriptors."""
    src, log, const = tab.init
    vals = []
    for j in range(tab.state_dim):
        if src[j] < 0:
            vals.append(torch.tensor(const[j], dtype=torch.float64))
        else:
            v = params64[src[j]]
            vals.append(torch.log(v) if log[j] else v)
    return torch.stack(vals).to(torch.float32)


def check_split(blocks, params):
    tab, params64 = hp.kernel_inputs(blocks, params, TIMELINE, STEPS, CAL)
    table = hp.table_columns(blocks, tab.host, params, CAL)
    assert torch.equal(table, hp.substep_table(blocks, params, TIMELINE, STEPS, CAL))
    assert table.shape == (tab.rows, tab.table_width) == (len(TIMELINE) * STEPS, table.shape[1])
    assert torch.equal(init_from_descriptors(tab, params64),
                       hp.initial_state(blocks, params, CAL))
    assert torch.equal(params64.to(torch.float32), torch.stack(params).to(torch.float32))
    # The prologue's column groups are those of the plain table, and each
    # lands on a table column a slot of the main kernel reads.
    n, kind, pbase, hcol, tcol = tab.groups
    groups = [(kind[i], pbase[i], hcol[i], tcol[i]) for i in range(n)]
    assert groups == hp._table_groups(blocks)
    slots, state_dim, width = hp.kernel_slots(blocks)
    assert (state_dim, width) == (tab.state_dim, tab.table_width)
    assert {g[3] for g in groups} <= {sl.tcol for sl in slots}
    # The CPU dispatcher of the prologue is the plain version.
    t, p, i = hp.hybrid_table(blocks, params, TIMELINE, STEPS, CAL)
    assert torch.equal(t, table) and torch.equal(i, hp.initial_state(blocks, params, CAL))
    assert torch.equal(p, params64.to(torch.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name,scheme", CASES)
def test_cached_host_part_and_plain_columns_equal_the_plain_version(name, scheme, dtype):
    blocks, params, _ = case(name, scheme, dtype)
    check_split(blocks, params)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_joint_block_list_split_equals_the_plain_version(dtype):
    blocks, params, _ = joint(dtype)
    check_split(blocks, params)


def test_same_key_returns_the_same_device_tensors():
    blocks, params, chol = joint()
    a, _ = hp.kernel_inputs(blocks, params, TIMELINE, STEPS, CAL)
    b, _ = hp.kernel_inputs(tuple(blocks), params, list(TIMELINE), STEPS, CAL)
    assert a is b and a.host is b.host
    assert hp._slots_of(blocks, chol) is hp._slots_of(tuple(blocks), chol.copy())


@pytest.mark.parametrize("change", ["timeline", "num_steps", "blocks", "calibration_date"])
def test_another_key_builds_other_tensors(change):
    blocks, params, _ = joint()
    base, _ = hp.kernel_inputs(blocks, params, TIMELINE, STEPS, CAL)
    args = dict(blocks=blocks, timeline=TIMELINE, num_steps=STEPS, calibration_date=CAL)
    args[change] = {"timeline": TIMELINE[:-1] + (2.5,), "num_steps": STEPS + 1,
                    "blocks": blocks[:-1] + [dataclasses.replace(blocks[-1], scheme="euler")],
                    "calibration_date": 0.05}[change]
    other, _ = hp.kernel_inputs(args["blocks"], params, args["timeline"], args["num_steps"],
                                args["calibration_date"])
    assert other is not base and other.host is not base.host
    assert torch.equal(hp.table_columns(args["blocks"], other.host, params,
                                        args["calibration_date"]),
                       hp.substep_table(args["blocks"], params, args["timeline"],
                                        args["num_steps"], args["calibration_date"]))


def test_another_cholesky_factor_builds_other_slot_descriptors():
    blocks, _, chol = joint()
    other = chol.copy()
    other[1, 0], other[1, 1] = 0.6, 0.8
    a, b = hp._slots_of(blocks, chol), hp._slots_of(blocks, other)
    assert a is not b
    n = len(chol)
    assert list(b[-1]) == list(other.astype(np.float32).reshape(-1)) != list(a[-1])
    assert len(a[-1]) == n * n


@pytest.fixture
def no_host_reads(monkeypatch):
    """Every way a tensor's value reaches the host raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a parameter was read to the host")

    for name in ("item", "__float__", "__int__", "__index__", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_hybrid_paths_prepares_its_inputs_without_a_host_read(no_host_reads):
    blocks, params, chol = joint()
    with pytest.raises(AssertionError, match="host"):
        float(params[0])
    hp.table_inputs.cache_clear()  # the cold path too
    hp.slot_inputs.cache_clear()
    for _ in range(2):
        tab, params64 = hp.kernel_inputs(blocks, params, TIMELINE, STEPS, CAL)
        hp._slots_of(blocks, chol)
    assert params64.dtype == torch.float64 and params64.shape == (len(params),)


def test_heston_qe_paths_prepares_its_inputs_without_a_host_read(no_host_reads):
    params = mt.params_from_numpy([100.0, 0.5, 0.03, -0.7, 2.0, 0.06, 0.04],
                                  dtype=torch.float64)
    with pytest.raises(AssertionError, match="host"):
        params[0].item()
    prm, dts = heston_qe.kernel_inputs(params, (0.1, 0.5, 0.5, 1.0), 4, 0.0)
    assert prm.dtype == torch.float32 and prm.shape == (7,)
    assert list(dts) == [np.float32(x) for x in (0.025, 0.1, 0.0, 0.125)]


def test_heston_parameters_round_once_as_the_host_conversion_did():
    # The device vector holds what float() -> c_float gave the kernel before.
    values = [100.0, 0.5, 0.03, -0.7, 2.0, 0.06, 0.04 + 1e-12]
    params = mt.params_from_numpy(values, dtype=torch.float64)
    prm, _ = heston_qe.kernel_inputs(params, (1.0,), 1)
    assert prm.tolist() == [float(np.float32(v)) for v in values]


def test_one_build_per_tuple_of_slot_roles():
    # K2 is compiled once per tuple of slot roles: the flags encode the slot
    # count and each role (4 bits per slot), not the parameter offsets.
    blocks, _, _ = joint()
    roles = [sl.role for sl in hp.kernel_slots(blocks)[0]]
    ns, bits = hp.role_flags(blocks)
    assert ns == f"-DMCRE_NS={len(roles)}"
    code = int(bits.split("=")[1], 16)
    assert [(code >> (4 * s)) & 15 for s in range(len(roles))] == roles
    shifted = [dataclasses.replace(b, param_base=b.param_base + 3) for b in blocks]
    assert hp.role_flags(shifted) == hp.role_flags(blocks)
    # every (kind, scheme) of K2 is a tuple of its own
    assert len({hp.role_flags(case(name, scheme)[0]) for name, scheme in CASES}) == len(CASES)


def test_launch_helper_binds_once_and_raises_a_failed_launch():
    """The wrappers' calling convention on a C function of the process
    (libc's ``abs``): the argument types are set at the first ``bind`` and
    kept after, a non-zero return code raises with the kernel's name, and
    a host array reaches the CPU as a plain copy."""
    import ctypes

    lib = ctypes.CDLL(None)
    fn = cuda_build.bind(lib, "abs", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    assert cuda_build.bind(lib, "abs", [ctypes.c_long]) is fn
    assert fn.argtypes == [ctypes.c_int]
    cuda_build.check(fn(0), "hybrid_paths")
    with pytest.raises(RuntimeError,
                       match=r"^hybrid_paths: CUDA launch failed with cudaError_t 700$"):
        cuda_build.check(fn(-700), "hybrid_paths")
    assert cuda_build.ptr(None) is None
    x = torch.arange(3.0)
    assert cuda_build.ptr(x) == x.data_ptr()
    host = np.arange(6.0).reshape(2, 3).T  # not contiguous
    on_cpu = cuda_build.upload(host, torch.device("cpu"))
    assert torch.equal(on_cpu, torch.from_numpy(host.copy())) and on_cpu.is_contiguous()


def test_launch_sizes_and_ulps_apart():
    """The tangent counts of a jacobian's launches (sweeps of ``chunk``
    directions, at most ``per_launch`` a launch), and the ulp distance the
    kernels' card tests hold them to: across zero, at nans in the same and
    in other places."""
    assert cuda_build.launch_sizes(7, 8, 8) == [7]
    assert cuda_build.launch_sizes(11, 8, 8) == [8, 3]
    assert cuda_build.launch_sizes(7, 4, 8) == [4, 3]
    assert cuda_build.launch_sizes(20, 20, 8) == [8, 8, 4]
    a = torch.tensor([1.0, -0.0, 5e-324, float("nan")], dtype=torch.float64)
    assert cuda_build.ulps_apart(a, a.clone()) == 0.0
    b = a.clone()
    b[0] = torch.nextafter(b[0], torch.tensor(2.0, dtype=torch.float64))
    b[1] = -5e-324  # one ulp below -0.0, two from 5e-324
    assert cuda_build.ulps_apart(a, b) == 1.0
    b[2] = -5e-324
    assert cuda_build.ulps_apart(a, b) == 2.0
    b[3] = 0.0
    assert cuda_build.ulps_apart(a, b) == float("inf")
    assert cuda_build.ulps_apart(a[3:], a[3:].clone()) == 0.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_a_build_refuses_another_tuple(cuda_device):
    blocks, params, chol = joint()
    other = [b for b in blocks if b.kind != "hw"]
    params = tuple(p.to(cuda_device) for p in params)
    hp.hybrid_paths(other, np.eye(sum(b.n_sim for b in other)), params, TIMELINE, 64, 1)
    wrong = cuda_build.bind(hp._library(other), "mcre_hybrid_paths", hp._ARGS)
    tab, params64 = hp.kernel_inputs(blocks, params, TIMELINE, STEPS, CAL)
    table, prm, init = hp._run_table(hp._library(blocks), tab, params64, CAL)
    out = torch.empty((len(TIMELINE), 64, tab.state_dim), device=cuda_device)
    rc = wrong(out.data_ptr(), prm.data_ptr(), table.data_ptr(), init.data_ptr(),
               *hp._slots_of(blocks, chol), tab.state_dim, tab.table_width, len(TIMELINE), STEPS,
               64, 0, 0, 0, 1, torch.cuda.current_stream().cuda_stream)
    assert rc != 0
