#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's two main paths through ``SimulationController`` at full
size, forward and differentiated, and checks every kernel on them against
its plain PyTorch version:

  * the Heston-QE European book (ten netting sets, one ATM call each,
    maturities 0.1 .. 1.0) at 2^20 paths x 10 points x 4 substeps, on the
    path kernel K1 (``heston_qe_paths``);
  * the north-star xVA book of ``benchmarks/north_star.py`` (one netting set
    of 5 Vasicek swaps and 5 Black-Scholes options, a CIR++ counterparty,
    MPoR 10/252, CVA + EPE + PFE(0.95) on ``linspace(0, 7, 29)``) at 1e6
    main and 1e6 pre-simulation paths, on the hybrid path kernel K2
    (``hybrid_paths``).

Phases:

  1. take the card, print its name and power limit (nvidia-smi);
  2. build both kernels from the sources in this checkout (concurrent nvcc,
     sm_90a) and print their registers and spills;
  3. compare each kernel with its plain version on the card at its main
     path's shapes and time both (CUDA events, warm median of 5);
  4. Heston book: counts to 0, forward and differentiated runs, counts
     read; PVs against the characteristic-function price, the kernel-route
     jacobian against the engine route's on the same Philox stream, the 1y
     delta against a central difference of the closed form;
  5. north-star book: counts to 0, forward and differentiated runs, counts
     read (K2: one launch per phase, two per run); CVA against the JAX
     package's 16M-path value, EPE and PFE printed, the kernel-route values
     and CVA/EPE jacobian against the engine route's on the same stream;
  6. print the card line, the kernels' JSON line and, last, the JSON result
     line.

Any failure raises and the script exits non-zero.  Without CUDA it exits
non-zero and prints no result.  Run from the repository root:

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import (
    heston_qe_paths,
    heston_qe_paths_reference,
)
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
    hybrid_paths,
    hybrid_paths_reference,
)
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import dense_timeline

NUM_PATHS = 1 << 20
NUM_STEPS = 4
MATURITIES = tuple(round(0.1 * (i + 1), 10) for i in range(10))
MODEL_KW = dict(spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06, v0=0.04)
SEED = 0
PHASE = mt.rng.PHASE_MAINSIM

# North-star book (benchmarks/north_star.py:43-96, :101).
NS_PATHS = 1_000_000
NS_PRESIM_FIT = 131_072  # the presim size of the JAX 16M-path reference run
HAZARDS = {1.0: 0.02, 2.0: 0.022, 3.0: 0.025, 5.0: 0.028, 10.0: 0.02}
CP = "counterparty"
# JAX package, 16M paths (NOTES_R5.md:132-134, benchmarks/north_star_16m_mesh.py).
CVA_REF, CVA_REF_SE = 0.2872266, 1.8e-5

# Device peaks for the bounds (NVIDIA H100 SXM data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per path-substep counted from the sources, one per float or
# integer add, multiply, compare, select, conversion, division or
# transcendental call (a lower bound on the issue slots):
#   K1 (csrc/heston_qe.cu): Philox4x32-10 98 (10 rounds of 2 mul.hi, 2 mul.lo,
#   4 xor; 9 key bumps of 2 adds), 3 uniforms x 5, one Box-Muller pair 8,
#   the QE update 52 -> 173.
#   K2 (csrc/hybrid_paths.cu), per path-substep of the north-star blocks:
#   Philox 98, 4 uniforms x 5, Box-Muller 8 + 6 (cosine half), the 3x3
#   triangular combine 9, vasicek 9, bs 7, cirpp 13 -> 170.
K1_OPS_PER_SUBSTEP = 173
K2_OPS_PER_SUBSTEP = 170


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def slice_book():
    model = mt.HestonModel(0.0, asset_id="eq", **MODEL_KW)
    netting_sets = [
        mt.NettingSet(name=f"call_{t:g}", products=[
            mt.EuropeanOption(mt.Equity("eq"), t, 100.0, mt.OptionType.CALL, asset_id="eq")])
        for t in MATURITIES
    ]
    return model, netting_sets


def controller(differentiate: bool, use_kernel="auto"):
    model, netting_sets = slice_book()
    return mt.SimulationController(
        netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), NUM_PATHS, 0, NUM_STEPS,
        mt.SimulationScheme.QE, differentiate=differentiate, root_seed=SEED,
        use_kernel=use_kernel, device="cuda",
    ), model, netting_sets


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes / memory rate and
    operations / FP32 peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def live_substeps(timeline, steps: int) -> int:
    t_prev, n = 0.0, 0
    for t in timeline:
        n += steps if t > t_prev else 0
        t_prev = t
    return n


def north_star(num_paths: int, differentiate: bool, use_kernel="auto", num_paths_presim=None):
    """The north-star book (benchmarks/north_star.py:47-96) on the card."""
    model = mt.ModelConfig(
        [mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012,
                         asset_id="irs"),
         mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq"),
         mt.CIRPPModel(0.0, asset_id=CP, hazard_rates=HAZARDS, kappa=0.1, theta=0.01,
                       volatility=0.02, y0=0.0001)],
        inter_asset_correlation_matrix=[np.array([[0.25]]), np.array([[0.4]]), np.array([[0.15]])],
    )
    products = [mt.InterestRateSwap(0.0, 2.0 + i, notional=1.0, fixed_rate=0.028 + 0.001 * i,
                                    tenor_fixed=0.5, tenor_float=0.5,
                                    irs_type=mt.IRSType.PAYER if i % 2 == 0 else mt.IRSType.RECEIVER,
                                    asset_id="irs") for i in range(5)]
    products += [mt.EuropeanOption(mt.Equity("eq"), 1.0 + 0.75 * i, 90.0 + 5.0 * i,
                                   mt.OptionType.CALL if i % 2 == 0 else mt.OptionType.PUT,
                                   asset_id="eq") for i in range(5)]
    netting_set = mt.NettingSet(name="north_star", products=products, counterparty_id=CP,
                                margin_period_of_risk=10 / 252)
    metrics = mt.RiskMetrics(
        metrics=[mt.CVAMetric(counterparty_id=CP, recovery_rate=0.4), mt.EPEMetric(),
                 mt.PFEMetric(0.95)],
        exposure_timeline=np.linspace(0.0, 7.0, 29))
    return mt.SimulationController(
        [netting_set], model, metrics, num_paths,
        num_paths if num_paths_presim is None else num_paths_presim, 1, mt.SimulationScheme.EULER,
        differentiate=differentiate, grad_chunk_size=8, use_kernel=use_kernel, device="cuda")


def median_ms(fn, reps: int = 5) -> float:
    """Warm median of ``reps`` runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def compare_kernel(params, timeline, steps, smoothing, emit, min_close):
    """Kernel vs plain version on the card; returns the max abs state error."""
    out = heston_qe_paths(params, timeline, NUM_PATHS, steps, seed=SEED, phase=PHASE,
                          smoothing=smoothing, emit_noise=emit)
    ref = heston_qe_paths_reference(params, timeline, NUM_PATHS, steps, seed=SEED,
                                    phase=PHASE, smoothing=smoothing, emit_noise=emit)
    torch.cuda.synchronize()
    label = f"smoothing={smoothing} emit_noise={emit}"
    if emit:
        check(torch.equal(out[2], ref[2]), f"{label}: uniforms differ from the plain version")
        z_err = float((out[1] - ref[1]).abs().max())
        check(torch.isclose(out[1], ref[1], rtol=1e-6, atol=1e-6).all().item(),
              f"{label}: normals differ (max abs {z_err:.3e})")
        out, ref = out[0], ref[0]
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite states")
    close = torch.isclose(out, ref, rtol=1e-5, atol=1e-6).all(dim=-1).all(dim=0)
    frac = float(close.double().mean())
    err = float((out - ref).abs().max())
    mean_k = out[-1].double().mean(dim=0)
    mean_r = ref[-1].double().mean(dim=0)
    mean_rel = float(((mean_k - mean_r).abs() / mean_r.abs()).max())
    print(f"  {label}: paths within rtol 1e-5/atol 1e-6 {frac:.6f}, max abs err {err:.3e}, "
          f"rel err of mean (log S_T, v_T) {mean_rel:.3e}, bitwise {torch.equal(out, ref)}")
    check(frac >= min_close, f"{label}: only {frac:.6f} of paths agree")
    check(mean_rel <= 1e-6, f"{label}: terminal means differ by {mean_rel:.3e}")
    return err


def compare_hybrid(blocks, chol, params, dense, phase):
    """K2 vs its plain version at the north-star shapes; returns the max abs
    state error."""
    out = hybrid_paths(blocks, chol, params, dense, NS_PATHS, 1, seed=SEED, phase=phase)
    ref = hybrid_paths_reference(blocks, chol, params, dense, NS_PATHS, 1, seed=SEED, phase=phase)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"K2 phase {phase}: non-finite states")
    bitwise = torch.equal(out, ref)
    close = torch.isclose(out, ref, rtol=1e-5, atol=1e-6).all(dim=-1).all(dim=0)
    frac = float(close.double().mean())
    err = float((out - ref).abs().max())
    mean_k, mean_r = out[-1].double().mean(dim=0), ref[-1].double().mean(dim=0)
    mean_rel = float(((mean_k - mean_r).abs() / mean_r.abs().clamp(min=1e-30)).max())
    print(f"  phase {phase}: states bitwise {bitwise} (so every draw is the same word), paths "
          f"within rtol 1e-5/atol 1e-6 {frac:.6f}, max abs err {err:.3e}, rel err of terminal "
          f"means {mean_rel:.3e}")
    check(frac >= 0.9999, f"K2 phase {phase}: only {frac:.6f} of paths agree")
    check(mean_rel <= 1e-6, f"K2 phase {phase}: terminal means differ by {mean_rel:.3e}")
    return err


def heston_main_path(device):
    """Phase 4: the Heston book; returns K1's launches in it."""
    heston_qe_paths.launches = 0
    heston_qe_paths.emit_launches = 0

    fwd, model, netting_sets = controller(False)
    check(fwd._kernel_active, "the forward book is not on the kernel path")
    fwd.run_simulation()
    check(heston_qe_paths.launches > 0, "forward run launched no kernel")
    results = None

    def run_fwd():
        nonlocal results
        results = fwd.run_simulation()

    fwd_s = wall_seconds(run_fwd)
    print(f"[heston forward] warm wall {fwd_s:.4f} s")
    for ns in netting_sets:
        pv = float(results.get_results(ns.name, "pv", evaluation_idx=0))
        se = float(results.get_mc_error(ns.name, "pv", evaluation_idx=0))
        cf = ns.products[0].compute_pv_analytically_heston(model)
        print(f"  {ns.name}: pv {pv:.6f} se {se:.6f} cf {cf:.6f} |pv-cf|/se {abs(pv - cf) / se:.2f}")
        check(np.isfinite(pv) and np.isfinite(se) and se > 0, f"{ns.name}: bad pv/se")
        check(abs(pv - cf) < 4 * se + 0.05, f"{ns.name}: pv {pv} vs cf {cf} (se {se})")

    emit_before = heston_qe_paths.emit_launches
    diff, model, netting_sets = controller(True)
    torch.cuda.reset_peak_memory_stats()
    diff_results = diff.run_simulation()
    check(heston_qe_paths.emit_launches > emit_before, "differentiated run launched no emit kernel")

    def run_diff():
        nonlocal diff_results
        diff_results = diff.run_simulation()

    diff_s = wall_seconds(run_diff)
    print(f"[heston differentiated] warm wall {diff_s:.4f} s ({diff._grad_mode_resolved} mode), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_run("heston forward", run_fwd)
    profile_run("heston differentiated", run_diff)
    launches = heston_qe_paths.launches  # this main path only
    print(f"  K1 launches: {launches} (forward 1 per run, differentiated 1 per run)")

    # Reconstruction primal vs the kernel's own states (f32 rounding).
    params64 = model.initial_params(device=device)
    fwd_coarse, noise_fn, recon_fn = diff._kernel_ad_fns(NUM_PATHS, PHASE)
    with torch.no_grad():
        kernel_states = fwd_coarse(params64)
        recon = recon_fn(params64, noise_fn(params64))
    recon_err = float((recon.float() - kernel_states).abs().max())
    print(f"  reconstruction vs kernel states: max abs err {recon_err:.3e}")
    check(torch.isclose(recon.float(), kernel_states, rtol=1e-4, atol=1e-5).all().item(),
          f"reconstruction primal differs from the kernel states ({recon_err:.3e})")

    plain, _, _ = controller(True, use_kernel=False)
    check(not plain._kernel_active, "use_kernel=False took the kernel")
    plain_results = None

    def run_plain_diff():
        nonlocal plain_results
        plain_results = plain.run_simulation()

    plain_diff_s = wall_seconds(run_plain_diff)
    print(f"[heston differentiated, engine route] wall {plain_diff_s:.4f} s")
    names = [ns.name for ns in netting_sets]
    jac_k = np.array([[diff_results.get_derivatives(n, "pv", param=p, evaluation_idx=0)
                       for p in model.get_model_param_names()] for n in names])
    jac_p = np.array([[plain_results.get_derivatives(n, "pv", param=p, evaluation_idx=0)
                       for p in model.get_model_param_names()] for n in names])
    check(bool(np.isfinite(jac_k).all()), "non-finite jacobian")
    jac_rel = float(np.max(np.abs(jac_k - jac_p) / np.maximum(np.abs(jac_p), 1e-6)))
    print(f"  kernel vs engine jacobian: max rel err {jac_rel:.3e}")
    np.testing.assert_allclose(jac_k, jac_p, rtol=1e-3, atol=1e-6)

    option = netting_sets[-1].products[0]
    base = [float(p) for p in model.initial_params()]
    bump = 0.01 * base[0]
    up = option.heston_call_price(model, option.strike, option.exercise_date, [base[0] + bump] + base[1:])
    down = option.heston_call_price(model, option.strike, option.exercise_date, [base[0] - bump] + base[1:])
    cf_delta = (up - down) / (2 * bump)
    mc_delta = float(diff_results.get_derivatives(names[-1], "pv", param="spot", evaluation_idx=0))
    gap = abs(mc_delta - cf_delta) / abs(cf_delta)
    print(f"  1y delta: pathwise {mc_delta:.6f} vs CF central difference {cf_delta:.6f} (gap {gap:.4%})")
    check(gap < 0.02, f"1y delta gap {gap:.4%}")
    return launches


def profile_run(label: str, fn) -> None:
    """One run under torch.profiler: wall, device busy time (the sum of the
    CUDA kernels' durations) and the five kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = wall_seconds(fn)
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e6
    busy = sum(by_name.values())
    print(f"  [profile {label}] wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({busy / wall:.1%}; idle {1 - busy / wall:.1%}), {len(prof.events())} events")
    for name, sec in sorted(by_name.items(), key=lambda kv: -kv[1])[:5]:
        print(f"    {sec:.4f} s  {name[:90]}")


def ns_values(results):
    get = lambda metric: (np.asarray(results.get_results("north_star", metric)),
                          np.asarray(results.get_mc_error("north_star", metric)))
    return {m: get(m) for m in (f"cva[{CP}]", "epe", "pfe[0.95]")}


def ns_jacobian(results, metric):
    return np.asarray(results.get_derivatives("north_star", metric))  # [evals, P]


def north_star_main_path():
    """Phase 5: the north-star book; returns K2's launches in it."""
    hybrid_paths.launches = 0
    fwd = north_star(NS_PATHS, False)
    check(fwd._kernel_active, "the north-star book is not on the kernel path")
    results = fwd.run_simulation()
    check(hybrid_paths.launches == 2, f"forward run made {hybrid_paths.launches} K2 launches, not 2")

    def run_fwd():
        nonlocal results
        results = fwd.run_simulation()

    torch.cuda.reset_peak_memory_stats()
    fwd_s = wall_seconds(run_fwd)
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[north-star forward] {NS_PATHS} + {NS_PATHS} presim paths, "
          f"{len(fwd.simulation_timeline)}-point timeline: warm wall {fwd_s:.4f} s, "
          f"peak memory {fwd_peak:.2f} GiB")
    values = ns_values(results)
    cva, cva_se = (float(x[0]) for x in values[f"cva[{CP}]"])
    epe, epe_se = values["epe"]
    pfe, pfe_se = values["pfe[0.95]"]
    for i in (0, 4, 8, 16, 28):
        print(f"  t={fwd.metric_exposure_timeline[i]:.2f}: epe {epe[i]:.6f} (se {epe_se[i]:.2e}) "
              f"pfe {pfe[i]:.6f} (se {pfe_se[i]:.2e})")
    check(all(np.isfinite(x).all() for pair in values.values() for x in pair), "non-finite values")
    check(all(len(values[m][0]) == 29 for m in ("epe", "pfe[0.95]")), "EPE/PFE length is not 29")
    check(bool((epe >= 0).all()), "negative EPE")
    combined = (cva_se ** 2 + CVA_REF_SE ** 2) ** 0.5
    gap = abs(cva - CVA_REF) / combined
    print(f"  CVA {cva:.7f} (se {cva_se:.2e}) vs JAX 16M {CVA_REF} (se {CVA_REF_SE:.1e}): "
          f"{gap:.2f} combined SE")
    if gap > 4:
        # Separate LSM fit bias from a fault: the reference fitted its
        # exposures on 131,072 presim paths.
        fit = north_star(NS_PATHS, False, num_paths_presim=NS_PRESIM_FIT)
        fit_cva, fit_se = (float(x[0]) for x in ns_values(fit.run_simulation())[f"cva[{CP}]"])
        fit_gap = abs(fit_cva - CVA_REF) / (fit_se ** 2 + CVA_REF_SE ** 2) ** 0.5
        print(f"  with {NS_PRESIM_FIT} presim paths: CVA {fit_cva:.7f} (se {fit_se:.2e}), "
              f"{fit_gap:.2f} combined SE from the reference")
        best = min(abs(cva - CVA_REF), abs(fit_cva - CVA_REF)) / CVA_REF
        check(min(gap, fit_gap) <= 4 or best <= 0.01,
              f"CVA is {best:.3%} from the reference in both presim variants")

    diff = north_star(NS_PATHS, True)
    torch.cuda.reset_peak_memory_stats()
    before = hybrid_paths.launches
    diff_results = diff.run_simulation()
    check(hybrid_paths.launches == before + 2,
          "differentiated run did not launch K2 once per phase")

    def run_diff():
        nonlocal diff_results
        diff_results = diff.run_simulation()

    diff_s = wall_seconds(run_diff)
    diff_peak = torch.cuda.max_memory_allocated() / 2**30
    launches = hybrid_paths.launches
    print(f"[north-star differentiated] warm wall {diff_s:.4f} s ({diff._grad_mode_resolved} mode, "
          f"chunk {diff.grad_chunk_size}), peak memory {diff_peak:.2f} GiB")
    print(f"  K2 launches: {launches} (2 per run: presim + mainsim)")
    profile_run("forward", run_fwd)
    profile_run("differentiated", run_diff)
    launches = hybrid_paths.launches  # this main path only
    grads = diff_results.get_derivatives("north_star", f"cva[{CP}]", evaluation_idx=0)
    print(f"  dCVA/d irs.rate {float(grads['irs.rate']):.6f}, dCVA/d eq.spot "
          f"{float(grads['eq.spot']):.6f}")
    check(all(np.isfinite(float(g)) for g in grads.values()), "non-finite CVA gradient")

    del diff
    torch.cuda.empty_cache()
    engine = north_star(NS_PATHS, True, use_kernel=False)
    check(not engine._kernel_active, "use_kernel=False took the kernel")
    engine_results = None

    def run_engine():
        nonlocal engine_results
        engine_results = engine.run_simulation()

    engine_s = wall_seconds(run_engine)
    check(hybrid_paths.launches == launches, "the engine route launched K2")
    print(f"[north-star differentiated, engine route] wall {engine_s:.4f} s")
    kv, ev = ns_values(diff_results), ns_values(engine_results)
    for metric in kv:
        rel = float(np.max(np.abs(kv[metric][0] - ev[metric][0])
                           / np.maximum(np.abs(ev[metric][0]), 1e-12)))
        print(f"  {metric}: kernel vs engine values max rel err {rel:.3e}")
        np.testing.assert_allclose(kv[metric][0], ev[metric][0], rtol=1e-4, atol=1e-8)
        jk, je = ns_jacobian(diff_results, metric), ns_jacobian(engine_results, metric)
        jrel = float(np.max(np.abs(jk - je) / np.maximum(np.abs(je), 1e-6)))
        print(f"  {metric}: kernel vs engine jacobian max rel err {jrel:.3e}")
        check(bool(np.isfinite(jk).all()), f"non-finite {metric} jacobian")
        if metric != "pfe[0.95]":
            # PFE's derivative is the tangent of the one path at the
            # quantile, which float32 and float64 paths may rank apart.
            np.testing.assert_allclose(jk, je, rtol=1e-3, atol=1e-6)
    return launches


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build both kernels concurrently
    for name, built in cuda_build.load_libraries(["heston_qe", "hybrid_paths"]).items():
        how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
        print(f"[build] {name}: {how} -> {built.path.name}")
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {line.strip()}")

    # 3a. K1 vs plain version at the Heston path's shapes
    params32 = mt.params_from_numpy(
        [MODEL_KW[k] for k in ("spot", "sigma", "rate", "rho", "kappa", "theta", "v0")],
        device=device, dtype=torch.float32)
    dense, _ = dense_timeline(0.0, MATURITIES, NUM_STEPS)
    print(f"[kernel] heston_qe_paths at {NUM_PATHS} paths x {len(MATURITIES)} points x {NUM_STEPS} substeps")
    k1_errs = [
        compare_kernel(params32, MATURITIES, NUM_STEPS, False, False, 0.9999),
        compare_kernel(params32, MATURITIES, NUM_STEPS, True, False, 1.0),
        compare_kernel(params32, dense, 1, True, True, 1.0),
    ]
    run_k1 = lambda: heston_qe_paths(params32, MATURITIES, NUM_PATHS, NUM_STEPS, seed=SEED, phase=PHASE)
    run_k1_plain = lambda: heston_qe_paths_reference(params32, MATURITIES, NUM_PATHS, NUM_STEPS,
                                                     seed=SEED, phase=PHASE)
    k1_plain_ms = median_ms(run_k1_plain)
    k1_ms = median_ms(run_k1)
    k1_substeps = NUM_PATHS * live_substeps(MATURITIES, NUM_STEPS)
    k1_bound = bound(len(MATURITIES) * NUM_PATHS * 2 * 4, k1_substeps * K1_OPS_PER_SUBSTEP)
    print(f"  kernel {k1_ms:.3f} ms ({k1_substeps / k1_ms * 1e3:.3e} path-steps/s), "
          f"plain {k1_plain_ms:.3f} ms, bound {k1_bound[0]:.4f} ms by {k1_bound[1]} "
          f"({k1_bound[0] / k1_ms:.1%} of it reached)")

    # 3b. K2 vs plain version at the north-star shapes (both phases)
    ns = north_star(NS_PATHS, False)
    ns_model = ns.model
    ns_dense, _ = dense_timeline(0.0, ns.simulation_timeline, 1)
    blocks = ns_model.kernel_blocks()
    chol = np.linalg.cholesky(ns_model.static_joint_correlation())
    ns_params32 = ns_model.initial_params(device=device, dtype=torch.float32)
    print(f"[kernel] hybrid_paths at {NS_PATHS} paths x {len(ns_dense)} points "
          f"(dense timeline), blocks {[b.kind for b in blocks]}")
    k2_errs = [compare_hybrid(blocks, chol, ns_params32, ns_dense, phase)
               for phase in (mt.rng.PHASE_PRESIM, mt.rng.PHASE_MAINSIM)]
    run_k2 = lambda: hybrid_paths(blocks, chol, ns_params32, ns_dense, NS_PATHS, 1, seed=SEED,
                                  phase=PHASE)
    run_k2_plain = lambda: hybrid_paths_reference(blocks, chol, ns_params32, ns_dense, NS_PATHS, 1,
                                                  seed=SEED, phase=PHASE)
    k2_plain_ms = median_ms(run_k2_plain)
    k2_ms = median_ms(run_k2)
    k2_substeps = NS_PATHS * live_substeps(ns_dense, 1)
    k2_bound = bound(len(ns_dense) * NS_PATHS * ns_model.state_dim * 4,
                     k2_substeps * K2_OPS_PER_SUBSTEP)
    print(f"  kernel {k2_ms:.3f} ms ({k2_substeps / k2_ms * 1e3:.3e} path-steps/s), "
          f"plain {k2_plain_ms:.3f} ms, bound {k2_bound[0]:.4f} ms by {k2_bound[1]} "
          f"({k2_bound[0] / k2_ms:.1%} of it reached)")
    del ns

    # 4. + 5. the main paths: each path's counts from 0 just before it
    k1_launches = heston_main_path(device)
    torch.cuda.empty_cache()
    k2_launches = north_star_main_path()
    check(k1_launches > 0 and k2_launches > 0, "a kernel of the main paths never launched")

    # 6. result lines
    print(smi)
    print(json.dumps({"kernels": [
        {
            "name": "heston_qe_paths",
            "route": "cuda",
            "source": "montecarlo_risk_engine_tpu_torch/csrc/heston_qe.cu",
            "replaces": "montecarlo_risk_engine_tpu/ops/pallas_paths.py:148",
            "launches": k1_launches,
            "max_abs_err": max(k1_errs),
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": None,
        },
        {
            "name": "hybrid_paths",
            "route": "cuda",
            "source": "montecarlo_risk_engine_tpu_torch/csrc/hybrid_paths.cu",
            "replaces": "montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153",
            "launches": k2_launches,
            "max_abs_err": max(k2_errs),
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound[0],
            "bound_by": k2_bound[1],
            "library_ms": None,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
