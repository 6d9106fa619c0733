#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's main path — the Heston-QE European book (ten netting sets,
one ATM call each, maturities 0.1 .. 1.0) through ``SimulationController``
at 2^20 paths x 10 points x 4 substeps, forward and differentiated — and
checks every kernel on that path against its plain PyTorch version:

  1. take the card, print its name and power limit (nvidia-smi);
  2. build the kernels from the sources in this checkout (nvcc, sm_90a);
  3. compare the path kernel with its plain version on the card (hard,
     smoothed and noise-emitting variants) and time both;
  4. run the controller forward; PVs against the Heston characteristic-
     function price;
  5. run it differentiated; the kernel-path jacobian against the engine
     path's on the same Philox stream, d pv / d spot against a central
     difference of the closed form;
  6. print the kernels' JSON line and, last, the JSON result line.

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
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import dense_timeline

NUM_PATHS = 1 << 20
NUM_STEPS = 4
MATURITIES = tuple(round(0.1 * (i + 1), 10) for i in range(10))
MODEL_KW = dict(spot=100.0, rate=0.03, sigma=0.5, rho=-0.7, kappa=2.0, theta=0.06, v0=0.04)
SEED = 0
PHASE = mt.rng.PHASE_MAINSIM


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

    # 2. build
    built = cuda_build.load_library("heston_qe")
    how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
    print(f"[build] heston_qe: {how} -> {built.path.name}")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # 3. kernel vs plain version at the main path's shapes
    params32 = mt.params_from_numpy(
        [MODEL_KW[k] for k in ("spot", "sigma", "rate", "rho", "kappa", "theta", "v0")],
        device=device, dtype=torch.float32)
    dense, _ = dense_timeline(0.0, MATURITIES, NUM_STEPS)
    print(f"[kernel] heston_qe_paths at {NUM_PATHS} paths x {len(MATURITIES)} points x {NUM_STEPS} substeps")
    errs = [
        compare_kernel(params32, MATURITIES, NUM_STEPS, False, False, 0.9999),
        compare_kernel(params32, MATURITIES, NUM_STEPS, True, False, 1.0),
        compare_kernel(params32, dense, 1, True, True, 1.0),
    ]
    run_kernel = lambda: heston_qe_paths(params32, MATURITIES, NUM_PATHS, NUM_STEPS, seed=SEED, phase=PHASE)
    run_plain = lambda: heston_qe_paths_reference(params32, MATURITIES, NUM_PATHS, NUM_STEPS, seed=SEED, phase=PHASE)
    plain_ms = median_ms(run_plain)
    kernel_ms = median_ms(run_kernel)
    path_steps = NUM_PATHS * len(MATURITIES) * NUM_STEPS
    print(f"  kernel {kernel_ms:.3f} ms ({path_steps / kernel_ms * 1e3:.3e} path-steps/s), "
          f"plain {plain_ms:.3f} ms ({path_steps / plain_ms * 1e3:.3e} path-steps/s)")

    # 4. + 5. the main path: counts from here to the end of phase 5
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
    print(f"[controller forward] warm wall {fwd_s:.4f} s")
    for ns in netting_sets:
        pv = float(results.get_results(ns.name, "pv", evaluation_idx=0))
        se = float(results.get_mc_error(ns.name, "pv", evaluation_idx=0))
        cf = ns.products[0].compute_pv_analytically_heston(model)
        print(f"  {ns.name}: pv {pv:.6f} se {se:.6f} cf {cf:.6f} |pv-cf|/se {abs(pv - cf) / se:.2f}")
        check(np.isfinite(pv) and np.isfinite(se) and se > 0, f"{ns.name}: bad pv/se")
        check(abs(pv - cf) < 4 * se + 0.05, f"{ns.name}: pv {pv} vs cf {cf} (se {se})")

    emit_before = heston_qe_paths.emit_launches
    diff, model, netting_sets = controller(True)
    diff_results = diff.run_simulation()
    check(heston_qe_paths.emit_launches > emit_before, "differentiated run launched no emit kernel")

    def run_diff():
        nonlocal diff_results
        diff_results = diff.run_simulation()

    diff_s = wall_seconds(run_diff)
    print(f"[controller differentiated] warm wall {diff_s:.4f} s")
    launches = heston_qe_paths.launches  # main path only

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
    print(f"[controller differentiated, engine path] wall {plain_diff_s:.4f} s")
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

    # 6. result lines
    print(json.dumps({"kernels": [{
        "name": "heston_qe_paths",
        "route": "cuda",
        "source": "montecarlo_risk_engine_tpu_torch/csrc/heston_qe.cu",
        "replaces": "montecarlo_risk_engine_tpu/ops/pallas_paths.py:148",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
