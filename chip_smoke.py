#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

Drives the port's main paths through ``SimulationController`` at full size,
forward and differentiated, and checks every kernel on them against its
plain PyTorch version:

  * the Heston-QE European book (ten netting sets, one ATM call each,
    maturities 0.1 .. 1.0) at 2^20 paths x 10 points x 4 substeps, on the
    path kernel K1 (``heston_qe_paths``);
  * the north-star xVA book of ``benchmarks/north_star.py`` (one netting set
    of 5 Vasicek swaps and 5 Black-Scholes options, a CIR++ counterparty,
    MPoR 10/252, CVA + EPE + PFE(0.95) on ``linspace(0, 7, 29)``) at 1e6
    main and 1e6 pre-simulation paths, on the hybrid path kernel K2
    (``hybrid_paths``, Euler blocks bs, vasicek, cirpp);
  * the BS-multi European book of ``benchmarks/pv_european_book.py``
    (10,000 options over the four assets of a BlackScholesMulti, 2^20
    paths, ANALYTICAL, PV) on K2's exact bs_multi block, forward and
    differentiated at full size (the family batches' hinge sums);
  * the K2 routes of the other models: the 100-basket family of
    ``benchmarks/pv_large_book.py`` on the same model, a Hull-White bond, a
    Schwartz-2F call, standalone Black-Scholes, Vasicek and CIR++
    (stochastic and deterministic) books, and a mixed ModelConfig of
    BS-multi, Vasicek, Hull-White and deterministic CIR++;
  * the 50,000-product mixed PV book of ``benchmarks/pv_large_book.py``
    (Europeans, binaries, baskets, Asians, barriers, Americans, FlexiCalls
    and storage deals on the 4-asset BlackScholesMulti, 1,000 main and
    1,000 presim paths) on K2's exact bs_multi block, forward and
    differentiated, and family-batched against per-product; the products
    against their oracles (American puts against a CRR tree, barriers,
    binary and FlexiCall against closed forms, Asian call-put parity) on
    Black-Scholes, storage against a DP oracle on Schwartz-2F; and the
    5,000-product CVA book of ``benchmarks/cva_large_book.py`` (a ModelConfig
    of BS-multi and CIR++, EULER, CVA on 80 dates), forward and
    differentiated;
  * Hessians (``compute_higher_derivatives``), each on the kernel route and
    the engine route: the Heston book at full size (K1 emitted draws,
    forward branch), a Black-Scholes call (K2 bs exact; the JAX package's
    TPU-only test, tests/test_pallas_controller_tpu.py:195-240), the BS-multi
    book at its differentiated size (K2 bs_multi exact, reverse branch) and
    the north-star book cut in depth to 2^17 main and 2^17 presim paths
    (``HESS_NS_PATHS``; 1e6 would keep the smoke past its time, each row's
    peak memory is printed for the full-width run still to make); and the
    analytic route (EvaluationType.ANALYTICAL, gamma and vomma against the
    closed forms);
  * samplers and streaming: the north-star book at 16,777,216 main and
    131,072 presim paths with ``streaming=True`` (the engine and the
    streaming metric pipeline), forward and differentiated; streaming
    against the plane on one stream at 2^20; kernel-streaming AD on K2 at
    2^22 (cut from 2^24: 342 emitted rows and the frozen draws per phase,
    PERF.md section 4); the Heston book with ``sampler="sobol"`` and the
    Brownian bridge, a Black-Scholes call's Sobol error against the
    pseudo-random SE, and the BS-multi book with antithetic pairs;
  * path sharding: the north-star book on two ranks that share the card
    over gloo (``SimulationController(path_sharding=...)``, each rank on
    its own paths, K2 at its path offset and stride), forward at 1e6 + 1e6
    paths and differentiated at 2^18 + 2^18 in both jacobian modes, and
    forward on one rank over NCCL, each against one process;
  * the Heston-QE substep ladder K3 (``heston_ladder_paths``, nine rungs
    over K1's stages) through its decomposition tool,
    ``montecarlo_risk_engine_tpu_torch.tools.kernel_decomposition``, at the
    shapes of ``benchmarks/kernel_decomposition.py`` (1,000,000 paths x 10
    points x 4 substeps);
  * the 33 example scripts of ``examples_torch/`` (the port of
    ``examples/``), each through its ``main()`` at its own default size
    (20,000-200,000 paths, the sweeps as written), on K1 and K2 where their
    books reach them, and one north-star forward run traced through
    ``run_simulation(profile_dir=...)``.

Phases:

  1. take the card, print its name and power limit (nvidia-smi);
  2. build K1, K2 and K3 from the sources in this checkout, K2 once per
     block tuple the script launches (concurrent nvcc, sm_90a); print each
     kernel's ptxas frame and fail if ptxas reports a spill in any K1, K2
     or K3 kernel, or a stack frame over the 32 bytes of sincosf's
     reduction array; count each kernel's issued instructions per
     path-substep from the SASS (cuobjdump, ``ops/sass.py``) for its
     issue-slot time; fail unless K1's count, taken as its build before
     the shared QE header was counted (no nested loop a slow path), is
     within 4 instructions of that build's 414;
  3. compare each kernel with its plain version on the card at its main
     path's shapes, bitwise, and time the call (CUDA events, warm median
     of 5), the launch alone (events around the kernel's C call) and the
     wrapper's host time: K1; K2 and its table prologue on the north-star
     shapes; K2 on ragged and misaligned launches; K1, K2 and every K3
     rung under torch.cuda.set_sync_debug_mode("error"); the K2 ladder of
     every (block, scheme), the CVA book's bs_multi + cirpp tuple and the
     examples' vasicek + cirpp and vasicek + cirpp_det tuples (at
     cva_wwr_sweep's and cva_corporate_bond's shapes) included;
  3d. the substep ladder K3 (``k3_ladder``): every rung bitwise against
     its plain version, qe-full bitwise K1's states, qe-algebra within
     rtol 1e-5 / atol 1e-6 of qe-full on >= 99.99 % of paths (terminal
     means 1e-6), every QE rung's discounted terminal spot within 4 SE +
     0.05 of the spot; then its main path, the decomposition tool's run
     (single and marginal times, instructions per path-substep and what
     each rung adds), counts from 0 and read, and each rung's split;
  3e. K1 (forward and noise-emitting) and K2 at the north-star shapes at
     path (offset, stride) (0, 2), (1, 2) and (1, 4) under
     set_sync_debug_mode("error"): bitwise the whole launch's strided
     columns and the plain version at the same offset and stride
     (``strided_launches``);
  3f. the forward-mode reconstruction kernel (csrc/recon_tangents.cu) at
     the north-star shapes on the main phase's frozen draws: its builds
     gated on ptxas (no spill), the primal and both sweeps' tangent planes
     bitwise its plain version's, call / launch-only / wrapper beside the
     byte bound; then a differentiated north-star run with the route on and
     off: its launches counted by tangent count (4 primal, 2 of 8 and 2 of
     3 tangents), values and jacobian within 1e-10 (``recon_phase``);
     3g and 3h: the storage and equity exercise scan kernels;
  3i. the forward-mode Heston QE reconstruction kernel (csrc/qe_tangents.cu)
     at the Heston surface's shapes on K1's emitted draws: its builds gated
     on ptxas, the primal and 7-tangent planes against its plain version
     (at most 2 ulps apart; bitwise so far), call / launch-only / wrapper
     beside its bound; then the differentiated surface with the route on
     and off: one primal and one 7-tangent launch a run, values and
     jacobian within 1e-12 (``qe_tangents_phase``);
  4. BS-multi European book: counts to 0, forward (one K2 launch per run)
     and differentiated runs, counts read; PV against the sum of the
     marginals' closed forms, deltas and vegas against theirs, the
     jacobian against the engine route's on the same stream;
  5. Heston book: counts to 0, forward and differentiated runs, counts
     read (K1's, and the forward-mode QE reconstruction kernel's: a primal
     and a 7-tangent launch a differentiated run); PVs against the
     characteristic-function price, the kernel-route
     jacobian against the engine route's on the same Philox stream, the 1y
     delta against a central difference of the closed form;
  6. north-star book: counts to 0, forward and differentiated runs, counts
     read (K2 and its prologue: one launch each per phase, two per run);
     CVA against the JAX package's 16M-path value, EPE and PFE printed, the
     kernel-route values and CVA/EPE jacobian against the engine route's
     on the same stream;
  6b. the sharded north star (``sharded_north_star``): one process's runs
     first (forward at 1e6, differentiated at 2^18 in fwd and rev mode),
     then two rank processes of this file (``--shard-rank``) on the card
     over gloo, a FileStore in a temporary directory, then one over NCCL
     (forward): each rank counts its own launches from 0 (one K2 and one
     prologue launch per phase per run) and prints its warm walls, peak
     memory and its collectives' share of the host time; every rank's CVA,
     EPE and PFE bitwise one process's, their errors within 1 ulp, the
     jacobians within rtol 1e-8; a rank that fails fails the smoke;
  7. the other K2 routes, each with its counts from 0 and its own oracle;
  7a. kernel-streaming AD on K2 at 2^22, with the card to itself, its
     counts from 0 (one K2 and one prologue launch per phase), against the
     engine's streaming route fed the kernel's draws (values 1e-4,
     jacobians rtol 1e-3, atol 1e-6);
  7b. the mixed book (forward cold and warm; one netting set per
     family differentiated on both routes: the book's PV 1e-4, its
     jacobian rtol 1e-3, the families that miss printed; one netting set
     per family forward, batched against per-product on the same K2
     draws: the book's PV 1e-9, each family printed), the product oracles
     (the down-and-out barrier against the textbook closed form within
     max(6 SE, 1 %)), the storage scenarios and the storage scan against
     its unrolled path, and the full CVA book (forward cold and warm,
     differentiated in reverse mode; kernel vs engine route: CVA 1e-4, its
     jacobian rtol 1e-3, atol 1e-6), each with its counts from 0;
  7c. in a second process on the same card (``--hessians-only``), started
     before 7b and run beside it, its output printed after 7b: Hessians,
     each with its counts from 0 (exactly one K1 or K2 launch,
     and one prologue launch, per simulation phase for the whole run): the
     Heston, BS-multi and north-star books, kernel route against the engine
     route on the kernel's own draws (rtol 1e-3, atol 1e-6, every metric),
     symmetric to 1e-8; the BS call's pathwise gamma exactly 0, its vomma
     and cross term against the engine at half the paths, and the engine on
     the same stream and paths within rtol 1e-3; the Hessian walls, peak
     memory and each row's wall and peak printed; the analytic route's
     gamma and vomma against the closed forms to 1e-9; then, in the same
     process, the other samplers and streaming phases: the north star at
     16,777,216 paths, forward (cold and warm) and differentiated with the
     metric stream on (CVA against the JAX 16M value within 4 combined SE,
     else 1 %; the peak below the plane route's own estimate; finite
     derivatives); at 2^20 the metric stream and emission alone against
     the plane (values rtol 1e-10, jacobians rtol 1e-8, atol 1e-12) and the
     BS-multi book streaming against the plane (1e-10); the Sobol and
     bridge Heston books (4 SE + 0.05 of the CF), the BS call's Sobol error
     below the pseudo-random SE, the antithetic BS-multi book (4 SE; deltas
     and vegas 2 %), each differentiated once;
  7d. the examples (``examples_phase``), after 7c, with the card to
     itself: every script of examples_torch/ twice at its own size (a cold
     run, then the warm run whose wall is printed and whose launches are
     counted from 0 just before it), its own asserts, and beside them:
     pv_heston_convergence's QE PVs within 4 SE + 0.05 of the
     characteristic-function price at substeps up to 0.25 y (PERF.md
     section 2's Heston rule), the QE error not growing as substeps are
     added (2 combined SE), one K1 launch per QE run,
     sabr_calibration's fits (vol error < 1e-8, each parameter within
     5e-3 max(1, |x|)), pv_basket_option's control variate (se_cv <
     se_plain), pv_second_derivatives' gamma and vomma > 0, and K2's count
     rising in every script whose books ``EXAMPLES`` puts on K2; one line
     per script (warm wall, launches, headline value); then one north-star
     forward run with ``run_simulation(profile_dir=...)``: the trace holds
     K2's kernel by its CUDA symbol (``hybrid_kernel``), and the values
     equal the unprofiled run's bit for bit;
  8. print the card line, the kernels' JSON line and, last, the JSON result
     line.

The Hessian rows are host-bound (second-order forward mode dispatches
every op through two tangent levels), so 7c takes ~7 minutes of host time;
run beside 7b, whose books are host-bound too, it leaves the smoke inside
its time limit (the walls of both carry the other's load on the card).

``--split-only`` runs only the call / launch-only / wrapper split of K1
and K2 at the main paths' shapes, K1's substep loop by opcode, the warm
walls of the three books and of the CVA and mixed books and the north-star
forward run's host profile, for the package beside this file
(``--books-only``: K1's opcodes and the CVA and mixed books' walls alone);
a copy of the file run from another checkout's root measures that tree
the same way (parent and change in turns, in one call).

Any failure raises and the script exits non-zero.  Without CUDA it exits
non-zero and prints no result.  Run from the repository root:

    python3 chip_smoke.py [--split-only [--books-only] | --hessians-only | --examples-only
                           | --recon-only | --storage-scan-only | --exercise-scan-only
                           | --qe-tangents-only]

(``--examples-only``: phase 7d alone, after building K1 and K2;
``--recon-only``: phase 3f alone; ``--storage-scan-only``: phase 3g alone;
``--exercise-scan-only``: phase 3h alone; ``--qe-tangents-only``: phase 3i
alone, the Heston QE reconstruction kernel.)

(``--shard-rank r --world R --store F --backend gloo|nccl --out D`` is one
rank of phase 6b, started by the smoke itself.)
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.func import jvp, vmap

import montecarlo_risk_engine_tpu_torch as mt
from montecarlo_risk_engine_tpu_torch import tracing
from montecarlo_risk_engine_tpu_torch.helpers.cs_helper import probability_of_default
from montecarlo_risk_engine_tpu_torch.ops import cuda_build
from montecarlo_risk_engine_tpu_torch.ops import hybrid_paths as k2_module
from montecarlo_risk_engine_tpu_torch.ops import (
    exercise_scan, qe_tangents, recon_tangents, storage_scan,
)
from montecarlo_risk_engine_tpu_torch.ops.heston_qe import (
    heston_qe_paths,
    heston_qe_paths_reference,
)
from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
    CIRPP,
    CIRPP_DET,
    GBM_EULER,
    GBM_EXACT,
    HW_EULER,
    HW_EXACT,
    S2F_X_EULER,
    S2F_X_EXACT,
    S2F_Y_EULER,
    S2F_Y_EXACT,
    VAS_EULER,
    VAS_EXACT,
    hybrid_paths,
    hybrid_paths_reference,
    kernel_slots,
)
from montecarlo_risk_engine_tpu_torch.ops.heston_ladder import (
    RUNGS,
    heston_ladder_paths,
    heston_ladder_paths_reference,
)
from montecarlo_risk_engine_tpu_torch.ops.paths_ad import dense_timeline
from montecarlo_risk_engine_tpu_torch.ops.sass import HBM_BYTES_PER_S, IssueSlots, ptxas_frames
from montecarlo_risk_engine_tpu_torch.requests import AtomicRequest, AtomicRequestType
from montecarlo_risk_engine_tpu_torch.tools import kernel_decomposition as k3_tool

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

# BS-multi European book (benchmarks/pv_european_book.py:37-64).
EURO_OPTIONS = 10_000
ASSETS = tuple(f"asset_{i}" for i in range(4))

# Device peaks for the bounds (NVIDIA H100 SXM data sheet; the memory rate
# HBM_BYTES_PER_S in ops/sass.py).
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12  # outside the tensor cores
# Operations per path-substep counted from the sources, one per float or
# integer add, multiply, compare, select, conversion, division or
# transcendental call (a lower bound on the issue slots):
#   K1 (csrc/heston_qe.cu): Philox4x32-10 98 (10 rounds of 2 mul.hi, 2 mul.lo,
#   4 xor; 9 key bumps of 2 adds), 3 uniforms x 5, one Box-Muller pair 8,
#   the QE update 52 -> 173.
#   K2 (csrc/hybrid_paths.cu): k2_ops() below, from the same rules.
K1_OPS_PER_SUBSTEP = 173
PHILOX_OPS, UNIFORM_OPS, BM_PAIR_OPS, BM_COS_OPS = 98, 5, 8, 6
# K1 before its QE update moved into csrc/heston_qe_step.cuh (NVIDIA H100
# 80GB HBM3, 700.00 W): 414 instructions per path-substep by the count of
# that time, which took only local-memory and CALL regions for slow paths
# (substep_loop(nested_loops=False) in ops/sass.py; 110 of them are the
# sincos reduction that ptxas keeps in registers), and its launch-only
# times.  The header must leave K1 as it was: this build, counted by the
# same rule, within K1_SASS_SLACK instructions of it.
K1_SASS_BEFORE, K1_SASS_SLACK, K1_LAUNCH_MS_BEFORE = 414, 4, "0.506-0.546"
#   K3 (csrc/heston_ladder.cu), per rung, from the same rules: the QE update
#   52 (K1's 173 less its draws; the division-reduced update drops the psi
#   division and adds the multiply of s2 > 1.5 m2), an inverse-CDF normal 27
#   on its central branch (w < 5: 99.66 % of the uniforms; the tail branch
#   adds a sqrtf), the trivial consumptions 5 (box-muller, icdf) and 4
#   (no-draws), the raw bits' two xors, conversion, multiply and two adds 6;
#   the batched rungs take 3/4 of a Philox call a substep.
QE_UPDATE_OPS, ICDF_OPS = 52, 27
K3_OPS_PER_SUBSTEP = {
    "no-draws": 4,
    "raw-bits-x3": PHILOX_OPS + 6,
    "box-muller": PHILOX_OPS + 3 * UNIFORM_OPS + BM_PAIR_OPS + 5,
    "icdf": PHILOX_OPS + 3 * UNIFORM_OPS + 2 * ICDF_OPS + 5,
    "qe-full": PHILOX_OPS + 3 * UNIFORM_OPS + BM_PAIR_OPS + QE_UPDATE_OPS,
    "qe-icdf": PHILOX_OPS + 3 * UNIFORM_OPS + 2 * ICDF_OPS + QE_UPDATE_OPS,
    "qe-batched-prng": PHILOX_OPS * 0.75 + 3 * UNIFORM_OPS + BM_PAIR_OPS + QE_UPDATE_OPS,
    "qe-algebra": PHILOX_OPS + 3 * UNIFORM_OPS + BM_PAIR_OPS + QE_UPDATE_OPS,
    "qe-combined": PHILOX_OPS * 0.75 + 3 * UNIFORM_OPS + BM_PAIR_OPS + QE_UPDATE_OPS,
}
# K2 slot updates per substep (the switch in csrc/hybrid_paths.cu); an
# exact GBM slot adds one expf per emitted point.
K2_ROLE_OPS = {GBM_EXACT: 8, GBM_EULER: 7, VAS_EXACT: 7, VAS_EULER: 9, CIRPP: 14,
               CIRPP_DET: 2, HW_EXACT: 7, HW_EULER: 10, S2F_X_EXACT: 3, S2F_X_EULER: 6,
               S2F_Y_EXACT: 9, S2F_Y_EULER: 10}


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


def controller(differentiate: bool, use_kernel="auto", noise_source=None, **kw):
    model, netting_sets = slice_book()
    return mt.SimulationController(
        netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), NUM_PATHS, 0, NUM_STEPS,
        mt.SimulationScheme.QE, differentiate=differentiate, root_seed=SEED,
        use_kernel=use_kernel, device="cuda", noise_source=noise_source, **kw,
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


def north_star(num_paths: int, differentiate: bool, use_kernel="auto", num_paths_presim=None,
               grad_chunk_size: int = 8, noise_source=None, **kw):
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
        differentiate=differentiate, grad_chunk_size=grad_chunk_size, use_kernel=use_kernel,
        device="cuda", noise_source=noise_source, **kw)


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


def split_ms(symbol, run, reps: int = 5):
    """(launch-only, wrapper host) ms of one wrapper call, warm medians of
    ``reps`` runs.  ``cuda_build.bind``, which returns a kernel's C
    function, is wrapped for the duration, and the C function ``symbol``
    with it: launch-only is CUDA events recorded just before and after that
    C call, its inputs prepared; wrapper is the host clock from the call's
    start to that C call, with no sync inside.  The same code measures any
    tree whose wrappers bind their kernels through ``cuda_build.bind`` at
    each call."""
    real = cuda_build.bind
    mark = {}

    def timed_bind(lib, name, argtypes):
        fn = real(lib, name, argtypes)
        if name != symbol:
            return fn

        def timed(*args):
            mark["host"] = time.perf_counter() - mark["t0"]
            mark["start"].record()
            rc = fn(*args)
            mark["end"].record()
            return rc

        return timed

    cuda_build.bind = timed_bind
    launch, host = [], []
    try:
        for i in range(reps + 1):
            mark["start"] = torch.cuda.Event(enable_timing=True)
            mark["end"] = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            mark["t0"] = time.perf_counter()
            run()
            torch.cuda.synchronize()
            if i:  # the first run is the warm-up
                launch.append(mark["start"].elapsed_time(mark["end"]))
                host.append(mark["host"] * 1e3)
    finally:
        cuda_build.bind = real
    return statistics.median(launch), statistics.median(host)


def call_split(label, symbol, run, bound_ms=None, issue_ms=None):
    """Call, launch-only and wrapper time of one kernel's wrapper (its C
    function ``symbol``), printed on a [time] line; returns the three."""
    ms = median_ms(run)
    launch_ms, wrapper_ms = split_ms(symbol, run)
    extra = "" if bound_ms is None else f", bound {bound_ms:.4f} ms"
    extra += "" if issue_ms is None else f", issue-slot {issue_ms:.4f} ms"
    print(f"[time] {label}: call {ms:.4f} ms, launch-only {launch_ms:.4f} ms, "
          f"wrapper {wrapper_ms:.4f} ms (host){extra}")
    return ms, launch_ms, wrapper_ms


def wall_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def compare_kernel(params, timeline, steps, smoothing, emit, min_close, bitwise=True):
    """Kernel vs plain version on the card; returns the max abs state error.
    ``bitwise``: the states must equal the plain version's exactly."""
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
        check(not bitwise or torch.equal(out[1], ref[1]), f"{label}: normals not bitwise")
        out, ref = out[0], ref[0]
    check(bool(torch.isfinite(out).all()), f"{label}: non-finite states")
    close = torch.isclose(out, ref, rtol=1e-5, atol=1e-6).all(dim=-1).all(dim=0)
    frac = float(close.double().mean())
    err = float((out - ref).abs().max())
    mean_k = out[-1].double().mean(dim=0)
    mean_r = ref[-1].double().mean(dim=0)
    mean_rel = float(((mean_k - mean_r).abs() / mean_r.abs()).max())
    same = torch.equal(out, ref)
    print(f"  {label}: paths within rtol 1e-5/atol 1e-6 {frac:.6f}, max abs err {err:.3e}, "
          f"rel err of mean (log S_T, v_T) {mean_rel:.3e}, bitwise {same}")
    check(frac >= min_close, f"{label}: only {frac:.6f} of paths agree")
    check(mean_rel <= 1e-6, f"{label}: terminal means differ by {mean_rel:.3e}")
    check(not bitwise or same, f"{label}: states not bitwise equal to the plain version")
    return err


def compare_hybrid(label, blocks, chol, params, timeline, steps, phase, num_paths):
    """K2 vs its plain version on the card, bitwise; returns (max abs state
    error, bitwise)."""
    out = hybrid_paths(blocks, chol, params, timeline, num_paths, steps, seed=SEED, phase=phase)
    ref = hybrid_paths_reference(blocks, chol, params, timeline, num_paths, steps, seed=SEED,
                                 phase=phase)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"K2 {label}: non-finite states")
    bitwise = torch.equal(out, ref)
    close = torch.isclose(out, ref, rtol=1e-5, atol=1e-6).all(dim=-1).all(dim=0)
    frac = float(close.double().mean())
    err = float((out - ref).abs().max())
    mean_k, mean_r = out[-1].double().mean(dim=0), ref[-1].double().mean(dim=0)
    mean_rel = float(((mean_k - mean_r).abs() / mean_r.abs().clamp(min=1e-30)).max())
    print(f"  {label}: states bitwise {bitwise}, paths within rtol 1e-5/atol 1e-6 {frac:.6f}, "
          f"max abs err {err:.3e}, rel err of terminal means {mean_rel:.3e}")
    check(frac >= 0.9999, f"K2 {label}: only {frac:.6f} of paths agree")
    check(mean_rel <= 1e-6, f"K2 {label}: terminal means differ by {mean_rel:.3e}")
    check(bitwise, f"K2 {label}: states not bitwise equal to the plain version")
    return err, bitwise


def compare_table(label, blocks, params, timeline, steps):
    """K2's table prologue vs its plain version (substep_table,
    initial_state, the parameters rounded to float32) on the card, bitwise;
    a column that differs is named with its largest gap in float32 ulps.
    Returns (the prologue's table, the largest absolute gap of its three
    outputs)."""
    from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
        hybrid_table, initial_state, substep_table)

    table, prm, init = hybrid_table(blocks, params, timeline, steps)
    plain = (substep_table(blocks, params, timeline, steps),
             torch.stack(params).detach().to(torch.float32), initial_state(blocks, params))
    torch.cuda.synchronize()
    err = 0.0
    for name, k, p in zip(("table", "parameters", "initial state"), (table, prm, init), plain):
        err = max(err, float((k.double() - p.double()).abs().max()))
        if not torch.equal(k, p):
            ulps = (k.view(torch.int32).long() - p.view(torch.int32).long()).abs()
            cols = ulps.reshape(len(k), -1).amax(dim=0).tolist() if k.dim() > 1 else ulps.tolist()
            print(f"  {label}: prologue {name} differs from the plain version, ulps by column {cols}")
        check(torch.equal(k, p), f"K2 {label}: the prologue's {name} is not bitwise")
    return table, err


def k2_ops(blocks, chol, timeline, steps: int, num_paths: int) -> float:
    """Operations of one K2 run counted from the source: per path-substep
    the Philox calls, the uniforms and Box-Muller pairs of the sim_dim
    normals, the non-zero Cholesky products and their sums, the slot
    updates; per emitted point one expf per exact GBM slot."""
    slots, _, _ = kernel_slots(blocks)
    n = len(slots)
    nnz = int(np.count_nonzero(np.tril(np.asarray(chol))))
    per_substep = (PHILOX_OPS * -(-n // 4) + UNIFORM_OPS * 2 * -(-n // 2)
                   + BM_PAIR_OPS * (n // 2) + BM_COS_OPS * (n % 2) + nnz + (nnz - n)
                   + sum(K2_ROLE_OPS[sl.role] for sl in slots))
    per_point = sum(sl.role == GBM_EXACT for sl in slots)
    return num_paths * (live_substeps(timeline, steps) * per_substep + len(timeline) * per_point)


def k2_rung(label, blocks, chol, params, timeline, steps, num_paths=NUM_PATHS, phase=PHASE,
            issue=None):
    """One rung of the K2 ladder: the table prologue and the kernel vs their
    plain versions, the call and its split timed, the plain version timed,
    the bound and (with ``issue``) the issue-slot time; returns the row of
    the kernels' JSON line (launches filled in by the main path that runs
    it)."""
    compare_table(label, blocks, params, timeline, steps)
    err, bitwise = compare_hybrid(label, blocks, chol, params, timeline, steps, phase, num_paths)
    run = lambda: hybrid_paths(blocks, chol, params, timeline, num_paths, steps, seed=SEED,
                               phase=phase)
    run_plain = lambda: hybrid_paths_reference(blocks, chol, params, timeline, num_paths, steps,
                                               seed=SEED, phase=phase)
    plain_ms = median_ms(run_plain, reps=3)  # seconds a run on the slowest rungs
    state_dim = kernel_slots(blocks)[1]
    substeps = num_paths * live_substeps(timeline, steps)
    t_bound, by = bound(len(timeline) * num_paths * state_dim * 4,
                        k2_ops(blocks, chol, timeline, steps, num_paths))
    issue_ms = None if issue is None else issue.slot_ms(
        f"K2 {label}", cuda_build.load_library("hybrid_paths", k2_module.role_flags(blocks)),
        "hybrid_kernelILb1E" if num_paths * state_dim % 4 == 0 else "hybrid_kernelILb0E",
        substeps)
    ms, launch_ms, wrapper_ms = call_split(f"K2 {label}", "mcre_hybrid_paths", run, t_bound,
                                           issue_ms)
    print(f"    [{len(timeline)} points x {steps} substeps, D={state_dim}] call {ms:.4f} ms "
          f"({substeps / ms * 1e3:.3e} path-steps/s), plain {plain_ms:.3f} ms, bound "
          f"{t_bound:.4f} ms by {by} ({t_bound / ms:.1%} of it reached by the call, "
          f"{t_bound / launch_ms:.1%} by the launch)")
    return {"name": f"hybrid_paths[{label}]", "route": "cuda",
            "source": "montecarlo_risk_engine_tpu_torch/csrc/hybrid_paths.cu",
            "replaces": "montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
            "launch_ms": launch_ms, "wrapper_ms": wrapper_ms}


# float64 operations per table row of each prologue column group, counted
# from csrc/hybrid_paths.cu table_kernel (one per add, multiply, division,
# exp, sqrt, compare or select), and one conversion per float32 column.
TABLE_GROUP_OPS = {0: 10, 1: 31, 2: 0, 3: 20, 4: 30, 5: 4, 6: 21}


def table_row(blocks, params, timeline, steps):
    """The table prologue's row of the kernels' JSON line: its call and
    split against its plain version (substep_table, initial_state and the
    float32 parameters) at the given shapes."""
    from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import (
        _table_groups, hybrid_table, initial_state, substep_table, table_inputs)

    run = lambda: hybrid_table(blocks, params, timeline, steps)
    run_plain = lambda: (substep_table(blocks, params, timeline, steps),
                         torch.stack(params).detach().to(torch.float32),
                         initial_state(blocks, params))
    table, err = compare_table("table prologue", blocks, params, timeline, steps)
    plain_ms = median_ms(run_plain)
    rows, width = table.shape
    host_width = table_inputs(tuple(blocks), tuple(timeline), steps, 0.0,
                              params[0].device).host.shape[1]
    n_par, dim = len(params), kernel_slots(blocks)[1]
    nbytes = rows * host_width * 8 + n_par * 8 + (rows * width + n_par + dim) * 4
    ops = rows * (width + sum(TABLE_GROUP_OPS[g[0]] for g in _table_groups(blocks))) + n_par + dim
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP64_OPS_PER_S * 1e3
    t_bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    ms, launch_ms, wrapper_ms = call_split("K2 table prologue", "mcre_hybrid_table", run,
                                           t_bound)
    print(f"    [{rows} rows x {width} columns] plain {plain_ms:.3f} ms")
    return {"name": "hybrid_table", "route": "cuda",
            "source": "montecarlo_risk_engine_tpu_torch/csrc/hybrid_paths.cu",
            "replaces": "montecarlo_risk_engine_tpu/ops/pallas_hybrid.py:153",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
            "launch_ms": launch_ms, "wrapper_ms": wrapper_ms}


def blocks_of(c):
    """(K2 blocks, static correlation) of a controller's model."""
    m = c.model
    if isinstance(m, mt.ModelConfig):
        return m.kernel_blocks(), m.static_joint_correlation()
    return [m.kernel_block(c.simulation_scheme)], m.kernel_correlation()


def model_rung(label, c, device, issue=None, phase=PHASE):
    """The ladder rung of a controller's K2 run at its own shapes: its
    model's blocks, scheme, timeline and substeps, float32 parameters."""
    blocks, corr = blocks_of(c)
    params = c.model.initial_params(device=device, dtype=torch.float32)
    return k2_rung(label, blocks, np.linalg.cholesky(corr), params, c.simulation_timeline,
                   c.num_steps, c.num_paths_mainsim, phase, issue)


def heston_main_path(device):
    """Phase 5: the Heston book; returns K1's launches in it.  Its
    differentiated runs (forward mode, P = 7 < V = 10) rebuild the plane by
    the forward-mode Heston QE kernel (ops/qe_tangents.py): a primal and a
    7-tangent launch a run, counted from 0 here."""
    heston_qe_paths.launches = 0
    heston_qe_paths.emit_launches = 0
    qe_tangents.qe_planes.launches.clear()

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
    check(diff._recon_kernel() is qe_tangents, "the differentiated book is off its rebuild kernel")
    per_run = {0: 1, 7: 1}
    check(qe_tangents.qe_planes.launches == per_run,
          f"qe_tangents launched {dict(qe_tangents.qe_planes.launches)} in a run, not {per_run}")

    def run_diff():
        nonlocal diff_results
        diff_results = diff.run_simulation()

    diff_s = wall_seconds(run_diff)
    print(f"[heston differentiated] warm wall {diff_s:.4f} s ({diff._grad_mode_resolved} mode), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = heston_qe_paths.launches  # this main path only
    print(f"  K1 launches: {launches} (forward 1 per run, differentiated 1 per run)")
    check(qe_tangents.qe_planes.launches == {k: 2 * n for k, n in per_run.items()},
          f"qe_tangents launched {dict(qe_tangents.qe_planes.launches)} in two runs")
    print(f"  qe_tangents launches a differentiated run by tangent count: {per_run}")

    # Reconstruction primal (the qe_tangents kernel's primal launch) vs K1's
    # own states (f32 rounding).
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


def ns_values(results):
    get = lambda metric: (np.asarray(results.get_results("north_star", metric)),
                          np.asarray(results.get_mc_error("north_star", metric)))
    return {m: get(m) for m in (f"cva[{CP}]", "epe", "pfe[0.95]")}


def ns_jacobian(results, metric):
    return np.asarray(results.get_derivatives("north_star", metric))  # [evals, P]


def north_star_main_path():
    """Phase 6: the north-star book; returns K2's launches in it."""
    reset_k2_counts()
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


# -- path sharding --------------------------------------------------------------------

SHARD_WORLD = 2                # ranks sharing the card over gloo
SHARD_PATHS = NS_PATHS         # forward: main and presim paths
SHARD_DIFF_PATHS = 1 << 18     # differentiated, both jacobian modes, cut from 1e6
SHARD_CHUNK = 16               # tangents (fwd) or cotangents (rev) a sweep: P = 11, V = 59
SHARD_TIMEOUT_S = 420


def strided_launches(k1_params, k2_args):
    """Phase 3e: K1 (forward and noise-emitting) and K2 at the north-star
    shapes launched at (path offset r, stride R) = (0, 2), (1, 2) and (1, 4),
    under set_sync_debug_mode("error"): each equal to the whole launch's
    [:, r::R] columns bitwise, and to its plain version at the same offset
    and stride bitwise."""
    blocks, chol, params, dense, n_k2, steps = k2_args
    k1_dense, _ = dense_timeline(0.0, MATURITIES, NUM_STEPS)
    k1_runs = {
        "K1": lambda fn, n, **kw: fn(k1_params, MATURITIES, n, NUM_STEPS, seed=SEED, phase=PHASE,
                                     **kw),
        "K1 emit": lambda fn, n, **kw: fn(k1_params, k1_dense, n, 1, seed=SEED, phase=PHASE,
                                          emit_noise=True, **kw),
    }
    runs = {**{name: (run, heston_qe_paths, heston_qe_paths_reference, NUM_PATHS)
               for name, run in k1_runs.items()},
            "K2": (lambda fn, n, **kw: fn(blocks, chol, params, dense, n, steps, seed=SEED,
                                          phase=PHASE, **kw),
                   hybrid_paths, hybrid_paths_reference, n_k2)}
    for name, (run, kernel, plain, n) in runs.items():
        whole = run(kernel, n)
        whole = whole if isinstance(whole, tuple) else (whole,)
        for offset, stride in ((0, 2), (1, 2), (1, 4)):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                part = run(kernel, n // stride, path_offset=offset, path_stride=stride)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            ref = run(plain, n // stride, path_offset=offset, path_stride=stride)
            part = part if isinstance(part, tuple) else (part,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for w, p, q in zip(whole, part, ref):
                check(torch.equal(p, w[:, offset::stride]),
                      f"{name} at offset {offset}, stride {stride}: not the whole launch's columns")
                check(torch.equal(p, q),
                      f"{name} at offset {offset}, stride {stride}: not its plain version")
            del part, ref
        del whole
        print(f"[strided] {name} at (offset, stride) (0, 2), (1, 2), (1, 4), {n} paths: bitwise the "
              f"whole launch's columns and the plain version's, no host sync")
    torch.cuda.empty_cache()


def shard_results(c, results, key):
    """The north star's values, errors and, if differentiated, jacobian."""
    names = (f"cva[{CP}]", "epe", "pfe[0.95]")
    out = {f"{key}.values": np.concatenate([np.atleast_1d(results.get_results("north_star", m))
                                            for m in names]),
           f"{key}.errors": np.concatenate([np.atleast_1d(results.get_mc_error("north_star", m))
                                            for m in names])}
    if c.differentiate:
        out[f"{key}.jac"] = np.concatenate([ns_jacobian(results, m) for m in names])
    return out


def shard_rank_main(argv):
    """``--shard-rank r --world R --store F --backend gloo|nccl --out D``: one
    rank of phase 6b on card 0.  Runs the north star on its share of the
    paths, forward at SHARD_PATHS (cold, then two warm runs) and, with gloo,
    differentiated at SHARD_DIFF_PATHS in both jacobian modes; checks one K2
    and one prologue launch per phase per run; writes its results, walls,
    peak memory and collectives' host time to ``D/rank<r>.npz``."""
    from montecarlo_risk_engine_tpu_torch.parallel import collectives, distributed

    opts = dict(zip(argv[::2], argv[1::2]))
    rank, world, backend = int(opts["--shard-rank"]), int(opts["--world"]), opts["--backend"]
    card()
    store = torch.distributed.FileStore(opts["--store"], world)
    sharding = distributed.initialize_and_make_sharding(
        rank, world, store=store, device="cuda:0", shared_device=backend == "gloo")
    check(torch.distributed.get_backend() == backend, f"rank {rank} runs {torch.distributed.get_backend()}")
    out, stats = {}, {}
    try:
        runs = [("forward", SHARD_PATHS, False, "auto")]
        if backend == "gloo":
            runs += [("fwd", SHARD_DIFF_PATHS, True, "fwd"), ("rev", SHARD_DIFF_PATHS, True, "rev")]
        for key, n, diff, mode in runs:
            c = north_star(n, diff, path_sharding=sharding, grad_mode=mode,
                           grad_chunk_size=SHARD_CHUNK)
            check(c._kernel_active, f"rank {rank}: the sharded north star is off the kernel route")
            reset_k2_counts()
            results = c.run_simulation()
            check(hybrid_paths.launches == 2 and k2_module.hybrid_table.launches == 2,
                  f"rank {rank} {key}: {hybrid_paths.launches} K2 and "
                  f"{k2_module.hybrid_table.launches} prologue launches, not one each per phase")
            torch.cuda.reset_peak_memory_stats()
            collectives.reset_stats()
            walls = []
            for _ in range(2 if key == "forward" else 1):
                walls.append(wall_seconds(lambda: c.run_simulation()))
            stats[key] = dict(walls=walls, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                              collective_calls=collectives.stats["calls"] / len(walls),
                              collective_s=collectives.stats["seconds"] / len(walls),
                              mode=c._grad_mode_resolved if diff else "forward")
            out.update(shard_results(c, results, key))
            del c, results
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    np.savez(os.path.join(opts["--out"], f"rank{rank}.npz"), **out)
    with open(os.path.join(opts["--out"], f"rank{rank}.json"), "w") as f:
        json.dump(stats, f)


def launch_shard_ranks(world, backend, out_dir):
    """Start ``world`` rank processes of this file on card 0 (a FileStore in
    ``out_dir``) and wait for them; a rank that fails fails the smoke."""
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard-rank", str(r), "--world", str(world),
         "--store", os.path.join(out_dir, "store"), "--backend", backend, "--out", out_dir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=SHARD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"{backend} rank {r} of {world} failed (exit {p.returncode}):\n"
                                 f"{log[-6000:]}")
    return [(dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))),
             json.load(open(os.path.join(out_dir, f"rank{r}.json")))) for r in range(world)]


def within_ulps(a, b, ulps: int) -> bool:
    return bool(np.all(np.abs(a - b) <= ulps * np.spacing(np.maximum(np.abs(a), np.abs(b)))))


def sharded_north_star():
    """Phase 6b: the north star on two ranks that share the card over gloo
    (forward at SHARD_PATHS, differentiated at SHARD_DIFF_PATHS in both
    jacobian modes), then forward on one rank over NCCL, against one process
    on the same stream: values bitwise, errors within 1 ulp, jacobians rtol
    1e-8; each rank one K2 and one prologue launch per phase."""
    import tempfile

    one, walls1 = {}, {}
    for key, n, diff, mode in (("forward", SHARD_PATHS, False, "auto"),
                               ("fwd", SHARD_DIFF_PATHS, True, "fwd"),
                               ("rev", SHARD_DIFF_PATHS, True, "rev")):
        c = north_star(n, diff, grad_mode=mode, grad_chunk_size=SHARD_CHUNK)
        results = c.run_simulation()
        torch.cuda.reset_peak_memory_stats()
        walls1[key] = (wall_seconds(lambda: c.run_simulation()),
                       torch.cuda.max_memory_allocated() / 2**30)
        one.update(shard_results(c, results, key))
        del c, results
        torch.cuda.empty_cache()
    for backend, world in (("gloo", SHARD_WORLD), ("nccl", 1)):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ranks = launch_shard_ranks(world, backend, tmp)
            print(f"[sharded north star] {world} rank(s) over {backend} on one card: "
                  f"{time.perf_counter() - t0:.1f} s with start-up")
        for r, (res, stats) in enumerate(ranks):
            for key, st in stats.items():
                wall = statistics.median(st["walls"])
                print(f"  rank {r} {key} ({st['mode']}): warm wall {wall:.4f} s (one process "
                      f"{walls1[key][0]:.4f} s), peak {st['peak_gib']:.2f} GiB (one process "
                      f"{walls1[key][1]:.2f} GiB), {st['collective_calls']:.0f} collectives "
                      f"{st['collective_s']:.4f} s = {st['collective_s'] / wall:.1%} of the wall")
            for field, want in one.items():
                key = field.split(".")[0]
                if key not in stats:
                    continue
                got = res[field]
                check(got.shape == want.shape, f"rank {r} {field}: shape {got.shape}")
                if field.endswith(".values"):
                    gap = float(np.max(np.abs(got - want)))
                    check(np.array_equal(got, want), f"{backend} rank {r} {field}: not bitwise "
                                                     f"one process's (max gap {gap:.3e})")
                elif field.endswith(".errors"):
                    check(within_ulps(got, want, 1), f"{backend} rank {r} {field}: beyond 1 ulp")
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12,
                                               err_msg=f"{backend} rank {r} {field}")
        print(f"  {backend}: every rank's CVA, EPE and PFE bitwise one process's, errors within "
              f"1 ulp{', jacobians (fwd and rev) within rtol 1e-8' if backend == 'gloo' else ''}")


# -- samplers and streaming ----------------------------------------------------------

STREAM_PATHS = 1 << 24         # the JAX package's streaming width (north_star_16m_mesh.py)
STREAM_CHECK_PATHS = 1 << 20   # streaming against the plane on one stream
STREAM_CHECK_CHUNK = 4         # its jacobians' tangents a sweep
KSTREAM_PATHS = 1 << 22        # kernel-streaming AD on K2, cut from 2^24 (PERF.md section 4)
# Memory model of a differentiated streaming run, in units of one [N, D]
# float64 state (PERF.md section 6): the primal's residents and each forward
# tangent's.  A first model of 10 + 8 per tangent over-predicted; 23.16 GiB
# measured at chunk 6 and 2^24 paths (37 units, NVIDIA H100 80GB HBM3)
# refits it to 10 + 5.
STREAM_PRIMAL_ND, STREAM_TANGENT_ND = 10, 5
# The second process's share of the card (phase 7c, beside 7b): at this cap
# its caching allocator frees its cache and retries instead of growing into
# the memory the main process's phases need beside it (~12 GiB; with no cap
# the main process's CVA book once found 79.16 GiB of the card in use).
HESSIAN_PROCESS_MEMORY_FRACTION = 0.7
KSTREAM_CHUNK = 1              # kernel-streaming AD: [342, N] rows per tangent


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def plane_estimate_gib(c) -> float:
    """The plane route's own estimate of its state plane at this width: the
    [T, N, D] plane of the larger phase in float64 (the streaming decision's
    plane bytes)."""
    rows = len(c.simulation_timeline) * c.model.state_dim
    return rows * max(c.num_paths_mainsim, c.num_paths_presim) * 8 / 2**30


def balanced_chunk(num_params: int, widest: int) -> int:
    """The tangent chunk of the fewest sweeps at most ``widest`` wide,
    balanced across them."""
    sweeps = -(-num_params // max(1, min(widest, num_params)))
    return -(-num_params // sweeps)


def stream_chunk(num_paths: int, state_dim: int, num_params: int) -> int:
    """``grad_chunk_size`` of a differentiated metric-streaming run from the
    memory model: tangents of STREAM_TANGENT_ND [N, D] states each into
    three quarters of the second process's share of the card beside the
    primal's STREAM_PRIMAL_ND."""
    nd = num_paths * state_dim * 8
    budget = 0.75 * HESSIAN_PROCESS_MEMORY_FRACTION * torch.cuda.get_device_properties(0).total_memory
    return balanced_chunk(num_params, int((budget - STREAM_PRIMAL_ND * nd) // (STREAM_TANGENT_ND * nd)))


def north_star_streaming():
    """Phases S1-S2: the north star at STREAM_PATHS main and NS_PRESIM_FIT
    presim paths with ``streaming=True`` (the engine with the metric stream
    on), forward (cold and warm) and differentiated (forward mode, P = 11,
    ``use_kernel=False``): CVA against the JAX 16M reference (4 combined SE,
    else 1 %), EPE and PFE at five dates, finite derivatives, walls and
    peaks, the peak below the plane route's own estimate."""
    launches = hybrid_paths.launches
    fwd = north_star(STREAM_PATHS, False, num_paths_presim=NS_PRESIM_FIT, streaming=True)
    check(not fwd._kernel_active, "streaming=True forward took the kernel")
    t0 = time.perf_counter()
    results = fwd.run_simulation()
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    check(fwd._metric_stream is not None, f"metric stream off: {fwd.metric_stream_reason}")
    torch.cuda.reset_peak_memory_stats()

    def run_fwd():
        nonlocal results
        results = fwd.run_simulation()

    warm = wall_seconds(run_fwd)
    peak, plane = peak_gib(), plane_estimate_gib(fwd)
    print(f"[north-star streaming forward] {STREAM_PATHS} + {NS_PRESIM_FIT} presim paths, metric "
          f"stream on, {fwd._emission_schedule.num_emitted_rows()} emitted rows a run: cold wall "
          f"{cold:.4f} s, warm wall {warm:.4f} s, peak memory {peak:.2f} GiB (the plane route's "
          f"own estimate of its plane: {plane:.2f} GiB)")
    check(peak < plane, f"streaming peak {peak:.2f} GiB is not below the plane's {plane:.2f} GiB")
    values = ns_values(results)
    cva, cva_se = (float(x[0]) for x in values[f"cva[{CP}]"])
    epe, epe_se = values["epe"]
    pfe, pfe_se = values["pfe[0.95]"]
    for i in (0, 4, 8, 16, 28):
        print(f"  t={fwd.metric_exposure_timeline[i]:.2f}: epe {epe[i]:.6f} (se {epe_se[i]:.2e}) "
              f"pfe {pfe[i]:.6f} (se {pfe_se[i]:.2e})")
    check(all(np.isfinite(x).all() for pair in values.values() for x in pair), "non-finite values")
    gap = abs(cva - CVA_REF) / (cva_se ** 2 + CVA_REF_SE ** 2) ** 0.5
    rel = abs(cva - CVA_REF) / CVA_REF
    print(f"  CVA {cva:.7f} (se {cva_se:.2e}) vs JAX 16M {CVA_REF} (se {CVA_REF_SE:.1e}): "
          f"{gap:.2f} combined SE, {rel:.3%}")
    check(gap <= 4 or rel <= 0.01, f"streaming CVA {cva} is {rel:.3%} from the reference")
    del fwd, results
    torch.cuda.empty_cache()

    chunk = stream_chunk(STREAM_PATHS, 5, 11)
    diff = north_star(STREAM_PATHS, True, use_kernel=False, num_paths_presim=NS_PRESIM_FIT,
                      streaming=True, grad_chunk_size=chunk)
    diff_results, diff_s, diff_peak = run_timed(diff)
    check(diff._metric_stream is not None, "differentiated metric stream off")
    print(f"[north-star streaming differentiated] {STREAM_PATHS} paths, {diff._grad_mode_resolved} "
          f"mode, chunk {chunk} (model: {STREAM_PRIMAL_ND} + {STREAM_TANGENT_ND} x chunk [N, D] "
          f"f64 states, {(STREAM_PRIMAL_ND + STREAM_TANGENT_ND * chunk) * STREAM_PATHS * 40 / 2**30:.1f}"
          f" GiB): wall {diff_s:.4f} s, peak memory {diff_peak:.2f} GiB")
    grads = diff_results.get_derivatives("north_star", f"cva[{CP}]", evaluation_idx=0)
    print(f"  dCVA/d irs.rate {float(grads['irs.rate']):.6f}, dCVA/d eq.spot "
          f"{float(grads['eq.spot']):.6f}")
    for metric in ns_values(diff_results):
        check(bool(np.isfinite(ns_jacobian(diff_results, metric)).all()),
              f"non-finite {metric} jacobian")
    check(hybrid_paths.launches == launches, "the streaming engine route launched K2")
    del diff, diff_results
    torch.cuda.empty_cache()


def streaming_vs_plane():
    """Phase S3: on one stream at STREAM_CHECK_PATHS, engine route: the north
    star forward and differentiated, ``streaming=True`` with the metric
    stream and with emission alone against ``streaming=False`` (values rtol
    1e-10; jacobians rtol 1e-8, atol 1e-12), and the BS-multi book forward
    streaming against the plane (PV rtol 1e-10).  The presim takes
    NS_PRESIM_FIT paths and the jacobians STREAM_CHECK_CHUNK tangents a
    sweep, so each run stays under ~30 GB beside 7b."""
    launches = hybrid_paths.launches
    for differentiate in (False, True):
        runs = {}
        for label, kw in (("plane", dict(streaming=False)),
                          ("metric stream", dict(streaming=True)),
                          ("emission", dict(streaming=True, metric_streaming=False))):
            c = north_star(STREAM_CHECK_PATHS, differentiate, use_kernel=False,
                           num_paths_presim=NS_PRESIM_FIT, grad_chunk_size=STREAM_CHECK_CHUNK,
                           **kw)
            runs[label], wall, peak = run_timed(c)
            streams = (c._emission_schedule is not None, c._metric_stream is not None)
            check(streams == {"plane": (False, False), "metric stream": (True, True),
                              "emission": (True, False)}[label], f"{label}: wrong route {streams}")
            print(f"[north-star {'differentiated' if differentiate else 'forward'}, {label}] "
                  f"{STREAM_CHECK_PATHS} + {NS_PRESIM_FIT} presim paths: wall {wall:.4f} s, peak "
                  f"memory {peak:.2f} GiB")
            del c
            torch.cuda.empty_cache()
        plane = runs.pop("plane")
        for label, res in runs.items():
            for metric, (vals, _) in ns_values(plane).items():
                got = ns_values(res)[metric][0]
                rel = float(np.max(np.abs(got - vals) / np.maximum(np.abs(vals), 1e-300)))
                print(f"  {label} vs plane, {metric}: values max rel err {rel:.3e}")
                np.testing.assert_allclose(got, vals, rtol=1e-10, atol=1e-13, err_msg=metric)
                if differentiate:
                    jp, js = ns_jacobian(plane, metric), ns_jacobian(res, metric)
                    jrel = float(np.max(np.abs(js - jp) / np.maximum(np.abs(jp), 1e-12)))
                    print(f"  {label} vs plane, {metric}: jacobian max rel err {jrel:.3e}")
                    np.testing.assert_allclose(js, jp, rtol=1e-8, atol=1e-12, err_msg=metric)
    pvs = {}
    for streaming in (False, True):
        c, _ = euro_book(EURO_OPTIONS, use_kernel=False, streaming=streaming)
        res, wall, _ = run_timed(c)
        check((c._emission_schedule is not None) == streaming, "bs-multi route")
        pvs[streaming] = pv_of(res)[0]
        print(f"[bs-multi european forward, {'streaming' if streaming else 'plane'}, engine] "
              f"wall {wall:.4f} s, pv {pvs[streaming]:.6f}")
        del c
    np.testing.assert_allclose(pvs[True], pvs[False], rtol=1e-10)
    check(hybrid_paths.launches == launches, "the engine route launched K2")
    torch.cuda.empty_cache()


def kernel_streaming():
    """Phase S4: kernel-streaming AD on K2: the north star differentiated
    with ``streaming=True`` on the kernel route at KSTREAM_PATHS main and
    NS_PRESIM_FIT presim paths, counts from 0 (one K2 and one prologue
    launch per phase), against the engine's streaming route fed the
    kernel's own draws (values 1e-4; jacobians rtol 1e-3, atol 1e-6).
    Returns K2's and the prologue's launches."""
    reset_k2_counts()
    kernel = north_star(KSTREAM_PATHS, True, num_paths_presim=NS_PRESIM_FIT, streaming=True,
                        grad_chunk_size=KSTREAM_CHUNK)
    draws = capture_draws(kernel)
    kr, wall, peak = run_timed(kernel)
    check(kernel._kernel_active and kernel._emission_schedule is not None,
          "not on kernel-streaming AD")
    launches = (hybrid_paths.launches, k2_module.hybrid_table.launches)
    print(f"[north-star kernel-streaming AD] {KSTREAM_PATHS} + {NS_PRESIM_FIT} presim paths, "
          f"{kernel._emission_schedule.num_emitted_rows()} emitted rows a run over "
          f"{len(kernel.simulation_timeline)} points of D = {kernel.model.state_dim}, chunk "
          f"{KSTREAM_CHUNK}: wall {wall:.4f} s ({kernel._grad_mode_resolved} mode), peak memory "
          f"{peak:.2f} GiB; K2 launches {launches[0]}, prologue {launches[1]}")
    check(launches == (2, 2), f"kernel-streaming AD launched K2 / its prologue {launches} times")
    source = draws_source(kernel, draws)
    del kernel, draws
    torch.cuda.empty_cache()
    engine = north_star(KSTREAM_PATHS, True, use_kernel=False, num_paths_presim=NS_PRESIM_FIT,
                        streaming=True, metric_streaming=False, grad_chunk_size=KSTREAM_CHUNK,
                        noise_source=source)
    er, wall, peak = run_timed(engine)
    print(f"[north-star streaming, engine route on the kernel's draws] wall {wall:.4f} s, peak "
          f"memory {peak:.2f} GiB")
    for metric in ns_values(kr):
        kv, ev = ns_values(kr)[metric][0], ns_values(er)[metric][0]
        rel = float(np.max(np.abs(kv - ev) / np.maximum(np.abs(ev), 1e-12)))
        jk, je = ns_jacobian(kr, metric), ns_jacobian(er, metric)
        jrel = float(np.max(np.abs(jk - je) / np.maximum(np.abs(je), 1e-6)))
        print(f"  {metric}: kernel vs engine streaming values max rel err {rel:.3e}, jacobian "
              f"{jrel:.3e}")
        np.testing.assert_allclose(kv, ev, rtol=1e-4, atol=1e-8, err_msg=metric)
        np.testing.assert_allclose(jk, je, rtol=1e-3, atol=1e-6, err_msg=metric)
    check((hybrid_paths.launches, k2_module.hybrid_table.launches) == launches,
          "the engine route launched K2")
    del engine, source, kr, er
    torch.cuda.empty_cache()
    return launches


def bs_call(sampler, use_kernel=False, differentiate=False):
    """The call of examples/pv_sobol_convergence.py: S = K = 100, r 3 %,
    sigma 20 %, T = 2, ANALYTICAL, 4 substeps."""
    model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    option = mt.EuropeanOption(mt.Equity("eq"), 2.0, 100.0, CALL, asset_id="eq")
    return book(model, [mt.NettingSet(name="opt", products=[option])],
                mt.SimulationScheme.ANALYTICAL, 4, differentiate, use_kernel, sampler=sampler)


def run_timed(c):
    """(results, wall, peak GiB) of one run of a controller."""
    torch.cuda.reset_peak_memory_stats()
    out = {}
    wall = wall_seconds(lambda: out.setdefault("results", c.run_simulation()))
    return out["results"], wall, peak_gib()


def sampler_phases():
    """Phase S5: the samplers at full width on the engine route: the
    Heston-QE book with ``sampler="sobol"`` and with the Brownian bridge
    (PVs within 4 SE + 0.05 of the characteristic function), the BS call's
    Sobol error below the pseudo-random run's SE, the BS-multi book with
    antithetic pairs (PV within 4 SE of the closed-form sum; deltas and vegas
    within 2 %); each differentiated once, walls and peaks printed."""
    launches = (hybrid_paths.launches, heston_qe_paths.launches, heston_qe_paths.emit_launches)
    for kw in (dict(sampler="sobol"), dict(sampler="sobol", qmc_bridge=True)):
        c, model, netting_sets = controller(False, **kw)
        check(not c._kernel_active, "the Sobol sampler took the kernel")
        res, wall, peak = run_timed(c)
        label = "sobol" + (" + bridge" if kw.get("qmc_bridge") else "")
        print(f"[heston {label}] {NUM_PATHS} paths x {len(MATURITIES)} points x {NUM_STEPS} "
              f"substeps: wall {wall:.4f} s, peak memory {peak:.2f} GiB")
        for ns in netting_sets:
            pv, se = pv_of(res, ns.name)
            cf = ns.products[0].compute_pv_analytically_heston(model)
            print(f"  {ns.name}: pv {pv:.6f} se {se:.6f} cf {cf:.6f} |pv-cf|/se "
                  f"{abs(pv - cf) / se:.2f}")
            check(np.isfinite(pv) and se > 0 and abs(pv - cf) < 4 * se + 0.05, f"{label} {ns.name}")
        del c
    diff, model, netting_sets = controller(True, sampler="sobol", qmc_bridge=True)
    res, wall, peak = run_timed(diff)
    jac = np.array([[res.get_derivatives(ns.name, "pv", param=p, evaluation_idx=0)
                     for p in model.get_model_param_names()] for ns in netting_sets])
    print(f"[heston sobol + bridge differentiated] wall {wall:.4f} s ({diff._grad_mode_resolved} "
          f"mode), peak memory {peak:.2f} GiB; 1y delta {jac[-1, 0]:.6f}")
    check(bool(np.isfinite(jac).all()), "non-finite Sobol jacobian")
    del diff
    torch.cuda.empty_cache()

    s0, k, r, sigma, tau = 100.0, 100.0, 0.03, 0.2, 2.0
    d1 = (math.log(s0 / k) + (r + 0.5 * sigma ** 2) * tau) / (sigma * math.sqrt(tau))
    ncdf = lambda x: 0.5 * math.erfc(-x / math.sqrt(2.0))
    ref = s0 * ncdf(d1) - k * math.exp(-r * tau) * ncdf(d1 - sigma * math.sqrt(tau))
    out = {}
    for sampler in ("pseudo", "sobol"):
        res, wall, _ = run_timed(bs_call(sampler))
        out[sampler] = pv_of(res, "opt")
        print(f"[bs call, {sampler}] {NUM_PATHS} paths: pv {out[sampler][0]:.6f} se "
              f"{out[sampler][1]:.2e}, error {abs(out[sampler][0] - ref):.2e} vs closed form "
              f"{ref:.6f}, wall {wall:.4f} s")
    check(abs(out["sobol"][0] - ref) < out["pseudo"][1],
          "the Sobol error is not below the pseudo-random SE")
    res, wall, peak = run_timed(bs_call("sobol", differentiate=True))
    grads = res.get_derivatives("opt", "pv", evaluation_idx=0)
    print(f"[bs call, sobol, differentiated] wall {wall:.4f} s, peak memory {peak:.2f} GiB, "
          f"delta {float(grads['spot']):.6f} vega {float(grads['volatility']):.6f}")
    check(all(np.isfinite(float(g)) for g in grads.values()), "non-finite Sobol call gradient")

    fwd, products = euro_book(EURO_OPTIONS, antithetic=True)
    check(not fwd._kernel_active, "antithetic pairs took the kernel")
    res, wall, peak = run_timed(fwd)
    pv, se = pv_of(res)
    cf, _ = closed_form_sum(fwd.model, products)
    print(f"[bs-multi european antithetic forward] wall {wall:.4f} s, peak memory {peak:.2f} GiB; "
          f"pv {pv:.4f} se {se:.4f} vs closed-form sum {cf:.4f}: {abs(pv - cf) / se:.2f} SE")
    check(np.isfinite(pv) and se > 0 and abs(pv - cf) < 4 * se, "antithetic pv vs closed form")
    del fwd
    diff, products = euro_book(EURO_OPTIONS, differentiate=True, antithetic=True)
    res, wall, peak = run_timed(diff)
    print(f"[bs-multi european antithetic differentiated] wall {wall:.4f} s "
          f"({diff._grad_mode_resolved} mode), peak memory {peak:.2f} GiB")
    cf, cf_grads = closed_form_sum(diff.model, products)
    grads = res.get_derivatives("european_book", "pv", evaluation_idx=0)
    for name in diff.model.get_model_param_names()[:8]:
        mc, ref_g = float(grads[name]), cf_grads[name]
        gap = abs(mc - ref_g) / abs(ref_g)
        print(f"  d pv / d {name}: pathwise {mc:.4f} vs closed forms {ref_g:.4f} (gap {gap:.3%})")
        check(gap < 0.02, f"antithetic d pv / d {name} is {gap:.3%} from the closed forms")
    del diff
    torch.cuda.empty_cache()
    check(launches == (hybrid_paths.launches, heston_qe_paths.launches,
                       heston_qe_paths.emit_launches), "a sampler book launched a kernel")


def streaming_phases():
    """The samplers and streaming phases that launch no kernel: the north
    star at 16.8M paths, streaming against the plane, the sampler books (the
    smoke runs them in its second process after the Hessians, beside 7b;
    each stays under ~45 GB)."""
    t0 = time.perf_counter()
    north_star_streaming()
    print(f"[time] 16.8M-path streaming phases: {time.perf_counter() - t0:.1f} s")
    streaming_vs_plane()
    print(f"[time] streaming vs plane: {time.perf_counter() - t0:.1f} s")
    sampler_phases()
    print(f"[time] samplers: {time.perf_counter() - t0:.1f} s")


# -- second-order sensitivities --------------------------------------------------------

HESS_NS_PATHS = 1 << 17  # north-star Hessian depth (main and presim paths), cut from 1e6
HESS_BS_PATHS = (1 << 18, 1 << 17)  # tests/test_pallas_controller_tpu.py:195-240: kernel, engine


def hessians(results):
    """{(netting set, metric, evaluation): [P, P]} of a run's Hessians."""
    names = results.get_model_param_names()
    out = {}
    for ns in results.get_netting_set_names():
        for metric in results.get_metric_names():
            for k in range(len(results.get_results(ns, metric))):
                out[ns, metric, k] = np.array([[
                    results.get_second_derivatives(ns, metric, param1=a, param2=b,
                                                   evaluation_idx=k) for b in names]
                    for a in names], dtype=float)
    return out


def hessian_checks(label, kernel, engine, rtol=1e-3, atol=1e-6):
    """Kernel-route Hessians against an engine route's, and the kernel
    route's symmetry to 1e-8 relative."""
    hk, he = hessians(kernel), hessians(engine)
    check(hk.keys() == he.keys() and len(hk) > 0, f"{label}: Hessian keys differ")
    worst_rel, worst_sym = 0.0, 0.0
    for key, h in hk.items():
        check(bool(np.isfinite(h).all()), f"{label} {key}: non-finite Hessian")
        scale = max(float(np.abs(h).max()), 1e-300)
        worst_sym = max(worst_sym, float(np.abs(h - h.T).max()) / scale)
        worst_rel = max(worst_rel, float(np.max(np.abs(h - he[key])
                                                / np.maximum(np.abs(he[key]), atol))))
        np.testing.assert_allclose(h, he[key], rtol=rtol, atol=atol, err_msg=f"{label} {key}")
    print(f"  {label}: kernel vs engine Hessian max rel err {worst_rel:.3e} ({len(hk)} "
          f"evaluations; rtol {rtol}, atol {atol}); symmetry max rel {worst_sym:.3e}")
    check(worst_sym <= 1e-8, f"{label}: Hessian not symmetric ({worst_sym:.3e})")


def hessian_run(label, c, rows=None):
    """One Hessian run of a differentiated controller: (results, wall s,
    peak GiB).  ``rows`` collects each Hessian row's (wall s, peak GiB)."""
    c.compute_higher_derivatives()
    if rows is not None:
        row = c._hessian_row

        def measured_row(*args):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = row(*args)
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30))
            return out

        c._hessian_row = measured_row
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = c.run_simulation()
    torch.cuda.synchronize()
    wall, peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30
    check(len(results.second_derivatives) > 0, f"{label}: no Hessian returned")
    print(f"[{label}] Hessian run wall {wall:.4f} s ({c._grad_mode_resolved} branch, P = "
          f"{len(c.model.get_model_param_names())}), peak memory {peak:.2f} GiB")
    return results, wall, peak


def capture_draws(c):
    """{phase: frozen draws} that a kernel-route run of ``c`` computes,
    recorded as the run makes them (no launch of its own)."""
    draws = {}
    compute = c._kernel_noise_of

    def record(params):
        draws.update(compute(params))
        return draws

    c._kernel_noise_of = record
    return draws


def draws_source(c, draws):
    """{phase: counter -> (z, u)}: the engine's noise source that feeds it
    the kernel route's frozen draws of ``c`` (K1's emitted draws, or the
    standard normals recovered from K2's states): the engine counter of
    sub-step k of point p reads the dense step of that sub-step."""
    _, orig_idx = dense_timeline(c.model.calibration_date, c.simulation_timeline, c.num_steps)
    first = [int(i) - c.num_steps + 1 for i in orig_idx]

    def source(noise):
        z, u = noise if isinstance(noise, tuple) else (noise, None)

        def at(counter):
            point, k = divmod(counter, c.num_steps)
            i = first[point] + k
            return z[i], None if u is None else u[i]

        return at

    return {phase: source(noise) for phase, noise in draws.items()}


def hessian_routes(label, make):
    """The Hessian of one book on the kernel route (counts read just after
    its run, each row's wall and peak printed) and on the engine route fed
    the kernel's own draws (the Philox stream at the kernel's rounding),
    held to rtol 1e-3, atol 1e-6 on every metric.  (The engine's own float64
    draws differ from the kernel's by their rounding, and second pathwise
    derivatives are heavy-tailed: a few Heston paths near v = 0 carry per-path
    vol-of-vol terms of 1e5 against a mean of -2.5, so the two streams' gap
    measures that tail, not the route: PERF.md section 6.)
    ``make(use_kernel, noise_source)`` builds the controller.  Returns the
    kernel route's results and launches (K1's, K1's emitting ones, K2's and
    its prologue's)."""
    kernel = make("auto", None)
    check(kernel._kernel_active, f"{label}: not on the kernel path")
    draws = capture_draws(kernel)
    rows = []
    kr, _, _ = hessian_run(f"{label}, kernel route", kernel, rows)
    launches = (heston_qe_paths.launches, heston_qe_paths.emit_launches,
                hybrid_paths.launches, k2_module.hybrid_table.launches)
    print("  rows (wall s, peak GiB): " + ", ".join(f"({w:.3f}, {m:.2f})" for w, m in rows))
    source = draws_source(kernel, draws)
    del kernel
    torch.cuda.empty_cache()
    same, _, _ = hessian_run(f"{label}, engine route on the kernel's draws", make(False, source))
    hessian_checks(label, kr, same)
    check(launches == (heston_qe_paths.launches, heston_qe_paths.emit_launches,
                       hybrid_paths.launches, k2_module.hybrid_table.launches),
          f"{label}: the engine route launched a kernel")
    del same, source, draws
    torch.cuda.empty_cache()
    return kr, launches


def heston_hessian():
    """The Heston-QE book's Hessian at full size (K1 with emitted draws,
    forward branch, P = 7) on both routes; returns K1's launches."""
    heston_qe_paths.launches = 0
    heston_qe_paths.emit_launches = 0
    kr, (launches, emits, _, _) = hessian_routes(
        "heston hessian", lambda use_kernel, source: controller(True, use_kernel, source)[0])
    check(launches == 1 and emits == 1,
          f"the Heston Hessian run made {launches} K1 launches, not 1")
    g = kr.get_second_derivatives("call_1", "pv", param1="spot", param2="spot", evaluation_idx=0)
    print(f"  1y call: gamma {g:.6e}, d2/dspot dvariance "
          f"{kr.get_second_derivatives('call_1', 'pv', 'spot', 'initial_variance', 0):.6f}")
    return launches


def bs_controller(num_paths, use_kernel):
    """tests/test_pallas_controller_tpu.py:35-48: one ATM call on Black-Scholes."""
    model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.2, asset_id="eq")
    option = mt.EuropeanOption(mt.Equity("eq"), 1.0, 100.0, CALL, asset_id="eq")
    return mt.SimulationController([mt.NettingSet(name="book", products=[option])], model, PV(),
                                   num_paths, 0, 1, mt.SimulationScheme.ANALYTICAL,
                                   differentiate=True, root_seed=SEED, use_kernel=use_kernel,
                                   device="cuda")


def bs_hessian():
    """tests/test_pallas_controller_tpu.py:195-240 on the card: the kernel
    route (K2 bs exact) at 262,144 paths and the engine route at 131,072;
    pathwise gamma exactly 0 on both, vomma within 0.5 + 5 %, the cross
    term within 0.05 + 5 %; then the engine route at 262,144 paths on the
    kernel's stream within rtol 1e-3.  Returns K2's launches."""
    reset_k2_counts()
    n_kernel, n_engine = HESS_BS_PATHS
    kc = bs_controller(n_kernel, "auto")
    check(kc._kernel_active, "the BS Hessian book is not on the kernel path")
    kr, _, _ = hessian_run("bs european hessian, kernel route", kc)
    launches = hybrid_paths.launches
    check(launches == 1 and k2_module.hybrid_table.launches == 1,
          f"the BS Hessian run made {launches} K2 launches, not 1")
    er, _, _ = hessian_run("bs european hessian, engine route", bs_controller(n_engine, False))
    same, _, _ = hessian_run("bs european hessian, engine route, same stream and paths",
                             bs_controller(n_kernel, False))
    check(hybrid_paths.launches == launches, "the engine route launched K2")
    h2 = lambda r, a, b: float(r.get_second_derivatives("book", "pv", a, b, evaluation_idx=0))
    v_k, v_e = h2(kr, "volatility", "volatility"), h2(er, "volatility", "volatility")
    x_k, x_e = h2(kr, "spot", "volatility"), h2(er, "spot", "volatility")
    print(f"  gamma kernel {h2(kr, 'spot', 'spot')} engine {h2(er, 'spot', 'spot')}; vomma kernel "
          f"{v_k:.6f} engine {v_e:.6f}; d2/dspot dvol kernel {x_k:.6f} engine {x_e:.6f}")
    check(h2(kr, "spot", "spot") == 0.0 and h2(er, "spot", "spot") == 0.0,
          "pathwise gamma of the hard call payoff is not exactly 0")
    check(abs(v_k - v_e) < 0.5 + 0.05 * abs(v_e), f"vomma {v_k} vs {v_e}")
    check(abs(x_k - x_e) < 0.05 + 0.05 * abs(x_e), f"d2/dspot dvol {x_k} vs {x_e}")
    hessian_checks("bs european hessian, same stream and paths", kr, same)
    return launches


def bs_multi_hessian():
    """The BS-multi European book's Hessian at full size (10,000 options,
    K2 bs_multi exact with recovered draws, reverse branch,
    P = 9) on both routes; returns K2's launches."""
    reset_k2_counts()
    _, (_, _, launches, table) = hessian_routes(
        "bs-multi european hessian",
        lambda use_kernel, source: euro_book(EURO_OPTIONS, True, use_kernel, source)[0])
    check(launches == 1 and table == 1,
          f"the BS-multi Hessian run made {launches} K2 launches, not 1")
    return launches


def north_star_hessian():
    """The north-star book's Hessian (K2 Euler vasicek, bs, cirpp; LSM fits;
    forward branch, P = 11, one sweep of 11 tangents per row) at 2^17 main
    and 2^17 presim paths on both routes, each row's wall and peak memory
    printed; returns K2's launches (its table prologue's equal them).  On
    the kernel's draws PFE is held too: both routes rank the same paths."""
    reset_k2_counts()
    kr, (_, _, launches, table) = hessian_routes(
        "north-star hessian",
        lambda use_kernel, source: north_star(HESS_NS_PATHS, True, use_kernel,
                                              grad_chunk_size=11, noise_source=source))
    check(launches == 2 and table == 2,
          f"the north-star Hessian run made {launches} K2 launches, not 2 (one per phase)")
    h = kr.get_second_derivatives("north_star", f"cva[{CP}]", "irs.rate", "irs.rate", 0)
    print(f"  {HESS_NS_PATHS} + {HESS_NS_PATHS} presim paths; d2 CVA / d irs.rate^2 {h:.6f}")
    return launches


def analytic_hessian():
    """The analytic route (tests/test_heston_and_hessian.py:65) on the card:
    a Black-Scholes call under EvaluationType.ANALYTICAL, Hessian gamma and
    vomma against the closed forms to 1e-9; no simulation, no launch."""
    reset_k2_counts()
    model = mt.BlackScholesModel(0.0, spot=100.0, rate=0.05, sigma=0.2)
    option = mt.EuropeanOption(mt.Equity(), 2.0, 110.0, CALL)
    c = mt.SimulationController(
        [mt.NettingSet(name="ns", products=[option])], model,
        mt.RiskMetrics([mt.PVMetric(evaluation_type=mt.Metric.EvaluationType.ANALYTICAL)]), 1, 0,
        1, mt.SimulationScheme.ANALYTICAL, differentiate=True, device="cuda")
    r, _, _ = hessian_run("analytic hessian", c)
    params = model.initial_params(device="cpu")  # the closed forms, on the host
    gamma = float(option.compute_dDeltadSpot_analytically(model, params))
    vomma = float(option.compute_dVegadSigma_analytically(model, params))
    h = lambda a: float(r.get_second_derivatives("ns", "pv", a, a, evaluation_idx=0))
    print(f"  gamma {h('spot'):.12f} vs closed form {gamma:.12f}; vomma {h('volatility'):.12f} "
          f"vs closed form {vomma:.12f}")
    check(abs(h("spot") - gamma) < 1e-9 and abs(h("volatility") - vomma) < 1e-9,
          "analytic gamma or vomma differs from the closed forms")
    check(hybrid_paths.launches == 0, "the analytic route launched K2")


# -- the BS-multi books and the other K2 routes --------------------------------------

CALL, PUT = mt.OptionType.CALL, mt.OptionType.PUT
PV = lambda: mt.RiskMetrics([mt.PVMetric()])
HW_TIMES, HW_DFS = [0.0, 1.0, 3.0, 5.0], [1.0, 0.97, 0.90, 0.84]
CIR_HAZARDS = {1.0: 0.02, 2.0: 0.022, 5.0: 0.028}


def bs_multi_model(pkg=mt):
    """The 4-asset model of benchmarks/pv_european_book.py:38-46 (and of the
    mixed and CVA books, pv_large_book.py:153-161)."""
    corr = np.full((4, 4), 0.35)
    np.fill_diagonal(corr, 1.0)
    return pkg.BlackScholesMulti(0.0, rate=0.03, asset_ids=list(ASSETS),
                                 spots=[95.0 + 7.5 * i for i in range(4)],
                                 volatilities=[0.18 + 0.03 * i for i in range(4)],
                                 correlation_matrix=corr)


# -- the mixed book and the CVA book (benchmarks/pv_large_book.py, cva_large_book.py) --------

# Family counts of the 50,000-product mixed PV book (pv_large_book.py:149-150)
# and of the 5,000-product CVA book (cva_large_book.py:48-49), in build order.
MIXED_COUNTS = {"european": 39_400, "binary": 1_000, "basket": 1_000, "asian": 2_000,
                "barrier": 4_000, "american": 1_800, "flexicall": 700, "storage": 100}
CVA_COUNTS = {k: v // 10 for k, v in MIXED_COUNTS.items()}
MIXED_PATHS = 1_000  # main and presim paths of both benchmarks
ORACLE_PATHS = (1 << 17, 1 << 18, 1 << 20)  # American and FlexiCall, barriers, binary and Asian
# The CVA benchmark's bootstrapped hazard curve (cva_large_book.py:39-43).
CVA_HAZARDS = {0.5: 0.006402303360855854, 1.0: 0.01553038972325307,
               2.0: 0.009729741230773657, 3.0: 0.015552544648116201,
               4.0: 0.021196186202801115, 5.0: 0.02284319986706472,
               7.0: 0.010111423894480876, 10.0: 0.00613267811172937,
               15.0: 0.0036969930706003337, 20.0: 0.003791311459217732}


def scaled_counts(counts, scale: float):
    """Family counts at ``scale`` of the full book, at least one each
    (pv_large_book.py:151)."""
    return {k: max(1, int(v * scale)) for k, v in counts.items()}


def make_storage(asset_id, maturity, capacity, initial, inj_cost, wd_cost, num_states, rollout,
                 pkg=mt):
    """A seasonal storage deal of the mixed book (pv_large_book.py:49-70)."""
    cfg = pkg.StorageConfig()
    ramp_end, plateau_end = 0.35 * maturity, 0.70 * maturity
    cfg.add_volume_constraint(0.0, ramp_end, 0.0, 0.55 * capacity)
    cfg.add_volume_constraint(ramp_end, plateau_end, 0.10 * capacity, 0.85 * capacity)
    cfg.add_volume_constraint(plateau_end, maturity, 0.0, capacity)
    cfg.add_injection_flexibility(0.0, ramp_end, 0.0, 0.30 * capacity)
    cfg.add_injection_flexibility(0.0, ramp_end, 0.60 * capacity, 0.18 * capacity)
    cfg.add_injection_flexibility(ramp_end, maturity, 0.0, 0.22 * capacity)
    cfg.add_injection_flexibility(ramp_end, maturity, 0.60 * capacity, 0.12 * capacity)
    cfg.add_withdrawal_flexibility(0.0, plateau_end, 0.0, 0.16 * capacity)
    cfg.add_withdrawal_flexibility(0.0, plateau_end, 0.60 * capacity, 0.24 * capacity)
    cfg.add_withdrawal_flexibility(plateau_end, maturity, 0.0, 0.24 * capacity)
    cfg.add_withdrawal_flexibility(plateau_end, maturity, 0.60 * capacity, 0.32 * capacity)
    cfg.add_variable_injection_cost(0.0, inj_cost)
    cfg.add_variable_injection_cost(plateau_end, inj_cost * 1.10)
    cfg.add_variable_withdrawal_cost(0.0, wd_cost)
    cfg.add_variable_withdrawal_cost(plateau_end, wd_cost * 1.10)
    return pkg.Storage(asset_id=asset_id, start_date=0.0, end_date=maturity,
                       initial_amount=initial, storage_config=cfg, num_states=num_states,
                       rollout_interval=rollout)


def build_book(asset_ids, counts, pkg=mt):
    """{family: products} of the mixed book, the families in build order
    (pv_large_book.py:73-145, with the port's classes by default)."""
    a = lambda i: asset_ids[i % len(asset_ids)]
    cp = lambda even: pkg.OptionType.CALL if even else pkg.OptionType.PUT
    mats, strikes = [0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3.0], [80.0, 90.0, 100.0, 110.0, 120.0]
    book = {"european": [pkg.EuropeanOption(pkg.Equity(a(i)), mats[i % 8], strikes[i % 5],
                                            cp(i % 2 == 0), asset_id=a(i))
                         for i in range(counts["european"])],
            "binary": [pkg.BinaryOption([0.5, 1.0, 1.5, 2.0][i % 4], [90.0, 100.0, 110.0][i % 3],
                                        8.0 + 2.0 * (i % 4), cp(i % 2 == 0), asset_id=a(i))
                       for i in range(counts["binary"])]}
    basket_weights = [[0.5, 0.3, 0.2, 0.0], [0.25] * 4, [0.4, 0.35, 0.15, 0.10]]
    book["basket"] = []
    for i in range(counts["basket"]):
        n_active = 2 + (i % 3)
        w = basket_weights[i % 3][:n_active]
        book["basket"].append(pkg.BasketOption(
            [0.75, 1.25, 2.0, 2.5][i % 4], list(asset_ids[:n_active]), [x / sum(w) for x in w],
            95.0 + 5.0 * (i % 5), cp(i % 2 == 0),
            pkg.BasketOptionType.ARITHMETIC if i % 3 != 0 else pkg.BasketOptionType.GEOMETRIC))
    book["asian"] = [pkg.AsianOption(
        0.0, [0.5, 0.75, 1.0, 1.5, 2.0][i % 5], 88.0 + 6.0 * (i % 6), [8, 12, 18, 24][i % 4],
        cp(i % 2 == 0),
        pkg.AsianAveragingType.ARITHMETIC if i % 3 != 0 else pkg.AsianAveragingType.GEOMETRIC,
        asset_id=a(i)) for i in range(counts["asian"])]
    book["barrier"] = [pkg.BarrierOption(
        0.0, [0.5, 0.75, 1.25, 1.75, 2.5, 3.0][i % 6], 85.0 + 7.5 * (i % 6),
        [8, 12, 18, 24, 36][i % 5], cp(i % 3 != 0), [118.0, 125.0, 132.0, 140.0][i % 4]
        + 2.0 * (i % 2), pkg.BarrierOptionType.UPANDOUT, asset_id=a(i))
        for i in range(counts["barrier"])]
    book["american"] = [pkg.AmericanOption(
        pkg.Equity(a(i)), [0.75, 1.0, 1.5, 2.0, 2.5, 3.0][i % 6], [8, 12, 18, 24, 36, 48][i % 6],
        [80.0, 92.5, 100.0, 107.5, 120.0][i % 5], cp(i % 2 != 0), asset_id=a(i))
        for i in range(counts["american"])]
    book["flexicall"] = []
    for i in range(counts["flexicall"]):
        maturity, n_dates = [1.0, 1.5, 2.0, 2.5][i % 4], [3, 4, 5][i % 3]
        dates = np.linspace(maturity / n_dates, maturity, n_dates)
        unds = [pkg.EuropeanOption(pkg.Equity(a(i)), float(t), 90.0 + 6.0 * ((i + k) % 6),
                                   pkg.OptionType.CALL, asset_id=a(i))
                for k, t in enumerate(dates)]
        book["flexicall"].append(pkg.FlexiCall(unds, num_exercise_rights=min(1 + (i % 3),
                                                                             n_dates - 1),
                                               asset_id=a(i)))
    book["storage"] = [make_storage(
        a(i), [1.0, 1.5, 2.0, 2.5][i % 4], [18.0, 26.0, 34.0, 42.0][i % 4], 2.0 + 0.5 * (i % 5),
        0.10 + 0.02 * (i % 4), 0.08 + 0.015 * (i % 4), 6 + (i % 5), [0.05, 0.10, 0.125][i % 3],
        pkg) for i in range(counts["storage"])]
    return book


def mixed_book_parts(counts, by_family: bool = False, pkg=mt):
    """(netting sets, model, metrics) of the mixed PV book: one netting set
    (pv_large_book.py:165), or one per family."""
    book = build_book(list(ASSETS), counts, pkg)
    if by_family:
        netting_sets = [pkg.NettingSet(name=f, products=ps) for f, ps in book.items()]
    else:
        netting_sets = [pkg.NettingSet(name="mixed_book",
                                       products=[p for ps in book.values() for p in ps])]
    return netting_sets, bs_multi_model(pkg), pkg.RiskMetrics(metrics=[pkg.PVMetric()])


def cva_book_parts(scale: float = 1.0, pkg=mt, num_dates: int = 80):
    """(netting sets, model, metrics) of the CVA book (cva_large_book.py:46-87):
    the mixed book's families at a tenth, times ``scale``, on a ModelConfig
    of BS-multi and a CIR++ counterparty, MPoR 10/252, CVA on ``num_dates``
    dates to the last product date (the benchmark's 80 by default)."""
    products = [p for ps in build_book(list(ASSETS), scaled_counts(CVA_COUNTS, scale), pkg).values()
                for p in ps]
    credit = pkg.CIRPPModel(0.0, asset_id=CP, hazard_rates=CVA_HAZARDS, kappa=0.10, theta=0.01,
                            volatility=0.02, y0=0.0001)
    model = pkg.ModelConfig([bs_multi_model(pkg), credit],
                            inter_asset_correlation_matrix=[np.zeros((4, 1))])
    horizon = max(p.modeling_timeline[-1] for p in products)
    netting_set = pkg.NettingSet(name="cva_book", products=products, counterparty_id=CP,
                                 margin_period_of_risk=10 / 252)
    metrics = pkg.RiskMetrics(metrics=[pkg.CVAMetric(counterparty_id=CP, recovery_rate=0.4)],
                              exposure_timeline=np.linspace(0.0, horizon, num_dates))
    return [netting_set], model, metrics


def euro_options(num_options: int):
    """The European book of benchmarks/pv_european_book.py:47-55."""
    return [mt.EuropeanOption(mt.Equity(ASSETS[i % 4]), 0.5 + 0.25 * (i % 10),
                              80.0 + (i % 9) * 5.0, CALL if i % 2 == 0 else PUT,
                              asset_id=ASSETS[i % 4]) for i in range(num_options)]


def book(model, netting_sets, scheme, num_steps, differentiate=False, use_kernel="auto",
         noise_source=None, **kw):
    return mt.SimulationController(netting_sets, model, PV(), NUM_PATHS, 0, num_steps, scheme,
                                   differentiate=differentiate, root_seed=SEED,
                                   use_kernel=use_kernel, device="cuda",
                                   noise_source=noise_source, **kw)


def euro_book(num_options: int, differentiate=False, use_kernel="auto", noise_source=None,
              **kw):
    products = euro_options(num_options)
    return book(bs_multi_model(), [mt.NettingSet(name="european_book", products=products)],
                mt.SimulationScheme.ANALYTICAL, 1, differentiate, use_kernel, noise_source,
                **kw), products


def closed_form_sum(model, products):
    """The sum of the products' closed forms and its gradient by the
    parameters (float64 on the CPU)."""
    params = tuple(p.requires_grad_(True) for p in model.initial_params(device="cpu"))
    total = sum(p.compute_pv_analytically(model, params) for p in products)
    grads = torch.autograd.grad(total, params)
    return float(total.detach()), dict(zip(model.get_model_param_names(), (float(g) for g in grads)))


def pv_of(results, ns="european_book"):
    return (float(results.get_results(ns, "pv", evaluation_idx=0)),
            float(results.get_mc_error(ns, "pv", evaluation_idx=0)))


def same_values(kernel, engine, label, rtol=1e-4, atol=1e-6):
    """Kernel route vs engine route, every netting set's PV, one stream."""
    names = engine.get_netting_set_names()
    k = np.array([pv_of(kernel, n)[0] for n in names])
    e = np.array([pv_of(engine, n)[0] for n in names])
    rel = float(np.max(np.abs(k - e) / np.maximum(np.abs(e), atol)))
    print(f"  {label}: kernel vs engine route values max rel err {rel:.3e} ({len(names)} netting sets)")
    np.testing.assert_allclose(k, e, rtol=rtol, atol=atol, err_msg=label)


def euro_main_path():
    """Phase 4: the BS-multi European book; returns K2's launches in it."""
    reset_k2_counts()
    fwd, products = euro_book(EURO_OPTIONS)
    check(fwd._kernel_active, "the European book is not on the kernel path")
    results = fwd.run_simulation()
    check(hybrid_paths.launches == 1, f"forward run made {hybrid_paths.launches} K2 launches, not 1")

    def run_fwd():
        nonlocal results
        results = fwd.run_simulation()

    torch.cuda.reset_peak_memory_stats()
    walls = [wall_seconds(run_fwd) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    pv, se = pv_of(results)
    cf, _ = closed_form_sum(fwd.model, products)
    print(f"[bs-multi european forward] {EURO_OPTIONS} options x {NUM_PATHS} paths, "
          f"{len(fwd.simulation_timeline)}-point timeline: warm walls "
          f"{', '.join(f'{w:.4f}' for w in walls)} s ({EURO_OPTIONS / min(walls):.0f} options/s), "
          f"peak memory {peak:.2f} GiB")
    print(f"  pv {pv:.4f} se {se:.4f} vs closed-form sum {cf:.4f}: {abs(pv - cf) / se:.2f} SE")
    check(np.isfinite(pv) and se > 0 and abs(pv - cf) < 4 * se, f"pv {pv} vs closed form {cf}")
    torch.cuda.empty_cache()

    diff, products = euro_book(EURO_OPTIONS, differentiate=True)
    before = hybrid_paths.launches
    torch.cuda.reset_peak_memory_stats()
    diff_results = diff.run_simulation()
    check(hybrid_paths.launches == before + 1, "differentiated run did not launch K2 once")

    def run_diff():
        nonlocal diff_results
        diff_results = diff.run_simulation()

    diff_s = wall_seconds(run_diff)
    diff_peak = torch.cuda.max_memory_allocated() / 2**30
    (batch,) = diff._batches
    print(f"[bs-multi european differentiated] {EURO_OPTIONS} options x {NUM_PATHS} paths "
          f"({len(batch._hinge_groups())} hinge-sum groups): warm wall {diff_s:.4f} s "
          f"({diff._grad_mode_resolved} mode), peak memory {diff_peak:.2f} GiB")
    launches = hybrid_paths.launches  # this main path only
    print(f"  K2 launches: {launches} (1 per run, forward and differentiated)")
    cf, cf_grads = closed_form_sum(diff.model, products)
    grads = diff_results.get_derivatives("european_book", "pv", evaluation_idx=0)
    for name in diff.model.get_model_param_names()[:8]:
        mc, ref = float(grads[name]), cf_grads[name]
        gap = abs(mc - ref) / abs(ref)
        print(f"  d pv / d {name}: pathwise {mc:.4f} vs closed forms {ref:.4f} (gap {gap:.3%})")
        check(gap < 0.02, f"d pv / d {name} is {gap:.3%} from the closed forms")
    names = diff.model.get_model_param_names()
    jac_k = np.array([float(grads[n]) for n in names])
    torch.cuda.empty_cache()

    engine, _ = euro_book(EURO_OPTIONS, differentiate=True, use_kernel=False)
    engine_results = None

    def run_engine():
        nonlocal engine_results
        engine_results = engine.run_simulation()

    engine_s = wall_seconds(run_engine)
    check(hybrid_paths.launches == launches, "the engine route launched K2")
    jac_e = np.array([float(engine_results.get_derivatives("european_book", "pv",
                                                             evaluation_idx=0)[n]) for n in names])
    jrel = float(np.max(np.abs(jac_k - jac_e) / np.maximum(np.abs(jac_e), 1e-6)))
    print(f"[bs-multi european differentiated, engine route] wall {engine_s:.4f} s; kernel vs "
          f"engine jacobian max rel err {jrel:.3e}")
    same_values(diff_results, engine_results, "bs-multi european differentiated")
    np.testing.assert_allclose(jac_k, jac_e, rtol=1e-3, atol=1e-6)
    del engine
    torch.cuda.empty_cache()
    return launches


def baskets():
    """The 100-basket family of benchmarks/pv_large_book.py:90-99, then four
    equal-weight geometric baskets of all four assets (the closed form's
    case)."""
    weights = [[0.5, 0.3, 0.2, 0.0], [0.25] * 4, [0.4, 0.35, 0.15, 0.10]]
    family = []
    for i in range(100):
        n_active = 2 + (i % 3)
        w = weights[i % 3][:n_active]
        family.append(mt.BasketOption(
            [0.75, 1.25, 2.0, 2.5][i % 4], list(ASSETS[:n_active]), [x / sum(w) for x in w],
            95.0 + 5.0 * (i % 5), CALL if i % 2 == 0 else PUT,
            mt.BasketOptionType.ARITHMETIC if i % 3 != 0 else mt.BasketOptionType.GEOMETRIC))
    return family + [mt.BasketOption(t, list(ASSETS), [0.25] * 4, k, kind,
                                     mt.BasketOptionType.GEOMETRIC)
                     for t, k, kind in ((0.75, 100.0, CALL), (1.25, 105.0, PUT),
                                        (2.0, 95.0, CALL), (2.5, 110.0, PUT))]


def basket_phase():
    """The basket family on the European book's model, each basket its own
    netting set: kernel vs engine route, the geometric ones against the
    closed form."""
    make = lambda use_kernel: book(bs_multi_model(),
                                   [mt.NettingSet(name=f"basket_{i}", products=[p])
                                    for i, p in enumerate(baskets())],
                                   mt.SimulationScheme.ANALYTICAL, 1, use_kernel=use_kernel)
    reset_k2_counts()
    kernel = make("auto")
    check(kernel._kernel_active, "the basket book is not on the kernel path")
    results = kernel.run_simulation()
    launches = hybrid_paths.launches
    engine_results = make(False).run_simulation()
    check(hybrid_paths.launches == launches == 1, "the basket book did not launch K2 once")
    print(f"[basket family] {len(kernel.products)} baskets, {NUM_PATHS} paths, K2 launches "
          f"{launches}")
    same_values(results, engine_results, "baskets")
    params = kernel.model.initial_params(device="cpu")
    for i, p in enumerate(kernel.products[100:], start=100):
        pv, se = pv_of(results, f"basket_{i}")
        cf = float(p.compute_pv_analytically(kernel.model, params))
        print(f"  geometric T={p.maturity} K={p.strike}: pv {pv:.5f} se {se:.5f} closed form "
              f"{cf:.5f} ({abs(pv - cf) / se:.2f} SE)")
        check(abs(pv - cf) < 4 * se, f"geometric basket {i}: {pv} vs {cf}")
    return launches


def hw_book(scheme, differentiate=False, use_kernel="auto", vol=0.01, mr=0.4):
    """The Hull-White bond of tests/test_pallas_controller_tpu.py:454-466."""
    model = mt.HullWhiteModel(0.0, HW_TIMES, HW_DFS, volatility=vol, mean_reversion=mr,
                              asset_id="irs")
    bond = mt.Bond(startdate=0.0, maturity=3.0, notional=1.0, tenor=3.0, pays_notional=True,
                   fixed_rate=0.0, asset_id="irs")
    return book(model, [mt.NettingSet(name="bond", products=[bond])], scheme, 16,
                differentiate, use_kernel)


def hw_phase(scheme):
    """Hull-White bond: kernel vs engine route, the curve's 0.90, and under
    ANALYTICAL the differentiated vol / mean-reversion derivatives against
    a common-random-number central difference of the same kernel stream
    (tests/test_pallas_controller_tpu.py:468-505)."""
    reset_k2_counts()
    kernel = hw_book(scheme)
    check(kernel._kernel_active, "the Hull-White bond is not on the kernel path")
    pv_k, _ = pv_of(kernel.run_simulation(), "bond")
    pv_e, se_e = pv_of(hw_book(scheme, use_kernel=False).run_simulation(), "bond")
    print(f"[hull-white bond, {scheme.name}] pv kernel {pv_k:.6f} engine {pv_e:.6f} (se {se_e:.2e})")
    check(abs(pv_k - pv_e) < 4 * se_e + 1e-4, "kernel and engine bond PVs differ")
    check(abs(pv_e - 0.90) < 5e-3, f"bond pv {pv_e} is not the curve's 0.90")
    if scheme == mt.SimulationScheme.ANALYTICAL:
        diff = hw_book(scheme, differentiate=True)
        grads = diff.run_simulation().get_derivatives("bond", "pv", evaluation_idx=0)
        base = dict(zip(diff.model.get_model_param_names(), diff.model._initial_values()))
        for name, kw in (("volatility", "vol"), ("mean_reversion", "mr")):
            h = 1e-3 * max(1.0, abs(base[name]))
            bumped = lambda s: pv_of(hw_book(scheme, **{kw: base[name] + s * h}).run_simulation(),
                                     "bond")[0]
            fd = (bumped(1) - bumped(-1)) / (2 * h)
            aad = float(grads[name])
            print(f"  d pv / d {name}: pathwise {aad:.6f} vs CRN central difference {fd:.6f}")
            check(abs(aad - fd) < 2e-3 * max(1.0, abs(fd)) + 2e-4, f"d pv / d {name}")
    check(hybrid_paths.launches > 0, "the Hull-White phase launched no K2")
    return hybrid_paths.launches


def s2f_book(scheme, differentiate, use_kernel="auto"):
    """The Schwartz-2F call of tests/test_pallas_controller_tpu.py:517-533."""
    model = mt.SchwartzTwoFactorModel(0.0, [0.0, 1.0, 3.0], [50.0, 52.0, 55.0], rate=0.03,
                                      short_term_mean_reversion=1.2, short_term_vol=0.3,
                                      long_term_drift=0.01, long_term_vol=0.15, rho=0.35,
                                      asset_id="gas")
    option = mt.EuropeanOption(mt.Equity("gas"), 2.0, 52.0, CALL, asset_id="gas")
    return book(model, [mt.NettingSet(name="book", products=[option])], scheme, 8,
                differentiate, use_kernel)


def s2f_phase(scheme):
    """Schwartz-2F call, differentiated: kernel vs engine PV within 4
    combined SE + 1e-4, the vol and rho derivatives within 10 % + 1e-3."""
    reset_k2_counts()
    kernel = s2f_book(scheme, True)
    check(kernel._kernel_active, "the Schwartz-2F call is not on the kernel path")
    r_k = kernel.run_simulation()
    launches = hybrid_paths.launches
    r_e = s2f_book(scheme, True, use_kernel=False).run_simulation()
    check(hybrid_paths.launches == launches > 0, "the Schwartz-2F phase did not launch K2")
    (pv_k, se_k), (pv_e, se_e) = pv_of(r_k, "book"), pv_of(r_e, "book")
    se = math.hypot(se_k, se_e)
    print(f"[schwartz-2f call, {scheme.name}] pv kernel {pv_k:.6f} engine {pv_e:.6f} (se {se:.2e})")
    check(abs(pv_k - pv_e) < 4 * se + 1e-4, "kernel and engine call PVs differ")
    g_k = r_k.get_derivatives("book", "pv", evaluation_idx=0)
    g_e = r_e.get_derivatives("book", "pv", evaluation_idx=0)
    for name in ("short_term_vol", "long_term_vol", "rho"):
        a, b = float(g_k[name]), float(g_e[name])
        print(f"  d pv / d {name}: kernel {a:.6f} engine {b:.6f}")
        check(np.isfinite(a) and abs(a - b) < 0.1 * max(abs(a), abs(b)) + 1e-3, f"d pv / d {name}")
    return launches


class SurvivalClaim(mt.Product):
    """Pays 1 at maturity if the reference entity has not defaulted: its
    value on a path is the survival exp(-int lambda) of a CIR++ model, whose
    mean reprices the market survival curve."""

    def __init__(self, maturity: float, asset_id: str):
        super().__init__(asset_ids=[asset_id])
        self.product_timeline = self.modeling_timeline = (float(maturity),)
        self.spot_requests = {(0, asset_id): AtomicRequest(AtomicRequestType.SURVIVAL_PROBABILITY)}

    def compute_normalized_cashflows(self, time_idx, model, params, resolved_requests,
                                     regression_function=None, state_matrix=None):
        survival = resolved_requests[0][self.spot_requests[(0, self.asset_ids[0])].handle]
        return state_matrix, survival[:, None]


def route_specs():
    """The other K2 routes: {rung label: (title, model maker, products maker,
    scheme, substeps, oracle, tolerance)}.  BS, Vasicek, CIR++ and
    deterministic CIR++ alone, each with an oracle of its book's PV; two
    ModelConfig books under EULER (the European book's first 100 options on
    BS-multi alone, a PV book on the mixed model), held to the engine only."""
    A, E = mt.SimulationScheme.ANALYTICAL, mt.SimulationScheme.EULER
    bs = lambda: mt.BlackScholesModel(0.0, spot=100.0, rate=0.03, sigma=0.22, asset_id="eq")
    bs_options = lambda: [mt.EuropeanOption(mt.Equity("eq"), 0.5 + 0.25 * i, 80.0 + 5.0 * i,
                                            CALL if i % 2 == 0 else PUT, asset_id="eq")
                          for i in range(10)]
    vas = lambda: mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                                  volatility=0.012, asset_id="irs")
    zero_bonds = lambda: [mt.Bond(startdate=0.0, maturity=0.5 + 0.25 * i, notional=1.0,
                                  tenor=0.5 + 0.25 * i, pays_notional=True, fixed_rate=0.0,
                                  asset_id="irs") for i in range(10)]
    cir = lambda det: (lambda: mt.CIRPPModel(0.0, "cp", CIR_HAZARDS, kappa=0.5, theta=0.03,
                                             volatility=0.05, y0=0.03, deterministic=det))
    claim = lambda: [SurvivalClaim(3.0, "cp")]
    market = lambda m: 1.0 - float(probability_of_default(
        torch.tensor(m.hazard_rates), torch.tensor(m.tenors), torch.tensor(3.0)))
    params = lambda m: m.initial_params(device="cpu")
    mixed_products = lambda: [
        mt.EuropeanOption(mt.Equity("asset_0"), 1.0, 100.0, CALL, asset_id="asset_0"),
        mt.EuropeanOption(mt.Equity("asset_3"), 2.0, 115.0, PUT, asset_id="asset_3"),
        mt.InterestRateSwap(0.0, 3.0, notional=1.0, fixed_rate=0.04, tenor_fixed=0.5,
                            tenor_float=0.5, irs_type=mt.IRSType.PAYER, asset_id="irs"),
        mt.Bond(startdate=0.0, maturity=3.0, notional=1.0, tenor=3.0, pays_notional=True,
                fixed_rate=0.0, asset_id="hw")]
    return {
        "bs exact": ("black-scholes alone, ANALYTICAL", bs, bs_options, A, 1,
                     lambda m: sum(float(o.compute_pv_analytically(m, params(m)))
                                   for o in bs_options()), lambda se: 4 * se),
        # the left-Riemann numeraire bias (quirk Q3) of ten bonds at 4 substeps
        "vasicek exact": ("vasicek alone, ANALYTICAL", vas, zero_bonds, A, 4,
                          lambda m: sum(float(m.bond_price(params(m), 0.0, b.maturity,
                                                           params(m)[0])) for b in zero_bonds()),
                          lambda se: 1e-2),
        "cirpp euler": ("cir++ alone, EULER", cir(False), claim, E, 32, market,
                        lambda se: 4 * se + 2e-3),
        "cirpp_det euler": ("deterministic cir++ alone, EULER", cir(True), claim, E, 16, market,
                            lambda se: 2e-3),
        "bs_multi euler": ("model config of bs-multi, EULER",
                           lambda: mt.ModelConfig([bs_multi_model()]),
                           lambda: euro_options(100), E, 4, None, None),
        "bs_multi, vasicek, hw, cirpp_det euler": (
            "model config of bs-multi, vasicek, hull-white, deterministic cir++, EULER",
            mixed_model, mixed_products, E, 4, None, None),
    }


def route_book(spec, use_kernel="auto"):
    _, make_model, products, scheme, num_steps = spec[:5]
    return book(make_model(), [mt.NettingSet(name="book", products=products())], scheme,
                num_steps, use_kernel=use_kernel)


def route_phase(spec):
    """One K2 route: kernel vs engine values on one stream, and the book's
    PV against its oracle where it has one; returns K2's launches."""
    title, _, _, _, _, oracle, tol = spec
    reset_k2_counts()
    kernel = route_book(spec)
    check(kernel._kernel_active, f"{title}: not on the kernel path")
    r_k = kernel.run_simulation()
    launches = hybrid_paths.launches
    r_e = route_book(spec, use_kernel=False).run_simulation()
    check(hybrid_paths.launches == launches == 1, f"{title}: K2 launches {launches}, not 1")
    pv, se = pv_of(r_k, "book")
    if oracle is None:
        print(f"[{title}] pv {pv:.6f} se {se:.2e}")
    else:
        ref = oracle(kernel.model)
        print(f"[{title}] pv {pv:.6f} se {se:.2e} vs {ref:.6f} ({abs(pv - ref):.2e} apart)")
        check(abs(pv - ref) < tol(se), f"{title}: pv {pv} vs {ref}")
    same_values(r_k, r_e, title)
    return launches


def mixed_model():
    """ModelConfig of BS-multi (4), Vasicek, Hull-White and deterministic
    CIR++: seven noise factors, every ModelConfig block kind but Black-Scholes
    and stochastic CIR++ (which the north star has)."""
    col = lambda v: np.full((4, 1), v)
    return mt.ModelConfig(
        [bs_multi_model(),
         mt.VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3, volatility=0.012,
                         asset_id="irs"),
         mt.HullWhiteModel(0.0, HW_TIMES, HW_DFS, volatility=0.01, mean_reversion=0.4,
                           asset_id="hw"),
         mt.CIRPPModel(0.0, CP, HAZARDS, kappa=0.1, theta=0.01, volatility=0.02, y0=0.0001,
                       deterministic=True)],
        inter_asset_correlation_matrix=[col(0.1), col(0.05), col(0.2), np.array([[0.3]]),
                                        np.array([[0.1]]), np.array([[0.15]])])


# -- the mixed book, the product oracles, storage and the CVA book ----------------------------

def slice_controller(parts, num_paths, num_presim, scheme, differentiate=False, use_kernel="auto",
                     **kw):
    return mt.SimulationController(*parts, num_paths, num_presim, 1, scheme,
                                   differentiate=differentiate, root_seed=SEED,
                                   use_kernel=use_kernel, device="cuda", **kw)


def mixed_controller(by_family=False, differentiate=False, use_kernel="auto", batch_products=True,
                     scale=1.0):
    """The mixed PV book (pv_large_book.py:148-174) on the card: 1,000 main
    and 1,000 presim paths, ANALYTICAL, one substep, PV."""
    parts = mixed_book_parts(scaled_counts(MIXED_COUNTS, scale), by_family)
    return slice_controller(parts, MIXED_PATHS, MIXED_PATHS, mt.SimulationScheme.ANALYTICAL,
                            differentiate, use_kernel, batch_products=batch_products)


def route_gap(label, kernel, engine, names):
    """Kernel route vs engine route of differentiated runs on one stream, a
    netting set per family: the book's PV (their sum) to 1e-4 relative and
    its jacobian to rtol 1e-3, atol 1e-6; a family that misses these limits
    prints its PV and jacobian on both routes.  (An exercise decision taken
    at t = 0, where every path shares the spot, turns on continuation
    values that the float32 paths move by ~1e-7: a near tie there flips the
    decision on every path of that product, so a family can miss where the
    book does not.)"""
    k = np.array([pv_of(kernel, n)[0] for n in names])
    e = np.array([pv_of(engine, n)[0] for n in names])
    jk = np.array([np.asarray(kernel.get_derivatives(n, "pv"), dtype=float).ravel() for n in names])
    je = np.array([np.asarray(engine.get_derivatives(n, "pv"), dtype=float).ravel() for n in names])
    rel = np.abs(k - e) / np.maximum(np.abs(e), 1e-6)
    for i in range(len(names)):
        if rel[i] > 1e-4 or not np.allclose(jk[i], je[i], rtol=1e-3, atol=1e-6):
            print(f"    {names[i]} misses the limits: pv kernel {k[i]:.10g} engine {e[i]:.10g} "
                  f"(rel {rel[i]:.2e}); jacobian kernel {jk[i].tolist()} engine {je[i].tolist()}")
    book_k, book_e, jac_k, jac_e = k.sum(), e.sum(), jk.sum(axis=0), je.sum(axis=0)
    jrel = float(np.max(np.abs(jac_k - jac_e) / np.maximum(np.abs(jac_e), 1e-6)))
    print(f"  {label}: kernel vs engine route book pv {book_k:.8g} vs {book_e:.8g} (rel "
          f"{abs(book_k - book_e) / abs(book_e):.3e}), jacobian max rel err {jrel:.3e}; families' "
          f"max rel err {rel.max():.3e}")
    check(bool(np.isfinite(k).all() and np.isfinite(jk).all()), f"{label}: non-finite values")
    np.testing.assert_allclose(book_k, book_e, rtol=1e-4, err_msg=label)
    np.testing.assert_allclose(jac_k, jac_e, rtol=1e-3, atol=1e-6, err_msg=label)


def batched_vs_per_product(names):
    """The mixed book forward with one netting set per family, family-batched
    and per product (``batch_products=False``), on the same K2 draws (one
    seed, one stream): each family's PV printed, the book's (their sum) to
    rel 1e-9; cold and warm walls of both.  Returns the per-product run."""
    out = {}
    for batched in (True, False):
        c = mixed_controller(by_family=True, batch_products=batched)
        results = None

        def run():
            nonlocal results
            results = c.run_simulation()

        before = hybrid_paths.launches
        cold, warm = wall_seconds(run), wall_seconds(run)
        check(hybrid_paths.launches == before + 4, "a forward run did not launch K2 once a phase")
        out[batched] = (np.array([pv_of(results, n)[0] for n in names]), cold, warm, c)
    (pv_b, cold_b, warm_b, c_b), (pv_p, cold_p, warm_p, c_p) = out[True], out[False]
    print(f"[mixed book, batched vs per product] one netting set per family, {len(c_b._batches)} "
          f"batches ({len(c_b._batched_ids)} products) vs {len(c_p._exercise_scan_groups()[0])} "
          f"exercise buckets and {len(c_p.products)} products one by one: cold walls "
          f"{cold_b:.4f} / {cold_p:.4f} s, warm walls {warm_b:.4f} / {warm_p:.4f} s "
          f"({warm_p / warm_b:.1f}x)")
    rel = np.abs(pv_b - pv_p) / np.maximum(np.abs(pv_p), 1e-12)
    for n, b, q, r in zip(names, pv_b, pv_p, rel):
        print(f"  {n}: pv batched {b:.12g} per product {q:.12g} (rel {r:.2e})")
    book_rel = abs(pv_b.sum() - pv_p.sum()) / abs(pv_p.sum())
    print(f"  book pv batched {pv_b.sum():.12g} per product {pv_p.sum():.12g} (rel {book_rel:.2e})")
    check(bool(np.isfinite(pv_b).all()), "non-finite batched family PVs")
    np.testing.assert_allclose(pv_b.sum(), pv_p.sum(), rtol=1e-9, err_msg="batched vs per product")
    return c_p


def mixed_main_path(device, issue=None):
    """The 50,000-product mixed PV book on K2 (bs_multi exact, both
    phases), counts from 0: one netting set forward (cold and warm), then
    one netting set per family differentiated on the kernel route (the
    differentiated wall: reverse mode, P = 9 > V = 8) and on the engine
    route, then forward batched against per product.  Returns the K2 row of
    the book's shapes (its launches filled in)."""
    reset_k2_counts()
    t0 = time.perf_counter()
    fwd = mixed_controller()
    setup_s = time.perf_counter() - t0
    check(fwd._kernel_active, "the mixed book is not on the kernel path")
    families = dict(MIXED_COUNTS)
    buckets, _ = fwd._exercise_scan_groups()
    batched = sum(len(b.products) for b in fwd._batches)
    results = None

    def run_fwd():
        nonlocal results
        results = fwd.run_simulation()

    torch.cuda.reset_peak_memory_stats()
    cold = wall_seconds(run_fwd)
    check(hybrid_paths.launches == 2, f"forward run made {hybrid_paths.launches} K2 launches, not 2")
    warm = wall_seconds(run_fwd)
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    pv, se = pv_of(results, "mixed_book")
    print(f"[mixed book forward] {len(fwd.products)} products {families}, {MIXED_PATHS} + "
          f"{MIXED_PATHS} presim paths, {len(fwd.simulation_timeline)}-point timeline, "
          f"{len(fwd._batches)} family batches ({batched} products), {len(buckets)} exercise "
          f"buckets ({sum(map(len, buckets))} products): set-up "
          f"{setup_s:.2f} s, cold wall {cold:.4f} s, warm wall {warm:.4f} s "
          f"({len(fwd.products) / warm:.0f} products/s), peak memory {fwd_peak:.2f} GiB")
    print(f"  pv {pv:.4f} se {se:.4f}; K2 launches per run: 2 (presim + mainsim)")
    check(np.isfinite(pv) and np.isfinite(se) and se > 0, f"mixed book pv {pv} se {se}")

    names = list(families)
    diff = mixed_controller(by_family=True, differentiate=True)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    fam_k = diff.run_simulation()
    torch.cuda.synchronize()
    diff_s = time.perf_counter() - t1
    diff_peak = torch.cuda.max_memory_allocated() / 2**30
    check(hybrid_paths.launches == 6, "the differentiated run did not launch K2 once per phase")
    check(diff._grad_mode_resolved == "rev", "the mixed book's jacobian is not reverse mode")
    del diff
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fam_e = mixed_controller(by_family=True, differentiate=True, use_kernel=False).run_simulation()
    engine_s = time.perf_counter() - t1
    check(hybrid_paths.launches == 6, "the engine route launched K2")
    grads = np.sum([np.asarray(fam_k.get_derivatives(n, "pv"), dtype=float).ravel()
                    for n in names], axis=0)
    print(f"[mixed book differentiated] one netting set per family: wall {diff_s:.4f} s (rev mode: "
          f"P = 9 > V = 8), peak memory {diff_peak:.2f} GiB; engine route wall {engine_s:.4f} s; "
          f"d pv / d spot[asset_0] {grads[0]:.4f}, d pv / d rate {grads[-1]:.4f}")
    for n in names:
        (pk, sk), (pe, _) = pv_of(fam_k, n), pv_of(fam_e, n)
        print(f"  {n}: {families[n]} products, pv kernel {pk:.6f} engine {pe:.6f} (se {sk:.2e})")
    check(bool(np.isfinite(grads).all()), "non-finite mixed-book gradient")
    route_gap("mixed book by family", fam_k, fam_e, names)
    del fam_k, fam_e
    torch.cuda.empty_cache()
    per_product = batched_vs_per_product(names)
    launches = hybrid_paths.launches
    del per_product
    torch.cuda.empty_cache()
    # the kernel against its plain version at the book's shapes, after the
    # counts were read: these launches are not the main path's
    row = model_rung("bs_multi exact, mixed book", fwd, device, issue)
    row["launches"] = launches
    return row


def crr_american_put(s0, k, r, sigma, maturity, steps=2000):
    """Cox-Ross-Rubinstein tree (tests/test_american_option.py:27-40)."""
    dt = maturity / steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    p = (np.exp(r * dt) - d) / (u - d)
    disc = np.exp(-r * dt)
    j = np.arange(steps + 1)
    prices = s0 * u ** (steps - j) * d ** j
    values = np.maximum(k - prices, 0.0)
    for step in range(steps - 1, -1, -1):
        prices = prices[: step + 1] * d
        values = disc * (p * values[: step + 1] + (1 - p) * values[1: step + 2])
        values = np.maximum(values, k - prices)
    return values[0]


def one_product(product, model, num_paths, num_presim):
    """PV and SE of one product on the card (K2, ANALYTICAL)."""
    c = slice_controller(([mt.NettingSet(name="p", products=[product])], model, PV()), num_paths,
                         num_presim, mt.SimulationScheme.ANALYTICAL)
    check(c._kernel_active, f"{type(product).__name__}: not on the kernel path")
    return pv_of(c.run_simulation(), "p")


def product_oracles():
    """The products against their oracles at path counts a desk uses, on K2
    (bs exact), each with the tolerance of the JAX package's own test;
    returns K2's launches."""
    reset_k2_counts()
    bs = lambda rate, sigma: mt.BlackScholesModel(0.0, spot=100.0, rate=rate, sigma=sigma,
                                                   asset_id="eq")
    n17, n18, n20 = ORACLE_PATHS
    crr = crr_american_put(100.0, 100.0, 0.05, 0.3, 1.0)
    for itm_only in (False, True):
        put = mt.AmericanOption(mt.Equity("eq"), 1.0, 50, 100.0, PUT, asset_id="eq")
        put.itm_only_regression = itm_only
        pv, se = one_product(put, bs(0.05, 0.3), n17, n17)
        print(f"[american put, 50 dates, {'itm-only' if itm_only else 'all-path'} LSM] {n17} + {n17} "
              f"presim paths: pv {pv:.5f} se {se:.5f} vs CRR {crr:.5f} ({pv / crr - 1:+.3%})")
        if itm_only:  # tests/test_american_option.py:86-107
            check(abs(pv / crr - 1.0) < 0.015, f"itm-only American put {pv} vs CRR {crr}")
        else:  # tests/test_american_option.py:63-78
            check(0.9 * crr < pv < crr + 4 * se, f"American put {pv} vs CRR {crr}")

    model = bs(0.05, 0.2)
    # the down-and-out closed form is the textbook one (the JAX package's
    # lacks a factor S/B), so its limit is max(6 SE, 1 %)
    for kind, strike, barrier, tol in (("UPANDOUT", 90.0, 140.0, 0.06),
                                       ("DOWNANDOUT", 100.0, 80.0, 0.01)):
        option = mt.BarrierOption(0.0, 1.0, strike, 101, CALL, barrier, mt.BarrierOptionType[kind],
                                  asset_id="eq")
        option.set_use_brownian_bridge()
        pv, se = one_product(option, model, n18, 0)
        ref = float(option.compute_pv_analytically(model, model.initial_params(device="cpu")))
        print(f"[barrier {kind} call, bridge, 101 dates] {n18} paths: pv {pv:.5f} se {se:.5f} vs "
              f"closed form {ref:.5f} ({abs(pv - ref) / se:.2f} SE)")
        check(abs(pv - ref) < max(6 * se, tol * ref), f"{kind} barrier {pv} vs {ref}")

    model = bs(0.03, 0.25)
    binary = mt.BinaryOption(1.0, 100.0, 10.0, CALL, asset_id="eq")
    pv, se = one_product(binary, model, n20, 0)
    ref = float(binary.compute_pv_analytically(model, model.initial_params(device="cpu")))
    print(f"[binary call] {n20} paths: pv {pv:.5f} se {se:.5f} vs closed form {ref:.5f} "
          f"({abs(pv - ref) / se:.2f} SE)")
    check(abs(pv - ref) < max(4 * se, 0.02 * ref), f"binary {pv} vs {ref}")

    # Asian: call - put = e^{-rT} (average - K) on every path
    times = np.linspace(0.0, 1.0, 12)
    asian = lambda kind: mt.AsianOption(0.0, 1.0, 100.0, len(times), kind,
                                        mt.AsianAveragingType.ARITHMETIC, asset_id="eq")
    c = slice_controller(([mt.NettingSet(name="call", products=[asian(CALL)]),
                           mt.NettingSet(name="put", products=[asian(PUT)])], model, PV()),
                         n20, 0, mt.SimulationScheme.ANALYTICAL)
    check(c._kernel_active, "the Asian book is not on the kernel path")
    r = c.run_simulation()
    (call, _), (put, _) = pv_of(r, "call"), pv_of(r, "put")
    disc, s0, rate, sigma = np.exp(-0.03), 100.0, 0.03, 0.25
    mean = s0 * np.exp(rate * times)
    cov = np.outer(mean, mean) * (np.exp(sigma ** 2 * np.minimum.outer(times, times)) - 1.0)
    ref = disc * (mean.mean() - 100.0)
    se_diff = disc * np.sqrt(cov.mean() / n20)  # the pathwise difference's exact SE
    print(f"[asian arithmetic, 12 dates] {n20} paths: call - put {call - put:.5f} vs "
          f"e^-rT (mean S0 e^(r t_i) - K) {ref:.5f} ({abs(call - put - ref) / se_diff:.2f} SE)")
    check(abs(call - put - ref) < 4 * se_diff, f"Asian parity {call - put} vs {ref}")

    dates, strikes = (0.5, 1.0, 1.5), (95.0, 100.0, 105.0)
    europeans = [mt.EuropeanOption(mt.Equity("eq"), t, k, CALL, asset_id="eq")
                 for t, k in zip(dates, strikes)]
    cfs = [float(o.compute_pv_analytically(model, model.initial_params(device="cpu")))
           for o in europeans]
    pv, se = one_product(mt.FlexiCall(europeans, 2, asset_id="eq"), model, n17, n17)
    print(f"[flexicall, 3 dates, 2 rights] {n17} + {n17} presim paths: pv {pv:.5f} se {se:.5f}; "
          f"Europeans' closed forms {', '.join(f'{x:.5f}' for x in cfs)}")
    check(0.95 * max(cfs) <= pv <= sum(cfs) + 4 * se, f"FlexiCall {pv} vs Europeans {cfs}")
    launches = hybrid_paths.launches
    print(f"  K2 launches: {launches}")
    check(launches > 0, "the product oracles launched no K2")
    return launches


# The deterministic storage scenarios of tests/test_storage_s2f_scenarios.py:
# (end date, initial amount, volume windows, injection ramp, withdrawal
# ramp, injection cost, withdrawal cost, states, (day, price) curve, daily rate).
STORAGE_SCENARIOS = {
    "ramp_up_curve": (62.0, 0.0, ((0.0, 62.0, 0.0, 90.0),),
                      ((0.0, 62.0, 0.0, 4.0), (0.0, 62.0, 50.0, 2.0)),
                      ((0.0, 62.0, 0.0, 1.5), (0.0, 62.0, 50.0, 5.0)), 0.2, 0.05, 10,
                      ((0.0, 100.0), (15.0, 100.0), (34.0, 110.0), (62.0, 112.0)), 0.0),
    "seasonal_windows": (120.0, 0.0, ((0.0, 40.0, 0.0, 100.0), (40.0, 80.0, 20.0, 120.0),
                                      (80.0, 121.0, 0.0, 60.0)),
                         ((0.0, 60.0, 0.0, 5.0), (0.0, 60.0, 60.0, 3.5), (0.0, 60.0, 110.0, 2.0),
                          (60.0, 121.0, 0.0, 6.5), (60.0, 121.0, 60.0, 4.0),
                          (60.0, 121.0, 110.0, 2.5)),
                         ((0.0, 60.0, 0.0, 2.0), (0.0, 60.0, 60.0, 3.6), (0.0, 60.0, 110.0, 5.0),
                          (60.0, 121.0, 0.0, 2.6), (60.0, 121.0, 60.0, 4.4),
                          (60.0, 121.0, 110.0, 6.4)), 0.35, 0.12, 12,
                         ((0.0, 90.0), (30.0, 94.0), (60.0, 88.0), (90.0, 104.0), (120.0, 98.0)),
                         0.0),
    "forced_drawdown": (60.0, 48.0, ((0.0, 30.0, 0.0, 80.0), (30.0, 45.0, 0.0, 40.0),
                                     (45.0, 61.0, 0.0, 10.0)),
                        ((0.0, 61.0, 0.0, 2.0),), ((0.0, 61.0, 0.0, 3.0), (0.0, 61.0, 70.0, 6.0)),
                        0.1, 0.1, 8, ((0.0, 120.0), (25.0, 112.0), (45.0, 104.0), (60.0, 100.0)),
                        0.0),
}
STORAGE_SCENARIOS["discounted"] = STORAGE_SCENARIOS["ramp_up_curve"][:-1] + (0.10 / 365.0,)


def scenario_storage(sc):
    end, initial, windows, inj, wd, c_inj, c_wd, states = sc[:8]
    cfg = mt.StorageConfig()
    for start, stop, vmin, vmax in windows:
        cfg.add_volume_constraint(start, stop, vmin, vmax, 0.0)
    for start, stop, point, rate in inj:
        cfg.add_injection_flexibility(start, stop, point, rate)
    for start, stop, point, rate in wd:
        cfg.add_withdrawal_flexibility(start, stop, point, rate)
    cfg.add_variable_injection_cost(0.0, c_inj)
    cfg.add_variable_withdrawal_cost(0.0, c_wd)
    return mt.Storage(asset_id="gas", start_date=0.0, end_date=end, initial_amount=initial,
                      storage_config=cfg, num_states=states)


def scenario_model(sc):
    """Schwartz-2F with zero volatilities: the spot is the forward curve."""
    curve, rate = sc[8], sc[9]
    return mt.SchwartzTwoFactorModel(0.0, [t for t, _ in curve], [v for _, v in curve], rate=rate,
                                     short_term_mean_reversion=1.5 / 365.0, short_term_vol=0.0,
                                     long_term_drift=0.0, long_term_vol=0.0, rho=0.2,
                                     asset_id="gas")


def storage_dp_oracle(storage, spot_fn, rate: float) -> float:
    """Backward grid DP with interpolated continuations, then the forward
    policy rollout, in plain numpy (tests/test_storage_s2f_scenarios.py:96-177)."""
    cfg, S = storage.storage_config, storage.num_states
    grid = np.arange(S, dtype=float)

    def event(i):
        t, tn = storage.product_timeline[i], storage.next_action_dates[i]
        pw, nw = cfg.get_volume_constraint(t), cfg.get_volume_constraint(tn)
        period, spot = max(tn - t, 0.0), spot_fn(t)
        span_p, span_n = pw.vmax - pw.vmin, max(nw.vmax - nw.vmin, 1e-30)
        cinj, cwd = cfg.get_variable_injection_cost(t), cfg.get_variable_withdrawal_cost(t)

        def actions(states):
            prev = pw.vmin + np.asarray(states, dtype=float) * span_p / (S - 1)
            inj = np.array([cfg.get_injection_flexibility_rate(t, v) for v in prev])
            wd = np.array([cfg.get_withdrawal_flexibility_rate(t, v) for v in prev])
            vols = np.stack([np.minimum(prev + inj * period, nw.vmax), np.clip(prev, nw.vmin, nw.vmax),
                             np.maximum(prev - wd * period, nw.vmin)])
            deltas = vols - prev
            hold_price = np.where(deltas[1] >= 0.0, spot + cinj, spot - cwd)
            payoffs = np.stack([-deltas[0] * (spot + cinj), -deltas[1] * hold_price,
                                -deltas[2] * (spot - cwd)])
            return payoffs, np.clip((vols - nw.vmin) * (S - 1) / span_n, 0.0, S - 1.0)

        return actions, tn >= storage.end_date - 1e-12, t, tn

    events = [event(i) for i in range(len(storage.product_timeline))]
    v_grids, v_next = [None] * len(events), np.zeros(S)
    for i in reversed(range(len(events))):
        actions, is_last, t, tn = events[i]
        payoffs, coords = actions(grid)
        cont = (np.zeros_like(payoffs) if is_last
                else np.stack([np.interp(c, grid, v_next) for c in coords]))
        vals = payoffs + np.exp(-rate * (tn - t)) * cont
        v_next = vals[np.argmax(vals, axis=0), np.arange(S)]
        v_grids[i] = v_next.copy()
    x, pv = 0.0, 0.0
    for i, (actions, is_last, t, tn) in enumerate(events):
        payoffs, coords = actions(np.array([x]))
        cont = (np.zeros((3, 1)) if is_last
                else np.stack([np.interp(c, grid, v_grids[i + 1]) for c in coords]))
        best = int(np.argmax(payoffs[:, 0] + np.exp(-rate * (tn - t)) * cont[:, 0]))
        pv += payoffs[best, 0] * np.exp(-rate * t)
        x = coords[best, 0]
    return pv


def storage_phase():
    """Storage on K2 (s2f exact): the deterministic scenarios against the DP
    oracle, then the event scan against the per-date unrolled path on
    tests/test_storage_scan_equivalence.py's set-up (rel 1e-12); returns
    K2's launches.  The scenarios hold to the JAX test's rel 1e-9 on the
    engine route (float64 paths; EULER, the test's scheme: the exact step's
    Cholesky needs a volatility); on K2 (ANALYTICAL) the state log S is
    float32 (|log S| ~ 4.7: ~3e-7 relative in the spot), so the kernel route
    holds to 1e-6."""
    reset_k2_counts()
    for name, sc in STORAGE_SCENARIOS.items():
        curve = sc[8]
        spot_fn = lambda t: float(np.interp(t, [c[0] for c in curve], [c[1] for c in curve]))
        expected = storage_dp_oracle(scenario_storage(sc), spot_fn, sc[9])
        check(expected != 0.0, f"storage {name}: the oracle's PV is 0")
        pvs = {}
        for use_kernel, rtol, scheme in (("auto", 1e-6, mt.SimulationScheme.ANALYTICAL),
                                         (False, 1e-9, mt.SimulationScheme.EULER)):
            c = slice_controller(([mt.NettingSet(name="storage", products=[scenario_storage(sc)])],
                                  scenario_model(sc), PV()), 256, 256, scheme, use_kernel=use_kernel,
                                 regression_function=mt.PolynomialRegression(degree=3))
            check(c._kernel_active == (use_kernel == "auto"), f"storage {name}: wrong route")
            pvs[use_kernel] = pv = pv_of(c.run_simulation(), "storage")[0]
            check(abs(pv - expected) <= rtol * abs(expected) + 1e-9,
                  f"storage {name} ({'kernel' if use_kernel else 'engine'} route): {pv} vs "
                  f"{expected}")
        print(f"[storage {name}] pv kernel {pvs['auto']:.9f} (rel {pvs['auto'] / expected - 1:+.2e}), "
              f"engine {pvs[False]:.9f} (rel {pvs[False] / expected - 1:+.2e}) vs DP oracle "
              f"{expected:.9f}")

    def scan_storage():
        cfg = mt.StorageConfig()
        cfg.add_volume_constraint(0.0, 2.0, 0.0, 10.0)
        cfg.add_injection_flexibility(0.0, 2.0, 0.0, 3.0)
        cfg.add_injection_flexibility(0.0, 2.0, 6.0, 1.5)
        cfg.add_withdrawal_flexibility(0.0, 2.0, 0.0, 1.0)
        cfg.add_withdrawal_flexibility(0.0, 2.0, 6.0, 2.5)
        cfg.add_variable_injection_cost(0.0, 0.2)
        cfg.add_variable_withdrawal_cost(0.0, 0.15)
        return mt.Storage(asset_id="gas", start_date=0.0, end_date=2.0, initial_amount=3.0,
                          storage_config=cfg, num_states=6, rollout_interval=0.25)

    def gas_pv(unrolled):
        model = mt.SchwartzTwoFactorModel(0.0, [0.0, 2.0], [10.0, 11.0], rate=0.02,
                                          short_term_mean_reversion=1.0, short_term_vol=0.4,
                                          long_term_drift=0.01, long_term_vol=0.2, rho=0.3,
                                          asset_id="gas")
        c = slice_controller(([mt.NettingSet(name="s", products=[scan_storage()])], model, PV()),
                             4000, 4000, mt.SimulationScheme.ANALYTICAL)
        check(c._kernel_active, "the storage scan book is not on the kernel path")
        if unrolled:
            c._supports_exercise_scan = lambda p: False
        return pv_of(c.run_simulation(), "s")[0]

    scan, unrolled = gas_pv(False), gas_pv(True)
    print(f"[storage scan vs unrolled] 4000 + 4000 paths: {scan:.12f} vs {unrolled:.12f} "
          f"(rel {abs(scan - unrolled) / abs(unrolled):.2e})")
    check(abs(scan - unrolled) <= 1e-12 * abs(unrolled), "storage scan and unrolled path differ")
    launches = hybrid_paths.launches
    check(launches > 0, "the storage phase launched no K2")
    return launches


def cva_controller(use_kernel="auto", differentiate=False):
    return slice_controller(cva_book_parts(), MIXED_PATHS, MIXED_PATHS, mt.SimulationScheme.EULER,
                            differentiate, use_kernel)


def cva_values(results):
    """(CVA, its SE, its jacobian [P]) of a CVA-book run."""
    name = f"cva[{CP}]"
    cva = float(results.get_results("cva_book", name, evaluation_idx=0))
    se = float(results.get_mc_error("cva_book", name, evaluation_idx=0))
    jac = (np.array(list(results.get_derivatives("cva_book", name, evaluation_idx=0).values()),
                    dtype=float) if results.derivatives else None)
    return cva, se, jac


def cva_family_parts():
    """The CVA book with one netting set per family (one counterparty, MPoR
    10/252): each family's CVA alone."""
    (netting_set,), model, metrics = cva_book_parts()
    families = {}
    for p in netting_set.products:
        families.setdefault(type(p).__name__, []).append(p)
    return ([mt.NettingSet(name=f, products=ps, counterparty_id=CP, margin_period_of_risk=10 / 252)
             for f, ps in families.items()], model, metrics)


def cva_families_on_own_streams():
    """Each family's CVA on the kernel route and on the engine route with
    its own float64 draws (another stream: the kernel's Box-Muller runs in
    float32), printed; informational, the routes are held to each other on
    the kernel's draws."""
    values = {}
    for use_kernel in ("auto", False):
        r = slice_controller(cva_family_parts(), MIXED_PATHS, MIXED_PATHS,
                             mt.SimulationScheme.EULER, use_kernel=use_kernel).run_simulation()
        values[use_kernel] = {n: float(r.get_results(n, f"cva[{CP}]", evaluation_idx=0))
                              for n in r.get_netting_set_names()}
    print("  one netting set per family, kernel route vs engine route on its own draws:")
    for n, k in values["auto"].items():
        e = values[False][n]
        print(f"    {n}: cva kernel {k:.8f} engine {e:.8f} (rel {abs(k - e) / abs(e):.2e})")


def cva_phase():
    """The full CVA book (cva_large_book.py:46-87: 5,000 products, MPoR
    10/252, CVA on 80 dates) on K2 (bs_multi Euler + cirpp, both phases),
    counts from 0: forward cold and warm, then differentiated in reverse
    mode as the benchmark's ``--aad`` (P = 13 > V = 1); two K2 launches a
    run; CVA finite and positive.  The kernel route against the engine route
    fed the kernel's own draws (``draws_source``): the forward and the
    differentiated CVA 1e-4, the jacobian rtol 1e-3, atol 1e-6.  On its own
    float64 draws the engine's storage family alone moves the book's CVA
    by ~1e-3 (its decisions flip with the float32 paths; PERF.md section
    6), so each family's CVA on both routes is printed.  Returns K2's launches."""
    reset_k2_counts()
    t0 = time.perf_counter()
    c = cva_controller()
    setup_s = time.perf_counter() - t0
    check(c._kernel_active, "the CVA book is not on the kernel path")
    results = None

    def run():
        nonlocal results
        results = c.run_simulation()

    torch.cuda.reset_peak_memory_stats()
    cold = wall_seconds(run)
    check(hybrid_paths.launches == 2, f"the CVA book made {hybrid_paths.launches} K2 launches, not 2")
    warm = wall_seconds(run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cva, se, _ = cva_values(results)
    buckets, _ = c._exercise_scan_groups()
    print(f"[cva book] {len(c.products)} products ({len(c._batched_ids)} in {len(c._batches)} family "
          f"batches, {sum(map(len, buckets))} in {len(buckets)} exercise buckets), {MIXED_PATHS} + "
          f"{MIXED_PATHS} presim paths, {len(c.exposure_timeline)} exposure dates "
          f"({len(c.metric_exposure_timeline)} metric dates), {len(c.simulation_timeline)}-point "
          f"timeline: set-up {setup_s:.2f} s, cold wall {cold:.4f} s, warm wall {warm:.4f} s "
          f"({len(c.products) / warm:.0f} products/s), peak memory {peak:.2f} GiB; CVA {cva:.6f} "
          f"(se {se:.2e})")
    check(np.isfinite(cva) and cva > 0 and se > 0, f"CVA {cva} se {se}")
    del c
    torch.cuda.empty_cache()

    diff = cva_controller(differentiate=True)
    draws = capture_draws(diff)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    diff_results = diff.run_simulation()
    torch.cuda.synchronize()
    diff_s = time.perf_counter() - t1
    diff_peak = torch.cuda.max_memory_allocated() / 2**30
    check(hybrid_paths.launches == 6, "the differentiated CVA run did not launch K2 once per phase")
    check(diff._grad_mode_resolved == "rev", "the CVA book's jacobian is not reverse mode")
    launches = hybrid_paths.launches
    names = diff.model.get_model_param_names()
    d_cva, _, jac_k = cva_values(diff_results)
    print(f"[cva book differentiated] wall {diff_s:.4f} s (rev mode: P = {len(names)} > V = 1), "
          f"peak memory {diff_peak:.2f} GiB; " + ", ".join(
              f"d CVA / d {n} {g:.6g}" for n, g in zip(names, jac_k) if "asset_0" in n or "rate" in n))
    check(bool(np.isfinite(jac_k).all()) and np.abs(jac_k).max() > 0, "non-finite CVA jacobian")

    source = draws_source(diff, draws)
    del diff, draws
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    d_cva_e, _, jac_e = cva_values(slice_controller(
        cva_book_parts(), MIXED_PATHS, MIXED_PATHS, mt.SimulationScheme.EULER, True,
        use_kernel=False, noise_source=source).run_simulation())
    engine_s = time.perf_counter() - t1
    check(hybrid_paths.launches == launches, "the engine route launched K2")
    jrel = float(np.max(np.abs(jac_k - jac_e) / np.maximum(np.abs(jac_e), 1e-6)))
    print(f"  engine route on the kernel's draws, differentiated: {engine_s:.4f} s (cold); CVA "
          f"{d_cva_e:.8f} vs kernel route forward {cva:.8f} (rel {abs(cva - d_cva_e) / d_cva_e:.2e}), "
          f"differentiated {d_cva:.8f} (rel {abs(d_cva - d_cva_e) / d_cva_e:.2e}); jacobian max "
          f"rel err {jrel:.3e}")
    np.testing.assert_allclose(cva, d_cva_e, rtol=1e-4, err_msg="CVA kernel vs engine route")
    np.testing.assert_allclose(d_cva, d_cva_e, rtol=1e-4, err_msg="CVA kernel vs engine route")
    np.testing.assert_allclose(jac_k, jac_e, rtol=1e-3, atol=1e-6,
                               err_msg="CVA jacobian kernel vs engine route")
    torch.cuda.empty_cache()
    cva_families_on_own_streams()
    check(hybrid_paths.launches == launches + 2, "the family runs did not launch K2 once a phase")
    return hybrid_paths.launches


def k2_ladder(device, issue=None):
    """Phase 3c: every (block, scheme) of K2 against its plain version at
    the shapes of the book that runs it (the mixed ModelConfig at the
    north star's 57 points); returns the rows by label."""
    A, E, M = (mt.SimulationScheme.ANALYTICAL, mt.SimulationScheme.EULER,
               mt.SimulationScheme.MILSTEIN)
    print(f"[kernel] hybrid_paths ladder at {NUM_PATHS} paths")
    rows = {"bs_multi exact": model_rung("bs_multi exact", euro_book(EURO_OPTIONS)[0], device,
                                         issue)}
    for label, spec in route_specs().items():
        if label != "bs_multi, vasicek, hw, cirpp_det euler":
            rows[label] = model_rung(label, route_book(spec), device, issue)
    rows["hw exact"] = model_rung("hw exact", hw_book(A), device, issue)
    rows["hw euler"] = model_rung("hw euler", hw_book(M), device, issue)
    rows["s2f exact"] = model_rung("s2f exact", s2f_book(A, False), device, issue)
    rows["s2f euler"] = model_rung("s2f euler", s2f_book(E, False), device, issue)
    rows["bs_multi, cirpp euler"] = model_rung("bs_multi, cirpp euler", cva_controller(), device,
                                               issue)
    for label, c in example_books().items():
        rows[label] = model_rung(label, c, device, issue)
    mixed = mixed_model()
    ns_dense, _ = dense_timeline(0.0, north_star(NS_PATHS, False).simulation_timeline, 1)
    rows["bs_multi, vasicek, hw, cirpp_det euler"] = k2_rung(
        "bs_multi, vasicek, hw, cirpp_det euler", mixed.kernel_blocks(),
        np.linalg.cholesky(mixed.static_joint_correlation()),
        mixed.initial_params(device=device, dtype=torch.float32), ns_dense, 1, issue=issue)
    return rows


def k2_block_tuples():
    """The blocks of every K2 launch of this script (one build per tuple of
    slot roles)."""
    A, E, M = (mt.SimulationScheme.ANALYTICAL, mt.SimulationScheme.EULER,
               mt.SimulationScheme.MILSTEIN)
    books = [route_book(spec) for spec in route_specs().values()]
    books += [hw_book(A), hw_book(M), s2f_book(A, False), s2f_book(E, False), cva_controller()]
    books += list(example_books().values())
    return ([north_star(NS_PATHS, False).model.kernel_blocks(), [bs_multi_model().kernel_block(A)]]
            + [blocks_of(c)[0] for c in books])


def ragged_rungs(device):
    """K2 where the bulk copy cannot store every tile, bitwise against its
    plain version: the north-star blocks (D = 5) at N = 1, 257 and
    1,000,003, where N * D * 4 is not a multiple of 16 (the coalesced-store
    variant), and the BS-multi block (D = 4) at N = 257 (bulk copies and a
    ragged last block)."""
    ns = north_star(NS_PATHS, False).model
    dense, _ = dense_timeline(0.0, north_star(NS_PATHS, False).simulation_timeline, 1)
    blocks, chol = ns.kernel_blocks(), np.linalg.cholesky(ns.static_joint_correlation())
    params = ns.initial_params(device=device, dtype=torch.float32)
    print("[kernel] hybrid_paths on ragged and misaligned launches")
    for n in (1, 257, 1_000_003):
        compare_table(f"north-star blocks, N={n}", blocks, params, dense, 1)
        compare_hybrid(f"north-star blocks, N={n} (coalesced stores)", blocks, chol, params,
                       dense, 1, PHASE, n)
    m = bs_multi_model()
    timeline = tuple(0.5 + 0.25 * i for i in range(10))
    compare_hybrid("bs_multi, N=257 (bulk copies, ragged last block)",
                   [m.kernel_block(mt.SimulationScheme.ANALYTICAL)],
                   np.linalg.cholesky(m.kernel_correlation()),
                   m.initial_params(device=device, dtype=torch.float32), timeline, 1, PHASE, 257)


def sync_free(k1_params, k2_args):
    """K1's, K2's and the ladder K3's wrappers (every rung) under
    torch.cuda.set_sync_debug_mode("error"), with K2's input cache emptied
    first and then warm: no call may synchronise the host with the card."""
    from montecarlo_risk_engine_tpu_torch.ops.hybrid_paths import slot_inputs, table_inputs

    torch.cuda.synchronize()
    table_inputs.cache_clear()
    slot_inputs.cache_clear()
    dense, _ = dense_timeline(0.0, MATURITIES, NUM_STEPS)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            heston_qe_paths(k1_params, MATURITIES, NUM_PATHS, NUM_STEPS, seed=SEED, phase=PHASE)
            heston_qe_paths(k1_params, dense, NUM_PATHS, 1, seed=SEED, phase=PHASE,
                            emit_noise=True)
            hybrid_paths(*k2_args, seed=SEED, phase=PHASE)
            for rung in RUNGS:
                heston_ladder_paths(rung, k1_params, MATURITIES, NUM_PATHS, NUM_STEPS, seed=SEED,
                                    phase=PHASE)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[sync] K1 (forward and emit), K2 (table prologue and paths, cold and warm cache) and "
          "K3 (every rung) ran under set_sync_debug_mode('error'): no host sync")


def k3_ladder(issue):
    """Phase 3d: the substep ladder K3 at the JAX script's shapes
    (``tools/kernel_decomposition.py``: 1,000,000 paths x 10 points x 4
    substeps).  Every rung bitwise against its plain version; qe-full
    bitwise K1's states; qe-algebra against qe-full on the same draws
    (rtol 1e-5 / atol 1e-6 on >= 99.99 % of paths, terminal means 1e-6: the
    psi test rounds apart); every QE rung's discounted terminal spot within
    4 SE + 0.05 of the spot.  Then the ladder's main path, the run of
    ``tools/kernel_decomposition.py``, with the counts from 0 just before it
    and read just after, its table printed; each rung's launch-only and
    wrapper times.
    Returns the rungs' rows of the kernels JSON line."""
    t0 = time.perf_counter()
    device, d = torch.device("cuda"), k3_tool
    params = d.ladder_params(device)
    n, timeline, steps = d.NUM_PATHS, d.TIMELINE, d.NUM_STEPS
    plain = lambda rung: heston_ladder_paths_reference(rung, params, timeline, n, steps,
                                                       seed=d.SEED, phase=d.PHASE)
    print(f"[kernel] heston_ladder at {n} paths x {len(timeline)} points x {steps} substeps")
    states, rows = {}, {}
    for rung in RUNGS:
        out, ref = d.run(rung, params), plain(rung)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"heston_ladder[{rung}]: non-finite states")
        err, same = float((out - ref).abs().max()), torch.equal(out, ref)
        del ref
        plain_ms = median_ms(lambda: plain(rung), reps=3)
        print(f"  {rung}: bitwise {same}, max abs err {err:.3e}, plain {plain_ms:.3f} ms")
        check(same, f"heston_ladder[{rung}]: states not bitwise equal to the plain version")
        states[rung] = out
        rows[rung] = {"name": f"heston_ladder[{rung}]", "route": "cuda",
                      "source": "montecarlo_risk_engine_tpu_torch/csrc/heston_ladder.cu",
                      "replaces": "benchmarks/kernel_decomposition.py:226", "launches": 0,
                      "max_abs_err": err, "plain_ms": plain_ms}
    k1 = heston_qe_paths(params, timeline, n, steps, seed=d.SEED, phase=d.PHASE)
    check(torch.equal(k1, states["qe-full"]), "qe-full is not bitwise K1's states")
    del k1
    algebra, full = states["qe-algebra"], states["qe-full"]
    frac = float(torch.isclose(algebra, full, rtol=1e-5, atol=1e-6).all(-1).all(0).double().mean())
    mean_a, mean_f = algebra[-1].double().mean(0), full[-1].double().mean(0)
    mean_rel = float(((mean_a - mean_f).abs() / mean_f.abs()).max())
    print(f"  qe-full bitwise K1's states; qe-algebra vs qe-full: paths within rtol 1e-5/atol "
          f"1e-6 {frac:.6f}, max abs err {float((algebra - full).abs().max()):.3e}, rel err of "
          f"mean (log S_T, v_T) {mean_rel:.3e}")
    check(frac >= 0.9999 and mean_rel <= 1e-6, "qe-algebra is not qe-full to float32 rounding")
    spot, rate, maturity = d.PARAMS[0], d.PARAMS[2], timeline[-1]
    for rung in (r for r in RUNGS if r.startswith("qe-")):
        disc = torch.exp(states[rung][-1, :, 0].double()) * math.exp(-rate * maturity)
        mean, se = float(disc.mean()), float(disc.std()) / math.sqrt(n)
        print(f"  {rung}: discounted E[S_T] {mean:.5f} (se {se:.5f}) vs spot {spot}: "
              f"{abs(mean - spot) / se:.2f} SE")
        check(abs(mean - spot) <= 4 * se + 0.05, f"{rung}: the discounted spot is no martingale")
    del states, algebra, full
    torch.cuda.empty_cache()

    heston_ladder_paths.rung_launches = dict.fromkeys(RUNGS, 0)
    table = d.decompose(device, issue)
    launches = dict(heston_ladder_paths.rung_launches)
    d.print_table(table)
    substeps = n * live_substeps(timeline, steps)
    for rung, r in zip(RUNGS, table):
        launch_ms, wrapper_ms = split_ms("mcre_heston_ladder", lambda: d.run(rung, params))
        t_bound, by = bound(len(timeline) * n * 8, substeps * K3_OPS_PER_SUBSTEP[rung])
        rows[rung].update(launches=launches[rung], ms=r["single_ms"], bound_ms=t_bound,
                          bound_by=by, library_ms=None, launch_ms=launch_ms,
                          wrapper_ms=wrapper_ms, marginal_ms=r["marginal_ms"],
                          issue_ms=r["issue_ms"])
        print(f"[time] K3 heston_ladder[{rung}]: call {r['single_ms']:.4f} ms, launch-only "
              f"{launch_ms:.4f} ms, wrapper {wrapper_ms:.4f} ms (host), marginal "
              f"{r['marginal_ms']:.4f} ms, bound {t_bound:.4f} ms by {by}, launches "
              f"{launches[rung]}")
    check(all(launches[rung] > 0 for rung in RUNGS), f"a rung never launched: {launches}")
    print(f"[time] K3 ladder phase: {time.perf_counter() - t0:.1f} s")
    return list(rows.values())


# The stack a kernel may have: the 7-word reduction array of sincosf's
# large-argument path (|x| >= 105615; the angles here lie in [0, 2 pi)),
# which ptxas keeps in local memory in K2 once the kernel holds a bulk copy.
SINCOS_STACK_BYTES = 32
# Every kernel instance of each source, as ptxas_frames names them.
KERNELS = {"heston_qe": ["heston_qe_kernel<0,0>", "heston_qe_kernel<0,1>",
                         "heston_qe_kernel<1,0>", "heston_qe_kernel<1,1>"],
           "hybrid_paths": ["hybrid_kernel<0>", "hybrid_kernel<1>", "table_kernel"],
           "heston_ladder": [f"heston_ladder_kernel<{i}>" for i in range(len(RUNGS))],
           "recon_tangents": ["recon_kernel"], "qe_tangents": ["qe_tangents_kernel"]}


def local_memory_gate(name, built):
    """A build of ``csrc/<name>.cu``: ptxas reports every kernel instance of
    :data:`KERNELS`, none with a spill store or load, and no stack frame
    beyond :data:`SINCOS_STACK_BYTES`."""
    frames = {k: f for k, f in ptxas_frames(built.log).items() if k in KERNELS[name]}
    check(sorted(frames) == KERNELS[name], f"{built.path.name}: ptxas reported {sorted(frames)}")
    for kernel, frame in frames.items():
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      frame)
        check(m is not None, f"{kernel}: no stack frame in the ptxas report: {frame}")
        stack, stores, loads = (int(x) for x in m.groups())
        check(stores == 0 and loads == 0 and stack <= SINCOS_STACK_BYTES,
              f"{built.path.name} {kernel} uses local memory: {frame}")


# The north star's sweeps: P = 11 tangents, 8 a sweep.
RECON_SWEEPS = ((0, 8), (8, 11))


def recon_phase():
    """Phase 3f: the forward-mode reconstruction kernel
    (csrc/recon_tangents.cu) at the north-star shapes ([57, 1e6, 5]) on the
    main phase's frozen draws.  Its builds for the primal and the two sweeps
    (ptxas: no spill); the primal and each sweep's tangent planes bitwise its
    plain version's; call, launch-only and wrapper times beside the byte
    bound (planes written, draws read, at 3.35 TB/s); then one warm
    differentiated north-star run with its launches counted from 0 by
    tangent count (two phases x two sweeps, a primal and a tangent launch
    each: 4 primal, 2 of 8 and 2 of 3 tangents) against the same run with
    the route off (the torch rebuild, no launch), values and jacobian to
    1e-10 relative.  Each kernel row's launches are its own build's count
    in that run.  Returns the kernels' JSON rows."""
    t0 = time.perf_counter()
    device, scheme = torch.device("cuda"), mt.SimulationScheme.EULER
    c = north_star(NS_PATHS, True)
    params = c.model.initial_params(device=device, dtype=torch.float64)
    z = c._kernel_noise_of(params)[mt.rng.PHASE_MAINSIM]
    layout, steps, times = recon_tangents.model_plan(c.model, scheme, c.simulation_timeline,
                                                     c.num_steps)
    steps = torch.from_numpy(steps).to(device)
    times = torch.tensor(times, dtype=torch.float64, device=device)
    builds = recon_tangents.load_builds(layout, [0, *(hi - lo for lo, hi in RECON_SWEEPS)])
    for (name, extra), built in builds.items():
        how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
        print(f"[build] {name} {' '.join(extra)}: {how} -> {built.path.name}")
        for kernel, frame in ptxas_frames(built.log).items():
            print(f"  {kernel}: {frame}")
        local_memory_gate(name, built)
    pvec = torch.stack(params)
    psi_of = lambda p: recon_tangents.psi_columns(c.model, scheme, tuple(p.unbind(0)), times)
    psi, chol = psi_of(pvec), c.model.noise_transform(params, scheme)
    eye = torch.eye(len(params), dtype=torch.float64, device=device)
    n_pts, n_dense = layout.num_coarse, steps.shape[0]
    print(f"[kernel] recon_tangents at {NS_PATHS} paths x {n_dense} dense steps -> "
          f"{n_pts} points x D={layout.state_dim}, roles {layout.roles}")
    rows = {}
    for lo, hi in ((0, 0), *RECON_SWEEPS):
        basis = eye[lo:hi] if hi else None
        psi_t = vmap(lambda t: jvp(psi_of, (pvec,), (t,))[1])(basis) if hi else None
        args = (layout, steps, z, pvec, psi, chol, basis, psi_t)
        out, ref = recon_tangents.recon_planes(*args), recon_tangents.recon_planes_reference(*args)
        torch.cuda.synchronize()
        err, same = float((out - ref).abs().max()), torch.equal(out, ref)
        planes = max(hi - lo, 1)
        label = f"c={hi - lo}" if hi else "primal"
        del out, ref
        check(same, f"recon_tangents[{label}]: not bitwise its plain version")
        run = lambda: recon_tangents.recon_planes(*args)
        plain_ms = median_ms(lambda: recon_tangents.recon_planes_reference(*args), reps=3)
        nbytes = (planes * n_pts * layout.state_dim + n_dense * len(layout.roles)) * NS_PATHS * 8
        t_bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms, launch_ms, wrapper_ms = call_split(f"recon_tangents {label}",
                                               "mcre_recon_tangents", run, t_bound)
        print(f"    bitwise {same}, {nbytes / 1e9:.2f} GB: call {ms:.4f} ms, launch "
              f"{launch_ms:.4f} ms ({t_bound / launch_ms:.1%} of the byte bound "
              f"{t_bound:.4f} ms), plain {plain_ms:.3f} ms")
        rows[hi - lo] = {"name": f"recon_tangents[{label}]", "route": "cuda",
                         "source": "montecarlo_risk_engine_tpu_torch/csrc/recon_tangents.cu",
                         "replaces": None, "launches": 0, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": t_bound, "bound_by": "bytes",
                         "library_ms": None, "launch_ms": launch_ms, "wrapper_ms": wrapper_ms}
        torch.cuda.empty_cache()
    del z, c
    torch.cuda.empty_cache()

    def run_book(on):
        """(wall, values, jacobian, launches by tangent count) of a warm run."""
        book = north_star(NS_PATHS, True)
        if not on:
            book._recon_kernel = lambda: None
        book.run_simulation()
        out = []
        recon_tangents.recon_planes.launches.clear()
        wall = wall_seconds(lambda: out.append(book.run_simulation()))
        launches = dict(recon_tangents.recon_planes.launches)
        metrics = (f"cva[{CP}]", "epe", "pfe[0.95]")
        values = np.concatenate([np.ravel(v[0]) for v in ns_values(out[0]).values()])
        jac = np.concatenate([np.ravel(ns_jacobian(out[0], m)) for m in metrics])
        return wall, torch.from_numpy(values), torch.from_numpy(jac), launches

    wall_on, values_on, jac_on, launches = run_book(True)
    wall_off, values_off, jac_off, launches_off = run_book(False)
    want = {0: 4, **{hi - lo: 2 for lo, hi in RECON_SWEEPS}}
    check(launches == want, f"recon_tangents launched {launches} a run by tangent count, "
          f"not {want}")
    check(not launches_off, f"recon_tangents launched {launches_off} with the route off")
    gap_v = float(((values_on - values_off).abs() / values_off.abs().clamp(min=1e-300)).max())
    gap_j = float((jac_on - jac_off).abs().max() / jac_off.abs().max())
    print(f"[recon route] north star differentiated at {NS_PATHS} + {NS_PATHS} paths: wall "
          f"{wall_on:.3f} s with the kernel, {wall_off:.3f} s rebuilt in torch; launches a run "
          f"by tangent count {launches}; values rel gap {gap_v:.3e}, jacobian gap {gap_j:.3e} "
          f"(of max)")
    check(gap_v <= 1e-10 and gap_j <= 1e-10, "the kernel route's values or jacobian moved")
    for count, row in rows.items():
        row["launches"] = launches[count]
    torch.cuda.empty_cache()
    print(f"[time] recon phase: {time.perf_counter() - t0:.1f} s")
    return list(rows.values())


def storage_scan_phase():
    """Phase 3g: the storage scan kernel (csrc/storage_scan.cu) at the mixed
    book's shapes: its 100 storage deals at MIXED_PATHS paths.  Its build
    (ptxas frames printed: the fit keeps each path's grid row and stack in
    local memory); the fit's coefficients and normal equations and the
    valuation's cashflows bitwise the plain version's; call, launch-only and
    wrapper times beside the operations bound (the fit's tree-summed
    products and DP steps at the card's float64 rate); then two warm runs of
    the whole mixed book with the route on (one fit and one value launch a
    run; its ``exercise`` spans: route "kernel" over every storage deal in
    each phase) and off (the bucketed torch scans), PV to 1e-13 relative.
    Returns the kernels' JSON rows."""
    t0 = time.perf_counter()
    built = cuda_build.load_library("storage_scan")
    how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
    print(f"[build] storage_scan: {how} -> {built.path.name}")
    for kernel, frame in ptxas_frames(built.log).items():
        print(f"  {kernel}: {frame}")
    counts = {family: 0 for family in MIXED_COUNTS}
    counts["storage"] = MIXED_COUNTS["storage"]
    deals = build_book(list(ASSETS), counts)["storage"]
    c = mt.SimulationController([mt.NettingSet(name="storage", products=deals)],
                                bs_multi_model(), mt.RiskMetrics(metrics=[mt.PVMetric()]),
                                MIXED_PATHS, MIXED_PATHS, 1, mt.SimulationScheme.ANALYTICAL,
                                device="cuda")
    c._ensure_plan()
    params = c.model.initial_params(device=torch.device("cuda"), dtype=torch.float64)
    with torch.no_grad():
        pre, _ = c._simulate_and_resolve(params, MIXED_PATHS, mt.rng.PHASE_PRESIM)
    book = c._book_deals
    check(len(book.products) == len(deals), "the storage executor does not hold every deal")
    tables = book.device_tables()
    packed, obs = tables.packed, book.observations(pre, MIXED_PATHS)
    coeffs, normal = storage_scan.storage_fit(tables, obs, want_normal=True)
    ref_coeffs, ref_normal = storage_scan.storage_fit_reference(tables, obs, True)
    cfs, _ = storage_scan.storage_value(tables, obs, coeffs)
    ref_cfs, _ = storage_scan.storage_value_reference(tables, obs, coeffs)
    torch.cuda.synchronize()
    max_abs_err = {}  # by phase, against the plain version
    for phase, what, a, b in (("fit", "fit coefficients", coeffs, ref_coeffs),
                              ("fit", "fit normal equations", normal, ref_normal),
                              ("value", "value cashflows", cfs, ref_cfs)):
        check(torch.equal(a, b), f"storage_scan {what}: not bitwise the plain version")
        max_abs_err[phase] = max(max_abs_err.get(phase, 0.0), float((a - b).abs().max()))
    # operations: the fit's tree-summed products (a product and an add each)
    # and its DP step of every grid state (~120 float64 operations: two
    # ramp interpolations, three candidates, four state lookups), the value
    # phase's one step a path and event
    n, deg = MIXED_PATHS, packed.deg
    rows_states = np.repeat(packed.deals[:, storage_scan.STATES], packed.deals[:, 1])
    is_prod = packed.consts[:, storage_scan.IS_PROD]
    fit_ops = float(n * (2 * (deg + deg * (deg + 1) // 2 + deg * rows_states)
                         + 120 * rows_states * is_prod).sum())
    value_ops = float(n * 120 * is_prod.sum())
    rows = []
    for phase, run, plain, ops in (
            ("fit", lambda: storage_scan.storage_fit(tables, obs),
             lambda: storage_scan.storage_fit_reference(tables, obs), fit_ops),
            ("value", lambda: storage_scan.storage_value(tables, obs, coeffs),
             lambda: storage_scan.storage_value_reference(tables, obs, coeffs), value_ops)):
        bound = ops / FP64_OPS_PER_S * 1e3
        ms, launch_ms, wrapper_ms = call_split(f"storage_scan {phase}", f"mcre_storage_{phase}",
                                               run, bound)
        plain_ms = median_ms(plain, reps=3)
        print(f"    {packed.num_deals} deals, {packed.rows.shape[0]} event rows, {n} paths: "
              f"{ops / 1e9:.3f} GFLOP, {bound / launch_ms:.1%} of the operations bound "
              f"{bound:.4f} ms; plain {plain_ms:.1f} ms")
        rows.append({"name": f"storage_scan[{phase}]", "route": "cuda",
                     "source": "montecarlo_risk_engine_tpu_torch/csrc/storage_scan.cu",
                     "replaces": None, "launches": 0, "max_abs_err": max_abs_err[phase], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "operations",
                     "library_ms": None, "launch_ms": launch_ms, "wrapper_ms": wrapper_ms})
    del pre, obs, c
    torch.cuda.empty_cache()

    def mixed_pv(on):
        """(warm wall, PV, storage launches, storage ``exercise`` spans of a
        traced run as (route, phase, products)) of the whole mixed book; the
        route off: the kernel's devices emptied."""
        book = mt.SimulationController(*mixed_book_parts(MIXED_COUNTS), MIXED_PATHS,
                                       MIXED_PATHS, 1, mt.SimulationScheme.ANALYTICAL,
                                       device="cuda")
        devices = storage_scan._KERNEL_DEVICES
        storage_scan._KERNEL_DEVICES = devices if on else ()
        try:
            book.run_simulation()
            storage_scan.launches.clear()
            out = []
            wall = wall_seconds(lambda: out.append(book.run_simulation()))
            launched = dict(storage_scan.launches)
            tracing.enable()
            book.run_simulation()
            spans = [(r.attrs["route"], r.attrs["phase"], r.attrs["products"])
                     for r in tracing.take()
                     if r.name == "exercise" and r.attrs["kind"] == "Storage"]
        finally:
            tracing.disable()
            storage_scan._KERNEL_DEVICES = devices
        return (wall, float(out[0].get_results("mixed_book", "pv", evaluation_idx=0)),
                launched, spans)

    (wall_on, pv_on, launches, spans), (wall_off, pv_off, launches_off, spans_off) = (
        mixed_pv(True), mixed_pv(False))
    gap = abs(pv_on - pv_off) / abs(pv_off)
    deals = MIXED_COUNTS["storage"]
    print(f"[storage route] mixed book at {MIXED_PATHS} + {MIXED_PATHS} paths: wall "
          f"{wall_on:.3f} s with the kernel, {wall_off:.3f} s on the torch scans; storage "
          f"launches a run {launches}; PV {pv_on!r} vs {pv_off!r}, rel gap {gap:.3e}; storage "
          f"exercise spans {spans} (route off: {len(spans_off)} spans over "
          f"{sum(p for _, _, p in spans_off)} deals)")
    check(launches == {"fit": 1, "value": 1} and not launches_off,
          f"storage_scan launched {launches} / {launches_off} a run (route on / off)")
    check(spans == [("kernel", "fit", deals), ("kernel", "value", deals)],
          "the storage deals' exercise spans are not one kernel span a phase over every deal")
    check(gap <= 1e-13, "the storage kernel route moved the mixed book's PV")
    for row, phase in zip(rows, ("fit", "value")):
        row["launches"] = launches.get(phase, 0)
    print(f"[time] storage scan phase: {time.perf_counter() - t0:.1f} s")
    return rows


def mixed_exercise_options(counts):
    """The mixed book's Americans and FlexiCalls in ``counts`` (every fourth
    American gated in the money) and three Bermudans (a put, a gated call,
    a call)."""
    book = build_book(list(ASSETS), {family: counts.get(family, 0) for family in MIXED_COUNTS})
    for i, american in enumerate(book["american"]):
        american.itm_only_regression = i % 4 == 1
    put, call = mt.OptionType.PUT, mt.OptionType.CALL
    bermudans = [mt.BermudanOption(mt.Equity("asset_1"), dates, k, kind, asset_id="asset_1",
                                   itm_only_regression=itm)
                 for dates, k, kind, itm in (([0.3, 0.6, 1.0], 105.0, put, False),
                                             ([0.25, 0.7, 1.0], 95.0, call, True),
                                             ([0.4, 0.8, 1.2], 100.0, call, False))]
    return book["american"] + book["flexicall"] + bermudans


def two_netting_sets(products):
    """``products`` in two netting sets, the first half and the rest."""
    half = len(products) // 2
    return [mt.NettingSet(name="first", products=products[:half]),
            mt.NettingSet(name="second", products=products[half:])]


def exercise_scan_phase():
    """Phase 3h: the equity exercise scan kernel (csrc/exercise_scan.cu) at
    the mixed book's shapes: its 1,800 Americans (every fourth gated in the
    money here) and 700 FlexiCalls, with three Bermudans, at MIXED_PATHS
    paths, with EPE on six dates (exposure rows) and without.  Its build
    (ptxas frames printed); the coefficients, per-product cashflows and
    exposures bitwise the torch batches' (``ExerciseEquityBatch.fit`` /
    ``evaluate`` on the card), one launch a phase; call, launch-only and
    wrapper times beside the operations bound; then two warm runs of the
    whole mixed book with the route on (one fit and one value launch a
    run; its ``exercise`` spans: route "kernel" over every equity exercise
    product in each phase, no torch batch's) and off (the torch batches),
    PV to 1e-15 relative.  Returns the kernels' JSON rows."""
    t0 = time.perf_counter()
    built = cuda_build.load_library("exercise_scan")
    how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
    print(f"[build] exercise_scan: {how} -> {built.path.name}")
    for kernel, frame in ptxas_frames(built.log).items():
        print(f"  {kernel}: {frame}")
    counts = {"american": MIXED_COUNTS["american"], "flexicall": MIXED_COUNTS["flexicall"]}
    rows, max_abs_err = [], {}
    for exposures in (True, False):
        c = mt.SimulationController(
            two_netting_sets(mixed_exercise_options(counts)), bs_multi_model(),
            mt.RiskMetrics([mt.PVMetric(), mt.EPEMetric()] if exposures else [mt.PVMetric()],
                           exposure_timeline=np.linspace(0.0, 2.5, 6) if exposures else None),
            MIXED_PATHS, MIXED_PATHS, 1, mt.SimulationScheme.ANALYTICAL, device="cuda")
        c._ensure_plan()
        params = c.model.initial_params(device=torch.device("cuda"), dtype=torch.float64)
        with torch.no_grad():
            _, pre = c._simulate_and_resolve(params, MIXED_PATHS, mt.rng.PHASE_PRESIM)
            _, main = c._simulate_and_resolve(params, MIXED_PATHS, mt.rng.PHASE_MAINSIM)
        book = c._book_options
        check(len(book.products) == len(c.products), "the exercise executor misses a product")
        tables = book.device_tables()
        packed, obs, obs_main = tables.packed, book.observations(pre), book.observations(main)
        exercise_scan.launches.clear()
        coeffs = exercise_scan.exercise_fit(tables, obs)
        cfs, exp = exercise_scan.exercise_value(tables, obs_main, coeffs, exposures)
        check(exercise_scan.launches == {"fit": 1, "value": 1},
              f"exercise_scan launched {dict(exercise_scan.launches)} for one fit and one value")
        views = exercise_scan.product_coefficients(packed, coeffs)
        ctx, p = c._exposure_ctx(), 0
        with torch.no_grad():
            for batch in book.batches:
                batch.fit(pre, ctx)
                ref_cfs, ref_exp = batch.evaluate(main, ctx)
                for j, product in enumerate(batch.products):
                    pairs = [("fit", "coefficients", views[p],
                              batch._coeffs[:, j, :product.get_num_states()]),
                             ("value", "cashflows", cfs[p], ref_cfs[j])]
                    if exposures:
                        pairs.append(("value", "exposures", exp[p], ref_exp[:, j]))
                    for phase, what, a, b in pairs:
                        check(torch.equal(a, b), f"exercise_scan {what} of product {p}: not "
                                                 "bitwise the torch batches")
                        max_abs_err[phase] = max(max_abs_err.get(phase, 0.0),
                                                 float((a - b).abs().max()))
                    p += 1
                batch.release()
        print(f"[exercise_scan] {packed.num_products} products, {packed.rows.shape[0]} event "
              f"rows{' with exposure rows' if exposures else ''}: coefficients, cashflows"
              f"{' and exposures' if exposures else ''} bitwise the torch batches")
        if exposures:
            continue
        # operations: the fit's tree-summed products (a product and an add
        # each) and its step of every state (~2 deg + 8 a state), the value
        # phase's two continuations and its step a path and event
        n, deg = MIXED_PATHS, packed.deg
        row_states = np.repeat(packed.options[:, exercise_scan.STATES],
                               packed.options[:, exercise_scan.EVENTS])
        is_prod = packed.rows[:, exercise_scan.IS_PROD]
        fit_ops = float(n * (2 * (deg + deg * (deg + 1) // 2 + deg * row_states)
                             + (2 * deg + 8) * row_states * is_prod).sum())
        value_ops = float(n * (4 * deg + 8) * packed.rows.shape[0])
        for phase, run, ops in (
                ("fit", lambda: exercise_scan.exercise_fit(tables, obs), fit_ops),
                ("value", lambda: exercise_scan.exercise_value(tables, obs_main, coeffs), value_ops)):
            bound = ops / FP64_OPS_PER_S * 1e3
            ms, launch_ms, wrapper_ms = call_split(f"exercise_scan {phase}",
                                                   f"mcre_exercise_{phase}", run, bound)
            print(f"    {packed.num_products} products, {packed.rows.shape[0]} event rows, {n} "
                  f"paths: {ops / 1e9:.3f} GFLOP, {bound / launch_ms:.1%} of the operations "
                  f"bound {bound:.4f} ms")
            rows.append({"name": f"exercise_scan[{phase}]", "route": "cuda",
                         "source": "montecarlo_risk_engine_tpu_torch/csrc/exercise_scan.cu",
                         "replaces": None, "launches": 0, "max_abs_err": max_abs_err[phase],
                         "ms": ms, "plain_ms": None, "bound_ms": bound, "bound_by": "operations",
                         "library_ms": None, "launch_ms": launch_ms, "wrapper_ms": wrapper_ms})
        del pre, main, obs, obs_main, c
    torch.cuda.empty_cache()

    def mixed_pv(on):
        """(warm wall, PV, exercise launches, ``exercise`` spans of the
        equity products of a traced run as (kind, route, phase, products))
        of the whole mixed book; the route off: the kernel's devices
        emptied."""
        book = mt.SimulationController(*mixed_book_parts(MIXED_COUNTS), MIXED_PATHS,
                                       MIXED_PATHS, 1, mt.SimulationScheme.ANALYTICAL,
                                       device="cuda")
        devices = exercise_scan._KERNEL_DEVICES
        exercise_scan._KERNEL_DEVICES = devices if on else ()
        try:
            book.run_simulation()
            exercise_scan.launches.clear()
            out = []
            wall = wall_seconds(lambda: out.append(book.run_simulation()))
            launched = dict(exercise_scan.launches)
            tracing.enable()
            book.run_simulation()
            spans = [(r.attrs["kind"], r.attrs["route"], r.attrs["phase"], r.attrs["products"])
                     for r in tracing.take()
                     if r.name == "exercise" and r.attrs["kind"] != "Storage"]
        finally:
            tracing.disable()
            exercise_scan._KERNEL_DEVICES = devices
        return (wall, float(out[0].get_results("mixed_book", "pv", evaluation_idx=0)),
                launched, spans)

    (wall_on, pv_on, launches, spans), (wall_off, pv_off, launches_off, spans_off) = (
        mixed_pv(True), mixed_pv(False))
    gap = abs(pv_on - pv_off) / abs(pv_off)
    products = MIXED_COUNTS["american"] + MIXED_COUNTS["flexicall"]
    print(f"[exercise route] mixed book at {MIXED_PATHS} + {MIXED_PATHS} paths: wall "
          f"{wall_on:.3f} s with the kernel, {wall_off:.3f} s on the torch batches; exercise "
          f"launches a run {launches}; PV {pv_on!r} vs {pv_off!r}, rel gap {gap:.3e}; equity "
          f"exercise spans {spans} (route off: {len(spans_off)} spans over "
          f"{sum(p for *_, p in spans_off)} products)")
    check(launches == {"fit": 1, "value": 1} and not launches_off,
          f"exercise_scan launched {launches} / {launches_off} a run (route on / off)")
    check(spans == [("ExerciseEquityBatch", "kernel", "fit", products),
                    ("ExerciseEquityBatch", "kernel", "value", products)],
          "the equity exercise spans are not one kernel span a phase over every product")
    check(gap <= 1e-15, "the exercise kernel route moved the mixed book's PV")
    for row, phase in zip(rows, ("fit", "value")):
        row["launches"] = launches.get(phase, 0)
    print(f"[time] exercise scan phase: {time.perf_counter() - t0:.1f} s")
    return rows


# The Heston surface of the benchmark's heston_qe_book: 50 calls, each its
# own netting set; P = 7, one sweep of 7 tangents.
SURFACE_STRIKES = (80.0, 90.0, 100.0, 110.0, 120.0)
# Float64 operations of csrc/qe_tangents.cu a path-step (each +, -, x, /,
# sqrt, log, clamp and select one): the primal update, and each tangent's
# own.  Left out: what a tangent build computes once a step for all its
# tangents (the 12 divisors' reciprocals, 6 doublings and squares, 11
# comparisons), so the bound is a little low.
QE_PRIMAL_OPS = 69
QE_TANGENT_OPS = 92
FP64_OPS_PER_S = 33.5e12  # NVIDIA H100 SXM data sheet, outside the tensor cores


def surface_book():
    """The Heston surface, differentiated at NUM_PATHS paths on the card."""
    model = mt.HestonModel(0.0, asset_id="eq", **MODEL_KW)
    netting_sets = [mt.NettingSet(name=f"call_{t:g}_{k:g}", products=[
        mt.EuropeanOption(mt.Equity("eq"), t, k, mt.OptionType.CALL, asset_id="eq")])
        for t in MATURITIES for k in SURFACE_STRIKES]
    return mt.SimulationController(
        netting_sets, model, mt.RiskMetrics([mt.PVMetric()]), NUM_PATHS, 0, NUM_STEPS,
        mt.SimulationScheme.QE, differentiate=True, root_seed=SEED, device="cuda")


def qe_tangents_phase():
    """Phase 3i: the forward-mode Heston QE reconstruction kernel
    (csrc/qe_tangents.cu) at the Heston surface's shapes ([40, 2^20, 2]) on
    K1's emitted draws.  Its builds for the primal and the sweep's 7
    tangents (ptxas: no spill); the primal and the tangent planes against
    its plain version (bitwise, else the most ulps apart); call,
    launch-only and wrapper times beside the larger of the byte bound
    (planes written, draws read, at 3.35 TB/s) and the operation bound
    (QE_PRIMAL_OPS + c QE_TANGENT_OPS a path-step at 33.5 TFLOP/s); then one
    warm differentiated surface run with its launches counted from 0 by
    tangent count (a primal and a 7-tangent launch) against the same run
    with the route off (the torch rebuild, no launch), values and jacobian
    to 1e-12 relative.  Returns the kernels' JSON rows."""
    t0 = time.perf_counter()
    device = torch.device("cuda")
    c = surface_book()
    params = c.model.initial_params(device=device, dtype=torch.float64)
    z, u = c._kernel_noise_of(params)[mt.rng.PHASE_MAINSIM]
    steps, dts, n_pts = qe_tangents.plan(0.0, tuple(c.simulation_timeline), c.num_steps)
    steps, dts = torch.from_numpy(steps).to(device), torch.from_numpy(dts).to(device)
    builds = qe_tangents.load_builds([0, len(params)])
    for (name, extra), built in builds.items():
        how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
        print(f"[build] {name} {' '.join(extra)}: {how} -> {built.path.name}")
        for kernel, frame in ptxas_frames(built.log).items():
            print(f"  {kernel}: {frame}")
        local_memory_gate(name, built)
    pvec = torch.stack(params)
    cols = lambda p: qe_tangents.columns(c.model, tuple(p.unbind(0)), dts)
    table, init = cols(pvec)
    eye = torch.eye(len(params), dtype=torch.float64, device=device)
    table_t, init_t = vmap(lambda t: jvp(cols, (pvec,), (t,))[1])(eye)
    n_dense, live = steps.shape[0], int(steps[:, 0].sum())
    print(f"[kernel] qe_tangents at {NUM_PATHS} paths x {n_dense} dense steps -> {n_pts} points")
    rows = {}
    for count in (0, len(params)):
        tangents = (table_t, init_t) if count else (None, None)
        args = (steps, z, u, table, init, n_pts, *tangents)
        out, ref = qe_tangents.qe_planes(*args), qe_tangents.qe_planes_reference(*args)
        torch.cuda.synchronize()
        same, apart = torch.equal(out, ref), cuda_build.ulps_apart(out, ref)
        err = float((out - ref).abs().max())
        label = f"c={count}" if count else "primal"
        del out, ref
        check(apart <= 2, f"qe_tangents[{label}]: {apart} ulps from its plain version")
        run = lambda: qe_tangents.qe_planes(*args)
        plain_ms = median_ms(lambda: qe_tangents.qe_planes_reference(*args), reps=3)
        nbytes = (max(count, 1) * n_pts * 2 * 8 + n_dense * 12) * NUM_PATHS
        ops = (QE_PRIMAL_OPS + count * QE_TANGENT_OPS) * live * NUM_PATHS
        t_bound, by = max((nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
                          (ops / FP64_OPS_PER_S * 1e3, "operations"))
        ms, launch_ms, wrapper_ms = call_split(f"qe_tangents {label}", "mcre_qe_tangents", run,
                                               t_bound)
        print(f"    bitwise {same} ({apart:g} ulps at most), {nbytes / 1e9:.2f} GB, "
              f"{ops / 1e9:.2f} GFLOP: call {ms:.4f} ms, launch {launch_ms:.4f} ms "
              f"({t_bound / launch_ms:.1%} of the bound {t_bound:.4f} ms by {by}), plain "
              f"{plain_ms:.3f} ms")
        rows[count] = {"name": f"qe_tangents[{label}]", "route": "cuda",
                       "source": "montecarlo_risk_engine_tpu_torch/csrc/qe_tangents.cu",
                       "replaces": None, "launches": 0, "max_abs_err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound_ms": t_bound, "bound_by": by,
                       "library_ms": None, "launch_ms": launch_ms, "wrapper_ms": wrapper_ms}
        torch.cuda.empty_cache()
    del z, u, c
    torch.cuda.empty_cache()

    def run_book(on):
        """(wall, values, jacobian, launches by tangent count) of a warm run."""
        book = surface_book()
        if not on:
            book._recon_kernel = lambda: None
        book.run_simulation()
        out = []
        qe_tangents.qe_planes.launches.clear()
        wall = wall_seconds(lambda: out.append(book.run_simulation()))
        launches = dict(qe_tangents.qe_planes.launches)
        names = [ns.name for ns in book.netting_sets]
        values = torch.tensor([out[0].get_results(n, "pv", evaluation_idx=0) for n in names])
        jac = torch.tensor([list(out[0].get_derivatives(n, "pv", evaluation_idx=0).values())
                            for n in names])
        return wall, values, jac, launches

    wall_on, values_on, jac_on, launches = run_book(True)
    wall_off, values_off, jac_off, launches_off = run_book(False)
    check(launches == {0: 1, 7: 1}, f"qe_tangents launched {launches} a run, not {{0: 1, 7: 1}}")
    check(not launches_off, f"qe_tangents launched {launches_off} with the route off")
    gap_v = float(((values_on - values_off).abs() / values_off.abs().clamp(min=1e-300)).max())
    gap_j = float((jac_on - jac_off).abs().max() / jac_off.abs().max())
    print(f"[qe route] Heston surface differentiated at {NUM_PATHS} paths: wall {wall_on:.3f} s "
          f"with the kernel, {wall_off:.3f} s rebuilt in torch; launches a run by tangent count "
          f"{launches}; values rel gap {gap_v:.3e}, jacobian gap {gap_j:.3e} (of max)")
    check(gap_v <= 1e-12 and gap_j <= 1e-12, "the kernel route's values or jacobian moved")
    for count, row in rows.items():
        row["launches"] = launches[count]
    torch.cuda.empty_cache()
    print(f"[time] qe tangents phase: {time.perf_counter() - t0:.1f} s")
    return list(rows.values())


def reset_k2_counts():
    """K2's counts to 0: the paths kernel's and its table prologue's."""
    hybrid_paths.launches = 0
    k2_module.hybrid_table.launches = 0


def card():
    """The card, its nvidia-smi line (name, power limit) printed; exits
    non-zero without CUDA."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return torch.device("cuda"), smi


def heston_params(device):
    return mt.params_from_numpy(
        [MODEL_KW[k] for k in ("spot", "sigma", "rate", "rho", "kappa", "theta", "v0")],
        device=device, dtype=torch.float32)


def north_star_kernel_args(device):
    """(blocks, chol, float32 params, dense timeline) of the north star's K2
    launches."""
    ns = north_star(NS_PATHS, False)
    dense, _ = dense_timeline(0.0, ns.simulation_timeline, 1)
    return (ns.model.kernel_blocks(), np.linalg.cholesky(ns.model.static_joint_correlation()),
            ns.model.initial_params(device=device, dtype=torch.float32), dense)


def warm_walls(make, runs: int):
    """Warm walls of ``runs`` calls of a fresh controller's run_simulation."""
    c = make()
    c.run_simulation()
    walls = [wall_seconds(c.run_simulation) for _ in range(runs)]
    del c
    torch.cuda.empty_cache()
    return walls


def host_profile(label, run, top: int = 25, focus: str = "ops/hybrid_paths"):
    """The host's time in one warm run by Python function (cProfile, which
    slows the run): the ``top`` functions by their own time, then every
    function of the files matching ``focus`` by cumulative time."""
    import cProfile
    import io
    import pstats

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    run()
    torch.cuda.synchronize()
    prof.disable()
    text = io.StringIO()
    stats = pstats.Stats(prof, stream=text)
    stats.sort_stats("tottime").print_stats(top)
    stats.sort_stats("cumulative").print_stats(focus)
    print(f"[host profile {label}]\n{text.getvalue()}")


def k1_loop_opcodes():
    """{rule: {opcode: count}} of K1's substep loop outside its slow paths,
    by the current count (a nested loop is a slow path) and by the older
    one (``nested_loops=False``), from the SASS of this tree's build
    (ops/sass.py): the instructions behind the issue-slot count, so that
    two trees' counts can be told apart."""
    from collections import Counter

    from montecarlo_risk_engine_tpu_torch.ops.sass import sass_functions, sass_of, substep_loop

    funcs = sass_functions(sass_of(cuda_build.load_library("heston_qe", ())))
    name = next(n for n in funcs if "heston_qe_kernelILb0ELb0E" in n)
    out = {}
    for rule, nested in (("current", True), ("older", False)):
        body, slow = substep_loop(funcs[name], nested)
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
                      for a, op, _ in body if a not in slow)
        out[rule] = dict(sorted(ops.items()))
        print(f"[sass K1 loop, {rule} count] {sum(ops.values())} instructions: "
              f"{json.dumps(out[rule])}")
    return out


def book_walls(out):
    """Warm walls of the CVA book (forward, and differentiated in reverse
    mode) and of the mixed book (forward, and differentiated per family)."""
    walls = {
        "cva book forward": warm_walls(cva_controller, 3),
        "cva book differentiated": warm_walls(lambda: cva_controller(differentiate=True), 2),
        "mixed book forward": warm_walls(mixed_controller, 3),
        "mixed book differentiated": warm_walls(
            lambda: mixed_controller(by_family=True, differentiate=True), 2),
    }
    for name, w in walls.items():
        print(f"[wall] {name}: {', '.join(f'{x:.4f}' for x in w)} s")
    out["book walls"] = walls


def split_main(books_only: bool = False):
    """``--split-only``: for the tree this file sits in, K1's and K2's call,
    launch-only and wrapper times at the main paths' shapes (K1 on the Heston
    book, K2 on the north star and on the BS-multi book), K1's substep loop
    by opcode, the warm walls of the three books forward and differentiated
    and of the CVA and mixed books, and the north-star forward run's host
    time by function, then one JSON line; ``books_only``: K1's opcodes and
    the CVA and mixed books' walls alone.  A copy of this file run from another
    checkout's root measures that tree the same way, so one call can run two
    trees in turns."""
    device, _ = card()
    out = {"K1 loop opcodes": k1_loop_opcodes()}
    if books_only:
        book_walls(out)
        print(json.dumps(out))
        return
    p32 = heston_params(device)
    out["K1"] = call_split("K1 heston_qe_paths, Heston book", "mcre_heston_qe_paths",
                           lambda: heston_qe_paths(p32, MATURITIES, NUM_PATHS, NUM_STEPS,
                                                   seed=SEED, phase=PHASE))
    blocks, chol, params, dense = north_star_kernel_args(device)
    out["K2 north star"] = call_split("K2 hybrid_paths, north star", "mcre_hybrid_paths",
                                      lambda: hybrid_paths(blocks, chol, params, dense, NS_PATHS,
                                                           1, seed=SEED, phase=PHASE))
    euro = euro_book(EURO_OPTIONS)[0]
    m = euro.model
    e_blocks, e_chol = [m.kernel_block(euro.simulation_scheme)], np.linalg.cholesky(
        m.kernel_correlation())
    e_params, e_tl = m.initial_params(device=device, dtype=torch.float32), euro.simulation_timeline
    del euro
    out["K2 bs_multi"] = call_split("K2 hybrid_paths, BS-multi book", "mcre_hybrid_paths",
                                    lambda: hybrid_paths(e_blocks, e_chol, e_params, e_tl,
                                                         NUM_PATHS, 1, seed=SEED, phase=PHASE))
    ns_fwd = north_star(NS_PATHS, False)
    walls = {
        "heston forward": warm_walls(lambda: controller(False)[0], 3),
        "heston differentiated": warm_walls(lambda: controller(True)[0], 3),
        "north star forward": warm_walls(lambda: ns_fwd, 8),
        "north star differentiated": warm_walls(lambda: north_star(NS_PATHS, True), 2),
        "bs-multi forward": warm_walls(lambda: euro_book(EURO_OPTIONS)[0], 3),
        "bs-multi differentiated": warm_walls(lambda: euro_book(EURO_OPTIONS, True)[0], 3),
    }
    for name, w in walls.items():
        print(f"[wall] {name}: {', '.join(f'{x:.4f}' for x in w)} s")
    out["walls"] = walls
    del ns_fwd
    torch.cuda.empty_cache()
    book_walls(out)
    ns_fwd = north_star(NS_PATHS, False)
    ns_fwd.run_simulation()
    host_profile("north star forward", ns_fwd.run_simulation)
    print(json.dumps(out))


def main():
    # 1. device
    device, smi = card()
    t_start = time.perf_counter()

    # 2. build K1 and K2 for every block tuple this script launches,
    # concurrently; no kernel may spill, and none may keep more on its
    # stack than sincosf's reduction array
    builds = cuda_build.load_libraries(
        [("heston_qe", ()), ("heston_ladder", ())]
        + [("hybrid_paths", k2_module.role_flags(b)) for b in k2_block_tuples()])
    for (name, extra), built in builds.items():
        how = "reused" if built.build_seconds is None else f"built in {built.build_seconds:.1f} s"
        print(f"[build] {name} {' '.join(extra)}: {how} -> {built.path.name}")
        for kernel, frame in ptxas_frames(built.log).items():
            print(f"  {kernel}: {frame}")
        local_memory_gate(name, built)
    issue = IssueSlots.from_card()

    # 3a. K1 vs plain version at the Heston path's shapes
    params32 = heston_params(device)
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
    k1_substeps = NUM_PATHS * live_substeps(MATURITIES, NUM_STEPS)
    k1_bound = bound(len(MATURITIES) * NUM_PATHS * 2 * 4, k1_substeps * K1_OPS_PER_SUBSTEP)
    k1_issue = issue.slot_ms("K1 heston_qe_paths", builds["heston_qe", ()],
                             "heston_qe_kernelILb0ELb0E", k1_substeps)
    k1_ms, k1_launch_ms, k1_wrapper_ms = call_split("K1 heston_qe_paths", "mcre_heston_qe_paths",
                                                    run_k1, k1_bound[0], k1_issue)
    print(f"  kernel {k1_ms:.3f} ms ({k1_substeps / k1_ms * 1e3:.3e} path-steps/s), "
          f"plain {k1_plain_ms:.3f} ms, bound {k1_bound[0]:.4f} ms by {k1_bound[1]} "
          f"({k1_bound[0] / k1_ms:.1%} of it reached)")
    k1_sass = issue.per_substep(builds["heston_qe", ()], "heston_qe_kernelILb0ELb0E",
                                nested_loops=False)
    print(f"  K1 beside its build before the shared QE header, both counted without nested "
          f"loops as slow paths: {'not measured' if k1_sass is None else format(k1_sass, 'g')} "
          f"instructions per path-substep (before: {K1_SASS_BEFORE}), launch-only "
          f"{k1_launch_ms:.4f} ms (before: {K1_LAUNCH_MS_BEFORE} ms, NVIDIA H100 80GB HBM3, "
          f"700.00 W)")
    check(k1_sass is not None and abs(k1_sass - K1_SASS_BEFORE) <= K1_SASS_SLACK,
          f"K1's substep is {k1_sass} instructions, not its earlier build's {K1_SASS_BEFORE} "
          f"within {K1_SASS_SLACK} (none without cuobjdump)")

    # 3b. K2 and its table prologue vs their plain versions at the north-star
    # shapes (both phases), on ragged and misaligned launches, and K1 and K2
    # with host syncs forbidden
    blocks, chol, ns_params32, ns_dense = north_star_kernel_args(device)
    print(f"[kernel] hybrid_paths at {NS_PATHS} paths x {len(ns_dense)} points "
          f"(dense timeline), blocks {[b.kind for b in blocks]}")
    presim_err, _ = compare_hybrid("north star presim", blocks, chol, ns_params32, ns_dense, 1,
                                   mt.rng.PHASE_PRESIM, NS_PATHS)
    ns_row = k2_rung("vasicek, bs, cirpp euler", blocks, chol, ns_params32, ns_dense, 1,
                     NS_PATHS, issue=issue)
    ns_row["max_abs_err"] = max(ns_row["max_abs_err"], presim_err)
    ks_row = k2_rung("vasicek, bs, cirpp euler, kernel-streaming AD", blocks, chol, ns_params32,
                     ns_dense, 1, KSTREAM_PATHS, issue=issue)
    table_json = table_row(blocks, ns_params32, ns_dense, 1)
    ragged_rungs(device)
    sync_free(params32, (blocks, chol, ns_params32, ns_dense, NS_PATHS, 1))

    # 3c. the K2 ladder: every (block, scheme) at its book's shapes
    rows = k2_ladder(device, issue)

    # 3d. the substep ladder K3: every rung against its plain version and
    # K1, then its main path, the decomposition tool's run, counts from 0
    k3_rows = k3_ladder(issue)

    # 3e. K1 and K2 at a path offset and stride (a rank of a sharded run)
    strided_launches(params32, (blocks, chol, ns_params32, ns_dense, NS_PATHS, 1))

    # 3f. the forward-mode reconstruction kernel at the north-star shapes,
    # then its route in a differentiated north-star run, on and off
    recon_rows = recon_phase()

    # 3g. the storage scan kernel at the mixed book's shapes, then its route
    # in the whole mixed book, on and off
    storage_rows = storage_scan_phase()

    # 3h. the equity exercise scan kernel at the mixed book's shapes, then
    # its route in the whole mixed book, on and off
    exercise_rows = exercise_scan_phase()

    # 3i. the forward-mode Heston QE reconstruction kernel at the Heston
    # surface's shapes, then its route in the differentiated surface, on
    # and off
    qe_rows = qe_tangents_phase()

    print(f"[time] kernels checked after {time.perf_counter() - t_start:.1f} s")

    # 4. - 7. the main paths and routes: each one's counts from 0 just before
    # it; every K2 launch comes with one launch of its table prologue
    rows["bs_multi exact"]["launches"] = euro_main_path()
    check(k2_module.hybrid_table.launches == hybrid_paths.launches, "prologue launches differ")
    torch.cuda.empty_cache()
    k1_launches = heston_main_path(device)
    torch.cuda.empty_cache()
    print(f"[time] BS-multi and Heston books done after {time.perf_counter() - t_start:.1f} s")
    ns_row["launches"] = north_star_main_path()
    table_json["launches"] = k2_module.hybrid_table.launches
    check(table_json["launches"] == hybrid_paths.launches, "prologue launches differ")
    torch.cuda.empty_cache()
    print(f"[time] main paths done after {time.perf_counter() - t_start:.1f} s")
    # 6b. the north star on two ranks sharing the card (gloo), then on one
    # rank over NCCL, against one process; the ranks count their own launches
    sharded_north_star()
    print(f"[time] sharded north star done after {time.perf_counter() - t_start:.1f} s")
    basket_phase()
    for label, spec in route_specs().items():
        rows[label]["launches"] = route_phase(spec)
    rows["hw exact"]["launches"] = hw_phase(mt.SimulationScheme.ANALYTICAL)
    rows["hw euler"]["launches"] = hw_phase(mt.SimulationScheme.MILSTEIN)
    rows["s2f exact"]["launches"] = s2f_phase(mt.SimulationScheme.ANALYTICAL)
    rows["s2f euler"]["launches"] = s2f_phase(mt.SimulationScheme.EULER)
    check(k2_module.hybrid_table.launches == hybrid_paths.launches, "prologue launches differ")
    print(f"[time] routes done after {time.perf_counter() - t_start:.1f} s")

    # 7a. kernel-streaming AD on K2, with the card to itself (55-66 GB at
    # 2^22 paths), its counts from 0 just before it
    ks_row["launches"], ks_table_launches = kernel_streaming()
    table_json["launches"] += ks_table_launches
    check(k2_module.hybrid_table.launches == hybrid_paths.launches, "prologue launches differ")
    print(f"[time] kernel-streaming AD done after {time.perf_counter() - t_start:.1f} s")

    # 7b. the mixed PV book (a row of its own at its shapes), the product
    # oracles (bs exact) and storage (s2f exact), whose launches add to
    # their tuples' rows, and the CVA book (the bs_multi + cirpp tuple);
    # 7c. meanwhile, in a second process on the same card, the Hessians,
    # then the other samplers and streaming phases
    hessians = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--hessians-only"],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        hessian_launches = phases_beside_hessians(device, issue, rows, t_start, hessians)
    finally:
        if hessians.poll() is None:
            hessians.kill()
            hessians.wait()
    k1_launches += hessian_launches["heston_qe"]
    rows["bs exact"]["launches"] += hessian_launches["bs exact"]
    rows["bs_multi exact"]["launches"] += hessian_launches["bs_multi exact"]
    ns_row["launches"] += hessian_launches["north star"]
    table_json["launches"] += hessian_launches["hybrid_table, north star"]

    # 7d. the 33 example scripts at their own sizes, each with its counts
    # from 0, and one north-star forward run traced through profile_dir
    torch.cuda.empty_cache()
    example_launches = examples_phase(device)
    k1_launches += example_launches.pop("K1")
    table_json["launches"] += example_launches.pop("hybrid_table")
    for label, n in example_launches.items():
        rows[label]["launches"] += n
    ns_launches, ns_table_launches = profiled_north_star()
    ns_row["launches"] += ns_launches
    table_json["launches"] += ns_table_launches
    torch.cuda.empty_cache()
    print(f"[time] examples done after {time.perf_counter() - t_start:.1f} s")
    k2_rows = [ns_row, ks_row, *rows.values(), table_json]
    check(k1_launches > 0 and all(r["launches"] > 0 for r in k2_rows + k3_rows),
          "a kernel of the main paths never launched")

    print(f"[time] all phases done after {time.perf_counter() - t_start:.1f} s")

    # 8. result lines
    print(smi)
    k1_row = {
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
        "launch_ms": k1_launch_ms,
        "wrapper_ms": k1_wrapper_ms,
    }
    print(json.dumps({"kernels": [k1_row] + k2_rows + k3_rows + recon_rows + storage_rows
                      + exercise_rows + qe_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# -- 7d. the example scripts (examples_torch/) at their own sizes ---------------

# The path kernel each script's books reach on the card, and the K2 row its
# block tuple adds to: "K1", "K2" or None (no simulated book: closed forms,
# host-side calibration, a book of analytic PVs only, or the engine called
# directly); the Sobol runs of pv_sobol_convergence and the Euler runs of
# pv_heston_convergence take the engine beside their kernel runs.
EXAMPLES = {
    "basket_cds_copula": (None, None),
    "cirpp_scenarios_vs_deterministic_hazard": (None, None),
    "cva_corporate_bond": ("K2", "vasicek, cirpp_det euler"),
    "cva_wwr_sweep": ("K2", "vasicek, cirpp euler"),
    "ee_pfe_american_equity_option": ("K2", "bs exact"),
    "ee_pfe_barrier_option": ("K2", "bs exact"),
    "ee_pfe_bermudan_bond_option": ("K2", "vasicek exact"),
    "ee_pfe_bermudan_equity_option": ("K2", "bs exact"),
    "ee_pfe_bermudan_swaption": ("K2", "vasicek exact"),
    "ee_pfe_binary_option": ("K2", "bs exact"),
    "ee_pfe_bond": ("K2", "vasicek exact"),
    "ee_pfe_european_vs_analytic": ("K2", "bs exact"),
    "ee_pfe_flexicall": ("K2", "bs exact"),
    "ee_pfe_storage": ("K2", "s2f euler"),
    "ee_pfe_swap_collateralized": ("K2", "vasicek exact"),
    "ee_pfe_swap_profiles": ("K2", "vasicek exact"),
    "ee_pfe_swaption": ("K2", "vasicek exact"),
    "eepe_simulation": ("K2", "vasicek exact"),
    "heston_calibration": (None, None),
    "lsm_convergence_study": ("K2", "bs exact"),
    "pv_barrier_option": ("K2", "bs exact"),
    "pv_basket_option": ("K2", "bs_multi exact"),
    "pv_bermudan_option": ("K2", "bs exact"),
    "pv_binary_option": ("K2", "bs exact"),
    "pv_european_bond_option": ("K2", "vasicek exact"),
    "pv_european_option": ("K2", "bs exact"),
    "pv_heston_convergence": ("K1", None),
    "pv_second_derivatives": (None, None),
    "pv_sobol_convergence": ("K2", "bs exact"),
    "pv_storage": ("K2", "s2f euler"),
    "sabr_calibration": (None, None),
    "storage_volume_constraints": (None, None),
    "storage_volume_over_time": ("K2", "s2f euler"),
}
# Keywords of a script's main() beyond the device, by script: none, each
# runs at its own default size (a CPU rehearsal shrinks them here; a cut of
# a sweep's depth for time would go here and into PERF.md section 4).
EXAMPLE_KW = {}


def example_books():
    """The controllers of the two examples whose K2 block tuples no other
    phase launches, at the scripts' own shapes, by rung label."""
    from examples_torch import cva_corporate_bond, cva_wwr_sweep

    return {"vasicek, cirpp euler": cva_wwr_sweep.controller(0.5, device="cuda")[0],
            "vasicek, cirpp_det euler": cva_corporate_bond.controller(0.4, 50_000, "cuda")[0]}


# The longest substep (years) at which the Heston PV rule applies.
HESTON_RULE_MAX_DT = 0.25
# The headline of each script that runs no controller: (label, value) of
# what it returns at save_plot=False.
HEADLINES = {
    "basket_cds_copula": lambda out: ("gaussian first-to-default leg", out["gaussian", 1]),
    "cirpp_scenarios_vs_deterministic_hazard": lambda out: (
        "CIR++ mean survival at 5y", out["CIR++ MC mean"][-1]),
    "heston_calibration": lambda out: ("max price residual", out["max_residual"]),
    "sabr_calibration": lambda out: ("max vol error", max(r["max_vol_err"]
                                                          for r in out.values())),
    "storage_volume_constraints": lambda out: ("optimized vmin at day 90",
                                               out["optimized vmin"][-1]),
    "storage_volume_over_time": lambda out: ("peak mean volume", out["mean volume"].max()),
}


def example_checks(name, out, k1):
    """The phase's checks beside the script's own asserts; returns a note
    for the script's line, or None."""
    if name == "pv_heston_convergence":
        # PERF.md section 2's Heston rule where its 0.05 holds QE's O(dt)
        # bias (a substep of at most the Heston book's 0.25 y); over longer
        # substeps the bias is what the script shows (the JAX package's QE
        # PV at one 1 y substep is 0.33 below the CF price too), so there the
        # error may only shrink as substeps are added, within 2 combined SE.
        qe = out["runs"]["Andersen QE"]
        for n, (pv, se) in zip(out["steps"], qe):
            if out["maturity"] / n <= HESTON_RULE_MAX_DT:
                check(abs(pv - out["cf"]) < 4 * se + 0.05,
                      f"{name}: QE pv {pv} at {n} substeps vs cf {out['cf']}")
        for (pv0, se0), (pv1, se1) in zip(qe, qe[1:]):
            check(abs(pv1 - out["cf"]) < abs(pv0 - out["cf"]) + 2 * math.hypot(se0, se1),
                  f"{name}: the QE error grows with substeps ({pv0} -> {pv1})")
        qe_runs = len(qe)
        check(k1 == qe_runs, f"{name}: {k1} K1 launches for {qe_runs} QE runs")
        return "QE PVs " + ", ".join(f"{pv:.4f} +- {se:.4f}" for pv, se in
                                     out["runs"]["Andersen QE"]) + f" vs CF {out['cf']:.6f}"
    elif name == "sabr_calibration":
        for maturity, r in out.items():
            check(r["max_vol_err"] < 1e-8, f"{name}: T={maturity} max vol err {r['max_vol_err']}")
            for t, f in zip(r["true"], r["fit"]):
                check(abs(t - f) < 5e-3 * max(1.0, abs(t)), f"{name}: T={maturity} {r}")
    elif name == "pv_basket_option":
        check(out["se_cv"] < out["se_plain"], f"{name}: se_cv {out['se_cv']} >= se_plain")
    elif name == "pv_second_derivatives":
        check(out[0] > 0.0 and out[1] > 0.0, f"{name}: gamma {out[0]}, vomma {out[1]}")
    return None


def examples_phase(device):
    """Phase 7d: every script of examples_torch/ through its main() at its
    own default size on ``device`` (no plot), twice: a cold run, then the
    warm run whose wall is printed and whose launches are counted from 0
    just before it.  Beside the script's own asserts: the checks of
    ``example_checks``, and K1's or K2's count rising where ``EXAMPLES``
    says the script's books reach it.  A script's own table goes to its
    output only when it fails.  One line per script: its warm wall, its K1,
    K2 and prologue launches and its headline value (the first metric of
    its last controller run, with its MC error, else ``HEADLINES``).
    Returns the launches: {"K1": n, "hybrid_table": n, K2 row label: n}."""
    import contextlib
    import importlib
    import inspect
    import io

    real_run = mt.SimulationController.run_simulation
    captured = []

    def recording(self, *args, **kwargs):
        results = real_run(self, *args, **kwargs)
        captured.append(results)
        return results

    launches = {"K1": 0, "hybrid_table": 0}
    walls = {}
    t0 = time.perf_counter()
    mt.SimulationController.run_simulation = recording
    try:
        for name, (kernel, row) in EXAMPLES.items():
            mod = importlib.import_module(f"examples_torch.{name}")
            kw = dict(EXAMPLE_KW.get(name, {}), device=device)
            if "save_plot" in inspect.signature(mod.main).parameters:
                kw["save_plot"] = False
            text = io.StringIO()
            try:
                with contextlib.redirect_stdout(text):
                    cold = wall_seconds(lambda: mod.main(**kw))
                    heston_qe_paths.launches = 0
                    reset_k2_counts()
                    del captured[:]
                    out = None

                    def run():
                        nonlocal out
                        out = mod.main(**kw)

                    warm = wall_seconds(run)
                    k1, k2 = heston_qe_paths.launches, hybrid_paths.launches
                    table = k2_module.hybrid_table.launches
                    note = example_checks(name, out, k1)
                    check(kernel != "K1" or k1 > 0, f"{name}: no K1 launch")
                    check(kernel != "K2" or k2 > 0, f"{name}: no K2 launch")
                    check(table == k2, f"{name}: {table} prologue launches for {k2} K2 launches")
            except BaseException:
                print(text.getvalue())
                raise
            launches["K1"] += k1
            launches["hybrid_table"] += table
            if row is not None:
                launches[row] = launches.get(row, 0) + k2
            if captured:
                r = captured[-1]
                ns, metric = r.netting_set_names[0], r.metric_names[0]
                head = (f"{ns} {metric}[0] {float(r.get_results(ns, metric, evaluation_idx=0)):.6g}"
                        f" +- {float(r.get_mc_error(ns, metric, evaluation_idx=0)):.3g}")
            else:
                label, value = HEADLINES[name](out)
                head = f"{label} {float(value):.6g}"
            walls[name] = warm
            print(f"[example {name}] warm wall {warm:.3f} s (cold {cold:.3f} s), launches K1 {k1} "
                  f"K2 {k2} prologue {table}, {head}" + ("" if note is None else f"; {note}"))
    finally:
        mt.SimulationController.run_simulation = real_run
    total = time.perf_counter() - t0
    print(f"[examples] {len(EXAMPLES)} scripts, warm walls {sum(walls.values()):.1f} s, "
          f"phase {total:.1f} s (cold and warm runs)")
    return launches


def profiled_north_star():
    """One north-star forward run with run_simulation(profile_dir=...): the
    trace is written, holds K2's kernel by its CUDA symbol, and the values
    equal the unprofiled run's bit for bit.  Returns (K2, prologue)
    launches of the profiled run."""
    import glob
    import tempfile

    c = north_star(NS_PATHS, False)
    plain = ns_values(c.run_simulation())
    reset_k2_counts()
    with tempfile.TemporaryDirectory() as tmp:
        traced = ns_values(c.run_simulation(profile_dir=tmp))
        launches = (hybrid_paths.launches, k2_module.hybrid_table.launches)
        files = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        check(len(files) == 1, f"profile_dir holds {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    k2_events = [e for e in events if e.get("cat") == "kernel"
                 and "hybrid_kernel" in str(e.get("name", ""))]
    # CUPTI can drop a kernel event in a process that ran profilers before:
    # the trace must hold K2's kernel, not an event for every launch
    check(launches[0] == 2 and len(k2_events) >= 1,
          f"the trace holds {len(k2_events)} hybrid_kernel events for {launches[0]} K2 launches")
    for metric, (value, err) in plain.items():
        check(np.array_equal(value, traced[metric][0]) and np.array_equal(err, traced[metric][1]),
              f"profiled north star: {metric} differs from the unprofiled run")
    print(f"[profile_dir north star] trace {size / 2**20:.1f} MiB, {len(events)} events, "
          f"{len(k2_events)} hybrid_kernel events for {launches[0]} K2 launches "
          f"({k2_events[0]['name'][:60]}), values bitwise the unprofiled run's")
    return launches


def examples_main():
    """``--examples-only``: the card, K1 and K2 built as for the whole
    smoke, then phase 7d and the profiled north star."""
    device, smi = card()
    cuda_build.load_libraries([("heston_qe", ())] + [("hybrid_paths", k2_module.role_flags(b))
                                                     for b in k2_block_tuples()])
    launches = examples_phase(device)
    profiled_north_star()
    print(smi)
    print(json.dumps({"examples_launches": launches}))


def phases_beside_hessians(device, issue, rows, t_start, hessians):
    """Phase 7b while the Hessian process runs: the mixed book, the product
    oracles, storage and the CVA book, each with its counts from 0 (their
    launches into ``rows``); then the Hessian process's output, printed, its
    exit code checked.  Returns the Hessian process's launches by row."""
    rows["bs_multi exact, mixed book"] = mixed_main_path(device, issue)
    torch.cuda.empty_cache()
    print(f"[time] mixed book done after {time.perf_counter() - t_start:.1f} s")
    rows["bs exact"]["launches"] += product_oracles()
    rows["s2f exact"]["launches"] += storage_phase()
    rows["bs_multi, cirpp euler"]["launches"] = cva_phase()
    print(f"[time] oracles, storage and the CVA book done after {time.perf_counter() - t_start:.1f} s")
    check(k2_module.hybrid_table.launches == hybrid_paths.launches, "prologue launches differ")
    torch.cuda.empty_cache()
    out, _ = hessians.communicate()
    print(out, end="")
    check(hessians.returncode == 0, f"the Hessian process failed (exit {hessians.returncode})")
    print(f"[time] Hessians done after {time.perf_counter() - t_start:.1f} s")
    return json.loads(out.strip().splitlines()[-1])["hessian_launches"]


def hessian_main():
    """``--hessians-only`` (the smoke's second process, phase 7c): the
    Hessian phases, each with its counts from 0 (one K1 or K2 launch, and
    one prologue launch, per simulation phase for the whole run), then the
    samplers and streaming phases that launch no kernel, then the
    Hessians' launches by row as the last line's JSON.  Its allocator keeps
    to HESSIAN_PROCESS_MEMORY_FRACTION of the card."""
    card()
    torch.cuda.set_per_process_memory_fraction(HESSIAN_PROCESS_MEMORY_FRACTION)
    t0 = time.perf_counter()
    launches = {"heston_qe": heston_hessian()}
    torch.cuda.empty_cache()
    launches["bs exact"] = bs_hessian()
    launches["bs_multi exact"] = bs_multi_hessian()
    torch.cuda.empty_cache()
    launches["north star"] = north_star_hessian()
    launches["hybrid_table, north star"] = k2_module.hybrid_table.launches
    torch.cuda.empty_cache()
    analytic_hessian()
    print(f"[time] Hessians: {time.perf_counter() - t0:.1f} s")
    streaming_phases()
    print(f"[time] Hessian process: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"hessian_launches": launches}))


if __name__ == "__main__":
    if "--split-only" in sys.argv[1:]:
        split_main(books_only="--books-only" in sys.argv[1:])
    elif "--hessians-only" in sys.argv[1:]:
        hessian_main()
    elif "--examples-only" in sys.argv[1:]:
        examples_main()
    elif "--recon-only" in sys.argv[1:]:
        card()
        print(json.dumps({"kernels": recon_phase()}))
    elif "--storage-scan-only" in sys.argv[1:]:
        card()
        print(json.dumps({"kernels": storage_scan_phase()}))
    elif "--exercise-scan-only" in sys.argv[1:]:
        card()
        print(json.dumps({"kernels": exercise_scan_phase()}))
    elif "--qe-tangents-only" in sys.argv[1:]:
        card()
        print(json.dumps({"kernels": qe_tangents_phase()}))
    elif "--shard-rank" in sys.argv[1:]:
        shard_rank_main(sys.argv[1:])
    else:
        main()
