"""Shared builders and plotting helpers of the port's example scripts.

Counterpart of ``examples/_common.py``: each script runs alone
(``python examples_torch/<name>.py``), prints a results table, and saves a
PNG under ``examples_torch/plots/``.  ``device`` is where the controllers
run: None is the card (``resolve_device``), ``"cpu"`` the CPU.  matplotlib
is imported only by :func:`save_profile_plot`.
"""

from __future__ import annotations

import os

import numpy as np

from montecarlo_risk_engine_tpu_torch import (
    EPEMetric,
    NettingSet,
    PFEMetric,
    RiskMetrics,
    SimulationController,
    SimulationScheme,
    VasicekModel,
)

PLOT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "plots")


def save_profile_plot(filename, timeline, curves, title, ylabel="exposure",
                      loglog=False, xlabel="time (years)"):
    """Save a profile plot; curves = {label: values}. Returns the path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(PLOT_DIR, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    for label, values in curves.items():
        ax.plot(timeline, values, marker="o", markersize=3, label=label)
    if loglog:
        ax.set_xscale("log")
        ax.set_yscale("log")
        xlabel = "num paths" if xlabel == "time (years)" else xlabel
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    path = os.path.join(PLOT_DIR, filename)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def print_profile_table(timeline, curves):
    labels = list(curves.keys())
    header = "t       " + "  ".join(f"{l:>14s}" for l in labels)
    print(header)
    for i, t in enumerate(timeline):
        row = f"{t:6.3f}  " + "  ".join(f"{curves[l][i]:14.6f}" for l in labels)
        print(row)


def vasicek_model(asset_id="irs"):
    return VasicekModel(0.0, rate=0.03, mean=0.045, mean_reversion_speed=0.3,
                        volatility=0.012, asset_id=asset_id)


def profile(results, ns_name, metric_name, n):
    return np.array([
        float(results.get_results(ns_name, metric_name, evaluation_idx=i))
        for i in range(n)
    ])


def run_exposure_book(model, products, timeline, metrics=None, num_paths=20_000,
                      num_paths_presim=None, num_steps=1, scheme=None,
                      ns_name="book", device=None, **controller_kwargs):
    """One-netting-set EE/PFE run, the shape every exposure script shares:
    build the controller on ``device``, simulate, return the
    SimulationResults."""
    if metrics is None:
        metrics = [EPEMetric(), PFEMetric(0.95)]
    controller = SimulationController(
        netting_sets=[NettingSet(name=ns_name, products=list(products))],
        model=model,
        risk_metrics=RiskMetrics(metrics=metrics, exposure_timeline=timeline),
        num_paths_mainsim=num_paths,
        num_paths_presim=num_paths if num_paths_presim is None else num_paths_presim,
        num_steps=num_steps,
        simulation_scheme=SimulationScheme.ANALYTICAL if scheme is None else scheme,
        device=device,
        **controller_kwargs,
    )
    return controller.run_simulation()
