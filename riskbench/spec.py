"""Find a cell's files by the names in ``BENCHMARK.json``.

Every configuration, traffic mix, reference and metric reader is a file of
its own, found by name:

  * ``configs[].file``: the configuration (the book);
  * ``riskbench/traffic/<config>.<traffic>.json``: the cell's run parameters;
  * ``riskbench/reference/<config>.py``: the plain reference of the book;
  * ``riskbench/metrics/<metric>.py``: the reader of one metric.

A later cell or metric is added by adding files and entries, never by
editing one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, NamedTuple

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    reference: ModuleType
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"riskbench: no file {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_json(path: Path) -> Dict[str, Any]:
    if not path.is_file():
        raise FileNotFoundError(f"riskbench: no file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def cell_metrics(section: List[Dict[str, Any]], workload: str) -> List[Dict[str, Any]]:
    """The metrics of a section that a workload reports: those that list it,
    and those that list no workloads."""
    return [m for m in section if workload in m.get("workloads", [workload])]


def reader(metric_name: str) -> ModuleType:
    return load_module(BENCH_DIR / "metrics" / f"{metric_name}.py", f"riskbench_metric_{metric_name}")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"riskbench: no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['config']}.{w['traffic']}.json")
    reference = load_module(BENCH_DIR / "reference" / f"{w['config']}.py",
                            f"riskbench_reference_{w['config']}")
    return Cell(workload, int(w["chips"]), config, traffic, reference,
                cell_metrics(bench["end_to_end"], workload), cell_metrics(bench["per_layer"], workload))
