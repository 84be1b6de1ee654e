"""Finds everything by name: ``BENCHMARK.json`` at the checkout's root,
``cells/<workload>.json``, ``configs/<name>.json``, ``traffic/<name>.json``
and ``metrics/<metric>.py``. Adding a cell, a configuration, a traffic
mix or a per-layer metric is adding files."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _json(ROOT / "BENCHMARK.json")


def cell(name: str) -> Dict:
    return _json(HERE / "cells" / f"{name}.json")


def config(name: str) -> Dict:
    return _json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: Dict, kind: str, name: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def reader(metric: str):
    """The reader of a metric: ``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_name = "perfbench_metric_" + metric.replace(".", "_").replace(
        "-", "_")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
