"""Finds a cell's files by the names in ``BENCHMARK.json``: the cell
(``workloads/<name>.json``), its configuration (``configs/<config>.json``),
its traffic mix (``traffic/<traffic>.json``), its entry
(``entries/<entry>.py``), and the metrics (``metrics/<metric>.py``, or
the file of the name's part before its first dot) and
kernel work counts (``roofline/<kernel>.py``) as modules. Adding a cell, a
configuration, a traffic mix or a metric adds files; none of these is
edited."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
CHECKOUT = os.path.dirname(HERE)


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json"), encoding="utf-8") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py``; for a metric split by the end-to-end metric it
    moves (``step_ms.stream``, ``step_ms.serve``), ``<kind>/<base>.py`` where
    no file of the whole name is there, ``<base>`` being the name up to its
    first dot."""
    path = os.path.join(HERE, kind, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, kind, f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + kind + "_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(CHECKOUT, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    end_to_end: List[dict]  # BENCHMARK.json's metrics this cell reports, trace off
    per_layer: List[dict]  # and with the trace on


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def cell(name: str, bench: Dict = None) -> Cell:
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    spec = load_json("workloads", name)
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise SystemExit(f"portbench: {name}: {key} differs between BENCHMARK.json and "
                             f"workloads/{name}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, spec=spec, config=load_json("configs", spec["config"]),
                traffic=load_json("traffic", spec["traffic"]), end_to_end=e2e,
                per_layer=per_layer)
