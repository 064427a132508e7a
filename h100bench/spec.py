"""The benchmark's data, found by name: BENCHMARK.json at the root of the
checkout, configurations (the file each names), their data kinds
(data/<kind>.py), traffic mixes (traffic/<name>.json), checks
(checks/<name>.py) and per-layer metric readers (metrics/<name>.py).  A
later cell of one card, mix, data kind or metric is a new file and an
entry in BENCHMARK.json; no code here changes for it.  A cell of
several cards needs a runner of several processes, which is code (see
harness.py)."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: str = HERE):
    """<base>/<kind>/<name>.py as a module of its own."""
    path = os.path.join(base, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"h100bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic mix's contents
    end_to_end: List[dict]  # the metrics this cell reports, trace 0
    per_layer: List[dict]  # ... and with trace 1
    base: str = HERE  # where its traffic, checks and metrics are found


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: dict = None, root: str = ROOT,
              base: str = HERE) -> Cell:
    """The cell `name` of BENCHMARK.json (under `root`, or `bench`), its
    configuration file, traffic mix (<base>/traffic/) and metrics."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"h100bench: no workload {name!r} in BENCHMARK.json"
                         f" (have {sorted(cells)})")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    # a per-layer metric without a workloads list is read in every cell
    # that reports the end-to-end metric it moves
    layer = [m for m in bench["per_layer"]
             if (name in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return Cell(name, int(w["chips"]),
                load_json(os.path.join(root, cfg["file"])),
                load_json(os.path.join(base, "traffic",
                                       f"{w['traffic']}.json")),
                e2e, layer, base)
