"""What a cell is, found by name: BENCHMARK.json at the checkout's root
names the workloads, their configuration and traffic, and the metrics;
everything that belongs to one of them is a file of its own:

* a configuration: the file its entry names (ocrbench/configs/<name>.json);
* a traffic mix: ocrbench/traffic/<traffic>.json;
* a per-layer metric: ocrbench/metrics/<name>.py, whose `read(run)` gives
  the number or None when the run has nothing to read for it;
* a cell's limits on what decides `correct`: ocrbench/limits/<workload>.json.

So a later change adds a configuration, a traffic mix, a metric or a cell
as new files and entries, and edits none."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the load patterns harness.py drives; a traffic file naming another is
# refused rather than run as a closed loop under another name
LOOPS = ("closed",)


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, name: str) -> bool:
    return name in metric.get("workloads", [name])


def load(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of root/BENCHMARK.json, its files read."""
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    bench = os.path.join(root, "ocrbench")
    wl = {w["name"]: w for w in spec["workloads"]}
    if workload not in wl:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = wl[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(bench, "traffic", w["traffic"] + ".json"))
    loop = traffic.get("load", {}).get("loop", "closed")
    if loop not in LOOPS:
        raise ValueError(f"traffic {w['traffic']!r} asks for a {loop!r} "
                         f"loop; the harness drives {', '.join(LOOPS)}")
    limits = _json(os.path.join(bench, "limits", workload + ".json"))
    return Cell(w, config, traffic,
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)],
                limits)


def reader(name: str, root: str = ROOT) -> Callable:
    """`read` of ocrbench/metrics/<name>.py (names may hold dots)."""
    path = os.path.join(root, "ocrbench", "metrics", name + ".py")
    mod_name = "ocrbench.metrics." + name.replace(".", "__")
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read
