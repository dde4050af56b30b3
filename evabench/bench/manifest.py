"""The benchmark's data: ``BENCHMARK.json`` at the checkout's root, and
the files it names. Everything that belongs to one configuration, one
traffic mix, one cell or one metric is a file of its own, found by name:

    evabench/configs/<config>.json     sizes, source, cuts (BENCHMARK.json's ``file``)
    evabench/traffic/<traffic>.json    the closed loop's parameters
    evabench/workloads/<cell>.json     the engine's settings, the kernels
                                       it launches, the traced stretch and
                                       the correctness limits
    evabench/metrics/<metric>.py       the reader of one metric
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

from bench.traffic import check, max_len

HERE = Path(__file__).resolve().parents[1]      # evabench/
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict        # the configuration file
    traffic: Dict
    workload: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def cfg(self) -> Dict:
        return self.config["run"]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load(name: str, root: Path = ROOT) -> Cell:
    """Cell ``name`` of ``root``/BENCHMARK.json with its files.

    Raises:
      KeyError: no such cell, or a configuration BENCHMARK.json lacks.
      ValueError: the cell's file disagrees with BENCHMARK.json.
    """
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    workload = _json(HERE / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {workload[key]!r} in its "
                             f"file and {entry[key]!r} in BENCHMARK.json")
    traffic = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    check(traffic)
    if workload["engine"]["max_len"] < max_len(traffic):
        raise ValueError(f"{name}: max_len {workload['engine']['max_len']} "
                         f"holds fewer positions than its traffic's "
                         f"{max_len(traffic)}")
    return Cell(name=name, chips=entry["chips"],
                config=_json(root / conf["file"]), traffic=traffic,
                workload=workload,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``evabench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "evabench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
