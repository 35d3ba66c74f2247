"""Finds a cell's parts by name: its entry in ``BENCHMARK.json``, its
configuration file and the layout it names (``bench/layouts/<layout>.py``,
``layouts.layout_of``), its traffic mix (``bench/traffic/<traffic>.json``),
its limits (``bench/limits/<cell>.json``), and the reader of each of its
metrics (``bench/metrics/<metric>.py``, a function ``read(run)``)."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

from layouts import layout_of

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict                  # the configuration file's keys
    traffic: dict                 # the mix file's keys
    engine: dict                  # the configuration's engine settings
    limits: dict                  # the limits file's keys
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    layout_of(config)
    traffic = json.loads(
        (BENCH / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                engine=config["engine"],
                limits=limits, chips=wl["chips"],
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def reader(metric: str) -> Callable:
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
