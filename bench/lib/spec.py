"""Find a cell's files by the names ``BENCHMARK.json`` gives.

A cell ``<config>.<mix>`` names a configuration (``configs[].file``), a
traffic mix (``bench/traffic/<mix>.json``) and, through the metrics whose
``workloads`` list it (or that list none), its per-layer readers
(``bench/metrics/<metric>.py``). Nothing here knows a name: a new
configuration, mix or metric is a new file and a new entry, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict           # the configuration file's JSON
    traffic: dict          # the mix file's JSON
    end_to_end: list       # BENCHMARK.json metric entries this cell reports
    per_layer: list
    bench_dir: Path

    def reader(self, metric: str):
        """The per-layer metric's ``read(ctx)`` from its own file."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root/BENCHMARK.json``."""
    bj = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bj["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bj["configs"]}
    bench_dir = root / "bench"
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bj["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bj["per_layer"]
                           if _reports(m, workload)],
                bench_dir=bench_dir)
