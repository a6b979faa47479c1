"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``perfbench/configs/<config>.json``), its traffic mix
(``perfbench/traffic/<traffic>.json``), its limits
(``perfbench/limits/<cell>.json``) and the per-layer metrics it reports
(``perfbench/metrics/<metric>.py``), all found by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    traffic_name: str
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def reports(metric: dict, cell: str, e2e_names) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, or, without the key, every cell that reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", "") in e2e_names


def cell(name: str, bench: dict = None) -> Cell:
    bench = bench or load_benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, cfg, traffic, w["traffic"], int(w["chips"]), e2e,
                per_layer)


def metric_reader(name: str):
    """The ``read(run)`` function of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
