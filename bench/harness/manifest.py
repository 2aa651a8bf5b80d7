"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is resolved from files alone:

* its configuration: the ``configs`` entry of its ``config``, whose ``file``
  is the configuration as it is run;
* its traffic mix: ``bench/traffic/<traffic>.json``, whose ``driver``
  names the module that serves it, ``bench/drivers/<driver>.py`` (a class
  ``Driver``, the interface ``harness.runner`` drives);
* its limits for ``correct``: ``bench/limits/<workload>.json``;
* each metric: ``bench/metrics/<metric>.py``, a module with ``read(ctx)``
  that returns a number, or None where the run has nothing to read.

A cell reports the end-to-end metrics whose ``workloads`` list it (or that
have none), and the per-layer metrics whose ``workloads`` list it, or, with
no list, that move an end-to-end metric the cell reports.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    root: Path
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path) -> Dict:
    return _json(Path(root) / "BENCHMARK.json")


def _reports(metric: Dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    root = Path(root)
    m = manifest(root)
    by_name = {w["name"]: w for w in m["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in m["configs"]}[w["config"]]
    e2e = [x for x in m["end_to_end"] if _reports(x, name)]
    reported = {x["name"] for x in e2e}
    per_layer = [x for x in m["per_layer"]
                 if name in x.get("workloads", ()) or ("workloads" not in x and x["moves"] in reported)]
    return Cell(
        root=root, name=name, workload=w,
        config=_json(root / conf["file"]),
        traffic=_json(root / "bench" / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "bench" / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer,
    )


def _module(root: Path, folder: str, name: str):
    path = Path(root) / "bench" / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``bench/metrics/<metric>.py``, loaded from its file."""
    return _module(root, "metrics", metric).read


def driver(cell: Cell) -> Callable:
    """The ``Driver`` class of ``bench/drivers/<driver>.py`` that the cell's
    traffic mix names."""
    return _module(cell.root, "drivers", cell.traffic["driver"]).Driver
