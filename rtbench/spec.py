"""Finding a cell's files by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix. The configuration's
sizes are ``configs/<config>.json``, its plain reference
``reference/<config>.py``; the mix's parameters are
``traffic/<traffic>.json``, and the mix's ``kind`` names the general
generator that reads them, ``generators/<kind>.py``. How a configuration's
outputs under one kind of traffic are judged, with the limits, is
``reference/<config>.<kind>.py``, and the faults a test plants in that
path of the program ``faults/<config>.<kind>.py``. A per-layer metric's
reader is ``metrics/<metric>.py`` and a kernel's cost
``cost/<kernel>.py``. Names may hold dots, so the Python files are
loaded by path, not imported by module name.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``rtbench/<kind>/<name>.py``, loaded once a process."""
    key = f"rtbench._{kind}.{name}"
    if key in sys.modules:
        return sys.modules[key]
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"rtbench: no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One entry of ``workloads`` with everything it names resolved."""

    def __init__(self, bench: Dict[str, Any], name: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"rtbench: no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(ROOT / self.config_entry["file"])
        self.traffic = load_json(HERE / "traffic" / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    def _has(self, metric: Dict[str, Any]) -> bool:
        return self.name in metric.get("workloads", [self.name])

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def reference(self) -> ModuleType:
        return load_module("reference", self.config["name"])

    def generator(self) -> ModuleType:
        """The general generator of the mix's kind of traffic."""
        return load_module("generators", self.kind)

    def check(self) -> ModuleType:
        """The judge of the configuration's outputs under this kind of
        traffic, with its limits."""
        return load_module("reference", f"{self.config['name']}.{self.kind}")

    def faults(self) -> Dict[str, Any]:
        """The faults that can be planted in this cell's path of the
        program, by name (none where the cell has no faults file)."""
        name = f"{self.config['name']}.{self.kind}"
        if not (HERE / "faults" / f"{name}.py").is_file():
            return {}
        return load_module("faults", name).FAULTS

    def readers(self) -> List[tuple]:
        """(metric entry, reader module) for each per-layer metric."""
        return [(m, load_module("metrics", m["name"])) for m in self.per_layer]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")
