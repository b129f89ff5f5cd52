"""``BENCHMARK.json`` and the files it names, found by name.

Whatever belongs to one configuration, mix, metric or cell is a file of
its own, so that a later change adds files and entries and edits none:

- a configuration: the file its ``BENCHMARK.json`` entry names, and the
  plain reference of its family, ``reference/<family>.py``;
- a traffic mix: ``traffic/<name>.json``, read by the generator of its
  ``kind``, ``generators/<kind>.py``;
- a per-layer metric: its reader, ``metrics/<name>.py``, a module with
  ``read(ctx) -> float | None``;
- a cell: the sample and the limits of its check of outputs,
  ``limits/<cell>.json``.

Files are looked up under ``<root>/bench`` and then beside this module,
so a layout of data files elsewhere can use the code here.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    traffic: str
    mix: dict               # the traffic file's contents
    chips: int
    end_to_end: List[dict]  # BENCHMARK.json's entries this cell reports
    per_layer: List[dict]
    limits: dict


class Manifest:
    def __init__(self, root: Path = ROOT) -> None:
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dirs = [self.root / "bench"]
        if BENCH_DIR not in self.dirs:
            self.dirs.append(BENCH_DIR)

    def find(self, kind: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under "
                                f"{[str(d) for d in self.dirs]}")

    def module(self, kind: str, name: str) -> ModuleType:
        path = self.find(kind, name, ".py")
        mod_name = "bench_" + kind + "_" + re.sub(r"\W", "_", name)
        mod = sys.modules.get(mod_name)
        if mod is not None and getattr(mod, "__file__", None) == str(path):
            return mod
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod

    def workloads(self) -> List[str]:
        return [w["name"] for w in self.data["workloads"]]

    def config(self, name: str) -> dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.root / entry["file"]).read_text())

    def mix(self, traffic: str) -> dict:
        return json.loads(self.find("traffic", traffic, ".json").read_text())

    def generator(self, kind: str) -> ModuleType:
        return self.module("generators", kind)

    def reference(self, family: str) -> ModuleType:
        return self.module("reference", family)

    def reader(self, metric: str) -> ModuleType:
        return self.module("metrics", metric)

    def cell(self, name: str) -> Cell:
        try:
            w = next(w for w in self.data["workloads"] if w["name"] == name)
        except StopIteration:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{self.workloads()}") from None
        e2e = [m for m in self.data["end_to_end"] if _applies(m, name)]
        e2e_names = {m["name"] for m in e2e}
        per_layer = [m for m in self.data["per_layer"]
                     if _applies(m, name) and m["moves"] in e2e_names]
        return Cell(name=name, config=self.config(w["config"]),
                    traffic=w["traffic"], mix=self.mix(w["traffic"]),
                    chips=int(w["chips"]), end_to_end=e2e,
                    per_layer=per_layer,
                    limits=json.loads(
                        self.find("limits", name, ".json").read_text()))


def _applies(metric: dict, cell: str) -> bool:
    names: Optional[List[str]] = metric.get("workloads")
    return names is None or cell in names

