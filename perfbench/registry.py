"""Finds a cell's parts by the names in `BENCHMARK.json`, so that a new
configuration, traffic mix or per-layer metric is added by adding files:

- a configuration: the file its entry names (`configs/<name>.json`: the
  engine configuration as it is run under "config", the plain reference's
  package under "reference"), and its limits, `limits/<name>.json`;
- a traffic mix: `traffic/<name>.json` (see `traffic.py`);
- a per-layer metric: `metrics/<name>.py`, whose `read(ctx)` returns the
  value or None when the run has nothing for it to read (see
  `metrics/__init__.py` for `ctx`).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent


class Registry:
    def __init__(self, root: Optional[Path] = None):
        self.root = Path(root) if root is not None else HERE.parent
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / self.bench["paths"][0]

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        """The configuration's file, with its BENCHMARK.json entry."""
        for c in self.bench["configs"]:
            if c["name"] == name:
                return {**json.loads((self.root / c["file"]).read_text()), "entry": c}
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def limits(self, config: str) -> Dict:
        return json.loads((self.dir / "limits" / f"{config}.json").read_text())

    def traffic(self, name: str) -> Dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        """The per-layer metrics a cell reports: those that list it, and
        those without a list that move an end-to-end metric it reports."""
        mine = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in mine)]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def read_per_layer(self, cell: str, ctx: Dict) -> Tuple[Dict, Dict]:
        """{name: {"value", "unit"}} of the metrics that found something to
        read, and {name: reason} of those that did not."""
        out, silent = {}, {}
        for m in self.per_layer(cell):
            value = self.reader(m["name"])(ctx)
            if value is None:
                silent[m["name"]] = "nothing to read in this run"
            else:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out, silent
