"""What a run is made of, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell; the cell names a configuration (its file is
given in ``BENCHMARK.json``), a traffic mix (``portbench/traffic/<name>.json``)
and the metrics it reports (``portbench/metrics/<name>.py``, one reader
each). A cell's output check reads its limits from
``portbench/limits/<cell>.json``. Adding a cell, a mix, a configuration or a
metric adds files and entries; no file here names one of them. A metric
``<quantity>.<cells>`` (``idle_share.serve``) whose own file is absent is
read by ``metrics/<quantity>.py``, the one reader of a quantity that is
split by the end-to-end metric it moves.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names loaded."""

    def __init__(self, name: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / self.bench["paths"][0]
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        files = {c["name"]: self.root / c["file"]
                 for c in self.bench["configs"]}
        self.config = json.loads(files[self.workload["config"]].read_text())
        self.traffic = json.loads(
            (self.home / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        limits = self.home / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() \
            else {}
        self.run_seconds = int(self.bench["run_seconds"])

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries this cell reports: the end-to-end ones with
        ``--trace 0``, the per-layer ones with ``--trace 1``; an entry with
        a ``workloads`` key only in the cells it lists."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or self.name in m["workloads"]]

    def reader_path(self, metric: str) -> Path:
        """``metrics/<metric>.py``, else ``metrics/<quantity>.py`` for a
        metric named ``<quantity>.<cells>``."""
        own = self.home / "metrics" / f"{metric}.py"
        quantity = metric.rsplit(".", 1)[0]
        return own if own.exists() or quantity == metric else \
            self.home / "metrics" / f"{quantity}.py"

    def reader(self, metric: str):
        """The ``read(run)`` function of the metric's reader file."""
        path = self.reader_path(metric)
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def count(self, name: str):
        """The module ``counts/<name>.py`` (operations and bytes from
        shapes)."""
        path = self.home / "counts" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_count_" + name.replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
