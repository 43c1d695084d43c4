"""Cells as data: ``BENCHMARK.json`` names each cell's configuration and
traffic mix, and every configuration, mix, limit set and per-layer metric
is a file of its own under ``portbench/``, found by its name. So is the
code that a configuration or a mix names: a configuration's ``system``
(``systems/<name>.py``: the program's model built from it), its
``reference`` (``reference/<name>.py``) and its catalog's ``generator``
(``catalogs/<name>.py``); a mix's ``driver`` (``drivers/<name>.py``: the
warm-up, the timed window, its end-to-end rates and the check)."""

from __future__ import annotations

import glob
import importlib.util
import json
import os
import re


class Cell:
    """One entry of ``workloads`` with everything it names, read from the
    benchmark directory ``bench`` (``<root>/portbench``)."""

    def __init__(self, root: str, workload: str):
        self.root = root
        self.bench = os.path.join(root, "portbench")
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(cells: {', '.join(sorted(cells))})")
        self.workload = cells[workload]
        self.name = workload
        self.chips = int(self.workload["chips"])
        confs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = confs[self.workload["config"]]
        self.config = self._json(self.config_entry["file"], rel=self.root)
        self.traffic = self._json(os.path.join(
            "traffic", self.workload["traffic"] + ".json"))
        self.limits = self._json(os.path.join("limits", workload + ".json"))

    def _code(self, kind: str, name: str):
        return load_module(os.path.join(self.bench, kind, name + ".py"))

    @property
    def system(self):
        return self._code("systems", self.config["system"])

    @property
    def driver(self):
        return self._code("drivers", self.traffic["driver"])

    def catalog(self, seed: int) -> dict:
        """The configuration's catalog for ``seed``."""
        return self._code("catalogs", self.config["catalog"][
            "generator"]).make(self.config, seed)

    def reference(self, catalog: dict):
        """The configuration's plain reference for ``catalog``."""
        return self._code("reference", self.config["reference"]).build(
            self.config, catalog)

    def _json(self, path, rel=None):
        with open(os.path.join(rel or self.bench, path)) as fh:
            return json.load(fh)

    def metrics(self, trace: bool):
        """``[(entry, reader)]`` of this cell's metrics: its end-to-end
        metrics (taken by the window code itself) with ``trace`` 0, else its
        per-layer metrics, each with the ``read`` function of
        ``portbench/metrics/<name>.py``."""
        if not trace:
            return [(m, None) for m in self.spec["end_to_end"]
                    if self.name in m.get("workloads", [self.name])]
        out = []
        for m in self.spec["per_layer"]:
            if self.name not in m.get("workloads", [self.name]):
                continue
            out.append((m, load_module(os.path.join(
                self.bench, "metrics", m["name"] + ".py")).read))
        return out

    def kernel_names(self, wrapper: str):
        """``(family, patterns)`` of the program's kernel ``wrapper``:
        its family's name (``counts/<family>.py``) and its device kernels'
        name patterns, the union of every ``kernel_names/<wrapper>*.json``
        (a renamed kernel adds a file beside the old one)."""
        family, pats = None, []
        for path in sorted(glob.glob(os.path.join(
                self.bench, "kernel_names", wrapper + "*.json"))):
            with open(path) as fh:
                spec = json.load(fh)
            if spec["wrapper"] == wrapper:
                family = spec["family"]
                pats += spec["device_kernels"]
        return family, [re.compile(p) for p in pats]

    def counts(self, family: str):
        """``portbench/counts/<family>.py``'s ``counts`` function."""
        return load_module(os.path.join(self.bench, "counts",
                                        family + ".py")).counts

    def peaks(self):
        return self._json("peaks.json")


def load_module(path: str):
    """The Python file at ``path`` as a module of its own."""
    name = "portbench_file_" + re.sub(r"\W", "_", os.path.relpath(
        path, os.path.dirname(os.path.dirname(path))))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
