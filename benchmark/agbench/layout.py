"""Where the benchmark's parts are, found by the names BENCHMARK.json
gives them.

    BENCHMARK.json                 the cells, metrics and bounds
    benchmark/configs/<c>.json     a configuration (BENCHMARK.json's file)
    benchmark/reference/<c>.py     its plain reference: expected(config,
                                   inputs) and, optionally, control(...)
    benchmark/traffic/<t>.json     a traffic mix
    benchmark/metrics/<m>.py       a per-layer metric: read(bundle)

A later cell, mix or metric is new files and new entries; nothing here
names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


class LayoutError(Exception):
    """A name BENCHMARK.json uses that has no file, or a malformed one."""


def _json(path: str):
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except OSError as e:
        raise LayoutError("cannot read %s: %s" % (path, e)) from e


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise LayoutError("no workload %r in BENCHMARK.json" % name)


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise LayoutError("no config %r in BENCHMARK.json" % name)


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH, "traffic", name + ".json"))


def _module(kind: str, name: str):
    path = os.path.join(BENCH, kind, name + ".py")
    if not os.path.exists(path):
        raise LayoutError("no %s module %s" % (kind, path))
    spec = importlib.util.spec_from_file_location(
        "agbench_%s_%s" % (kind, name.replace(".", "_")), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg: dict):
    """The plain reference of a configuration (its "reference" key, or
    its name)."""
    return _module("reference", cfg.get("reference", cfg["name"]))


def metric(name: str):
    return _module("metrics", name)


def metrics_of(bench: dict, kind: str, cell_name: str) -> list:
    """The entries of bench[kind] ("end_to_end" or "per_layer") that the
    cell reports: those without a workloads list, and those whose list
    names it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell_name in m["workloads"]]
