"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its traffic mix
``traffic/<traffic>.json``, its correctness limits ``limits/<cell>.json``
and each metric a reader ``metrics/<metric>.py`` with a function
``read(obs)`` that returns the metric's value or None (nothing to read).
Adding a cell, a mix or a metric adds files and entries; no code here
names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent


def load(root: Path = REPO) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = REPO) -> dict:
    entry = _named(bench["configs"], name, "config")
    return json.loads((Path(root) / entry["file"]).read_text())


def limits(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((Path(bench_dir) / "limits" / f"{name}.json"
                       ).read_text())


def metrics_for(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, or list no cells; a per-layer metric without a
    list goes with every cell that reports the metric it moves."""
    if kind == "end_to_end":
        return metrics_for_e2e(bench, cell_name)
    e2e = {m["name"] for m in metrics_for_e2e(bench, cell_name)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def metrics_for_e2e(bench: dict, cell_name: str) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = Path(bench_dir) / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
