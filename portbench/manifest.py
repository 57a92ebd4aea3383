"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is ``configs/<config>.json``, its model path
``paths/<path>.py`` (the config's ``"path"`` key, ``paths.DEFAULT`` where
it has none; ``paths/__init__.py`` says what a path holds), its traffic mix
``traffic/<traffic>.json``, its correctness limits ``limits/<cell>.json``
and each metric a reader ``metrics/<metric>.py`` with a function
``read(obs)`` that returns the metric's value or None (nothing to read).
Adding a model, a cell, a mix or a metric adds files and entries; no
code here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

from portbench import paths

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


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


def _by_file(prefix: str, name: str, file: Path):
    """The module in ``file``, loaded once a process: kept in
    ``sys.modules`` under ``prefix`` + ``name``, so that a second load of
    the same file is the same module."""
    mod_name = prefix + name.replace(".", "_").replace("-", "_")
    mod = sys.modules.get(mod_name)
    if mod is not None and getattr(mod, "__file__", None) == str(file):
        return mod
    spec = importlib.util.spec_from_file_location(mod_name, file)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[mod_name]
        raise
    return mod


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    file = (Path(bench_dir) / "metrics" / f"{name}.py").resolve()
    if not file.is_file():
        raise FileNotFoundError(f"no metric reader {file}")
    return _by_file("portbench_metric_", name, file).read


def path(c: dict, bench_dir: Path = BENCH_DIR):
    """The model path module ``paths/<name>.py`` that config ``c`` names
    under ``"path"`` (``paths.DEFAULT`` where it names none)."""
    name = c.get("path", paths.DEFAULT)
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"config path {name!r}: not a name")
    file = (Path(bench_dir) / "paths" / f"{name}.py").resolve()
    if not file.is_file():
        raise FileNotFoundError(f"no model path {file}")
    return _by_file("portbench_path_", name, file)
