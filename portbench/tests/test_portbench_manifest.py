"""The manifest's names and units, and that a configuration, a traffic
mix and a metric are found by adding files alone."""

from __future__ import annotations

import json
import re
import time

import pytest

from portbench import harness, manifest
from portbench.tests import tiny
from portbench.traffic import generate as traffic_gen

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_names_units_and_keys():
    bench = manifest.load()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("portbench/")
        assert (manifest.REPO / c["file"]).is_file()
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        traffic_gen.load(w["traffic"])
        manifest.limits(w["name"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        manifest.reader(m["name"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and LINE.match(m["layer"])
        for cell in m.get("workloads", []):
            moved = manifest.metrics_for_e2e(bench, cell)
            assert m["moves"] in {x["name"] for x in moved}
    for w in bench["workloads"]:
        assert manifest.metrics_for(bench, w["name"], "per_layer")
        assert len(manifest.metrics_for(bench, w["name"], "end_to_end")) >= 2
    assert len(json.dumps(bench)) < 64 * 1024


def test_new_files_are_found_without_edits(tmp_path):
    """A new config, traffic mix, limits file and metric reader, and the
    manifest entries that name them, make a cell that runs."""
    root, bdir, bench = tiny.make_root(tmp_path)
    c = tiny.tiny_config()
    c["engine"]["param_dtype"] = "float32"
    (bdir / "configs" / "fresh-model.json").write_text(json.dumps(c))
    spec = dict(tiny.TRAFFIC["long"], history_min=60, history_max=90)
    (bdir / "traffic" / "fresh-mix.json").write_text(json.dumps(spec))
    (bdir / "limits" / "fresh.cell.json").write_text(json.dumps(
        {"gap_mean": 1e9, "head_mask_mismatch": 1e9, "tokens_judged": 1}))
    (bdir / "metrics" / "fresh.metric.py").write_text(
        "def read(obs):\n    return float(obs.tokens)\n")
    bench["configs"].append({"name": "fresh-model", "source": "test",
                             "file": "portbench/configs/fresh-model.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "fresh.cell", "config": "fresh-model",
                               "traffic": "fresh-mix", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "fresh.metric", "unit": "count",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["fresh.cell"]})
    out = harness.run("fresh.cell", 3, 0.5, False, t_start=time.perf_counter(),
                      device="cpu", root=root, bench=bench, bench_dir=bdir)
    assert out["metrics"]["fresh.metric"]["value"] > 0
    assert set(out["metrics"]) >= {"out_tok_s", "setup_s", "fresh.metric"}


@pytest.mark.parametrize("name", ["long", "chat"])
def test_traffic_same_for_a_seed(name):
    spec = tiny.TRAFFIC[name]

    def draw(seed):
        t = traffic_gen.Traffic(spec, seed, 8, 256)
        reqs = t.staged() + [t.next_request(i % 8) for i in range(20)]
        return [(r.client, r.prompt.tolist(), r.max_new_tokens)
                for r in reqs if r is not None]

    big = 2 ** 31 + 12345
    assert draw(big) == draw(big)
    assert draw(big) != draw(big + 1)
    # the same lengths for every seed, in another order
    if name == "long":
        lens = lambda s: sorted(len(p) for _, p, _ in draw(s))  # noqa: E731
        assert lens(big) == lens(7)


def test_pool_is_the_same_set_for_every_seed():
    spec = tiny.TRAFFIC["chat"]
    a = traffic_gen.Traffic(spec, 1, 8, 256)
    b = traffic_gen.Traffic(spec, 99, 8, 256)
    assert sorted(a._prompts) == sorted(b._prompts)
    assert sorted(a._outputs) == sorted(b._outputs)
