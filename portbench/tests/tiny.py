"""A tiny copy of the benchmark for the CPU tests: a two-layer model at
the serving knobs' shapes, both traffic kinds, the real metric readers
and model paths."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from portbench import manifest

BENCH = manifest.BENCH_DIR


def tiny_config(kv_heads: int = 2) -> dict:
    c = json.loads((BENCH / "configs" / "mistral-7b-instruct-v0.2.json"
                    ).read_text())
    c.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=kv_heads,
             vocab_size=256, max_position_embeddings=512, rope_theta=10000.0)
    c["spatten"].update(important_size=140, recent_size=25, head_keep=1,
                        head_update_interval=8)
    c["engine"].update(max_batch_size=8, cache_capacity=256,
                       prefill_chunk=32)
    return c


TRAFFIC = {
    "long": {"kind": "staged_sessions", "history_min": 100,
             "history_max": 240, "history_groups": 4, "stage_batch": 2,
             "max_new_tokens": 1000000, "warmup_ticks": 2,
             "judge_sessions": 8, "judge_lead": 2, "judge_horizon": 100,
             "judge_session_steps": 10, "judge_steps": 3,
             "judge_prefills": 2, "judge_requests": 8},
    "chat": {"kind": "closed_loop",
             "prompt": {"median": 40, "sigma": 0.6, "min": 16, "max": 80},
             "output": {"median": 12, "sigma": 0.7, "min": 4, "max": 24},
             "pool": 256, "stage_prompt": 40, "stage_batch": 4,
             "warmup_ticks": 4, "judge_requests": 8, "judge_steps": 2},
}


def make_root(tmp: Path) -> tuple[Path, Path, dict]:
    """A repository root under ``tmp`` holding a tiny BENCHMARK.json and
    its files; returns (root, bench_dir, bench)."""
    root = Path(tmp)
    bdir = root / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (bdir / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "paths"):
        shutil.copytree(BENCH / sub, bdir / sub, dirs_exist_ok=True,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bdir / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    bench = copy.deepcopy(manifest.load())
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "test"}]
    bench["workloads"] = []
    for name, spec in TRAFFIC.items():
        (bdir / "traffic" / f"{name}.json").write_text(json.dumps(spec))
        lim = {"first_gap_max": 1e-3, "gap_mean": 1e-4, "gap_max": 1e-3,
               "head_mask_mismatch": 0, "tokens_judged": 1}
        if spec["kind"] == "staged_sessions":
            lim["rows_across_prune"] = 1
        (bdir / "limits" / f"tiny.{name}.json").write_text(json.dumps(lim))
        bench["workloads"].append({"name": f"tiny.{name}", "config": "tiny",
                                   "traffic": name, "chips": 1,
                                   "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, bdir, bench
