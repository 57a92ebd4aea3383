"""The port's tools against the JAX repository's, on the CPU:

* ``tools/extract_doc_corpus.py``: on a temporary tree of ``.py`` files
  (nested packages, a ``tests`` and a ``__pycache__`` directory, short,
  code-ish and duplicate docstrings, a file that does not parse) the
  port's corpus is byte for byte the JAX script's (run with ``runpy``,
  ``sysconfig.get_paths`` patched to the tree);
* ``tools/replay_trace.py``: a CSV from the port's ``collect_trace``
  priced with every flag given prints the JAX tool's JSON (floats within
  1e-12 relative); without flags the port prices at ``H100_SXM``;
* ``tools/hbm_calibrate.py``: runs on the CPU at a small size when asked,
  raises without CUDA by default;
* the constructors that defaulted to the CPU (``rope_table``,
  ``layer_budgets``, ``init_layer_cache``, ``init_stacked_cache``) raise
  without CUDA when no device is given;
* ``tools/plain_gap.py``'s ppl mode at the tiny scale: on the CPU, where
  K1's wrapper runs its plain version, every call's output is bit-equal
  and the NLL gap 0, while each planted fault moves the NLL.
"""

import contextlib
import dataclasses
import io
import json
import math
import runpy
import sys
import sysconfig
from pathlib import Path

import numpy as np
import pytest
import torch

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.engine import kv_cache as tkv
from spatten_tpu_torch.engine import trace as ttrace
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.ops import rope as trope
from spatten_tpu_torch.perf import H100_SXM
from spatten_tpu_torch.pruning import token_pruning as ttp
from spatten_tpu_torch.tools import (
    extract_doc_corpus, hbm_calibrate, plain_gap, ppl_curve, replay_trace,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PROSE = ("The function returns the rows of the cache that the pruning "
         "step keeps, in order, with their scales and their importance. "
         "Each row holds one token of one layer and is read once per "
         "decode step by the attention kernel, which weights it by its "
         "probability and skips the blocks that no query keeps. ")


def doc(i: int, text: str = PROSE) -> str:
    return f"Entry {i}. " + text


def write_tree(root: Path) -> Path:
    """Packages whose docstrings exercise every filter and the walk."""
    (root / "pkg" / "sub").mkdir(parents=True)
    (root / "pkg" / "tests").mkdir()
    (root / "pkg" / "__pycache__").mkdir()
    (root / "zeta").mkdir()
    files = {
        "pkg/__init__.py": f'"""{doc(0)}"""\n',
        "pkg/a.py": (f'"""{doc(1)}"""\n\n'
                     f'class A:\n    """{doc(2)}"""\n\n'
                     f'    def f(self):\n        """{doc(3)}"""\n\n'
                     f'async def g():\n    """{doc(4)}"""\n\n'
                     'def short():\n    """Too short to keep."""\n\n'
                     f'def dup():\n    """{doc(1)}"""\n'),
        "pkg/sub/b.py": (f'def code():\n    """{doc(5, "x[i] = {a: b}_<>; " * 30)}"""\n\n'
                         f'def few_words():\n    """{"a1 " * 120}"""\n\n'
                         f'def kept():\n    """  {doc(6)}  """\n'),
        "pkg/tests/test_c.py": f'"""{doc(7)}"""\n',
        "pkg/__pycache__/d.py": f'"""{doc(8)}"""\n',
        "pkg/broken.py": f'"""{doc(9)}"""\ndef (:\n',
        "pkg/notes.txt": f'"""{doc(10)}"""\n',
        "zeta/z.py": f'"""{doc(11)}"""\n\nX = 1\n',
    }
    for name, text in files.items():
        (root / name).write_text(text)
    return root


def test_extract_doc_corpus_equals_jax(tmp_path, monkeypatch):
    tree = write_tree(tmp_path / "site")
    jax_out, port_out = tmp_path / "jax.txt", tmp_path / "port.txt"
    paths = dict(sysconfig.get_paths(), purelib=str(tree))
    monkeypatch.setattr(sysconfig, "get_paths", lambda *a, **k: paths)
    monkeypatch.setattr(sys, "argv", ["extract_doc_corpus.py",
                                      str(jax_out)])
    with contextlib.redirect_stderr(io.StringIO()):
        runpy.run_path(str(REPO / "tools" / "extract_doc_corpus.py"),
                       run_name="__main__")
    n, total = extract_doc_corpus.extract(out_path=port_out)
    assert port_out.read_bytes() == jax_out.read_bytes()
    text = port_out.read_text()
    # the kept docstrings: 0-4 (1's duplicate dropped), 6 stripped, 11
    assert n == 7 and total > 7 * 200
    assert [f"Entry {i}." in text for i in range(12)] == [
        True, True, True, True, True, False, True, False, False, False,
        False, True]


def trace_cfg():
    return tcfg.SpAttenConfig(
        model=tcfg.ModelConfig.tiny(),
        pruning=tcfg.PruningConfig(start_size=2, important_size=8,
                                   recent_size=8, v_keep_ratio=0.5,
                                   v_block_size=4,
                                   cascade_layer_ratios=(1.0, 0.5)),
        quant=tcfg.QuantConfig(requant_threshold=0.2),
        engine=tcfg.EngineConfig(max_batch_size=1, cache_capacity=32,
                                 prefill_chunk=8),
    ).validate()


@pytest.fixture(scope="module")
def trace_csv(tmp_path_factory):
    cfg = trace_cfg()
    params = ttr.init_params(cfg.model, 0, dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 255, (1, 30))
    rows = ttrace.collect_trace(params, cfg, prompt, max_new_tokens=12,
                                device="cpu")
    path = tmp_path_factory.mktemp("trace") / "trace.csv"
    ttrace.write_csv(rows, str(path))
    return path


def run_main(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue())


def assert_json_close(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            assert_json_close(g, w)
        elif isinstance(w, float):
            assert g == pytest.approx(w, rel=1e-12, abs=0), k
        else:
            assert g == w, k


def test_replay_trace_equals_jax_with_every_flag(trace_csv, tmp_path):
    sys.path.insert(0, str(REPO))
    try:
        jtool = runpy.run_path(str(REPO / "tools" / "replay_trace.py"))
    finally:
        sys.path.remove(str(REPO))
    flags = ["--hbm-gbps", "819", "--peak-tflops", "98",
             "--step-overhead-us", "30", "--weight-bytes-per-step", "1.5e8"]
    want = run_main(jtool["main"], [str(trace_csv), *flags])
    port_json = tmp_path / "port.json"
    got = run_main(replay_trace.main,
                   [str(trace_csv), *flags, "--json", str(port_json)])
    assert_json_close(got, want)
    assert json.loads(port_json.read_text()) == got
    assert got["iterations"] == 12 and got["rows"] > 12


def test_replay_trace_defaults_to_the_card_preset(trace_csv):
    got = run_main(replay_trace.main, [str(trace_csv)])
    assert got["hw"] == dataclasses.asdict(H100_SXM)
    assert got == replay_trace.replay(str(trace_csv))


def test_hbm_calibrate_on_the_cpu_when_asked():
    res = hbm_calibrate.calibrate("cpu", read_bytes=1 << 20,
                                  copy_bytes=1 << 20, k=64, n=128,
                                  rows=(2, 4), iters=2)
    assert [r["name"] for r in res] == [
        "read int8", "read bf16", "read f32", "int8 dot rows=2",
        "int8 dot rows=4", "copy int8 (r+w)"]
    assert all(r["device"] == "cpu" and math.isfinite(r["gbps"])
               and r["gbps"] > 0 for r in res)
    assert res[-1]["bytes"] == 2 << 20 and res[3]["bytes"] == 64 * 128
    lines = hbm_calibrate.lines(res)
    assert len(lines) == 6 and lines[0].startswith("read int8: ")
    assert "GB/s of weights" in lines[3] and "agg" in lines[5]


def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_hbm_calibrate_raises_without_cuda():
    no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hbm_calibrate.calibrate()


@pytest.mark.parametrize("build", [
    lambda: trope.rope_table(8, 4),
    lambda: ttp.layer_budgets(tcfg.PruningConfig(), 2),
    lambda: tkv.init_layer_cache(1, 1, 32, 8),
    lambda: tkv.init_stacked_cache(1, 1, 1, 32, 8),
], ids=["rope_table", "layer_budgets", "init_layer_cache",
        "init_stacked_cache"])
def test_constructors_default_to_cuda(build):
    no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_plain_gap_controls_move_the_nll():
    r = plain_gap.ppl("cpu", models=1, texts=1, steps=3,
                      sc=ppl_curve.SCALES["tiny"])
    calls = r["per_call"]
    assert calls["calls"] > 0 and calls["calls_exact"] == calls["calls"]
    assert calls["exact"] == calls["total"] and calls["max_ulp"] == 0
    assert r["worst"] == 0.0 and len(r["gaps"]) == 1
    assert set(r["controls"]) == {"probabilities rounded to bf16",
                                  "one V block fewer kept"}
    assert all(min(v) > 0.0 for v in r["controls"].values())
