"""The end-to-end metrics' arithmetic: a rate over all the window's work
and time, and 95th percentiles over every gap and every request, so a
stall inside the window moves them."""

from __future__ import annotations

from types import SimpleNamespace

from portbench import counts, manifest


def _obs(gaps, ttfts, tokens=1000, window_s=10.0):
    return SimpleNamespace(gaps=gaps, ttfts=ttfts, tokens=tokens,
                           window_s=window_s, counts=counts, setup_s=12.5)


def test_rate_is_over_the_whole_window():
    read = manifest.reader("out_tok_s")
    assert read(_obs([], [], tokens=1000, window_s=10.0)) == 100.0
    # a stall that adds seconds and no tokens lowers the rate
    assert read(_obs([], [], tokens=1000, window_s=12.0)) < 100.0


def test_p95_over_all_gaps_sees_a_stall():
    read = manifest.reader("itl_p95_ms")
    steady = [0.040] * 1000
    assert abs(read(_obs(steady, [])) - 40.0) < 1e-9
    # 6% of the gaps stalled at 200 ms: the 95th percentile is a stall
    stalled = [0.040] * 940 + [0.200] * 60
    assert abs(read(_obs(stalled, [])) - 200.0) < 1e-9
    # 4% stalled: below the tail's cut, so the percentile stays
    assert abs(read(_obs([0.040] * 960 + [0.200] * 40, [])) - 40.0) < 1e-9


def test_ttft_p95_counts_every_request():
    read = manifest.reader("server.ttft_p95_ms")
    waits = [0.3] * 90 + [2.0] * 10
    assert abs(read(_obs([], waits)) - 2000.0) < 1e-9
    assert read(_obs([], [])) is None


def test_percentile_nearest_rank():
    assert counts.percentile(range(1, 101), 0.95) == 95
    assert counts.percentile([5.0], 0.95) == 5.0
    assert counts.percentile([1, 2], 0.5) == 1


def test_setup_s():
    assert manifest.reader("setup_s")(_obs([], [])) == 12.5
