"""The traffic generator deals the same mix of lengths to every seed where
the mix asks for balanced rounds."""

from __future__ import annotations

import numpy as np

from portbench.traffic import generate as traffic_gen


def test_every_prefix_holds_each_stratum():
    values = np.arange(64) * 3 + 1
    for seed in (1, 2147491001, 3_000_000_019):
        out = traffic_gen.balanced_order(values, np.random.default_rng(seed),
                                         8)
        assert sorted(out) == sorted(values)
        stratum = np.searchsorted(np.sort(values), out) // 8
        for n in range(1, 65):
            counts = np.bincount(stratum[:n], minlength=8)
            assert counts.max() - counts.min() <= 1


def test_balanced_chat_gives_every_seed_the_same_work():
    spec = traffic_gen.load("chat")
    staged, prompts = [], []
    for seed in (11, 2147491013, 3_000_000_019):
        t = traffic_gen.Traffic(spec, seed, 64, 1000)
        staged.append(sum(r.max_new_tokens for r in t.staged()))
        prompts.append(sum(len(t.next_request(0).prompt) for _ in range(150)))
    for got in (staged, prompts):
        assert max(got) - min(got) <= 0.02 * min(got)
