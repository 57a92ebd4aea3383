"""Run metrics and their structured summary (port of
``spatten_tpu/engine/metrics.py``): throughput, pruning and requant
counts and the head keep fraction of one ``generate`` run, as one JSON
summary."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from spatten_tpu_torch.config import SpAttenConfig


@dataclass
class RunMetrics:
    model: str = ""
    batch: int = 0
    prompt_tokens: int = 0
    generated_tokens: int = 0
    wall_seconds: float = 0.0
    requant_events: int = 0
    final_cache_length: int = 0
    cache_capacity: int = 0
    head_keep_fraction: float = 1.0
    config: dict = field(default_factory=dict)

    @property
    def tokens_per_s(self) -> float:
        return (self.generated_tokens / self.wall_seconds
                if self.wall_seconds else 0.0)

    @property
    def requant_rate(self) -> float:
        """Requants per (step, layer, kv_head) request."""
        reqs = self.config.get("requests", 0)
        return self.requant_events / reqs if reqs else 0.0

    def summary(self) -> dict:
        d = dataclasses.asdict(self)
        d["tokens_per_s"] = round(self.tokens_per_s, 2)
        d["requant_rate"] = round(self.requant_rate, 4)
        return d

    def write(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.summary(), fh, indent=2)


def collect_run_metrics(cfg: SpAttenConfig, result, batch: int,
                        prompt_tokens: int, wall_seconds: float
                        ) -> RunMetrics:
    """The metrics of a ``generate`` result (``GenerateResult``);
    ``wall_seconds`` is the caller's host clock, device synchronised."""
    state = result.state
    steps = int(result.tokens.shape[1])
    m = cfg.model
    hm = state.head_mask.cpu().float()
    return RunMetrics(
        model=f"{m.model_type}-{m.num_layers}L-{m.hidden_size}d",
        batch=batch,
        prompt_tokens=prompt_tokens,
        generated_tokens=int(result.tokens.numel()),
        wall_seconds=wall_seconds,
        requant_events=int(result.requant_events),
        final_cache_length=int(state.lengths.max()),
        cache_capacity=cfg.engine.cache_capacity,
        head_keep_fraction=float(hm.mean()),
        config={
            "requests": steps * m.num_layers * m.num_kv_heads * batch,
            "pruning": dataclasses.asdict(cfg.pruning),
            "quant": dataclasses.asdict(cfg.quant),
        },
    )
