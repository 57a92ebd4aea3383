"""Workload traces in the reference CSV schema: emit, read, replay (port
of ``spatten_tpu/engine/trace.py``).

``TraceRow`` carries the 17 columns of the SpAtten hardware simulator's
workload CSVs (``HEADER``), so a CSV written here is one that simulator
reads and vice versa.  ``collect_trace`` runs a prompt through the engine
step by step and records, per (step, layer, kv head), the pruned fetch
counts and the progressive-quantization decision; on the card those
decisions come from K1's max probabilities (``StepAux.max_probs``).
``read_csv`` loads a workload for replay through
``spatten_tpu_torch.perf.cost_model``.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
from typing import Iterable, List

import torch

HEADER = [
    "iteration_id", "layer_id", "head_id", "embedding_length_D",
    "sentence_length_L", "key_fetch_num", "quant_key_bit",
    "quant_query_bit", "auto_requant_thres", "if_requant",
    "auto_requant_incre", "value_fetch_num", "quant_value_bit",
    "if_accumulate_importance", "if_rescale_previous_importance",
    "if_topk", "topk",
]


@dataclass
class TraceRow:
    """One (iteration, layer, head) attention request: a row of the
    workload CSV."""

    iteration_id: int
    layer_id: int
    head_id: int
    embedding_length_D: float
    sentence_length_L: int
    key_fetch_num: int
    quant_key_bit: int          # -1 = fp16 baseline, 4/6/8/12 otherwise
    quant_query_bit: int
    auto_requant_thres: float
    if_requant: bool
    auto_requant_incre: int
    value_fetch_num: int
    quant_value_bit: int
    if_accumulate_importance: bool
    if_rescale_previous_importance: bool
    if_topk: bool
    topk: int

    def as_csv(self) -> List[str]:
        return [str(getattr(self, c)) for c in HEADER]


def write_csv(rows: Iterable[TraceRow], path: str) -> None:
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(HEADER)
        for r in rows:
            w.writerow(r.as_csv())


def _parse_bool(s: str) -> bool:
    return s.strip().lower() == "true"


def read_csv(path: str) -> List[TraceRow]:
    """Read a workload CSV (ours or the hardware simulator's)."""
    rows: List[TraceRow] = []
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        # the simulator's files may open with a config-path banner line
        if header[0] != "iteration_id":
            header = next(reader)
        if header[:3] != HEADER[:3]:
            raise ValueError(f"unexpected header {header[:3]}")
        for rec in reader:
            # banners and repeated headers between runs: keep only numeric
            # data rows
            if not rec or not rec[0].strip().isdigit():
                continue
            rows.append(TraceRow(
                iteration_id=int(rec[0]), layer_id=int(rec[1]),
                head_id=int(rec[2]),
                embedding_length_D=float(rec[3]),
                sentence_length_L=int(rec[4]), key_fetch_num=int(rec[5]),
                quant_key_bit=int(rec[6]), quant_query_bit=int(rec[7]),
                auto_requant_thres=(float(rec[8]) if rec[8] not in
                                    ("-1", "") else -1.0),
                if_requant=_parse_bool(rec[9]),
                auto_requant_incre=int(rec[10]),
                value_fetch_num=int(rec[11]), quant_value_bit=int(rec[12]),
                if_accumulate_importance=_parse_bool(rec[13]),
                if_rescale_previous_importance=_parse_bool(rec[14]),
                if_topk=_parse_bool(rec[15]), topk=int(rec[16]),
            ))
    return rows


def collect_trace(params, cfg, prompt, max_new_tokens: int,
                  sequence: int = 0, device: str | torch.device = "cuda"
                  ) -> List[TraceRow]:
    """Run decode on ``device`` (default CUDA; ``params`` must live there)
    and emit one TraceRow per (step, layer, alive kv head).

    ``key_fetch_num`` is the layer's live pruned cache length at that step
    (it drops after every prune, and across layers under a cascade
    schedule), ``value_fetch_num`` the post-top-k V budget, ``if_requant``
    the per-head progressive-quantization decision: the step's max
    probability under the threshold, which the kernel took too."""
    import spatten_tpu_torch.engine.generate as gen
    from spatten_tpu_torch.device import resolve_device
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.pruning.token_pruning import layer_budgets_static

    cfg.validate()
    dev = resolve_device(device)
    m, p, q = cfg.model, cfg.pruning, cfg.quant
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(dev)
    b = prompt.shape[0]
    state = init_state(cfg, batch=b, device=dev)

    chunk = cfg.engine.prefill_chunk
    pos, prompt_len = 0, prompt.shape[1]
    last_logits = None
    while pos < prompt_len:
        n = min(chunk, prompt_len - pos)
        last_logits, state, _ = gen.prefill_chunk(
            params, cfg, state, prompt[:, pos:pos + n])
        pos += n

    token = torch.argmax(last_logits, dim=-1).to(torch.int32)
    rows: List[TraceRow] = []
    # pass-1 plane widths per layer (the per-layer quant profile as data)
    layer_kbits = (q.resolved_layer_bits(m.num_layers) if q.enabled
                   else (-1,) * m.num_layers)
    vbit = 8 if q.enabled else -1

    cap = cfg.engine.cache_capacity
    # per-layer value budgets, as the engine takes them (value_fetch_num
    # scales with the layer's key budget)
    v_keep_l = [0] * m.num_layers
    if p.enable_v_pruning:
        if p.enable_token_pruning:
            budgets = layer_budgets_static(p, m.num_layers)
            kb_l = [p.start_size + bl + p.recent_size for bl in budgets]
        else:
            kb_l = [cap] * m.num_layers
        v_keep_l = [max(p.v_block_size, int(p.v_keep_ratio * kb))
                    for kb in kb_l]

    group = m.num_heads // m.num_kv_heads
    for it in range(max_new_tokens):
        token, state, aux = gen.decode_step(params, cfg, state, token)
        layer_lengths = state.layer_lengths.cpu()           # [L, B]
        maxp = aux.max_probs.cpu()                          # [L, B, Hkv]
        need = ((maxp < q.requant_threshold) & q.enabled
                & q.enable_requant)
        hmask = state.head_mask.cpu()                       # [L, Hq]
        length = int(state.lengths[sequence])
        for layer in range(m.num_layers):
            kf = int(layer_lengths[layer, sequence])
            v_keep = v_keep_l[layer]
            for h in range(m.num_kv_heads):
                if not bool(hmask[layer, h * group:(h + 1) * group].any()):
                    continue          # pruned head: no request (no CSV row)
                vf = min(v_keep, kf) if v_keep > 0 else kf
                kbit = layer_kbits[layer]
                rows.append(TraceRow(
                    iteration_id=it, layer_id=layer, head_id=h,
                    embedding_length_D=float(m.head_dim),
                    sentence_length_L=length,
                    key_fetch_num=kf,
                    quant_key_bit=kbit, quant_query_bit=16,
                    auto_requant_thres=(q.requant_threshold
                                        if q.enabled else -1.0),
                    if_requant=bool(need[layer, sequence, h])
                    and kbit not in (8, -1),
                    auto_requant_incre=(8 - kbit) if q.enabled else -1,
                    value_fetch_num=vf, quant_value_bit=vbit,
                    if_accumulate_importance=p.cascade_accumulate,
                    if_rescale_previous_importance=bool(
                        p.importance_ema < 1.0),
                    if_topk=bool(v_keep > 0 and vf < kf),
                    topk=vf if (v_keep > 0 and vf < kf) else -1,
                ))
    return rows
