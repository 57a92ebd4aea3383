#!/usr/bin/env python
"""SpAtten demo and serving CLI on an NVIDIA GPU: the PyTorch/CUDA port's
counterpart of ``run_spatten_tpu.py``.

Loads a local Hugging Face checkpoint (Llama or GPT-2 family) through
``spatten_tpu_torch.models.hf_loader``, enables the SpAtten pipeline
(cascade token pruning, local V pruning, progressive KV quantization,
optional head pruning) and runs multi-turn conversations, each over one
rolling pruned decode state; writes a workload trace and a metrics
summary on request.

Usage:
  python run_spatten_gpu.py --model_path /path/to/hf_checkpoint \\
      [--prompts prompts.jsonl] [--max_new_tokens 256] \\
      [--start_size 4 --important_size 384 --recent_size 384] \\
      [--cache_capacity 1024] [--disable_quant] [--disable_pruning] \\
      [--head_keep 0] [--trace_csv out.csv] [--summary out.json] \\
      [--temperature 0] [--top_p 1.0] [--device cuda]

Prompts: a jsonl whose lines are {"turns": [...]} (MT-Bench format) or
{"prompt": "..."}, tokenized with the checkpoint's tokenizer (the
``transformers`` package); or {"ids": [[...], ...]}, one list of token
ids per turn, which needs no tokenizer (replies then print as ids, and
the end-of-sequence id is the checkpoint config's ``eos_token_id``).
Without --prompts a built-in two-turn text prompt runs.  --device cpu
runs on the CPU; the default is the card, and the kernels build there at
first use.

--mesh_data / --mesh_model above 1 serve on a DP x TP mesh of processes
(``parallel.ShardedEngine``), one per rank, as the JAX CLI's mesh path
does: greedy, each turn from a fresh state, no trace or summary; rank 0
prints.  Start the ranks with PyTorch's launcher, which names the
rendezvous (``env://``), e.g. two ranks on the CPU:

  python -m torch.distributed.run --standalone --nproc_per_node 2 \
      run_spatten_gpu.py --model_path ... --mesh_model 2 --device cpu

The backend is gloo on the CPU and NCCL on cards (one card per rank).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model_path", required=True,
                   help="local HF checkpoint dir (Llama or GPT-2 family)")
    p.add_argument("--prompts", default=None, help="jsonl prompts file")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--max_prompts", type=int, default=4)
    # pruning knobs (reference defaults: start 0, important 150, recent 150)
    p.add_argument("--start_size", type=int, default=4)
    p.add_argument("--important_size", type=int, default=384)
    p.add_argument("--recent_size", type=int, default=384)
    p.add_argument("--cache_capacity", type=int, default=1024)
    p.add_argument("--v_keep_ratio", type=float, default=0.35)
    p.add_argument("--head_keep", type=int, default=0,
                   help=">0: keep this many kv-head groups per layer")
    p.add_argument("--requant_threshold", type=float, default=0.05)
    p.add_argument("--disable_quant", action="store_true")
    p.add_argument("--disable_pruning", action="store_true")
    p.add_argument("--no_pallas", action="store_true",
                   help="the reference attention path instead of the "
                        "fused kernels (the JAX flag's name)")
    # sampling
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    # mesh
    p.add_argument("--mesh_data", type=int, default=1)
    p.add_argument("--mesh_model", type=int, default=1)
    # outputs
    p.add_argument("--trace_csv", default=None)
    p.add_argument("--summary", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p.parse_args(argv)


def load_conversations(path, limit):
    """[[turn, turn, ...], ...]: MT-Bench-style multi-turn records (all
    turns of a record run through one rolling KV cache, pruning between
    rounds); a turn is text, or a list of token ids from an "ids"
    record."""
    if path is None:
        return [["The key idea of sparse attention is",
                 "Summarize that in one sentence."]]
    convs = []
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            rec = json.loads(line)
            if "turns" in rec:
                convs.append(list(rec["turns"]))
            elif "prompt" in rec:
                convs.append([rec["prompt"]])
            elif "ids" in rec:
                convs.append([[int(t) for t in turn] for turn in rec["ids"]])
            if len(convs) >= limit:
                break
    return convs


def load_tokenizer(path):
    """The checkpoint's tokenizer, for text prompts (imported here: the
    ``ids`` form needs none)."""
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise SystemExit(
            "text prompts need the checkpoint's tokenizer from the "
            "`transformers` package, which is not installed here; give "
            "token ids instead ({\"ids\": [[...], ...]} records in "
            "--prompts)") from e
    return AutoTokenizer.from_pretrained(path)


def build_config(args, mcfg):
    """The SpAtten configuration of a run: the model's, under the
    command line's pruning, quantization and cache settings (batch 1)."""
    from spatten_tpu_torch.config import (
        EngineConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    return SpAttenConfig(
        model=mcfg,
        pruning=PruningConfig(
            start_size=args.start_size,
            important_size=args.important_size,
            recent_size=args.recent_size,
            enable_token_pruning=not args.disable_pruning,
            enable_v_pruning=not args.disable_pruning,
            v_keep_ratio=args.v_keep_ratio,
            enable_head_pruning=args.head_keep > 0,
            head_keep=args.head_keep,
        ),
        quant=QuantConfig(enabled=not args.disable_quant,
                          enable_requant=not args.disable_quant,
                          requant_threshold=args.requant_threshold),
        engine=EngineConfig(
            max_batch_size=1, cache_capacity=args.cache_capacity,
            prefill_chunk=min(
                128, args.cache_capacity - args.start_size
                - args.important_size - args.recent_size)
            if not args.disable_pruning else 128,
            use_pallas=not args.no_pallas,
        ),
    ).validate()


def main(argv=None):
    args = parse_args(argv)
    use_mesh = args.mesh_data * args.mesh_model > 1

    import torch

    from spatten_tpu_torch.device import resolve_device
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.metrics import collect_run_metrics
    from spatten_tpu_torch.engine.sampling import SamplingParams
    from spatten_tpu_torch.models import hf_loader

    dev = resolve_device(args.device)
    mesh = None
    if use_mesh:
        from spatten_tpu_torch.config import MeshConfig
        from spatten_tpu_torch.parallel import make_mesh, multihost
        multihost.initialize(backend="gloo" if dev.type == "cpu"
                             else "nccl")
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        mesh = make_mesh(MeshConfig(data=args.mesh_data,
                                    model=args.mesh_model), device=dev)
    show = print if mesh is None or mesh.coords == {"data": 0, "model": 0} \
        else (lambda *a, **k: None)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    show(f"[spatten-gpu] device: {dev} ({name})"
         + (f"; mesh {args.mesh_data} x {args.mesh_model}" if mesh else ""))
    mcfg, params = hf_loader.load_pretrained(
        args.model_path, device="cpu" if mesh else dev)
    convs = load_conversations(args.prompts, args.max_prompts)
    texts = any(isinstance(t, str) for turns in convs for t in turns)
    tokenizer = load_tokenizer(args.model_path) if texts else None
    if tokenizer is not None:
        eos = tokenizer.eos_token_id
    else:
        with open(os.path.join(args.model_path, "config.json")) as fh:
            eos = json.load(fh).get("eos_token_id")

    cfg = build_config(args, mcfg)
    if mesh is not None:
        from spatten_tpu_torch.parallel import ShardedEngine
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, mesh=MeshConfig(data=args.mesh_data,
                                        model=args.mesh_model)))
        eng = ShardedEngine(cfg, mesh)
        params = eng.shard_params(params)

    sampling = SamplingParams(temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=dev).manual_seed(0)

    all_rows = []
    t_total0 = time.perf_counter()
    for i, turns in enumerate(convs):
        # multi-turn conversation over ONE rolling pruned cache: each
        # round's prompt and reply append to the same DecodeState; the
        # cascade prune fires between and within rounds as capacity
        # demands
        state = None
        for r, prompt in enumerate(turns):
            if isinstance(prompt, str):
                ids = torch.as_tensor(
                    tokenizer(prompt, return_tensors="np").input_ids,
                    dtype=torch.int64)
                shown = repr(prompt[:72])
            else:
                ids = torch.tensor([prompt], dtype=torch.int64)
                shown = f"{len(prompt)} ids"
            show(f"\n=== conv {i} round {r}: {shown} "
                 f"({ids.shape[1]} tokens)")
            t0 = time.perf_counter()
            if mesh is not None:
                # the JAX CLI's mesh path: greedy, a fresh state per turn
                toks = eng.generate(params, ids, args.max_new_tokens,
                                    eos_token_id=eos).cpu()
                result, cache_len = None, "?"
            else:
                result = gen.generate(params, cfg, ids, args.max_new_tokens,
                                      eos_token_id=eos, sampling=sampling,
                                      state=state, generator=generator,
                                      device=dev)
                state = result.state
                toks = result.tokens.cpu()
                cache_len = int(state.lengths[0])
            dt = time.perf_counter() - t0
            reply = [t for t in toks[0].tolist() if t != eos]
            if tokenizer is not None:
                show(tokenizer.decode(reply, skip_special_tokens=True))
            else:
                show("reply ids: " + json.dumps(reply))
            show(f"--- {toks.shape[1] / dt:.1f} tok/s; {dt:.1f}s; "
                 f"cache len {cache_len}")
        if mesh is not None:
            continue
        if args.trace_csv and i == 0:
            from spatten_tpu_torch.engine.trace import collect_trace
            all_rows = collect_trace(params, cfg, ids,
                                     min(8, args.max_new_tokens), device=dev)
        if args.summary:
            m = collect_run_metrics(cfg, result, len(turns),
                                    int(ids.shape[1]), dt)
            m.write(args.summary)
            print(f"[summary -> {args.summary}] "
                  f"requant_rate={m.requant_rate:.3f} "
                  f"head_keep={m.head_keep_fraction:.2f}")

    if args.trace_csv and all_rows:
        from spatten_tpu_torch.engine.trace import write_csv
        write_csv(all_rows, args.trace_csv)
        print(f"[trace -> {args.trace_csv}] {len(all_rows)} rows")
    show(f"\ntotal {time.perf_counter() - t_total0:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
