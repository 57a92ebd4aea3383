"""Supervised (restartable) decoding: health check -> restore -> resume
(port of ``spatten_tpu/engine/supervisor.py``).

Decode runs in windows; after each window the live state snapshots
(``engine.checkpoint``); before each window the supervisor runs a health
probe (``parallel.multihost.health_check`` by default), and on failure
restores the latest snapshot and replays the window.  A window is the
engine's own boundary work (``generate.window_start``: the capacity
prune, then the head mask update when due) followed by ``window`` greedy
steps of ``transformer.forward``.

Determinism contract: the resumed run replays the interrupted window from
its snapshot, whose tensors are the live state's bytes, so the emitted
token stream equals an uninterrupted run's exactly.
"""

from __future__ import annotations

import os
import shutil
from typing import Callable, Optional

import numpy as np
import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine import checkpoint
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.ops import rope as rope_ops


def _fresh_start(params, cfg, prompt, b, nwin, window, ckpt_dir,
                 write_snapshot, dev):
    """Prefill + first token + the one-time params checkpoint + the
    initial (cursor 0) snapshot."""
    state = init_state(cfg, batch=b, device=dev)
    chunk = cfg.engine.prefill_chunk
    last_logits = None
    for pos in range(0, prompt.shape[1], chunk):
        last_logits, state, _ = gen.prefill_chunk(
            params, cfg, state, prompt[:, pos:pos + chunk])
    token = torch.argmax(last_logits, dim=-1).to(torch.int32)
    emitted = np.zeros((b, nwin * window), np.int32)
    params_path = os.path.join(ckpt_dir, "params")
    if not os.path.exists(params_path):
        checkpoint.save(params_path, params)   # written ONCE
    write_snapshot(0, state, extra={"token": token, "emitted": emitted,
                                    "count": 0, "window": window})
    return state, token, emitted, 0


def generate_supervised(
    params,
    cfg: SpAttenConfig,
    prompt,                       # int [B, prompt_len] (tensor or array)
    max_new_tokens: int,
    ckpt_dir: str,
    *,
    window: int = 32,
    health: Optional[Callable[[], bool]] = None,   # default: the process
                                  #   group's heartbeat (multihost)
    max_restarts: int = 8,
    resume: bool = False,         # True: restore the latest snapshot in
                                  #   ckpt_dir (params from `params/`) and
                                  #   continue -- the cross-PROCESS
                                  #   restart path after a host dies
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Greedy decode with per-window snapshots and failure recovery.

    Returns int32 [B, max_new_tokens] on the CPU.  Runs on ``device``
    (default CUDA; raises when CUDA is missing), where ``params`` must
    already live.  Each window of ``window`` tokens runs the engine's
    window boundary (prune, head mask update) and ``window`` greedy
    ``forward`` steps; after it, (state, next token, emitted tokens)
    snapshot to ``ckpt_dir``.  A failed ``health()`` probe before a window
    restores the latest snapshot and the window replays, at most
    ``max_restarts`` times (RuntimeError after).  ``resume=True`` with a
    snapshot in ``ckpt_dir`` restores params and state from there (the
    window must be the writer's: ValueError otherwise).
    """
    if health is None:
        from spatten_tpu_torch.parallel.multihost import health_check
        health = health_check
    cfg.validate()
    dev = resolve_device(device)
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(dev)
    b = prompt.shape[0]
    os.makedirs(ckpt_dir, exist_ok=True)
    marker = os.path.join(ckpt_dir, "LATEST")

    def snap_path(c):
        return os.path.join(ckpt_dir, f"supervised-{c}")

    def write_snapshot(c, state, extra):
        """Write a STATE-ONLY snapshot c (params are immutable and were
        written once to `params/`), publish it in LATEST, drop older
        snapshots."""
        p = snap_path(c)
        if os.path.exists(p):
            shutil.rmtree(p)
        checkpoint.save(p, None, state, extra=extra)
        tmp = marker + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(c))
        os.replace(tmp, marker)
        for name in os.listdir(ckpt_dir):
            if name.startswith("supervised-") and name != f"supervised-{c}":
                shutil.rmtree(os.path.join(ckpt_dir, name))

    def read_snapshot():
        with open(marker) as f:
            c = int(f.read().strip())
        _, state, extra = checkpoint.restore_with_extra(snap_path(c), dev)
        return (state, extra["token"].to(dev),
                extra["emitted"].numpy().astype(np.int32),
                int(extra["count"]), int(extra["window"]))

    nwin = -(-max_new_tokens // window)
    if resume and os.path.exists(marker):
        # cross-process restart: weights from the one-time params
        # checkpoint, live state + cursor from the latest snapshot; the
        # interrupted window replays (same determinism contract)
        params, _ = checkpoint.restore(os.path.join(ckpt_dir, "params"), dev)
        state, token, emitted, count, snap_window = read_snapshot()
        # the restored cursor is a multiple of the WRITER's window; a
        # different resume window would misalign emitted[:, count:] (and
        # can overrun the nwin*window buffer near the budget end)
        if snap_window != window:
            raise ValueError(
                f"resume window {window} != snapshot window {snap_window};"
                " pass the same `window` the interrupted run used")
        # size the buffer from the live cursor, not nwin*window alone:
        # covers both a longer budget on resume and a non-aligned cursor
        need = max(nwin * window, count + window)
        if emitted.shape[1] < need:
            emitted = np.concatenate(
                [emitted, np.zeros((b, need - emitted.shape[1]), np.int32)],
                axis=1)
    else:
        state, token, emitted, count = _fresh_start(
            params, cfg, prompt, b, nwin, window, ckpt_dir, write_snapshot,
            dev)

    tables = rope_ops.model_rope_table(cfg.model, cfg.engine.cache_capacity,
                                       dev)
    restarts = 0
    while count < max_new_tokens:
        if not health():
            if restarts >= max_restarts:
                raise RuntimeError(
                    f"supervised decode: {restarts} restarts exhausted")
            restarts += 1
            # snapshots are state-only; the in-memory params are the
            # immutable weights (a cross-process restart restores them
            # from `<ckpt_dir>/params` before calling this function)
            state, token, emitted, count, _ = read_snapshot()
            continue
        state, _, _, _ = gen.window_start(cfg, state, window)
        toks = []
        for _ in range(window):
            logits, state, _ = transformer.forward(
                params, cfg, state, token[:, None], rope_tables=tables)
            toks.append(token)
            token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        emitted[:, count:count + window] = torch.stack(toks, 1).cpu().numpy()
        count += window
        write_snapshot(count, state, extra={"token": token,
                                            "emitted": emitted,
                                            "count": count,
                                            "window": window})
    return torch.from_numpy(emitted[:, :max_new_tokens].copy())
