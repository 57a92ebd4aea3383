"""Where K1's device time goes, pass by pass, on the card.

Builds extra copies of K1's library into ``build/cuda/`` (git-ignored;
nothing of them is committed), each from ``csrc/fused_decode.cu`` and
``csrc/fused_decode_latent.cu`` with one of them edited: two that return
early, after pass 1 and its softmax and after the requant pass, for the
``<G, D>`` instances and for the latent one, and others that change the
``<G, D>`` ring's constants (8 KB tiles, one row step per warp at a
time, both).  With the full kernel the early returns give three
cumulative times per shape:

  pass 1   append + pass 1 + softmax (+ the query row constants)
  requant  the int8 recompute and its softmax, where it fires
  rest     importance, V top-k, P·V and the output

Shapes: ``serving``, the serving combination at rungs 2048 and 4096, as
``chip_smoke.phase_k1_serving`` times them; ``latent``, DeepSeek-V2-
Lite's latent row as ``chip_smoke.phase_k1_latent`` runs it at capacity
2048 (batch 128, one cached head of 576 lanes, group 16, per-row delta
importance, 12 of 16 heads alive), once in the ``<8, 256>`` instance that
took it before K1's latent instance existed (``latent_takes`` patched to
refuse it) and once in the latent instance.  Run from the repository
root on a machine with one card and nvcc::

    python -m spatten_tpu_torch.tools.k1_passes [serving] [latent]

(both when none is named).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from spatten_tpu_torch import kernels

# variant -> (the file it edits, ((source text, what replaces it), ...))
VARIANTS = {
    "pass 1": ("fused_decode", (("  float mp = 0.f;\n",
                                 "  return;\n  float mp = 0.f;\n"),)),
    "requant": ("fused_decode", (
        ("  if (p.mrow != nullptr) {\n    for (int r = threadIdx.x; r < gl; "
         "r += kThreads) {\n      p.mrow[row0 + r] = misc[kMax * MG + r];",
         "  return;\n  if (p.mrow != nullptr) {\n    for (int r = "
         "threadIdx.x; r < gl; r += kThreads) {\n      p.mrow[row0 + r] = "
         "misc[kMax * MG + r];"),)),
    "1 row step": ("fused_decode", (("constexpr int kRowSteps = 2;",
                                     "constexpr int kRowSteps = 1;"),)),
    "8 KB tiles": ("fused_decode", (
        ("constexpr int kStageBytes = 16384;",
         "constexpr int kStageBytes = 8192;"),
        ("constexpr int kSegBytes = 2304;",
         "constexpr int kSegBytes = 1152;"))),
    "latent pass 1": ("fused_decode_latent", (
        ("  float mp = 0.f;\n  for (int g = 0; g < gl; ++g)",
         "  return;\n  float mp = 0.f;\n  for (int g = 0; g < gl; ++g)"),)),
    "latent requant": ("fused_decode_latent", (
        ("  for (int g = threadIdx.x; g < kLatRows; g += kThreads) {\n"
         "    const float inv",
         "  return;\n  for (int g = threadIdx.x; g < kLatRows; g += "
         "kThreads) {\n    const float inv"),)),
}
VARIANTS["8 KB tiles, 1 row step"] = (
    "fused_decode",
    VARIANTS["8 KB tiles"][1] + VARIANTS["1 row step"][1])
SHAPE_VARIANTS = {
    "serving": ("pass 1", "requant", "1 row step", "8 KB tiles",
                "8 KB tiles, 1 row step"),
    "latent": ("pass 1", "requant", "latent pass 1", "latent requant"),
}


def build_variants(names) -> dict:
    """Compile the named variants in parallel; {name: CDLL}.  A variant of
    ``fused_decode.cu`` is that file whole (K1_PART 0) linked with the
    unedited latent unit; a variant of ``fused_decode_latent.cu`` is the
    edited latent unit linked with the unedited parts 1 and 2, as
    ``kernels.build_all`` builds K1's library.  The unedited units are
    compiled once."""
    sources = {f: (kernels.CSRC / f"{f}.cu").read_text()
               for f in ("fused_decode", "fused_decode_latent")}
    procs, base, links = [], {}, {}

    def compile_unit(work: Path, texts: dict, f: str, flag: str) -> Path:
        work.mkdir(parents=True, exist_ok=True)
        for name, text in texts.items():          # the latent unit includes
            cu = work / f"{name}.cu"                 # fused_decode.cu
            if not cu.exists() or cu.read_text() != text:
                cu.write_text(text)
        obj = work / f"{f}{flag[-1]}.o"
        procs.append((obj, subprocess.Popen(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", flag, "-c", "-o", str(obj),
             str(work / f"{f}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        return obj

    def base_unit(f: str, flag: str) -> Path:
        if (f, flag) not in base:
            base[f, flag] = compile_unit(kernels.BUILD_DIR / "k1_base",
                                         sources, f, flag)
        return base[f, flag]

    for name in names:
        edited, edits = VARIANTS[name]
        texts = dict(sources)
        for old, new in edits:
            if texts[edited].count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once")
            texts[edited] = texts[edited].replace(old, new)
        tag = "".join(c for c in name if c.isalnum())
        work = kernels.BUILD_DIR / f"k1_{tag}"
        if edited == "fused_decode":
            objs = [compile_unit(work, texts, edited, "-DK1_PART=0"),
                    base_unit("fused_decode_latent", "-DK1_PART=3")]
        else:
            objs = [base_unit("fused_decode", "-DK1_PART=1"),
                    base_unit("fused_decode", "-DK1_PART=2"),
                    compile_unit(work, texts, edited, "-DK1_PART=3")]
        links[name] = (objs, work / f"libfused_decode_{tag}.so")
    for obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {obj}:\n{out}")
    libs = {}
    _, fn_name, argtypes = kernels.SIGNATURES["fused_decode"]
    for name, (objs, lib) in links.items():
        link = subprocess.run(
            [kernels._nvcc(), *kernels.ARCH_FLAGS, "-shared", "-o", str(lib),
             *map(str, objs)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{link.stdout}")
        dll = ctypes.CDLL(str(lib))
        getattr(dll, fn_name).argtypes = argtypes
        getattr(dll, fn_name).restype = ctypes.c_int
        libs[name] = dll
    return libs


def split(times: dict, full: str, p1: str, rq: str) -> str:
    """The cumulative early-return times as pass 1 / requant / rest."""
    return (f"full {times[full]:.4f} ms = pass 1 {times[p1]:.4f} + requant "
            f"{times[rq] - times[p1]:.4f} + rest "
            f"{times[full] - times[rq]:.4f} ms")


def timed(call, n: int, full, variants: dict) -> dict:
    """Device ms of ``call`` with each variant's library and the full one."""
    import chip_smoke as cs
    times = {}
    for name, lib in list(variants.items()) + [("full", full)]:
        kernels._loaded["fused_decode"] = lib
        times[name] = cs.device_ms(call, n)
    kernels._loaded["fused_decode"] = full
    return times


def serving(dev, full, variants) -> None:
    import chip_smoke as cs
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    cfg = cs.serving_config()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    hm = cs.serving_head_mask(cfg, gen, dev)
    st, q, kn, vn = cs.k1_inputs(cfg, dev, gen, cs.SERVING_BATCH)
    lens = {2048: [2048, 1900, 1601, 1200, 977, 800, 729, 33],
            4096: [4096, 3200, 3100, 2665, 2800, 2049, 1000, 1]}
    layers = {2048: list(range(2, 32)), 4096: [0, 1]}
    for rung in (2048, 4096):
        lengths = torch.tensor(lens[rung], dtype=torch.int32, device=dev)
        kw = dict(cs.k1_flags(cfg, layers[rung][0], rung),
                  v_block_size=cfg.pruning.v_block_size, head_mask=hm)
        probe = st.clone()
        mp = fd.fused_decode_attention_plain(
            q, probe.cache.k, probe.cache.v, kn, vn, lengths,
            layer=layers[rung][0], importance_in=probe.importance, **kw)[1]
        threshold = kc.split_threshold(mp.max_prob)
        del probe

        def call(i):
            fd.fused_decode_attention(
                q, st.cache.k, st.cache.v, kn, vn, lengths,
                requant_threshold=threshold, importance_in=st.importance,
                **dict(kw, layer=layers[rung][i % len(layers[rung])]))

        times = timed(call, 4 * len(layers[rung]), full, variants)
        print(f"K1 rung {rung} (serving combination, layers "
              f"{layers[rung][0]}-{layers[rung][-1]}): "
              + split(times, "full", "pass 1", "requant")
              + " (cumulative early-return builds); variants: " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items()
                  if k not in ("pass 1", "requant", "full")), flush=True)


def latent(dev, full, variants) -> None:
    import chip_smoke as cs
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    cfg = cs.latent_config()
    m, vb, cap = cfg.model, cfg.pruning.v_block_size, cs.LATENT_CAP
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 19)
    st = kc.random_state(cfg, cs.LATENT_BATCH, gen, dev)
    q = torch.randn((cs.LATENT_BATCH, m.num_heads, 1, m.cache_dim),
                    generator=gen, device=dev)
    row = torch.randn((cs.LATENT_BATCH, 1, 1, m.cache_dim), generator=gen,
                      device=dev)
    hm = torch.ones(m.num_heads, dtype=torch.bool, device=dev)
    hm[[1, 6, 11, 12]] = False
    lengths = torch.randint(1, cap + 1, (cs.LATENT_BATCH,), generator=gen,
                            device=dev, dtype=torch.int32)
    lengths[0], lengths[1] = cap, 1
    kw = dict(cs.k1_flags(cfg, 0, cap), sm_scale=m.softmax_scale,
              v_block_size=vb, head_mask=hm, per_row_importance=True)
    probe = st.clone()
    mp = fd.fused_decode_attention_plain(
        q, probe.cache.k, probe.cache.v, row, row, lengths, layer=0, **kw)[1]
    threshold = kc.split_threshold(mp.max_prob)
    del probe
    fired = int((mp.max_prob < threshold).sum())

    def call(i):
        fd.fused_decode_attention(
            q, st.cache.k, st.cache.v, row, row, lengths,
            requant_threshold=threshold, **dict(kw, layer=i % 2))

    takes = fd.latent_takes
    try:
        fd.latent_takes = lambda *a, **k: False       # the <8, 256> plan
        old = timed(call, 4, full, {k: variants[k] for k in
                                    ("pass 1", "requant")})
    finally:
        fd.latent_takes = takes
    new = timed(call, 8, full, {k: variants[k] for k in
                                ("latent pass 1", "latent requant")})
    print(f"K1 latent (batch {cs.LATENT_BATCH}, 576 lanes, group 16, "
          f"capacity {cap}, {fired} of {cs.LATENT_BATCH} rows requantize): "
          f"in <8, 256>: " + split(old, "full", "pass 1", "requant")
          + "; in the latent instance: "
          + split(new, "full", "latent pass 1", "latent requant")
          + " (cumulative early-return builds)", flush=True)


def main(argv=None) -> int:
    shapes = list(argv if argv is not None else sys.argv[1:]) or [
        "serving", "latent"]
    if not torch.cuda.is_available():
        print("k1_passes: CUDA is not available", file=sys.stderr)
        return 1
    unknown = sorted(set(shapes) - set(SHAPE_VARIANTS))
    if unknown:
        print(f"k1_passes: unknown shapes {unknown}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    kernels.load("fused_decode")
    full = kernels._loaded["fused_decode"]
    variants = build_variants(sorted({v for s in shapes
                                      for v in SHAPE_VARIANTS[s]}))
    for shape in shapes:
        {"serving": serving, "latent": latent}[shape](dev, full, variants)
    return 0


if __name__ == "__main__":
    sys.exit(main())
