"""Where K1's device time goes, pass by pass, on the card.

Builds extra copies of ``csrc/fused_decode.cu`` into ``build/cuda/``
(git-ignored; nothing of them is committed): two that return early,
after pass 1 and its softmax and after the requant pass, and others
that change the ring's constants (8 KB tiles, one row step per warp at
a time, both).  With the full kernel the first two give three
cumulative times per shape:

  pass 1   append + pass 1 + softmax (+ the query row constants)
  requant  the int8 recompute and its softmax, where it fires
  rest     importance, V top-k, P·V and the output

Shapes: the serving combination at rungs 2048 and 4096, as
``chip_smoke.phase_k1_serving`` times them.  Run from the repository root
on a machine with one card and nvcc::

    python -m spatten_tpu_torch.tools.k1_passes
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from spatten_tpu_torch import kernels

# variant -> (source text, what replaces it), ...
VARIANTS = {
    "pass 1": (("  float mp = 0.f;\n", "  return;\n  float mp = 0.f;\n"),),
    "requant": (("  if (p.mrow != nullptr && threadIdx.x < gl) {\n",
                 "  return;\n  if (p.mrow != nullptr && threadIdx.x < gl) "
                 "{\n"),),
    "1 row step": (("constexpr int kRowSteps = 2;",
                    "constexpr int kRowSteps = 1;"),),
    "8 KB tiles": (("constexpr int kStageBytes = 16384;",
                    "constexpr int kStageBytes = 8192;"),
                   ("constexpr int kSegBytes = 2304;",
                    "constexpr int kSegBytes = 1152;")),
}
VARIANTS["8 KB tiles, 1 row step"] = (VARIANTS["8 KB tiles"]
                                      + VARIANTS["1 row step"])


def build_variants() -> dict:
    """Compile the variants in parallel; {name: CDLL}."""
    src = (kernels.CSRC / "fused_decode.cu").read_text()
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once")
            text = text.replace(old, new)
        tag = "".join(c for c in name if c.isalnum())
        cu = kernels.BUILD_DIR / f"fused_decode_{tag}.cu"
        cu.write_text(text)
        lib = kernels.BUILD_DIR / f"libfused_decode_{tag}.so"
        cmd = [kernels._nvcc(), *kernels.ARCH_FLAGS, "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    _, fn_name, argtypes = kernels.SIGNATURES["fused_decode"]
    for name, (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        dll = ctypes.CDLL(str(lib))
        getattr(dll, fn_name).argtypes = argtypes
        getattr(dll, fn_name).restype = ctypes.c_int
        libs[name] = dll
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_passes: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    dev = torch.device("cuda", 0)
    kernels.load("fused_decode")
    full = kernels._loaded["fused_decode"]
    variants = build_variants()
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

        times = {}
        for name, lib in list(variants.items()) + [("full", full)]:
            kernels._loaded["fused_decode"] = lib
            times[name] = cs.device_ms(call, 4 * len(layers[rung]))
        kernels._loaded["fused_decode"] = full
        p1, rq = times["pass 1"], times["requant"]
        print(f"K1 rung {rung} (serving combination, layers "
              f"{layers[rung][0]}-{layers[rung][-1]}): full {times['full']:.4f}"
              f" ms = pass 1 {p1:.4f} + requant {rq - p1:.4f} + rest "
              f"{times['full'] - rq:.4f} ms (cumulative early-return "
              "builds); variants: " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in times.items()
                  if k not in ("pass 1", "requant", "full")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
