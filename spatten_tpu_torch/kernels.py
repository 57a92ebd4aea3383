"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<source>.cu`` exposes plain C functions and compiles on its
own with ``nvcc`` for ``sm_90a`` into ``build/cuda/lib<source>.so`` at the
repo root (listed in ``.gitignore``), the first time one of its kernels
is needed or when the source is newer than the library.  ``build_all``
starts one ``nvcc`` per source at once (K1's as three translation
units, ``PARTS``, linked after), so a fresh checkout builds in the time
of the slowest unit.  Several processes may reach first use at
once (the ranks of a mesh): a build holds a file lock in the build
directory, each library is written under a temporary name and renamed
into place, and a process that waited on the lock finds the library
fresh and builds nothing.  Libraries load with ``ctypes``; ``launch``
passes the wrappers' tensors as pointers and the current stream of their
card, and raises when the C function returns a CUDA error code.

Nothing here runs at import time: a CPU-only host imports every module.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# kernel -> (source, C function, argtypes); every pointer and the stream
# are c_void_p
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "fused_decode": ("fused_decode", "spatten_fused_decode",
                     [_P] * 23 + [_I] * 10 + [_F] * 3 + [_I] * 11
                     + [_P, _I] + [_P] * 2),
    "compact_gather": ("compact_gather", "spatten_compact_gather",
                       [_P] * 5 + [_I] * 5 + [_P]),
    "probe_bare": ("launch_probe", "spatten_probe_bare", [_P] * 3),
    "probe_gridded": ("launch_probe", "spatten_probe_gridded", [_P] * 3),
    "probe_dma": ("launch_probe", "spatten_probe_dma", [_P] * 3),
    "probe_aliased": ("launch_probe", "spatten_probe_aliased", [_P] * 3),
    "probe_spref": ("launch_probe", "spatten_probe_spref", [_P] * 4),
    "probe_empty": ("launch_probe", "spatten_probe_empty", [_P]),
}
SOURCES = tuple(sorted({src for src, _, _ in SIGNATURES.values()}))
# sources built as several translation units at once (one nvcc each, with
# its -D flag, of the source's file or, for a (file, flag) pair, of
# csrc/<file>.cu) and linked into their one library: K1's shared-plane and
# device-plane instances (csrc/fused_decode.cu, K1_PART) and its latent
# instance (csrc/fused_decode_latent.cu, which includes fused_decode.cu)
PARTS = {"fused_decode": ("-DK1_PART=1", "-DK1_PART=2",
                          ("fused_decode_latent", "-DK1_PART=3"))}
_NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{source}.so"


def _part(source: str, part) -> tuple[Path, str]:
    """(the .cu file, the -D flag) of one unit of ``source``."""
    name, flag = (source, part) if isinstance(part, str) else part
    return CSRC / f"{name}.cu", flag


def _stale(source: str) -> bool:
    lib = library_path(source)
    srcs = {CSRC / f"{source}.cu"} | {
        _part(source, x)[0] for x in PARTS.get(source, ())}
    return not lib.exists() or any(
        lib.stat().st_mtime < src.stat().st_mtime for src in srcs)


@contextlib.contextmanager
def _build_lock():
    """The build directory's lock, held while a process builds (released
    by the system if the process dies)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def build_all(names=None, force: bool = False) -> tuple[float, dict]:
    """Compile the given sources (default: all) in parallel, under the
    build lock (another process's build of the same sources is waited for
    and not repeated unless ``force``).

    Returns (seconds, {source: ptxas report}).  Raises RuntimeError with
    the compiler output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    with _build_lock():
        todo = [n for n in names if force or _stale(n)]
        procs = {}
        for n in todo:
            tmp = library_path(n).with_name(
                f"lib{n}.{os.getpid()}.tmp.so")
            src = str(CSRC / f"{n}.cu")
            if n in PARTS:
                # one object per part, all compiled at once, then linked
                jobs = [(tmp.with_suffix(f".{i}.o"),
                         [*_NVCC_FLAGS, flag, "-c", "-o",
                          str(tmp.with_suffix(f".{i}.o")), str(cu)])
                        for i, (cu, flag) in enumerate(
                            _part(n, x) for x in PARTS[n])]
            else:
                jobs = [(tmp, [*_NVCC_FLAGS, "-shared", "-o", str(tmp), src])]
            procs[n] = (tmp, [(out, subprocess.Popen(
                [_nvcc(), *cmd], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)) for out, cmd in jobs])
        reports, failed = {}, []
        for n, (tmp, jobs) in procs.items():
            outs = [(out, *proc.communicate(), proc.returncode)
                    for out, proc in jobs]
            reports[n] = "".join(text for _, text, _, _ in outs)
            bad = [(text, rc) for _, text, _, rc in outs if rc != 0]
            if not bad and n in PARTS:
                link = subprocess.run(
                    [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                     *(str(out) for out, _, _, _ in outs)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                if link.returncode != 0:
                    bad.append((link.stdout, link.returncode))
            if n in PARTS:
                for out, _, _, _ in outs:
                    out.unlink(missing_ok=True)
            if bad:
                failed += [f"{n}.cu (exit {rc}):\n{text}" for text, rc in bad]
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0, reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if needed), with the
    argument types of its entry points set."""
    lib = _loaded.get(source)
    if lib is None:
        if _stale(source):
            build_all([source])         # a no-op if another process did
        lib = ctypes.CDLL(str(library_path(source)))
        for src, fn_name, argtypes in SIGNATURES.values():
            if src == source:
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _loaded[source] = lib
    return lib


def entry(name: str):
    """Kernel ``name``'s C entry point (a ctypes function)."""
    source, fn_name, _ = SIGNATURES[name]
    return getattr(load(source), fn_name)


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry point with ``args`` followed by a
    CUDA stream; raise on a non-zero CUDA error code.  A tensor argument
    passes as its device pointer (None as NULL), and the kernel launches
    on the card its tensors lie on, under that card and on its current
    stream, whatever the process's current device is (one controller may
    drive shards on several cards); tensors on more than one device
    raise.  A call without tensors launches on the current device."""
    devices = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devices) > 1:
        raise ValueError(f"kernel {name}: tensors on "
                         f"{sorted(map(str, devices))}, one device expected")
    dev = devices.pop() if devices else torch.device(
        "cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        raise ValueError(f"kernel {name}: tensors on {dev}, not a card")
    fn = entry(name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(ptr(a) if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with error {err}")


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()
