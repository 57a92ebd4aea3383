"""Launch-overhead probe of the card: what one kernel launch costs.

Port of ``tools/pallas_overhead.py``, which timed trivial ``pallas_call``s
with one more feature each (P1 bare, P2 a 16-step grid, P3 a manual DMA,
P4 an aliased in-place plane, P5 scalar prefetch) inside one scanned
dispatch.  Here each probe is a hand-written CUDA kernel
(``csrc/launch_probe.cu``) with its plain PyTorch version beside it and a
launch counter; each is timed three ways over N = 64 iterations:

* eager: a host loop of N launches, synchronized at the end (wall time
  per iteration: the launch path the engine's Python decode loop pays);
* graph: one CUDA graph capturing the N launches, replayed (wall time per
  iteration: what a captured decode window would pay);
* device: CUDA events around N launches queued behind a sleep (the
  kernel's own time on the card).

Beside them: torch's ``c + 1.0`` eager and in a graph (the JAX tool's
"xla add"), "8x bare" per iteration, a bare ctypes call of P1's entry
point against ``kernels.launch`` and the wrapper, and (from
``chip_smoke.py``) the host time of one K1 wrapper call at the serving
shapes.  P2-P5 are also held against their same-function PyTorch calls
(``torch.add(x, 1.0, out=o)``; ``plane[:256].sum()``;
``plane[:8].add_(1)``; ``torch.add(x, s[0], out=o)``, with an f32 scalar
on the card and the host-scalar ``torch.add(x, 1.0)`` beside it) and the
launch floor (an empty kernel through ``kernels.launch``), as medians of
interleaved device timings (``interleaved_us``); a ``torch.profiler``
trace counts the kernels each of those calls launches
(``kernels_per_call``).

Run on a machine with a card: ``python -m spatten_tpu_torch.tools.
launch_overhead`` prints one line per probe.  The timing harness raises
without CUDA tensors; the wrappers run their plain versions on CPU
tensors (the tests).
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Optional

import torch

from spatten_tpu_torch import kernels

N = 64
BLOCK = (8, 128)               # f32 block of P1, P2, P5 and every output
PLANE = (1024, 512)            # int8 plane of P3 and P4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
REPEATS = 5                    # interleaved repeats of a comparison


# ------------------------------------------------------------ plain versions
def bare_plain(x: torch.Tensor) -> torch.Tensor:
    """P1 (``k_add``): o = x + 1."""
    return x + 1.0


def gridded_plain(x: torch.Tensor) -> torch.Tensor:
    """P2: ``k_add`` at every grid step on the same block: o = x + 1."""
    return x + 1.0


def dma_plain(plane: torch.Tensor) -> torch.Tensor:
    """P3 (``k_dma``): the sum of rows 0-255 (exact: |sum| <= 2^24),
    broadcast to the output block."""
    total = plane[:256].to(torch.int32).sum().to(torch.float32)
    return total.expand(BLOCK).contiguous()


def aliased_plain(plane: torch.Tensor) -> torch.Tensor:
    """P4 (``k_alias``): rows 0-7 of the plane +1 with int8 wrap-around,
    in place; o = 0."""
    plane[:8] = ((plane[:8].to(torch.int32) + 129) % 256 - 128).to(torch.int8)
    return torch.zeros(BLOCK, dtype=torch.float32, device=plane.device)


def spref_plain(s: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P5 (``k_sp``): o = x + s[0]."""
    return x + s[0].to(torch.float32)


# ------------------------------------------------------------ kernel wrappers
def _check(t: torch.Tensor, shape, dtype, what: str) -> None:
    if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} {shape}")


def _check_aligned(t: torch.Tensor, what: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned (the kernel moves "
                         "16-byte vectors)")


def _out(out: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty(BLOCK, dtype=torch.float32, device=like.device)
    _check(out, BLOCK, torch.float32, "out")
    return out


def bare(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P1 on the card (plain version on CPU tensors)."""
    if not x.is_cuda:
        return bare_plain(x)
    _check(x, BLOCK, torch.float32, "x")
    out = _out(out, x)
    kernels.launch("probe_bare", x.data_ptr(), out.data_ptr())
    bare.launches += 1
    return out


def gridded(x: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """P2 on the card: 16 CTAs, each a sixteenth of the block (plain
    version on CPU tensors)."""
    if not x.is_cuda:
        return gridded_plain(x)
    _check(x, BLOCK, torch.float32, "x")
    out = _out(out, x)
    _check_aligned(x, "x")
    _check_aligned(out, "out")
    kernels.launch("probe_gridded", x.data_ptr(), out.data_ptr())
    gridded.launches += 1
    return out


def dma(plane: torch.Tensor, out: Optional[torch.Tensor] = None
        ) -> torch.Tensor:
    """P3 on the card: a cluster of 8 CTAs, each a bulk async copy of 32
    rows and their exact sum (plain version on CPU tensors)."""
    if not plane.is_cuda:
        return dma_plain(plane)
    _check(plane, PLANE, torch.int8, "plane")
    out = _out(out, plane)
    _check_aligned(plane, "plane")
    _check_aligned(out, "out")
    kernels.launch("probe_dma", plane.data_ptr(), out.data_ptr())
    dma.launches += 1
    return out


def aliased(plane: torch.Tensor, out: Optional[torch.Tensor] = None
            ) -> torch.Tensor:
    """P4 on the card: the plane is updated IN PLACE (plain version on CPU
    tensors)."""
    if not plane.is_cuda:
        return aliased_plain(plane)
    _check(plane, PLANE, torch.int8, "plane")
    out = _out(out, plane)
    _check_aligned(plane, "plane")
    _check_aligned(out, "out")
    kernels.launch("probe_aliased", plane.data_ptr(), out.data_ptr())
    aliased.launches += 1
    return out


def spref(s: torch.Tensor, x: torch.Tensor,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P5 on the card: the scalar comes from a device int32 array (plain
    version on CPU tensors)."""
    if not x.is_cuda:
        return spref_plain(s, x)
    _check(x, BLOCK, torch.float32, "x")
    if s.dtype != torch.int32 or s.ndim != 1 or not s.numel() \
            or s.device != x.device:
        raise ValueError("s must be a non-empty int32 vector on x's device")
    out = _out(out, x)
    _check_aligned(x, "x")
    _check_aligned(out, "out")
    kernels.launch("probe_spref", s.data_ptr(), x.data_ptr(), out.data_ptr())
    spref.launches += 1
    return out


for _fn in (bare, gridded, dma, aliased, spref):
    _fn.launches = 0


def empty() -> None:
    """The launch floor: an empty kernel, through ``kernels.launch``."""
    kernels.launch("probe_empty")


# id -> (kernel wrapper, plain version, the Pallas call it replaces, bytes
# the function must move: inputs read once, outputs written once)
PROBES = {
    "P1": (bare, bare_plain, "tools/pallas_overhead.py:63", 8192),
    "P2": (gridded, gridded_plain, "tools/pallas_overhead.py:71", 8192),
    "P3": (dma, dma_plain, "tools/pallas_overhead.py:92", 131072 + 4096),
    "P4": (aliased, aliased_plain, "tools/pallas_overhead.py:115",
           8192 + 4096),
    "P5": (spref, spref_plain, "tools/pallas_overhead.py:142", 8192),
}


def inputs(device, seed: int = 0) -> dict:
    """The probes' operands: x [8, 128] f32, an int8 [1024, 512] plane, and
    s = [1, 1, 1, 1] int32 (as the JAX tool's)."""
    g = torch.Generator(device=device).manual_seed(seed)
    return dict(
        x=torch.randn(BLOCK, generator=g, device=device),
        plane=torch.randint(-128, 128, PLANE, generator=g, device=device,
                            dtype=torch.int8),
        s=torch.ones(4, dtype=torch.int32, device=device))


def args_of(pid: str, ops: dict) -> tuple:
    return {"P1": (ops["x"],), "P2": (ops["x"],), "P3": (ops["plane"],),
            "P4": (ops["plane"],), "P5": (ops["s"], ops["x"])}[pid]


# ------------------------------------------------------------ timing harness
def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the launch probe times the card: CUDA is not "
                           "available")


def device_us(step: Callable[[], object], n: int = N) -> float:
    """Device time per ``step()``: CUDA events around n steps queued behind
    a ``torch.cuda._sleep``, so that they run back to back."""
    _require_cuda()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2e8, 4e9 * host_s)))
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def eager_us(step: Callable[[], object], n: int = N) -> float:
    """Wall time per ``step()`` of a host loop of n steps, synchronized at
    the end."""
    _require_cuda()
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def graph_us(step: Callable[[], object], n: int = N) -> float:
    """Wall time per step of one CUDA graph that captured n steps,
    replayed (after a warm-up replay)."""
    _require_cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            step()
    graph.replay()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / n


def three_ways(step: Callable[[], object], n: int = N) -> dict:
    return dict(eager_us=eager_us(step, n), graph_us=graph_us(step, n),
                device_us=device_us(step, n))


def host_call_us(call: Callable[[], object], n: int = 20) -> float:
    """Median host time of one ``call()``, not synchronized (each call
    starts on an idle queue)."""
    _require_cuda()
    call()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def check_probes(ops: dict) -> dict:
    """Each probe's kernel against its plain version on the same operands
    (P4 on two copies of the plane): exact.  Returns {id: max |err|}."""
    errs = {}
    for pid, (kern, plain, _, _) in PROBES.items():
        a = {k: v.clone() for k, v in ops.items()}
        c = {k: v.clone() for k, v in ops.items()}
        got = kern(*args_of(pid, a))
        want = plain(*args_of(pid, c))
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{pid}: kernel output differs from the "
                                 "plain version")
        if not torch.equal(a["plane"], c["plane"]):
            raise AssertionError(f"{pid}: plane differs from the plain "
                                 "version's")
        errs[pid] = float((got - want).abs().max())
    return errs


def kernels_per_call(step: Callable[[], object], n: int = 8
                     ) -> Optional[dict]:
    """The device work of one ``step()`` from a ``torch.profiler`` trace of
    n steps: {kernel or copy name: launches per step}, or None when the
    trace holds no device event (a profiler that cannot see the card)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    counts: dict = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            counts[evt.name] = counts.get(evt.name, 0) + 1
    return {k: v / n for k, v in counts.items()} or None


def interleaved_us(steps: dict, repeats: int = REPEATS) -> dict:
    """Median device time (``device_us``) of each of ``steps`` ({name:
    step}) over ``repeats`` rounds whose order alternates forward and
    backward (for two: kernel, yardstick, yardstick, kernel, ...)."""
    names = list(steps)
    times = {n: [] for n in names}
    for r in range(repeats):
        for n in (names if r % 2 == 0 else names[::-1]):
            times[n].append(device_us(steps[n]))
    return {n: statistics.median(t) for n, t in times.items()}


def measure(ops: dict, k1_call: Optional[Callable[[], object]] = None
            ) -> dict:
    """Time every probe, its plain version and its library call, and the
    yardsticks.  Device and wall times in microseconds."""
    _require_cuda()
    x, plane, s = ops["x"], ops["plane"], ops["s"]
    o1, o2 = torch.empty_like(x), torch.empty_like(x)
    s0 = s[0]                  # a 0-d int32 view: the scalar stays on the card
    s0f = s.float()[0]         # the same scalar cast to f32 beforehand
    library = {
        "P1": lambda: torch.add(x, 1.0, out=o2),
        "P2": lambda: torch.add(x, 1.0, out=o2),
        "P3": lambda: plane[:256].sum(),
        "P4": lambda: plane[:8].add_(1),
        "P5": lambda: torch.add(x, s0, out=o2),
    }
    res = {"launch floor": three_ways(empty)}
    floor = res["launch floor"]["device_us"]
    for pid, (kern, plain, replaces, nbytes) in PROBES.items():
        args = args_of(pid, ops)
        r = three_ways(lambda: kern(*args, out=o1))
        r.update(plain_us=device_us(lambda: plain(*args)),
                 library_us=device_us(library[pid]),
                 bound_us=nbytes / HBM_BYTES_PER_S * 1e6, floor_us=floor,
                 bytes=nbytes, replaces=replaces)
        res[pid] = r
    res["P5"]["library_host_scalar_us"] = device_us(library["P1"])
    # the redesigned probes against their yardsticks, in turns, and the
    # kernels each of those calls launches
    steps = {
        "P2": {"P2 kernel": lambda: gridded(x, out=o1),
               "torch.add(x, 1.0, out=o)": library["P2"]},
        "P3": {"P3 kernel": lambda: dma(plane, out=o1),
               "plane[:256].sum()": library["P3"]},
        "P4": {"P4 kernel": lambda: aliased(plane, out=o1),
               "plane[:8].add_(1)": library["P4"]},
        "P5": {"P5 kernel": lambda: spref(s, x, out=o1),
               "torch.add(x, s[0], out=o)": library["P5"],
               "torch.add(x, s[0] as f32, out=o)":
                   lambda: torch.add(x, s0f, out=o2),
               "torch.add(x, 1.0, out=o)": library["P1"]}}
    res["interleaved"] = {
        pid: interleaved_us({**named, "launch floor": empty})
        for pid, named in steps.items()}
    res["kernels per call"] = {
        name: kernels_per_call(step)
        for named in steps.values() for name, step in named.items()}

    def eight():
        for _ in range(4):
            bare(x, out=o1)
            bare(o1, out=o2)

    res["8x bare"] = {k: v / 8 for k, v in three_ways(eight).items()}
    res["torch c + 1.0"] = three_ways(lambda: torch.add(x, 1.0, out=o2))
    fn = kernels.entry("probe_bare")
    stream = torch.cuda.current_stream().cuda_stream
    xp, op = x.data_ptr(), o1.data_ptr()
    res["host per call"] = dict(
        ctypes_us=eager_us(lambda: fn(xp, op, stream), 4 * N),
        launch_us=eager_us(lambda: kernels.launch("probe_bare", xp, op),
                           4 * N),
        wrapper_us=eager_us(lambda: bare(x, out=o1), 4 * N))
    if k1_call is not None:
        res["K1 wrapper host"] = dict(host_us=host_call_us(k1_call))
    return res


def report(res: dict) -> list[str]:
    """One line per probe and yardstick, as the JAX tool prints them."""
    lines = []
    for pid, med in res.get("interleaved", {}).items():
        lines.append(f"{pid} interleaved medians ({REPEATS} repeats, "
                     "device): " + ", ".join(f"{k} {v:.2f} us"
                                             for k, v in med.items()))
    for name, found in res.get("kernels per call", {}).items():
        lines.append(f"kernels per call of {name}: " + (
            "not measured (no device event in the trace)" if found is None
            else ", ".join(f"{k} x{v:g}" for k, v in found.items())))
    for name, r in res.items():
        if name in ("interleaved", "kernels per call"):
            continue
        parts = [f"{k[:-3]} {v:8.{4 if k == 'bound_us' else 2}f} us"
                 for k, v in r.items() if k.endswith("_us")]
        lines.append(f"{name:22s}: " + ", ".join(parts))
    return lines


def main() -> int:
    _require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    ops = inputs(torch.device("cuda", 0))
    check_probes(ops)
    print("P1-P5 kernels equal their plain versions", flush=True)
    for line in report(measure(ops)):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
