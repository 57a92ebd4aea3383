"""Kernel builds under concurrency (``spatten_tpu_torch.kernels``), on the
CPU with a stand-in for ``nvcc``.

The ranks of a mesh reach a kernel's first use at once.  Four threads
build the same stale source together: the build lock lets one compile it
and the others find the library fresh; the library appears under its own
name only when complete (written under a temporary name and renamed), no
temporary file is left, and a forced build compiles again.  A failed
compile raises and leaves no library behind.
"""

import sys
import threading
from pathlib import Path

import pytest

from spatten_tpu_torch import kernels

FAKE_NVCC = """
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
src = args[-1]
with open(sys.argv[0] + ".log", "a") as fh:
    fh.write(src + "\\n")
if "broken" in src:
    print("error: broken source")
    sys.exit(2)
time.sleep(0.5)
with open(out, "w") as fh:
    fh.write("library")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "demo.cu").write_text("// demo")
    (csrc / "broken.cu").write_text("// broken")
    nvcc = tmp_path / "nvcc.py"
    nvcc.write_text(FAKE_NVCC)
    wrapper = tmp_path / "nvcc"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {nvcc} \"$@\"\n")
    wrapper.chmod(0o755)
    monkeypatch.setattr(kernels, "CSRC", csrc)
    monkeypatch.setattr(kernels, "BUILD_DIR", build)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(wrapper))
    return build, Path(str(nvcc) + ".log")


def test_concurrent_builds_compile_once(fake_build):
    build, log = fake_build
    errors = []

    def build_one():
        try:
            kernels.build_all(["demo"])
        except Exception as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=build_one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors
    assert log.read_text().count("demo.cu") == 1
    assert (build / "libdemo.so").read_text() == "library"
    assert not list(build.glob("*.tmp.so"))
    assert not kernels._stale("demo")
    kernels.build_all(["demo"], force=True)
    assert log.read_text().count("demo.cu") == 2


def test_failed_build_raises_and_leaves_no_library(fake_build):
    build, _ = fake_build
    with pytest.raises(RuntimeError, match="broken source"):
        kernels.build_all(["broken"])
    assert not (build / "libbroken.so").exists()
    assert not list(build.glob("*.tmp.so"))
