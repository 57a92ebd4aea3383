"""Nothing the harness or the reference loads is JAX, jaxlib, flax or
the JAX package (top-level names compared whole: the port's name begins
with the JAX package's), and the reference loads nothing of the port."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench import manifest
from portbench.run import FORBIDDEN, loaded_forbidden

PROBE = """
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _tops(imports: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(imports=imports)],
                         cwd=manifest.REPO, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin",
                                          "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _tops("import portbench.run, portbench.harness, "
                 "portbench.calibrate\n"
                 "from portbench import manifest\n"
                 "for m in manifest.load()['end_to_end'] + "
                 "manifest.load()['per_layer']:\n"
                 "    manifest.reader(m['name'])")
    assert not tops.intersection(FORBIDDEN), tops
    assert "spatten_tpu_torch" in tops


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import portbench.reference.spatten_ref, "
                 "portbench.counts, portbench.traffic.generate, "
                 "portbench.weights")
    assert not tops.intersection(FORBIDDEN + ("spatten_tpu_torch",)), tops


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "spatten_tpu_torch_extra", sys)
    assert "spatten_tpu" not in loaded_forbidden() or \
        "spatten_tpu" in {m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in loaded_forbidden()
