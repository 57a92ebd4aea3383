"""Extract an English-prose corpus from installed packages' docstrings
(port of ``tools/extract_doc_corpus.py``).

There is no network and no NLP corpus on the machines the port runs on,
but their site-packages carry megabytes of real English documentation
prose (torch, numpy, scipy, ... docstrings).  This mines them into one
plain-text corpus for the from-scratch perplexity curve
(``spatten_tpu_torch.tools.ppl_curve`` with ``PPL_MODEL=gpt2s``):

    python -m spatten_tpu_torch.tools.extract_doc_corpus [out.txt]

Filters, walk order and skipped directories are the JAX tool's: module,
class and function docstrings of >= 200 characters and >= 40 words with
at most 4% code-ish characters, deduplicated by MD5, joined by blank
lines.  The default root is this interpreter's ``purelib``, so the text
differs between machines with different packages.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
import sys
import sysconfig
import time
from pathlib import Path
from typing import Iterable, Optional

DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "doc_corpus.txt"
SKIP_DIRS = ("tests", "test", "__pycache__")
_WORD = re.compile(r"[A-Za-z]{2,}")
_NODES = (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)


def default_roots() -> list:
    return [sysconfig.get_paths()["purelib"]]


def _keep(doc: Optional[str]) -> bool:
    return (bool(doc) and len(doc) >= 200
            and len(_WORD.findall(doc)) >= 40
            and sum(c in "={}[]<>_" for c in doc) / len(doc) <= 0.04)


def docstrings(roots: Iterable[str]) -> tuple[list, int]:
    """(the kept docstrings, stripped, in walk order; their characters
    before stripping)."""
    docs, seen, total = [], set(), 0
    for root in roots:
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
            for fn in filenames:
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                try:
                    with open(path, encoding="utf-8", errors="ignore") as f:
                        tree = ast.parse(f.read())
                except (OSError, SyntaxError, ValueError, RecursionError,
                        MemoryError):
                    continue
                for node in ast.walk(tree):
                    if not isinstance(node, _NODES):
                        continue
                    d = ast.get_docstring(node)
                    if not _keep(d):
                        continue
                    h = hashlib.md5(d.encode()).hexdigest()
                    if h in seen:
                        continue
                    seen.add(h)
                    docs.append(d.strip())
                    total += len(d)
    return docs, total


def extract(roots: Optional[Iterable[str]] = None,
            out_path: str | os.PathLike = DEFAULT_OUT) -> tuple[int, int]:
    """Write the corpus of ``roots`` (default: ``purelib``) to
    ``out_path``; returns (docstrings, characters)."""
    docs, total = docstrings(default_roots() if roots is None else roots)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write("\n\n".join(docs))
    return len(docs), total


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out_path = argv[0] if argv else DEFAULT_OUT
    t0 = time.perf_counter()
    n, total = extract(out_path=out_path)
    print(f"{n} docstrings, {total / 1e6:.1f} MB -> {out_path} in "
          f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
