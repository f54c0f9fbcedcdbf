"""Which modules the benchmark's sources import, by top-level name.

The benchmark measures go_mp3_tpu_torch and nothing else: no source under
benchmark/ may import jax, jaxlib, flax or go_mp3_tpu, and the plain
reference (benchmark/reference/ and what it imports of the benchmark) may
not import go_mp3_tpu_torch either. Names are compared whole: the part
before the first dot.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BANNED = frozenset({"jax", "jaxlib", "flax", "go_mp3_tpu"})
PORT = "go_mp3_tpu_torch"


def _module_of(path: Path) -> str:
    if not path.is_relative_to(HERE.parent):
        return path.stem
    rel = path.relative_to(HERE.parent).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def imports_of(path: Path) -> set[str]:
    """Absolute names of the modules a source file imports (relative
    imports resolved against its package)."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = _module_of(path).split(".")
    if path.name != "__init__.py":
        pkg = pkg[:-1]
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = pkg[: len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
    return out


def _file_of(name: str) -> Path | None:
    parts = name.split(".")
    if parts[0] != HERE.name:
        return None
    p = HERE.parent.joinpath(*parts)
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def closure(files) -> set[str]:
    """Top-level names imported by the files and by every benchmark module
    they import, transitively."""
    seen, todo, tops = set(), list(files), set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for name in imports_of(f):
            tops.add(name.split(".")[0])
            g = _file_of(name)
            if g is not None:
                todo.append(g)
    return tops


def violations() -> list[str]:
    """What the benchmark's sources import that they may not."""
    bad = []
    every = closure(sorted(HERE.rglob("*.py")))
    bad += [f"benchmark imports {n}" for n in sorted(every & BANNED)]
    ref = closure(sorted((HERE / "reference").rglob("*.py")))
    bad += [f"benchmark/reference imports {n}" for n in sorted(ref & (BANNED | {PORT}))]
    return bad


def loaded_banned() -> list[str]:
    """Modules of the banned packages this process holds."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in BANNED)
