"""What a run of the port may not load: JAX, its libraries, the JAX
package and its alias, compared by whole top-level module names (the
part before the first dot), so that ``biscuit_torch`` passes; and what
the reference may not import: those, and the program."""

import ast
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "biscuit_tpu",
             "biscuit")
PROGRAM = "biscuit_torch"


def loaded_forbidden(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def imports_of(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def reference_breaches(ref_dir: Path = None) -> list:
    """(file, module) of every import under ``reference/``, its trunk
    families included, of the program or of a forbidden module."""
    ref_dir = ref_dir or Path(__file__).resolve().parent.parent / "reference"
    bad = set(FORBIDDEN) | {PROGRAM}
    return [(str(p.relative_to(ref_dir)), m)
            for p in sorted(ref_dir.rglob("*.py"))
            for m in sorted(imports_of(p) & bad)]
