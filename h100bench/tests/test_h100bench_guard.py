"""The import guard compares whole top-level names; the reference imports
neither the program nor JAX."""

import subprocess
import sys

from h100bench.harness import guard, spec


def test_whole_top_level_names():
    assert guard.loaded_forbidden(["biscuit_torch", "biscuit_torch.ops",
                                   "biscuitx", "numpy"]) == []
    assert guard.loaded_forbidden(["jax.numpy", "flax.linen", "biscuit",
                                   "biscuit_tpu.hp", "optax", "orbax.x",
                                   "jaxlib"]) == sorted(guard.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    assert guard.reference_breaches() == []
    (tmp_path / "a.py").write_text(
        "import torch\nfrom biscuit_torch import hp\n")
    (tmp_path / "b.py").write_text("import jax.numpy as jnp\n")
    assert guard.reference_breaches(tmp_path) == [("a.py", "biscuit_torch"),
                                                  ("b.py", "jax")]


def test_the_guard_reads_the_trunk_families(tmp_path):
    assert any(p.parent.name == "families" for p in
               (spec.BENCH_DIR / "reference").rglob("*.py"))
    (tmp_path / "families").mkdir()
    (tmp_path / "families" / "vit.py").write_text(
        "def port_arch(name, port):\n"
        "    from biscuit_torch.models import vit\n")
    assert guard.reference_breaches(tmp_path) == [("families/vit.py",
                                                   "biscuit_torch")]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from h100bench.harness import drive, guard\n"
            "import biscuit_torch.train.uq, biscuit_torch.train.trainer\n"
            "print(guard.loaded_forbidden())\n" % str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    # This sandbox has no card: no result line, a code other than 0.
    proc = subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "xception299.serve.b256", "--seed", str(2 ** 31 + 5), "--seconds",
         "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=300)
    import torch

    if torch.cuda.is_available():
        return
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
