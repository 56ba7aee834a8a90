"""What the benchmark may import: nothing of JAX or the JAX package anywhere
under ``gpubench/``, and nothing of the package under test in the
reference."""

import ast
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "brepgen_tpu"}


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not imported_tops(f) & FORBIDDEN, f


def test_top_level_names_compare_whole():
    # the port's name begins with the JAX package's; only whole names match
    from gpubench.run import FORBIDDEN as harness_forbidden

    assert "brepgen_tpu_torch".split(".")[0] not in harness_forbidden
    assert "brepgen_tpu" in harness_forbidden


def test_reference_imports_nothing_of_the_program():
    for f in sorted((HERE / "reference").glob("*.py")):
        assert "brepgen_tpu_torch" not in imported_tops(f), f
    code = ("import sys, importlib, pkgutil, gpubench.reference as r\n"
            "for m in pkgutil.iter_modules(r.__path__):\n"
            "    importlib.import_module(f'{r.__name__}.{m.name}')\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'brepgen_tpu_torch', 'brepgen_tpu', 'jax', 'flax'})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_a_run_loads_no_jax():
    code = ("import sys, gpubench.run, gpubench.kinds.sample, gpubench.kinds.train, "
            "gpubench.kinds.eval, gpubench.control\n"
            "import brepgen_tpu_torch.sampling, brepgen_tpu_torch.train.ldm_train, "
            "brepgen_tpu_torch.eval.metrics\n"
            "assert not gpubench.run.forbidden_modules(), gpubench.run.forbidden_modules()\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)
