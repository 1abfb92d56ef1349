"""The benchmark stands apart: no module under ``portbench/`` imports JAX,
Flax or the JAX package ``repro`` (top-level names compared whole, since
the port's ``repro_torch`` begins with ``repro``), the reference imports
nothing of the program, and a run leaves none of them in ``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

from portbench import harness

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: what the plain reference may import: the standard library and torch
REFERENCE_MAY = {"__future__", "contextlib", "math", "typing", "torch"}


def imported_roots(path: Path) -> set:
    """Top-level names of every module ``path`` imports (relative imports
    as ``.<name>``)."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                roots.add("." + (node.module or "").split(".")[0])
            else:
                roots.add(node.module.split(".")[0])
    return roots


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py"))
    assert files
    for path in files:
        bad = imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PACKAGE / "reference").glob("*.py")):
        roots = imported_roots(path)
        outside = {r for r in roots if not r.startswith(".")} - REFERENCE_MAY
        assert not outside, f"{path.name} imports {sorted(outside)}"
        inside = {r[1:] for r in roots if r.startswith(".")}
        assert inside <= {"transformer", ""}, f"{path.name} imports {inside}"


def test_names_are_compared_whole(monkeypatch):
    for name in ("repro_torch", "repro_torch.models", "jaxtyping",
                 "reprox"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(harness.forbidden_modules()) & {
        "repro_torch", "repro_torch.models", "jaxtyping", "reprox"}
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in harness.forbidden_modules()


def test_a_run_loads_no_jax():
    code = (
        "import sys, time, torch\n"
        "torch.set_num_threads(2)\n"
        "from portbench import run, tiny, harness\n"
        "run.execute(tiny.cell(tiny.names()[0]), 7, 0.2, False, 'cpu',"
        " time.time())\n"
        "bad = harness.forbidden_modules()\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-2000:]


def test_the_command_refuses_without_a_card_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "dbrx_132b.serve.p2048", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_command_refuses_outside_a_checkout(tmp_path):
    import shutil

    shutil.copytree(PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "dbrx_132b.serve.p2048", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
