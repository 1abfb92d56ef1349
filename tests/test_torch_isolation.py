"""The port stands alone: no JAX and nothing of the JAX package.

``repro_torch`` keeps its own copies of the reference's framework-free
modules (``repro.core`` imports JAX eagerly through ``collective_fabric``),
so importing the port must leave both ``jax`` and ``repro`` out of
``sys.modules``, and no file of the port, nor ``chip_smoke.py``, may import
either. ``chip_smoke.py`` must refuse to run without CUDA and outside a
checkout, printing no result.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).parent.parent
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.core, repro_torch.core.scenario\n"
        "import repro_torch.core.collective_fabric\n"
        "import repro_torch.kernels.swarm, repro_torch.kernels.checksum\n"
        "import repro_torch.kernels.nvcc, repro_torch.data\n"
        "import repro_torch.examples.checkpoint_broadcast\n"
        "import repro_torch.configs, repro_torch.models, repro_torch.serve\n"
        "import repro_torch.launch.serve, repro_torch.kernels.attention\n"
        "import repro_torch.kernels.ssd, repro_torch.kernels.rglru\n"
        "import repro_torch.models.ssd, repro_torch.models.rglru\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(ROOT)), mod)
        for f in files for mod in _imported_roots(f) if mod in FORBIDDEN
    ]
    assert bad == []


def _run_smoke(cwd):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_refuses_without_cuda():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
