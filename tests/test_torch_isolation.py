"""The port stands alone: nothing under src/repro_torch/ (nor
chip_smoke.py) imports JAX or the reference package, and importing the
port on a CPU-only PyTorch without nvcc or triton pulls in neither;
each module imports as the first of its package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py")
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr


def test_each_module_imports_first():
    """Every port module (packages included) imports as the first port
    module of a process: no import cycle hides behind the order other
    imports happen in (``import repro_torch.serve`` alone once failed,
    ROADMAP C6)."""
    mods = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "import torch\n"
        f"for m in {mods!r}:\n"
        "    for k in [k for k in sys.modules if k.startswith('repro_torch')]:\n"
        "        del sys.modules[k]\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr


def test_every_kernel_has_source_and_note():
    from repro_torch.kernels.build import KERNEL_NAMES, source_path

    for name in KERNEL_NAMES:
        src = source_path(name).read_text()
        assert "Replaces the Pallas TPU kernel" in src
        assert "Bound on this card" in src
        assert 'extern "C"' in src
