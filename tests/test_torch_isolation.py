"""The port stands alone: no module of ``src/repro_torch`` and no line of
``chip_smoke.py`` imports ``jax`` or the reference package ``repro``, and
the whole package imports in a process where ``jax`` cannot be
imported."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "repro")


def _is_banned(module: str) -> bool:
    return any(module == b or module.startswith(b + ".") for b in BANNED)


def banned_imports(source: str):
    """Absolute imports of ``jax``/``repro`` (and their submodules) in a
    module's source, including ``__import__``/``import_module`` calls
    with a literal name."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _is_banned(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _is_banned(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            arg = node.args[0]
            if name in ("__import__", "import_module") and \
                    isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, str) and _is_banned(arg.value):
                found.append(arg.value)
    return found


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_imports(path):
    assert banned_imports(path.read_text()) == [], path


def test_scanner_catches_every_form():
    src = ("import jax\nimport jax.numpy as jnp\nfrom repro.core import x\n"
           "import repro\nfrom jax import lax\n__import__('repro.core')\n"
           "importlib.import_module('jax')\n"
           "import repro_torch\nfrom . import core\nfrom .repro import y\n")
    assert sorted(banned_imports(src)) == sorted(
        ["jax", "jax.numpy", "repro.core", "repro", "jax", "repro.core",
         "jax"])


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
