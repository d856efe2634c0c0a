"""The PyTorch port stands alone: neither ``src/repro_torch`` nor
``chip_smoke.py`` imports JAX or anything of the JAX package, and importing
every port module leaves JAX unloaded."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_modules_import_without_jax():
    mods = sorted(".".join(("repro_torch",) + p.relative_to(PORT).parts)
                  .removesuffix(".py").removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(k == 'repro' or k.startswith('repro.') "
            "for k in sys.modules), 'repro imported'\n"
            )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pkg", ["repro_torch.serve", "repro_torch.obs",
                                 "repro_torch.train", "repro_torch.optim",
                                 "repro_torch.checkpoint",
                                 "repro_torch.launch.train"])
def test_serving_and_obs_import_without_jax(pkg):
    code = (f"import sys, {pkg}\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _jax_all(module_dir: str) -> list:
    """``__all__`` of a JAX package module, read from its source (nothing
    of the JAX package is imported here)."""
    path = ROOT / "src" / "repro" / module_dir / "__init__.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in node.targets):
            return list(ast.literal_eval(node.value))
    raise AssertionError(f"no __all__ in {path}")


@pytest.mark.parametrize("module", ["core", "runtime"])
def test_front_end_names_match_the_jax_package(module):
    """Each public name of ``repro.core`` and ``repro.runtime`` is
    importable from the port's module of the same name, or is one of the
    XLA-only names that module's docstring lists (``JAX_ONLY``)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{module}")
    jax_only = getattr(mod, "JAX_ONLY", ())
    for name in jax_only:
        assert name in mod.__doc__, name
    missing = [n for n in _jax_all(module)
               if n not in jax_only and not hasattr(mod, n)]
    assert not missing, f"repro_torch.{module} lacks {missing}"
    assert set(mod.__all__) <= set(dir(mod))
