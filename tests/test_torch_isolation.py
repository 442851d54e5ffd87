"""The port stands alone: import isolation and code hygiene.

The PyTorch/CUDA port (``video_transformer_tpu_torch``) and ``chip_smoke.py``
run on a machine that has no JAX, flax, optax, orbax, yaml, transformers or
ml_dtypes, and they import nothing of the JAX package. A subprocess whose
meta-path finder refuses those imports must still import every module of the
port and ``chip_smoke``. The hygiene checks mirror tests/test_code_hygiene.py
(which covers the JAX package) for the port's sources.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "video_transformer_tpu_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "transformers", "ml_dtypes",
           "video_transformer_tpu")

_ISOLATED_IMPORT = """
import importlib, pkgutil, sys
REFUSED = {refused!r}

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused import: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import video_transformer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert "video_transformer_tpu_torch.parallel.serving" in names, names
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result = subprocess.run(
        [sys.executable, "-c", _ISOLATED_IMPORT.format(refused=REFUSED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert int(result.stdout.split()[-1]) >= 20  # every module was walked


def _module_ast(path: Path) -> ast.Module:
    return ast.parse(path.read_text(encoding="utf-8"), filename=str(path))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
class TestPortHygiene:
    def test_compiles(self, path):
        compile(path.read_text(encoding="utf-8"), str(path), "exec")

    def test_no_refused_imports(self, path):
        for node in ast.walk(_module_ast(path)):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in REFUSED, f"{path.name}:{node.lineno} imports {name}"

    def test_no_unused_imports(self, path):
        tree = _module_ast(path)
        imported: dict[str, int] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imported[(alias.asname or alias.name).split(".")[0]] = node.lineno
            elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
                for alias in node.names:
                    imported[alias.asname or alias.name] = node.lineno
        used: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif isinstance(node, ast.Attribute):
                base = node
                while isinstance(base, ast.Attribute):
                    base = base.value
                if isinstance(base, ast.Name):
                    used.add(base.id)
            elif isinstance(node, ast.Constant) and isinstance(node.value, str):
                used.add(node.value)
        unused = {name: line for name, line in imported.items() if name not in used}
        assert not unused, f"unused imports: {unused}"

    def test_no_mutable_default_args(self, path):
        offenders = [
            f"{node.name}:{node.lineno}"
            for node in ast.walk(_module_ast(path))
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            for default in node.args.defaults + node.args.kw_defaults
            if isinstance(default, (ast.List, ast.Dict, ast.Set))
        ]
        assert not offenders, f"mutable default arguments: {offenders}"

    def test_no_bare_except(self, path):
        offenders = [
            node.lineno for node in ast.walk(_module_ast(path))
            if isinstance(node, ast.ExceptHandler) and node.type is None
        ]
        assert not offenders, f"bare except at lines {offenders}"

    def test_has_docstring(self, path):
        if path.name != "__init__.py" or path.parent == PACKAGE:
            assert ast.get_docstring(_module_ast(path)), f"{path} has no module docstring"


def test_no_print_in_library_code():
    """The package logs nothing to stdout; only chip_smoke.py prints."""
    offenders = [
        f"{path.relative_to(REPO)}:{node.lineno}"
        for path in PACKAGE.rglob("*.py")
        for node in ast.walk(_module_ast(path))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "print"
    ]
    assert not offenders, f"print() in library code: {offenders}"


def test_kernel_sources_are_plain_cuda():
    """Each CUDA source names the TPU kernel it replaces and includes no
    PyTorch headers (the nvcc + ctypes route)."""
    sources = sorted((PACKAGE / "csrc").glob("*.cu"))
    assert [p.name for p in sources] == [
        "adopt_rows.cu", "decode_attention.cu", "flash_attention.cu", "flash_bwd.cu", "int4_matmul.cu",
        "write_cache_rows.cu",
    ]
    for path in sorted((PACKAGE / "csrc").glob("*.cuh")):  # device code shared by sources
        text = path.read_text(encoding="utf-8")
        assert "torch/extension.h" not in text and "ATen" not in text, path.name
    for path in sources:
        text = path.read_text(encoding="utf-8")
        assert "torch/extension.h" not in text and "ATen" not in text, path.name
        assert "Replaces video_transformer_tpu/ops/" in text, path.name
        assert 'extern "C" int vtx_' in text, path.name


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """No nvcc on CUDA_HOME, PATH or the default CUDA prefix: the build raises
    (there is no fallback to the plain versions on a CUDA tensor)."""
    from video_transformer_tpu_torch.ops import _lib

    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_lib.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _lib._nvcc()
