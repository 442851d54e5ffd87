"""The port stands alone: import isolation and code hygiene.

The PyTorch/CUDA port (``video_transformer_tpu_torch``) and ``chip_smoke.py``
run on a machine that has no JAX, flax, optax, orbax, yaml, transformers,
ml_dtypes, PIL, requests, yt_dlp, safetensors or tokenizers, and they
import nothing of the JAX package (``requests``, ``yt_dlp`` and
``tokenizers`` stay imports inside the functions that need them; the HF
checkpoint reader reads safetensors files with numpy). A subprocess whose
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
REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "transformers", "ml_dtypes", "PIL",
           "requests", "yt_dlp", "safetensors", "tokenizers", "video_transformer_tpu")
LAZY = ("requests", "yt_dlp", "tokenizers")  # imported inside functions only
# Command-line entry points: what they print is their interface.
PRINTING = ("cli.py", "tools/validate_note.py", "train/eval_content.py", "train/eval_real.py", "utils/compressor.py",
            "tools/add_p_params.py", "tools/export_pdf.py")
# The analyzer's modules (copies of the JAX package's, at the same paths).
ANALYZER_MODULES = (
    "contracts.timefmt", "contracts.normalize", "contracts.validators", "contracts.render",
    "contracts.knowledge", "contracts.results", "utils.counter", "utils.budget_planner", "utils.pacer",
    "utils.config", "video.containers", "video.probe", "video.segmenter", "video.prefetch",
    "analyzer.json_repair", "analyzer.segmentation", "analyzer.content_analyzer",
)
# The pipeline's modules and the CLI (copies of the JAX package's, at the same paths).
PIPELINE_MODULES = (
    "exceptions", "utils.logger", "utils.progress", "utils.proxy", "utils.refiner_contract", "utils.refiner",
    "utils.quality", "tools.validate_note", "pipeline.downloader", "pipeline.validator", "pipeline.visualizer",
    "pipeline.auditor", "pipeline.pipeline", "cli", "pipeline.service",
)
# The training data paths, the evals, the tracer and the last note tools.
SLICE_MODULES = (
    "train.data", "train.run", "train.eval_content", "train.eval_real", "utils.tracing", "utils.compressor",
    "tools.add_p_params", "tools.export_pdf", "models.bpe", "ops.token_grammar",
)
# The Qwen2-VL geometry: the vision tower, the HF checkpoint port, the HF
# tokenizer and the synthetic 152k vocabulary.
QWEN_MODULES = ("models.qwen_vit", "models.port", "models.hf_tokenizer", "models.synth_vocab")

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
for want in ("parallel.serving", "train.grounded", "train.shifts", "train.eval_grounding") + {analyzer!r}:
    assert "video_transformer_tpu_torch." + want in names, names
from video_transformer_tpu_torch.analyzer import ContentAnalyzer
from video_transformer_tpu_torch.utils.config import load_config
assert load_config()["engine"]["model_preset"] == "base"
assert ContentAnalyzer({{}}, None).device == "cuda"
from video_transformer_tpu_torch.pipeline import VideoPipeline
from video_transformer_tpu_torch.pipeline.service import WatchService
from video_transformer_tpu_torch.cli import build_parser
import inspect
assert inspect.signature(VideoPipeline).parameters["device"].default == "cuda"
assert inspect.signature(WatchService).parameters["device"].default == "cuda"
assert build_parser().parse_args(["--url", "clip.npzv"]).device == "cuda"
from video_transformer_tpu_torch.utils.proxy import verify_proxy_connection
assert verify_proxy_connection("http://localhost:1") is False  # requests refused: no key pool
from video_transformer_tpu_torch.parallel.engine import InferenceEngine
for method in ("generate_text", "continue_session", "restore"):
    assert callable(getattr(InferenceEngine, method)), method
from video_transformer_tpu_torch.models.bpe import train_bpe, BpeTokenizer
from video_transformer_tpu_torch.ops.token_grammar import TokenGrammar
from video_transformer_tpu_torch.train.data import distillation_records
from video_transformer_tpu_torch.train.grounded import stage_grounded_corpus, grounded_records
from video_transformer_tpu_torch.train.run import _grounded_batches, _staged_batches
from video_transformer_tpu_torch.train import eval_content, eval_real
from video_transformer_tpu_torch.utils.tracing import tracer, device_trace
assert callable(BpeTokenizer.save) and callable(TokenGrammar.encode_aligned)
assert inspect.signature(TokenGrammar).parameters["cache_dir"].default == "build/grammar_cache"
assert callable(eval_content.main) and callable(eval_real.main)
import json, tempfile
from pathlib import Path
from video_transformer_tpu_torch.models.config import get_preset
from video_transformer_tpu_torch.models.hf_tokenizer import HfTokenizer
from video_transformer_tpu_torch.models.port import load_qwen2vl_dir, read_safetensors
assert get_preset("qwen2vl-7b").video_tokens == 512 and callable(read_safetensors) and callable(load_qwen2vl_dir)
with tempfile.TemporaryDirectory() as tmp:
    vocab = {{chr(c): i for i, c in enumerate(range(ord("!"), ord("!") + 94))}}
    path = Path(tmp) / "tokenizer.json"
    path.write_text(json.dumps({{"model": {{"type": "BPE", "vocab": vocab, "merges": []}},
                                "added_tokens": [{{"content": "<|endoftext|>", "id": 94}}]}}))
    assert HfTokenizer(path).encode_branch == "merge_units"  # tokenizers refused: the merge-unit branch
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in REFUSED)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result = subprocess.run(
        [sys.executable, "-c", _ISOLATED_IMPORT.format(
            refused=REFUSED, analyzer=ANALYZER_MODULES + PIPELINE_MODULES + SLICE_MODULES + QWEN_MODULES)],
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
        """No refused import anywhere, but ``requests`` and ``yt_dlp`` inside
        the functions that need them (the JAX package's optional cloud and
        download seams)."""
        tree = _module_ast(path)
        lazy = {id(node) for fn in ast.walk(tree) if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                for node in ast.walk(fn)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in LAZY and id(node) in lazy:
                    continue
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
    """The package logs nothing to stdout; only chip_smoke.py and the
    command-line entry points (``PRINTING``, as in the JAX package) print."""
    offenders = [
        f"{path.relative_to(REPO)}:{node.lineno}"
        for path in PACKAGE.rglob("*.py")
        if path.relative_to(PACKAGE).as_posix() not in PRINTING
        for node in ast.walk(_module_ast(path))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "print"
    ]
    assert not offenders, f"print() in library code: {offenders}"


def test_only_the_conversion_tool_imports_orbax():
    """Of the port's files and its checkpoint converter, only the converter
    (a host tool that runs beside JAX) reads orbax."""
    outside = [REPO / "chip_smoke.py", *PACKAGE.rglob("*.py"), REPO / "tools" / "orbax_to_npz.py"]
    importers = []
    for path in outside:
        for node in ast.walk(_module_ast(path)):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            if any(name.split(".")[0] == "orbax" for name in names):
                importers.append(path.relative_to(REPO).as_posix())
    assert sorted(set(importers)) == ["tools/orbax_to_npz.py"]


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
