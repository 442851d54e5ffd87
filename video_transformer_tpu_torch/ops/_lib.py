"""Build the hand-written CUDA kernels in ``csrc/`` and bind them with ctypes.

Each ``csrc/*.cu`` source compiles for ``sm_90a`` in its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into a shared library with a plain C interface (no PyTorch headers, so the
build takes seconds, not minutes); ``csrc/*.cuh`` holds device code that
several sources share. The library lands in ``build/vtx_torch_kernels/`` under the
repository root, named by a hash of the sources, headers and flags, and is
built at first use only. Each ``extern "C"`` entry takes device pointers,
int sizes and the CUDA stream, launches on that stream, and returns
``cudaGetLastError()``; ``check`` raises on a non-zero return.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["library", "build_seconds", "build_log", "check", "ptr", "stream"]

_PACKAGE = Path(__file__).resolve().parents[1]
_CSRC = _PACKAGE / "csrc"
_BUILD_DIR = _PACKAGE.parent / "build" / "vtx_torch_kernels"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Entry name -> argtypes (every entry returns a cudaError_t as int).
_SIGNATURES = {
    # q, k, v, out, B, Hq, Hkv, Sq, Sk, D, causal, scale, stream
    "vtx_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # k_cache, v_cache, k_new, v_new, index, rows, k_scale, v_scale,
    # B, Hkv, S, W, D, cache_bytes, new_bytes, stream
    "vtx_write_cache_rows": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k_cache, v_cache, lengths, rows, k_scale, v_scale, out,
    # B, Hq, Hkv, S, W, D, splits, cache_is_int8, scale, stream
    "vtx_decode_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k_cache, v_cache, k_new, v_new, index, rows, out, B, Hq, Hkv, S, W, D, splits, scale, stream
    "vtx_decode_attention_update": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # dst_k, dst_v, src_k, src_v, rows, lanes, count, pool_rows, Hkv, S, S_park,
    # park_len, row_bytes, stream
    "vtx_adopt_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # q, k, v, out, lse, B, Hq, Hkv, S, D, causal, scale, stream
    "vtx_flash_fwd_lse": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, dout, lse, dsum, dq, B, Hq, Hkv, S, D, causal, scale, stream
    "vtx_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, dout, lse, dsum, dk_part, dv_part, B, Hq, Hkv, S, D, causal, scale, stream
    "vtx_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    # x, packed, out, M, K2, N, n_pad, splits, stream
    "vtx_int4_matmul": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
}

build_seconds = 0.0
"""Seconds the last ``nvcc`` build took in this process (0 when cached)."""
build_log = ""
"""``nvcc``'s report of that build: registers, shared memory, spills."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    global build_seconds, build_log
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    sources = sorted(_CSRC.glob("*.cu"))
    for src in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    target = _BUILD_DIR / f"libvtx_kernels_{digest.hexdigest()[:16]}.so"
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as objdir:  # removed on failure too
            objects = [Path(objdir) / f"{src.stem}.o" for src in sources]
            compiles = [
                subprocess.Popen([nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources, objects)
            ]
            logs = [proc.communicate()[0] for proc in compiles]  # wait for every process
            for src, proc, out in zip(sources, compiles, logs):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        build_seconds = time.perf_counter() - start
        build_log = "".join(logs)
        os.replace(tmp, target)
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(name: str, code: int) -> None:
    """Raise when a kernel entry reports a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None stays a null pointer)."""
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a raw handle (the
    handle alone, without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
