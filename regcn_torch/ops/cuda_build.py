"""Builds the package's CUDA sources into shared libraries at first use.

Each ``regcn_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``regcn_torch/_build/lib<name>-<hash>.so``, where the hash covers the
source and the flags, so an edited source is rebuilt. A library of
``VARIANTS`` is a source built again with a macro that selects another
part of its template instances, so that the parts compile in parallel. The library is
loaded with ctypes. Nothing here runs at import time: the CPU tests
import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_NVCC_TIMEOUT_S = 600
# library -> (source under csrc/, extra nvcc flags): streaming_ce.cu's
# instances for 256 < d <= 512 (the forward and both backward kernels at 12
# and 16 float4 columns a warp) in a library of their own
VARIANTS = {"streaming_ce_wide": ("streaming_ce", ("-DSTREAMING_CE_WIDE",))}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home}/bin or on PATH: the CUDA kernels "
            "of regcn_torch cannot be built")
    return found


def _source(name: str) -> tuple:
    """(source path, extra flags) of library ``name``."""
    src, flags = VARIANTS.get(name, (name, ()))
    return CSRC_DIR / f"{src}.cu", flags


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS + flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all ``nvcc``
    processes started together. Returns each new build's compiler output
    (``-Xptxas=-v`` register and spill counts); raises if any build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src, flags = _source(name)
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs, errors = {}, []
    for name, (proc, tmp, out) in running.items():
        try:
            logs[name], _ = proc.communicate(timeout=_NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            errors.append(f"{name}: nvcc timed out after {_NVCC_TIMEOUT_S} s")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if errors:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (``csrc/<name>.cu`` or a variant), building
    it if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
