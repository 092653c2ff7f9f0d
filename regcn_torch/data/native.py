"""The native (C++) snapshot builder (counterpart of ``regcn_tpu/native``).

``regcn_torch/csrc/graph_builder.cc`` is a CPython extension that builds a
snapshot's padded arrays in one pass (:func:`build_snapshot_arrays`),
bit for bit the arrays of the numpy path of
``regcn_torch/data/snapshots.py:build_snapshot``. At first use it is
compiled with the host C++ compiler (``$CXX``, else ``g++``; ``-O3
-shared -fPIC -std=c++17`` against Python's and numpy's headers) into
``regcn_torch/_build/_graph_builder-<hash>.so``, the hash taken over the
source, the flags, the interpreter's extension suffix and numpy's
version, so an edited source, or another interpreter or numpy, gets its
own build. The compiler writes a file of its own and an atomic
rename publishes it, so processes that build at once do not race. A
build that fails raises with the compiler's message: nothing falls back
to numpy behind the caller's back.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import logging
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "graph_builder.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-std=c++17")
_CXX_TIMEOUT_S = 300

_module = None


class StaleNativeError(RuntimeError):
    """The loaded module rejected the call's signature: a build of an older
    source. The numpy builder is safe in its place."""


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler ($CXX, g++ or c++) to build the native snapshot "
                           f"builder from {SOURCE}")
    return cxx


def _includes() -> tuple:
    return (sysconfig.get_paths()["include"], np.get_include())


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """Where the build of the current source lives."""
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = (SOURCE.read_bytes() + " ".join(CXX_FLAGS + _includes()).encode() + suffix.encode()
           + np.__version__.encode())
    return Path(build_dir) / f"_graph_builder-{hashlib.sha256(key).hexdigest()[:16]}{suffix}"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compiles the source into ``build_dir`` unless it is built there
    already; returns the library's path. Raises with the compiler's output
    if the build fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, *(f"-I{p}" for p in _includes()), "-o", str(tmp),
           str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_CXX_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native snapshot builder failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(build_dir: Path = BUILD_DIR):
    """The compiled module, built first if needed (once per process for the
    default directory)."""
    global _module
    if _module is not None and Path(build_dir) == BUILD_DIR:
        return _module
    path = build(build_dir)
    loader = importlib.machinery.ExtensionFileLoader("regcn_torch.data._graph_builder",
                                                     str(path))
    spec = importlib.util.spec_from_file_location(loader.name, str(path), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    if Path(build_dir) == BUILD_DIR:
        _module = module
    return module


def build_snapshot_arrays(triples, num_nodes, num_rels, edge_pad, rc_pad, rc_src_only=0):
    """(src, dst, rel, edge_mask, in_deg_norm, has_in_edge, rc_rel, rc_ent,
    rc_mask, num_edges, num_triples) of ``triples`` [n, >= 3] int64, padded
    to ``edge_pad`` >= 2n edges and ``rc_pad`` >= 4n pairs; ``rc_src_only``
    1 takes the relation context of the sources only (HisRES). Raises
    :class:`StaleNativeError` where the module rejects the signature (an
    arity complaint), as JAX's loader does; any other error propagates."""
    try:
        return load().build_snapshot_arrays(triples, num_nodes, num_rels, edge_pad, rc_pad,
                                         rc_src_only)
    except TypeError as exc:
        # only arity complaints mean an older signature; a value or type
        # complaint about the caller's input is a real fault and propagates
        if not any(s in str(exc) for s in ("takes exactly", "takes at least", "takes at most")):
            raise
        log.warning("the native snapshot builder has an older signature; falling back to "
                    "the numpy builder")
        raise StaleNativeError("stale native snapshot builder") from exc
