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
rename publishes it, so processes that build at once do not race.

A host without a C++ compiler, or a build that fails, raises
:class:`NativeBuildError` with the compiler's message. Under
``build_snapshot(use_native=None)``, every caller's default, the builder
then warns once per process and builds with numpy instead, as JAX's
default does where its module is not built; ``use_native=True`` raises.
That fallback covers the build only: a module that loads and then fails
inside a call raises. It is host data preparation with bit-identical
arrays either way, not a kernel of the device path, so it hides neither
the card nor a kernel.
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
import warnings
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "graph_builder.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-Wall", "-shared", "-fPIC", "-std=c++17")
_CXX_TIMEOUT_S = 300

_module = None
_build_failures: dict = {}  # build directory -> the NativeBuildError of this process
_warned = [False]


class NativeBuildError(RuntimeError):
    """No C++ compiler, or the build failed: the module cannot be built here."""


class StaleNativeError(RuntimeError):
    """The loaded module rejected the call's signature: a build of an older
    source. The numpy builder is safe in its place."""


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise NativeBuildError("no C++ compiler ($CXX, g++ or c++) to build the native snapshot "
                           f"builder from {SOURCE}")
    return cxx


def _includes() -> tuple:
    return (sysconfig.get_paths()["include"], np.get_include())


def library_path(build_dir=None) -> Path:
    """Where the build of the current source lives (``build_dir`` defaults
    to :data:`BUILD_DIR`)."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    key = (SOURCE.read_bytes() + " ".join(CXX_FLAGS + _includes()).encode() + suffix.encode()
           + np.__version__.encode())
    return Path(build_dir) / f"_graph_builder-{hashlib.sha256(key).hexdigest()[:16]}{suffix}"


def build(build_dir=None) -> Path:
    """Compiles the source into ``build_dir`` (default :data:`BUILD_DIR`)
    unless it is built there already; returns the library's path. Raises
    :class:`NativeBuildError` with the compiler's output if there is no
    compiler or the build fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_compiler(), *CXX_FLAGS, *(f"-I{p}" for p in _includes()), "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_CXX_TIMEOUT_S)
    except (OSError, subprocess.SubprocessError) as exc:  # a missing program, a timeout
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"building the native snapshot builder failed ({' '.join(cmd)}): "
                               f"{exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"building the native snapshot builder failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load(build_dir=None):
    """The compiled module, built first if needed (once per process for the
    default directory). A build that failed in this process raises its
    :class:`NativeBuildError` again without another attempt."""
    global _module
    default = build_dir is None or Path(build_dir) == BUILD_DIR
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
    if _module is not None and default:
        return _module
    if build_dir in _build_failures:
        raise _build_failures[build_dir]
    try:
        path = build(build_dir)
    except NativeBuildError as exc:
        _build_failures[build_dir] = exc
        raise
    loader = importlib.machinery.ExtensionFileLoader("regcn_torch.data._graph_builder",
                                                     str(path))
    spec = importlib.util.spec_from_file_location(loader.name, str(path), loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    if default:
        _module = module
    return module


def warn_numpy_fallback(exc: NativeBuildError) -> None:
    """The one warning of a process whose default builder takes numpy
    because the native module cannot be built."""
    if not _warned[0]:
        _warned[0] = True
        warnings.warn(f"the native snapshot builder cannot be built here, so snapshots are built "
                      f"with numpy (bit-identical arrays, slower): {exc}", RuntimeWarning,
                      stacklevel=3)


def build_snapshot_arrays(triples, num_nodes, num_rels, edge_pad, rc_pad, rc_src_only=0):
    """(src, dst, rel, edge_mask, in_deg_norm, has_in_edge, rc_rel, rc_ent,
    rc_mask, num_edges, num_triples) of ``triples`` [n, >= 3] int64, padded
    to ``edge_pad`` >= 2n edges and ``rc_pad`` >= 4n pairs; ``rc_src_only``
    1 takes the relation context of the sources only (HisRES). Raises
    :class:`StaleNativeError` where the module rejects the signature (an
    arity complaint), as JAX's loader does, and :class:`NativeBuildError`
    where the module cannot be built; any other error propagates."""
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
