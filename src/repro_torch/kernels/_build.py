"""Build and bind the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``; each
library holds one kernel's fused (f32 and bf16 tree tiles) and raw entry
points.  The
build runs at first use, from the sources in this package only, into
``build/kernels/`` at the root of the checkout; a library's file name
carries a digest of its sources and flags, so an edited source is rebuilt
and a stale library is never loaded.  ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["KERNEL_SOURCES", "build_all", "load", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", *ARCH_FLAGS]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _entry_points(kind: str, n_pointers: int):
    """The fused (f32 and bf16 tree tiles) and raw C entry points of one
    kernel: ``n_pointers`` tensor pointers (inputs, then out), B, then F,
    T, depth, block_b, block_t, x_staged (nonzero: stage x in shared
    memory), and the stream."""
    argtypes = [_P] * n_pointers + [_LL] + [_I] * 6 + [_P]
    return [(f"forest_{kind}_{variant}", argtypes)
            for variant in ("fused", "fused_bf16", "raw")]


#: library name -> (source file, [(C function, argtypes), ...])
KERNEL_SOURCES = {
    "forest_predicated": ("forest_predicated.cu",
                          _entry_points("predicated", 4)),
    "forest_hummingbird": ("forest_hummingbird.cu",
                           _entry_points("hummingbird", 6)),
    "forest_quickscorer": ("forest_quickscorer.cu",
                           _entry_points("quickscorer", 4)),
}

#: ptxas resource report of each library built by this process
BUILD_LOG: dict[str, str] = {}

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = CSRC / KERNEL_SOURCES[name][0]
    h = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in KERNEL_SOURCES[name][1]:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.forest_error_string.argtypes = [ctypes.c_int]
    lib.forest_error_string.restype = ctypes.c_char_p
    lib.forest_transpose_rows.argtypes = [_P, _P, _LL, _I, _P]
    lib.forest_transpose_rows.restype = ctypes.c_int
    _LOADED[name] = lib
    return lib


def build_all(names=None) -> float:
    """Compile every kernel library not yet built (one ``nvcc`` per source,
    all started together), load them, and return the seconds it took."""
    t0 = time.perf_counter()
    names = list(KERNEL_SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if name in _LOADED or target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNEL_SOURCES[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failures = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    for name in names:
        if name not in _LOADED:
            _bind(name, _target(name))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = _LOADED[name]
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.forest_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
