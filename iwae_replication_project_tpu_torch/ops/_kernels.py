"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries are built at first
use into ``_build/`` inside the package (listed in ``.gitignore``), keyed on a
hash of the source and the flags: an edited source rebuilds, an unchanged one
loads the existing library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_i = ctypes.c_int

#: C signatures of every kernel library: name -> {function: (restype, argtypes)}
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "hot_loop_fwd": {
        "hot_loop_fwd": (_i, [_vp] * 9 + [_i] * 6 + [_vp]),
        "hot_loop_fwd_smem_bytes": (ctypes.c_size_t, [_i, _i]),
    },
    "hot_loop_bwd": {
        "hot_loop_bwd": (_i, [_vp] * 12 + [_i] * 7 + [_vp]),
        "hot_loop_bwd_smem_bytes": (ctypes.c_size_t, [_i, _i]),
        "hot_loop_bwd_groups": (_i, [_i]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> (seconds the build took, nvcc's output) for builds in this process
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current source."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, Path]]:
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library exists."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names) -> Dict[str, float]:
    """Build every named library in parallel (one ``nvcc`` per source, all
    started together); returns ``{name: seconds}`` (0.0 for a library that
    already existed). nvcc's output (``-Xptxas -v``: registers, shared
    memory, spills) lands in :data:`build_log`."""
    t0 = time.perf_counter()
    started = {name: _start_build(name) for name in names}
    secs = {}
    for name, job in started.items():
        if job is None:
            secs[name] = 0.0
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, library_path(name))  # a loader sees all or nothing
        secs[name] = time.perf_counter() - t0
        build_log[name] = (secs[name], log)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it first if
    needed, with ``argtypes``/``restype`` set from :data:`SIGNATURES`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _libs[name] = lib
        return lib
