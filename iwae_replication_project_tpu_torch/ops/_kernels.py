"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries are built at first
use, keyed on a hash of the source, the local headers it includes
(``csrc/*.cuh``, and theirs) and the flags: an edited source rebuilds, an
unchanged one loads the existing library. Nothing here runs at import time.

**The build directory** is the port's compile cache (the JAX package's
persistent XLA cache, ``utils/compile_cache.py:167-207`` there, carried
over where its rules apply). :func:`use_build_dir` points it at the
driver's ``compile_cache_dir`` (``--compile-cache-dir``); the field wins,
``IWAE_COMPILE_CACHE`` fills in when it is None, ``off``/``none``/``0``
builds into a fresh private temporary directory (removed at exit, so
nothing is reused), and with neither set the libraries live in
:data:`BUILD_DIR`, ``_build/`` inside the package (listed in
``.gitignore``). First wins: once a library is loaded in this process the
directory stays, and a call naming another one says so. :func:`cache_counts`
counts the libraries found built on disk (hits), the ``nvcc`` builds
(misses) and their seconds.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
#: the default build directory (module docstring)
BUILD_DIR = _PKG / "_build"

#: the environment variable that names the build directory when the
#: caller's ``compile_cache_dir`` is None (the JAX package's name for its
#: compile cache)
CACHE_ENV = "IWAE_COMPILE_CACHE"
#: spellings of "no reusable cache"
_CACHE_OFF = ("off", "none", "0")

#: largest dynamic shared memory a Hopper CTA may use (bytes)
MAX_SMEM_BYTES = 232448

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_i = ctypes.c_int

#: C signatures of every kernel library: name -> {function: (restype, argtypes)}
SIGNATURES: Dict[str, Dict[str, Tuple[object, List[object]]]] = {
    "hot_loop_fwd": {
        "hot_loop_fwd": (_i, [_vp] * 10 + [_i] * 7 + [_vp]),
        "hot_loop_fwd_smem_bytes": (ctypes.c_size_t, [_i] * 3),
        "hot_loop_fwd_fits": (_i, [_i] * 3),
        "hot_loop_fwd_scratch_bytes": (ctypes.c_size_t, [_i] * 4),
    },
    "hot_loop_bwd": {
        "hot_loop_bwd": (_i, [_vp] * 12 + [_i] * 6 + [_vp]),
        "hot_loop_bwd_smem_bytes": (ctypes.c_size_t, [_i] * 3),
        "hot_loop_bwd_fits": (_i, [_i] * 3),
        "hot_loop_bwd_scratch_bytes": (ctypes.c_size_t, [_i] * 5),
    },
    "fused_ll_fwd": {
        "fused_ll_fwd": (_i, [_vp] * 6 + [_i] * 4 + [_vp]),
        "fused_ll_fwd_smem_bytes": (ctypes.c_size_t, [_i]),
        "fused_ll_fwd_scratch_bytes": (ctypes.c_size_t, [_i] * 2),
        "fused_ll_fwd_cta_rows": (_i, [_i] * 2),
    },
    "fused_ll_bwd": {
        "fused_ll_bwd": (_i, [_vp] * 8 + [_i] * 4 + [_vp]),
        "fused_ll_bwd_smem_bytes": (ctypes.c_size_t, [_i]),
        "fused_ll_bwd_scratch_bytes": (ctypes.c_size_t, [_i] * 3),
        "fused_ll_bwd_cta_rows": (_i, [_i] * 2),
        "fused_ll_bwd_splits": (_i, [_i]),
    },
    "row_dense": {
        "row_dense": (_i, [_vp] * 4 + [_i] * 6 + [_vp]),
        "row_dense_int8": (_i, [_vp] * 5 + [_i] * 5 + [_vp]),
        "row_dense_ctas": (ctypes.c_longlong, [_i] * 5),
    },
    "latent_block": {
        "latent_block": (_i, [_vp] * 13 + [_i] * 5 + [ctypes.c_float, _vp]),
        "latent_block_smem_bytes": (ctypes.c_size_t, [_i] * 3),
        "latent_block_fits": (_i, [_i] * 2),
        "latent_block_scratch_bytes": (ctypes.c_size_t, [_i] * 3),
    },
    "row_sum": {
        "row_sum": (_i, [_vp, _vp, ctypes.c_longlong, _i, ctypes.c_longlong,
                         _vp]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: name -> (seconds the build took, nvcc's output) for builds in this process
build_log: Dict[str, Tuple[float, str]] = {}
#: the build directory in effect (None: not resolved yet, see build_dir)
_dir: Optional[Path] = None
#: libraries found built (hits), nvcc builds (misses) and the builds'
#: wall seconds, in this process
_cache_counts = {"hits": 0, "builds": 0, "build_seconds": 0.0}

#: the launch counters: one per library, plus the modes a library's wrapper
#: counts under their own names (``row_dense``'s int8-weight mode)
COUNTERS = tuple(SIGNATURES) + ("row_dense_int8",)

_count_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in COUNTERS}


_tls = threading.local()

#: set by the program auditor while it records a graph
#: (``analysis/audit/graphs.trace``): ``hook(name, meta)`` is a context
#: manager around each wrapper's plain version, which marks the ops
#: recorded inside it as kernel `name`'s. None otherwise.
_region_hook = None


@contextlib.contextmanager
def plain_region(name: str, **meta):
    """Around a wrapper's plain version on CPU tensors: nothing, unless the
    program auditor is recording, which then marks the recorded ops as
    kernel `name`'s, with `meta` (``flops``: the matmul FLOPs the kernel
    does where its plain version does them as elementwise ops)."""
    hook = _region_hook
    if hook is None:
        yield
        return
    with hook(name, meta):
        yield


def count(name: str) -> None:
    """Count one launch of kernel `name`; each wrapper calls it where it
    launches its kernel, and nowhere else."""
    with _count_lock:
        _launches[name] += 1
    tally = getattr(_tls, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def recording():
    """``{name: launches}`` this thread counts inside the block (a graph
    capture's launches, apart from other threads' launches meanwhile)."""
    prev = getattr(_tls, "tally", None)
    tally: Dict[str, int] = {}
    _tls.tally = tally
    try:
        yield tally
    finally:
        _tls.tally = prev


def launch_counts(names) -> Dict[str, int]:
    """``{name: launches}`` of the named kernels since their last
    :func:`reset_launch_counts`."""
    with _count_lock:
        return {name: _launches[name] for name in names}


def reset_launch_counts(names) -> None:
    with _count_lock:
        for name in names:
            _launches[name] = 0


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x `counts` to the launch counts: a CUDA-graph replay
    launches what its capture counted, and a capture itself launches
    nothing (``times=-1`` takes back what the wrappers counted while it
    was being recorded)."""
    with _count_lock:
        for name, n in counts.items():
            _launches[name] += times * n


def all_launch_counts() -> Dict[str, int]:
    """``{name: launches}`` of every kernel."""
    with _count_lock:
        return dict(_launches)


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


def _local_headers(src: bytes, seen: List[str]) -> List[str]:
    """The ``csrc/`` headers `src` includes, and the ones they include, each
    once, in the order first met."""
    for h in re.findall(rb'#include "([^"]+)"', src):
        name = h.decode()
        if name not in seen:
            seen.append(name)
            _local_headers((SRC_DIR / name).read_bytes(), seen)
    return seen


def resolve_build_dir(cache_dir: Optional[str] = None) -> Optional[Path]:
    """The directory `cache_dir` names under the module docstring's rules:
    `cache_dir`, else ``$IWAE_COMPILE_CACHE``, else :data:`BUILD_DIR`;
    None for ``off``/``none``/``0`` (a fresh private directory)."""
    value = cache_dir if cache_dir is not None else os.environ.get(CACHE_ENV)
    if not value:
        return BUILD_DIR
    if value.strip().lower() in _CACHE_OFF:
        return None
    return Path(os.path.abspath(os.path.expanduser(value)))


def _made(want: Optional[Path]) -> Path:
    """`want`, or for None a fresh private directory removed at exit."""
    if want is not None:
        return want
    d = Path(tempfile.mkdtemp(prefix="iwae_kernels_"))
    atexit.register(shutil.rmtree, d, True)
    return d


def use_build_dir(cache_dir: Optional[str] = None, say=print) -> Path:
    """Build into and load from the directory `cache_dir` resolves to
    (:func:`resolve_build_dir`; off: a fresh private one) and return it.
    Once a library is loaded the directory in effect stays, and a call that
    names another one says so and returns the one in effect."""
    global _dir
    want = resolve_build_dir(cache_dir)
    with _lock:
        if _libs:
            if want != _dir:
                say(f"note: kernel libraries are already loaded from {_dir}; "
                    f"they stay loaded from there, and "
                    f"{'a private directory' if want is None else want} is "
                    f"not used in this process")
            return _dir
        _dir = _made(want)
        return _dir


def build_dir() -> Path:
    """The build directory in effect (resolved from ``$IWAE_COMPILE_CACHE``
    or the default on first use when :func:`use_build_dir` was not
    called)."""
    global _dir
    if _dir is None:
        _dir = _made(resolve_build_dir(None))
    return _dir


def cache_counts() -> Dict[str, float]:
    """``hits`` (libraries found built on disk), ``builds`` (``nvcc``
    runs) and ``build_seconds`` (their wall seconds) in this process."""
    with _count_lock:
        return dict(_cache_counts)


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for the current source,
    in the build directory in effect."""
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    headers = _local_headers(src, [])
    digest = hashlib.sha256(
        src + b"".join((SRC_DIR / h).read_bytes() for h in headers)
        + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, Path]]:
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library exists."""
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
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
    built = sum(job is not None for job in started.values())
    with _count_lock:
        _cache_counts["hits"] += len(started) - built
        _cache_counts["builds"] += built
        if built:
            _cache_counts["build_seconds"] += time.perf_counter() - t0
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


def load_fitting(name: str, *widths: int) -> ctypes.CDLL:
    """:func:`load`, after checking with the library's
    ``<name>_smem_bytes(*widths)`` that the kernel's tiles fit a Hopper
    CTA's shared memory at these widths (a launch above it would be
    refused)."""
    lib = load(name)
    smem = getattr(lib, f"{name}_smem_bytes")(*widths)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name} needs {smem} bytes of shared memory for "
                         f"widths {widths}; a Hopper CTA has "
                         f"{MAX_SMEM_BYTES}")
    return lib


@functools.lru_cache(maxsize=128)
def plan(name: str, widths: tuple, scratch_args: tuple) -> tuple:
    """``(C entry point, scratch bytes)`` of kernel `name`: the library's
    ``<name>_scratch_bytes(*scratch_args)``, after :func:`load_fitting`'s
    shared-memory check at `widths`. Host work that every call of the same
    shape would repeat, cached."""
    lib = load_fitting(name, *widths)
    return (getattr(lib, name),
            getattr(lib, f"{name}_scratch_bytes")(*scratch_args))


@functools.lru_cache(maxsize=None)
def entry(name: str, fn: Optional[str] = None):
    """The C entry point `fn` (default: ``name``) of ``csrc/<name>.cu``'s
    library, loaded (and built) once: later calls take no lock."""
    return getattr(load(name), fn or name)


def launch(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)``: a kernel library's C entry point on `device`'s
    current stream, with `device` made the current device around the call
    where it is not already (a launch goes to the current device's
    context). Returns the entry point's CUDA error code. The stream comes
    from torch's raw-stream binding, what its own generated kernels launch
    with: it builds no ``torch.cuda.Stream`` object, a few microseconds per
    call less."""
    stream = torch._C._cuda_getCurrentRawStream
    if device.index == torch.cuda.current_device():
        return fn(*args, stream(device.index))
    with torch.cuda.device(device):
        return fn(*args, stream(device.index))


def check_tensor(name: str, t, shape, device) -> None:
    """Raise unless `t` is a contiguous fp32 tensor of `shape` on `device`:
    what every kernel's C interface takes."""
    if (t.device == device and t.dtype == torch.float32 and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
