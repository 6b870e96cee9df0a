"""Build and bind the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface under
``racon_tpu_torch/build/cuda`` (ignored by git) the first time it is
needed, and loaded with ctypes.  A library newer than its source is
reused.  Several sources build in parallel (one ``nvcc`` each).

The process registry counts ``cuda_kernel_builds`` (an ``nvcc`` run)
and ``cuda_kernel_loads`` (a library bound in this process); the serve
tier reports each job's delta of both, so a warm daemon's jobs show 0.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, List

from racon_tpu_torch.obs.metrics import REGISTRY
from racon_tpu_torch.obs.trace import now

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "cuda", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "cuda")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

#: kernel sources, by library name
SOURCES = {"poa_full": "poa_full.cu", "align_wfa": "align_wfa.cu",
           "align_band": "align_band.cu", "seed_words": "seed_words.cu"}

_VP, _I = ctypes.c_void_p, ctypes.c_int
#: argument types of each library's ``<name>_launch`` (pointers and the
#: stream as c_void_p, so ctypes never cuts them to 32 bits)
SIGNATURES = {
    "poa_full": [_VP] * 10 + [ctypes.c_longlong] + [_I] * 16 + [_VP],
    "align_wfa": [_VP] * 9 + [_I] * 5 + [_VP],
    "align_band": [_VP] * 9 + [_I] * 7 + [_VP],
    "seed_words": [_VP] * 3 + [ctypes.c_longlong, _I, _VP],
}

#: other C functions of a library: name -> (argument types, result)
EXTRA = {"poa_full": {"poa_full_slots": ([_I] * 3, _I)},
         "align_wfa": {"align_wfa_slots": ([_I] * 3, _I),
                       "align_wfa_smem": ([_I] * 2, _I),
                       "align_wfa_warps": ([_I], _I)},
         "align_band": {"align_band_slots": ([_I] * 2, _I),
                        "align_band_smem": ([_I] * 2, _I),
                        "align_band_warps": ([_I] * 2, _I)}}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: per-library build record: seconds and the ptxas resource report
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("[racon_tpu_torch::cuda] nvcc not found: the CUDA "
                       "kernels are built on a machine with the CUDA "
                       "toolkit")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _start(name: str):
    """Start one nvcc; returns (Popen, t0) or None when up to date."""
    src = os.path.join(CSRC_DIR, SOURCES[name])
    out = lib_path(name)
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(src):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out + ".tmp", src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), \
        now()


def build_all(names: List[str] = None) -> Dict[str, dict]:
    """Build the named kernels (default: all), every nvcc started
    before any is waited on.  Raises on a failed build."""
    names = list(SOURCES) if names is None else names
    procs = {n: _start(n) for n in names}
    errors = []
    for n, started in procs.items():
        if started is None:
            # built by an earlier process: its ptxas report was kept
            # beside the library
            if n not in BUILD_LOG:
                try:
                    with open(lib_path(n) + ".ptxas") as fh:
                        report = fh.read()
                except OSError:
                    report = "cached"
                BUILD_LOG[n] = {"seconds": 0.0, "ptxas": report}
            continue
        proc, t0 = started
        log, _ = proc.communicate()
        REGISTRY.add("cuda_kernel_builds")
        if proc.returncode != 0:
            errors.append(f"{n}:\n{log}")
            continue
        with open(lib_path(n) + ".ptxas", "w") as fh:
            fh.write(log.strip())
        os.replace(lib_path(n) + ".tmp", lib_path(n))
        BUILD_LOG[n] = {"seconds": now() - t0,
                        "ptxas": log.strip()}
    if errors:
        raise RuntimeError("[racon_tpu_torch::cuda] nvcc failed:\n"
                           + "\n".join(errors))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The bound library of one kernel, built at first use."""
    with _lock:
        if name in _libs:
            return _libs[name]
        build_all([name])
        lib = ctypes.CDLL(lib_path(name))
        launch = getattr(lib, f"{name}_launch")
        launch.restype = _I
        launch.argtypes = SIGNATURES[name]
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [_I]
        for fn, (argtypes, restype) in EXTRA.get(name, {}).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        REGISTRY.add("cuda_kernel_loads")
        return lib


#: prefix of each kernel's launch counter in the process registry
LAUNCH_COUNTER = "cuda_kernel_launches."


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name``.  Its wrapper calls this
    where it launches the kernel and nowhere else (a plain-version call
    is no launch); the serve tier's per-job deltas, the fleet scrape and
    chip_smoke.py read the counters."""
    REGISTRY.add(LAUNCH_COUNTER + name)


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process now."""
    return {name: int(REGISTRY.value(LAUNCH_COUNTER + name, 0))
            for name in SOURCES}


def zero_launch_counts() -> None:
    """Set every kernel's launch count to 0: an in-process caller that
    counts one run from 0 (a daemon never does)."""
    for name in SOURCES:
        REGISTRY.zero(LAUNCH_COUNTER + name)


def error_string(name: str, err: int) -> str:
    return getattr(load(name), f"{name}_error_string")(err).decode()
