"""Measured rates of the hybrid device/CPU splits.

The CUDA polisher splits each hybrid stage (POA, overlap alignment)
between the card and the CPU workers with a deterministic rate-model
argmin over per-item costs (``cuda/polisher.py:_rate_split``).  The
rates that price it are measured here, the port's own copy of the JAX
package's store (racon_tpu/utils/calibrate.py):

* every run measures both engines (work units over busy wall) and
  persists the rates per machine key (the torch device's name, the
  device and CPU counts, and a hash of the sources whose code runs in
  the measured walls: the kernels, the native engines and the host
  modules around them) in
  ``calibration.json`` under ``RACON_TPU_TORCH_CACHE_DIR`` (unset:
  ``~/.cache/racon_tpu_torch``; empty: no store at all);
* stores are two-pass-then-frozen: the first measurement runs under the
  default split, one refinement follows, then the entry freezes, so
  later runs split a given input the same way and emit the same bytes
  (``RACON_TPU_TORCH_RECALIBRATE=1`` overwrites);
* ``RACON_TPU_TORCH_RATE_<STAGE>_{DEV,CPU}`` pin both rates of a stage
  exactly, ``RACON_TPU_TORCH_RATE_<STAGE>_DEV`` alone the rate of a
  single-rate stage; a pinned stage stores nothing.

Stages: ``poa`` (us per cost unit, device and CPU), ``align`` (band
kernel, ns per query row, and the native aligner's ns per modeled cell
when pinned), and the single-rate ``align_wfa`` (WFA kernel, ns per
wavefront step) and ``align_cpu`` (native aligner, ns per modeled
cell).

A rate is busy time per unit: for the card, the larger of a dispatch's
CUDA-event kernel time and the issuing thread's CPU time from one
collect to the next; for the CPU workers, their thread CPU time.  Time
a thread spends waiting for the interpreter lock is in neither, so
host work running beside a stage does not price its next split.
"""

from __future__ import annotations

import glob
import hashlib
import json
import math
import os
import threading

_lock = threading.Lock()

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the sources whose code runs inside a measured wall
_SALTED = ("cuda/csrc/*.cu", "cuda/*.py", "core/*.py", "convert.py",
           "native/*.cpp", "native/*.hpp")
#: share of a split's CPU workers held back for the host's data plane
HOST_RESERVE = 0.25


def cache_root():
    """The port's cache root: ``RACON_TPU_TORCH_CACHE_DIR``; unset ->
    ``~/.cache/racon_tpu_torch``; empty (or an unexpanded ``~``) ->
    None, the store is off."""
    path = os.environ.get(
        "RACON_TPU_TORCH_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "racon_tpu_torch"))
    if not path or path.startswith("~"):
        return None
    return path.rstrip("/") or None


def _calib_path():
    root = cache_root()
    if root is None:
        return None
    return os.path.join(root, "calibration.json")


def _code_salt(patterns=_SALTED) -> str:
    """Hash of the sources that ``patterns`` name (by default the
    kernels', the native engines' and the host modules'): rates
    measured for one generation of the code must not price another's
    split."""
    h = hashlib.sha1()
    paths = sorted({p for pat in patterns
                    for p in glob.glob(os.path.join(_PKG, pat))})
    for path in paths:
        with open(path, "rb") as fh:
            h.update(os.path.relpath(path, _PKG).encode())
            h.update(fh.read())
    return h.hexdigest()[:8]


def _machine_key(device) -> str:
    """``cuda-<card name>-<n>dev-<m>cpu-<salt>``, or ``cpu-1dev-...``
    for a run on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        plat = "cuda-" + torch.cuda.get_device_name(dev).replace(" ", "_")
        n_dev = torch.cuda.device_count()
    else:
        plat, n_dev = "cpu", 1
    return f"{plat}-{n_dev}dev-{os.cpu_count()}cpu-{_code_salt()}"


def get_rates(stage: str, device, default_dev: float,
              default_cpu: float = None) -> tuple:
    """(dev_rate, cpu_rate, source) of a hybrid stage; a single-rate
    stage (``default_cpu`` None) gives (rate, None, source).
    Precedence: env pin (source "env") > persisted calibration
    ("calibrated") > defaults ("default").  The file is read on every
    call (it is tiny), so a process that polishes several times adopts
    its own measurements as they land; within one polish each stage
    reads its rates once."""
    env_dev = os.environ.get(f"RACON_TPU_TORCH_RATE_{stage.upper()}_DEV")
    env_cpu = os.environ.get(f"RACON_TPU_TORCH_RATE_{stage.upper()}_CPU")
    if env_dev and default_cpu is None:
        return (float(env_dev), None, "env")
    if env_dev and env_cpu:
        return (float(env_dev), float(env_cpu), "env")
    out = (default_dev, default_cpu, "default")
    path = _calib_path()
    if not os.environ.get("RACON_TPU_TORCH_RECALIBRATE") and path:
        with _lock:
            try:
                with open(path) as f:
                    data = json.load(f)
                ent = data.get(_machine_key(device), {}).get(stage)
                if ent:
                    cpu = ent.get("cpu", default_cpu)
                    out = (float(ent.get("dev", default_dev)),
                           None if cpu is None else float(cpu),
                           "calibrated")
            except Exception:
                pass
    return out


def host_reserved_workers(n_workers: int, source: str) -> int:
    """CPU workers a split prices its CPU tail over: the host also runs
    the data plane (breaking-point decode, window routing, megabatch
    packing), so ``HOST_RESERVE`` of them are held back.  A constant,
    never a measured time, so the split stays a pure function of the
    input; under env-pinned rates the count passes through
    unchanged."""
    if source == "env" or n_workers <= 0:
        return n_workers
    return max(1, n_workers - math.ceil(n_workers * HOST_RESERVE))


#: device-rate unit scale per stage: "poa" stores us per unit, the
#: align stages ns per unit
RATE_SCALE_S = {"poa": 1e-6, "align": 1e-9, "align_wfa": 1e-9}


def predict_chunk_wall(stage: str, units: float, dev_rate: float,
                       n_dev: int = 1) -> float:
    """Predicted device wall (seconds) of one dispatch of ``units`` at
    ``dev_rate`` (the stage's native scale): the inverse of the
    measurement ``store_rates`` persists."""
    scale = RATE_SCALE_S.get(stage, 1e-9)
    return float(units) * float(dev_rate) * scale / max(1, int(n_dev))


def store_rates(stage: str, device, dev_rate: float, cpu_rate=None,
                provisional: bool = False) -> None:
    """Persist measured rates, two-pass-then-frozen per machine key and
    stage (``RACON_TPU_TORCH_RECALIBRATE=1`` always overwrites).
    ``cpu_rate=None`` stores the device rate alone (the stage's CPU
    rate then comes from its default).  A ``provisional`` sample (one
    megabatch, whose interval carries the whole dispatch latency) stays
    at generation 1, never freezes the entry and never replaces a
    non-provisional one.  Never raises."""
    if not dev_rate > 0 or (cpu_rate is not None and not cpu_rate > 0):
        return
    try:
        path = _calib_path()
        if path is None:
            return
        mkey = _machine_key(device)
        with _lock:
            data = {}
            try:
                with open(path) as f:
                    data = json.load(f)
            except Exception:
                pass
            ent = data.setdefault(mkey, {})
            old = ent.get(stage)
            recal = os.environ.get("RACON_TPU_TORCH_RECALIBRATE")
            old_real = old and not old.get("provisional")
            if old_real and old.get("gen", 1) >= 2 and not recal:
                return
            if provisional and old_real and not recal:
                return
            if provisional:
                gen = 1
            else:
                # a real sample after provisional ones starts its own
                # two-pass sequence at generation 1
                gen = old.get("gen", 1) + 1 if old_real else 1
            ent[stage] = {"dev": round(dev_rate, 4), "gen": gen}
            if provisional:
                ent[stage]["provisional"] = True
            if cpu_rate is not None:
                ent[stage]["cpu"] = round(cpu_rate, 4)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, path)
    except Exception:
        pass
