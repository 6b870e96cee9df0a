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
  single-rate stage; a pinned stage stores nothing;
* the serve daemon freezes the store for its lifetime
  (``RACON_TPU_TORCH_CALIB_FREEZE``: jobs read rates, never store
  them) and journals each job's :func:`epoch_snapshot` at admission,
  which a resumed job passes back as ``get_rates(..., pin=...)``;
  a drift epoch (``RACON_TPU_TORCH_CALIB_DRIFT_EPOCH=1``) lifts the
  freeze for one two-pass recalibration between jobs.

:func:`predict_walls` is the serve tier's admission price.

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


def epoch_snapshot() -> dict:
    """The persisted store as one pinnable value: ``{"epoch": <12-hex
    hash of the file, or "none">, "data": <the parsed file, or {}>}``.
    The serve tier journals it at a job's admission, so a job resumed
    after a restart prices its splits at the rates it was admitted
    under, however the store moved in between."""
    path = _calib_path()
    if path is None:
        return {"epoch": "none", "data": {}}
    with _lock:
        try:
            with open(path, "rb") as f:
                raw = f.read()
            data = json.loads(raw)
        except Exception:
            return {"epoch": "none", "data": {}}
    return {"epoch": hashlib.sha1(raw).hexdigest()[:12],
            "data": data if isinstance(data, dict) else {}}


def _entry_rates(ent, default_dev, default_cpu, source) -> tuple:
    cpu = ent.get("cpu", default_cpu)
    return (float(ent.get("dev", default_dev)),
            None if cpu is None else float(cpu), source)


def get_rates(stage: str, device, default_dev: float,
              default_cpu: float = None, pin: dict = None) -> tuple:
    """(dev_rate, cpu_rate, source) of a hybrid stage; a single-rate
    stage (``default_cpu`` None) gives (rate, None, source).
    Precedence: env pin (source "env") > the job's ``pin``, the
    ``data`` of an :func:`epoch_snapshot` ("pinned") > persisted
    calibration ("calibrated") > defaults ("default").  The file is
    read on every call (it is tiny), so a process that polishes several
    times adopts its own measurements as they land; within one polish
    each stage reads its rates once."""
    env_dev = os.environ.get(f"RACON_TPU_TORCH_RATE_{stage.upper()}_DEV")
    env_cpu = os.environ.get(f"RACON_TPU_TORCH_RATE_{stage.upper()}_CPU")
    if env_dev and default_cpu is None:
        return (float(env_dev), None, "env")
    if env_dev and env_cpu:
        return (float(env_dev), float(env_cpu), "env")
    if isinstance(pin, dict):
        ent = pin.get(_machine_key(device))
        ent = ent.get(stage) if isinstance(ent, dict) else None
        if isinstance(ent, dict):
            return _entry_rates(ent, default_dev, default_cpu, "pinned")
    out = (default_dev, default_cpu, "default")
    path = _calib_path()
    if not os.environ.get("RACON_TPU_TORCH_RECALIBRATE") and path:
        with _lock:
            try:
                with open(path) as f:
                    data = json.load(f)
                ent = data.get(_machine_key(device), {}).get(stage)
                if ent:
                    out = _entry_rates(ent, default_dev, default_cpu,
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
    if os.environ.get("RACON_TPU_TORCH_CALIB_FREEZE") \
            and not _drift["open"]:
        # a serve daemon: a job's split is a pure function of the
        # store as the daemon found it, so jobs never store (unless a
        # drift epoch is open)
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
            restart = False
            if _drift["open"] and stage not in _drift["fresh"]:
                # a drift epoch's first store of a stage overwrites the
                # frozen entry and restarts its two-pass sequence
                recal = restart = True
                _drift["fresh"].add(stage)
            old_real = old and not old.get("provisional")
            if old_real and old.get("gen", 1) >= 2 and not recal:
                return
            if provisional and old_real and not recal:
                return
            if provisional or restart:
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


def predict_walls(align_s: float, poa_s: float, overlap_s: float = None,
                  concurrency: int = 1, occupancy: float = None,
                  hit_ratio: float = None) -> dict:
    """The serve tier's admission price of a polish whose stages take
    ``align_s`` and ``poa_s`` alone (the JAX package's model,
    racon_tpu/utils/calibrate.py:176): additive wall, the overlapped
    floor max(align, poa) and, given the pipeline's ``overlap_s``, the
    predicted wall between them.  ``concurrency`` > 1 adds
    ``shared_wall_s``: each other job sharing the card adds up to one
    floor, discounted by the measured mean fusion ``occupancy``.
    ``hit_ratio``, the result cache's observed hit ratio, discounts
    every wall (to at most 90%).  Policy only: it moves admission,
    never bytes."""
    out = {"additive_wall_s": round(align_s + poa_s, 3),
           "overlapped_floor_s": round(max(align_s, poa_s), 3)}
    if overlap_s is not None:
        overlap_s = max(0.0, min(float(overlap_s), min(align_s, poa_s)))
        out["predicted_wall_s"] = round(
            max(max(align_s, poa_s), align_s + poa_s - overlap_s), 3)
        hideable = min(align_s, poa_s)
        out["overlap_efficiency"] = round(
            overlap_s / hideable, 3) if hideable > 0 else 0.0
    n = max(1, int(concurrency))
    if n > 1:
        occ = min(1.0, max(0.0, occupancy or 0.0))
        base = out.get("predicted_wall_s", out["additive_wall_s"])
        out["shared_wall_s"] = round(
            base + (n - 1) * out["overlapped_floor_s"] / (1.0 + occ), 3)
        out["shared_concurrency"] = n
        out["fusion_occupancy"] = round(occ, 3)
    if hit_ratio is not None and hit_ratio > 0:
        hr = min(1.0, max(0.0, float(hit_ratio)))
        discount = max(0.1, 1.0 - hr)
        out["cache_hit_ratio"] = round(hr, 4)
        for term in ("predicted_wall_s", "shared_wall_s",
                     "overlapped_floor_s"):
            if term in out:
                out["undiscounted_" + term] = out[term]
                out[term] = round(out[term] * discount, 3)
    return out


# -- drift epochs ---------------------------------------------------------
#
# A serve daemon freezes the store for its lifetime
# (RACON_TPU_TORCH_CALIB_FREEZE).  When obs.calhealth says the frozen
# rates price a stage badly, the scheduler may open a drift epoch
# (RACON_TPU_TORCH_CALIB_DRIFT_EPOCH=1) at a job boundary: the freeze
# lifts for one two-pass recalibration, then closes.  Jobs admitted
# before keep their journaled epoch pins, so no running job's rates
# move.

_drift = {"open": False, "jobs": 0, "fresh": set()}

#: job boundaries a drift epoch stays open for (store_rates' two passes)
DRIFT_EPOCH_JOBS = 2


def drift_epoch_enabled() -> bool:
    return os.environ.get("RACON_TPU_TORCH_CALIB_DRIFT_EPOCH", "0") == "1"


def open_drift_epoch() -> bool:
    """Open a recalibration epoch; True when this call opened it."""
    with _lock:
        if _drift["open"]:
            return False
        _drift.update(open=True, jobs=0, fresh=set())
        return True


def note_drift_job() -> bool:
    """Count one finished job against the open epoch; True when this
    call closed it."""
    with _lock:
        if not _drift["open"]:
            return False
        _drift["jobs"] += 1
        if _drift["jobs"] >= DRIFT_EPOCH_JOBS:
            _drift["open"] = False
            return True
        return False


def drift_epoch_state() -> dict:
    with _lock:
        return {"open": _drift["open"], "jobs": _drift["jobs"]}


def reset_drift() -> None:
    with _lock:
        _drift.update(open=False, jobs=0, fresh=set())
