"""Per-run provenance and the ``--metrics-json`` run report (JAX
package: racon_tpu/obs/provenance.py).

:func:`write_metrics_json` writes one self-describing JSON document::

    {"schema": "racon-tpu-torch-metrics-v1",
     "environment": {"knobs", "torch", "host"},
     "run": <the polisher's registry snapshot>,
     "process": <the global registry snapshot>,
     "device_util": <obs/devutil.py snapshot>,
     "details": {...}}

with the JAX report's top-level keys; ``environment.torch`` takes the
place of its ``environment.jax``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SCHEMA = "racon-tpu-torch-metrics-v1"

#: every environment variable the port reads, with its default as the
#: code resolves it ("" = unset).  Swept with any other
#: RACON_TPU_TORCH_* in the environment (the RATE_* pins among them).
KNOWN_KNOBS = {
    "RACON_TPU_TORCH_PIPELINE": "1",
    "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "",
    "RACON_TPU_TORCH_POA_DEVICE_ONLY": "",
    "RACON_TPU_TORCH_ALIGN_SPLIT": "",
    "RACON_TPU_TORCH_POA_SPLIT": "",
    "RACON_TPU_TORCH_MAX_ALIGN_DIM": "16384",
    "RACON_TPU_TORCH_WFA_MAX_MB": "256",
    "RACON_TPU_TORCH_CACHE_DIR": "",
    "RACON_TPU_TORCH_RECALIBRATE": "",
    # result cache (racon_tpu_torch/cache/): off-switch, in-process LRU
    # budget in MB, and the shared persistent tier ("1" =
    # <cache_root()>/results, any other non-empty value = that
    # directory).  Policy only: they never change output bytes, so
    # cache/keying.py leaves them out of the engine epoch that keys
    # every cached result.
    "RACON_TPU_TORCH_CACHE": "1",
    "RACON_TPU_TORCH_CACHE_MB": "256",
    "RACON_TPU_TORCH_CACHE_PERSIST": "",
    # the device executor (racon_tpu_torch/cuda/executor.py): fusion
    # off-switch, fusion with one tenant too, the fusion window, the
    # per-tenant in-flight quota, and the adaptive fusion window.  The
    # adaptive window moves when a bucket dispatches, never what it
    # computes, so cache/keying.py leaves it out of the epoch; the
    # others stay in it, as in the JAX package.
    "RACON_TPU_TORCH_FUSE": "1",
    "RACON_TPU_TORCH_FUSE_FORCE": "0",
    "RACON_TPU_TORCH_FUSE_WAIT_MS": "5",
    "RACON_TPU_TORCH_SERVE_TENANT_QUOTA": "2",
    "RACON_TPU_TORCH_FUSE_ADAPT": "0",
    "RACON_TPU_TORCH_TRACE": "",
    "RACON_TPU_TORCH_METRICS_JSON": "",
    "RACON_TPU_TORCH_FLIGHT_DUMP": "",
    # the mapper (overlap/chain.py), read when no overlaps file is
    # given: k/w/occ/min-chain/band/max-gap change which overlaps exist;
    # DEVICE_SEED only moves the word build (1: the polisher's device,
    # numpy for the plain CPU Polisher; 0: numpy), with equal words
    "RACON_TPU_TORCH_MAP_K": "13",
    "RACON_TPU_TORCH_MAP_W": "5",
    "RACON_TPU_TORCH_MAP_OCC": "64",
    "RACON_TPU_TORCH_MAP_MIN_CHAIN": "4",
    "RACON_TPU_TORCH_MAP_BAND": "500",
    "RACON_TPU_TORCH_MAP_MAX_GAP": "10000",
    "RACON_TPU_TORCH_MAP_DEVICE_SEED": "1",
    # POA windows per megabatch at most (0: sized from free memory
    # alone); bytes are the same at any cap
    "RACON_TPU_TORCH_POA_MEGABATCH": "0",
    # the serve daemon (racon_tpu_torch/serve/): workers, queue bound,
    # the admission price's wall cap and byte-rate priors, idle
    # self-shutdown, the telemetry sampler, the deadline classes, and
    # the calibration freeze serve_forever sets (with the drift epochs
    # that lift it for one recalibration)
    "RACON_TPU_TORCH_SERVE_JOBS": "2",
    "RACON_TPU_TORCH_SERVE_QUEUE": "8",
    "RACON_TPU_TORCH_SERVE_MAX_WALL_S": "",
    "RACON_TPU_TORCH_SERVE_ALIGN_MBPS": "4.0",
    "RACON_TPU_TORCH_SERVE_POA_MBPS": "2.0",
    "RACON_TPU_TORCH_SERVE_MAP_MBPS": "8.0",
    "RACON_TPU_TORCH_SERVE_IDLE_S": "0",
    "RACON_TPU_TORCH_SERVE_SAMPLE_S": "0",
    "RACON_TPU_TORCH_CLASS_TARGET_P99_S": "2.0",
    "RACON_TPU_TORCH_CLASS_HEADROOM": "0.125",
    "RACON_TPU_TORCH_CALIB_FREEZE": "",
    "RACON_TPU_TORCH_CALIB_DRIFT_EPOCH": "0",
    # the write-ahead journal ("0" off; its directory, default the
    # socket's; fsync per record) and the crash-site harness
    "RACON_TPU_TORCH_JOURNAL": "1",
    "RACON_TPU_TORCH_JOURNAL_DIR": "",
    "RACON_TPU_TORCH_JOURNAL_FSYNC": "1",
    "RACON_TPU_TORCH_FAULT": "",
    # the fleet (racon_tpu_torch/serve/router.py, scatter.py, fleet.py,
    # io/staging.py, parallel/multihost.py): the router's probe period
    # and timeout, its breakers, content-affinity pricing and TCP front;
    # the scatter threshold, shard cap and straggler factor; staged
    # parsing; the fleet scrape's period, timeout and staleness; and the
    # target-sharded ranks.  They steer placement only (a shard's or a
    # rank's bytes are a slice of the same stream), so cache/keying.py
    # leaves them all out of the epoch.
    "RACON_TPU_TORCH_ROUTE_PROBE_S": "1.0",
    "RACON_TPU_TORCH_ROUTE_PROBE_TIMEOUT_S": "2.0",
    "RACON_TPU_TORCH_ROUTE_BREAKER_FAILS": "3",
    "RACON_TPU_TORCH_ROUTE_BREAKER_COOLDOWN_S": "5.0",
    "RACON_TPU_TORCH_ROUTE_AFFINITY": "1",
    "RACON_TPU_TORCH_ROUTE_TCP": "",
    "RACON_TPU_TORCH_SCATTER_MIN_WALL_S": "",
    "RACON_TPU_TORCH_SCATTER_MAX_SHARDS": "8",
    "RACON_TPU_TORCH_SCATTER_REBALANCE": "2.5",
    "RACON_TPU_TORCH_STAGE": "1",
    "RACON_TPU_TORCH_FLEET_INTERVAL_S": "1.0",
    "RACON_TPU_TORCH_FLEET_TIMEOUT_S": "5.0",
    "RACON_TPU_TORCH_FLEET_STALE_S": "10.0",
    "RACON_TPU_TORCH_NPROC": "1",
    "RACON_TPU_TORCH_RANK": "0",
    "RACON_TPU_TORCH_COORD": "",
}

_probe_cache: list = []


def resolved_knobs() -> dict:
    """Every RACON_TPU_TORCH_* knob with its resolved value and
    source."""
    names = set(KNOWN_KNOBS)
    names.update(k for k in os.environ if k.startswith("RACON_TPU_TORCH_"))
    out = {}
    for name in sorted(names):
        env = os.environ.get(name)
        out[name] = {"value": env if env is not None
                     else KNOWN_KNOBS.get(name, ""),
                     "source": "env" if env is not None else "default"}
    return out


def card_line():
    """The cards as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (one entry per card), or None
    where there is no nvidia-smi."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    return lines if res.returncode == 0 and lines else None


def torch_info() -> dict:
    """torch and CUDA versions, and the card's name and power limit."""
    import torch

    out = {"version": torch.__version__, "cuda": torch.version.cuda,
           "cuda_available": torch.cuda.is_available()}
    if out["cuda_available"]:
        out["device_count"] = torch.cuda.device_count()
        out["device"] = torch.cuda.get_device_name(0)
        out["card"] = card_line()
    return out


def host_probe() -> dict:
    """Host capability: best-of-3 wall of a fixed native edit-distance
    probe (100 kb pair, 10% divergence, seeded) on the port's native
    engine.  Cached per process; a failure is reported in the result,
    not raised."""
    if _probe_cache:
        return _probe_cache[0]
    from racon_tpu_torch.obs.trace import now

    out = {}
    try:
        import numpy as np

        from racon_tpu_torch.ops import cpu

        rng = np.random.default_rng(42)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        g = acgt[rng.integers(0, 4, 100_000)]
        m = g.copy()
        idx = rng.random(len(m)) < 0.10
        m[idx] = acgt[rng.integers(0, 4, int(idx.sum()))]
        q, t = g.tobytes(), m.tobytes()
        cpu.get_library()             # build outside the timing
        best = None
        for _ in range(3):
            t0 = now()
            cpu.edit_distance(q, t)
            dt = now() - t0
            best = dt if best is None else min(best, dt)
        out["probe_wall_s"] = round(best, 4)
    except (OSError, RuntimeError) as exc:
        out["error"] = f"{type(exc).__name__}: {exc}"
    _probe_cache.append(out)
    return out


_identity_cache: dict = {}


def daemon_identity(socket_path: str = None) -> dict:
    """The serve daemon's identity block, on every ``status``,
    ``metrics``, ``health`` and ``watch`` frame: ``daemon_id`` hashes
    host, socket, pid and start time, so a socket path reused by a
    restarted daemon never reads as the same process.  The start time
    is a wall-clock stamp, an identifier and not a measurement."""
    import hashlib
    import socket as _socket

    from racon_tpu_torch import __version__
    from racon_tpu_torch.obs.trace import wall_now

    key = socket_path or ""
    if key not in _identity_cache:
        host = _socket.gethostname()
        start = wall_now()
        raw = f"{host}|{key}|{os.getpid()}|{start:.6f}"
        _identity_cache[key] = {
            "daemon_id": hashlib.sha1(raw.encode()).hexdigest()[:12],
            "host": host, "pid": os.getpid(), "socket": key or None,
            "start_epoch": round(start, 3), "version": __version__,
            "backend": "torch"}
    return dict(_identity_cache[key])


def environment(probe: bool = True) -> dict:
    env = {"knobs": resolved_knobs(), "torch": torch_info(),
           "host": {"cpu_count": os.cpu_count(), "platform": sys.platform}}
    if probe:
        env["host"]["capability_probe"] = host_probe()
    return env


def metrics_doc(run_registry=None, details=None, probe: bool = True,
                device_util=None) -> dict:
    """The run report as a dict (what ``--metrics-json`` writes);
    ``device_util`` is the run's ``DeviceUtil`` (default the process's
    ``DEVICE_UTIL``)."""
    from racon_tpu_torch.obs.devutil import DEVICE_UTIL
    from racon_tpu_torch.obs.metrics import REGISTRY

    doc = {"schema": SCHEMA,
           "environment": environment(probe=probe),
           "run": (run_registry.snapshot()
                   if run_registry is not None else None),
           "process": REGISTRY.snapshot(),
           "device_util": (DEVICE_UTIL if device_util is None
                           else device_util).snapshot()}
    if details:
        doc["details"] = details
    return doc


def write_metrics_json(path: str, run_registry=None, details=None,
                       probe: bool = True, device_util=None) -> str:
    """Write the run report (atomic replace); returns ``path``."""
    doc = metrics_doc(run_registry=run_registry, details=details,
                      probe=probe, device_util=device_util)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
    os.replace(tmp, path)
    return path
