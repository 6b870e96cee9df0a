"""Traces and metrics of the port (JAX package: racon_tpu/obs/).

* :mod:`~racon_tpu_torch.obs.trace` -- thread-safe span tracer writing
  Chrome trace-event JSON (Perfetto, ``chrome://tracing``): stage spans
  nested per thread, and a virtual ``device`` lane of every kernel
  dispatch, timed on the card by CUDA events;
* :mod:`~racon_tpu_torch.obs.metrics` -- process-wide registry of
  counters, gauges and histograms, with a per-run child per polisher;
* :mod:`~racon_tpu_torch.obs.devutil` -- per-engine device busy and
  idle time from the dispatch intervals;
* :mod:`~racon_tpu_torch.obs.decision` -- bounded ring of placement
  decisions (splits, ladder chunks, retries, rejects);
* :mod:`~racon_tpu_torch.obs.calhealth` -- per-stage drift of measured
  against predicted walls;
* :mod:`~racon_tpu_torch.obs.flight` -- bounded event ring the CLI dumps
  at exit and on a crash;
* :mod:`~racon_tpu_torch.obs.provenance` -- resolved knobs, torch and
  card facts, and the ``--metrics-json`` run report;
* :mod:`~racon_tpu_torch.obs.context` -- the job context that tags
  what is recorded under it;
* :mod:`~racon_tpu_torch.obs.aggregate` -- the exact merge of several
  processes' registry snapshots (the fleet scrape's);
* :mod:`~racon_tpu_torch.obs.assemble` -- one job's lineage across the
  fleet's daemons, its timeline and its merged trace (``inspect
  --fleet``).

Clocks here feed only the trace and the metrics, never control flow: a
traced run writes the same bytes as an untraced one.  All timing in
``racon_tpu_torch/`` goes through :func:`now` (``utils/logger.py``
keeps its own clock for the reference's stderr format); the lint in
tests/test_torch_obs.py holds the package to it.
"""

from __future__ import annotations

from racon_tpu_torch.obs.aggregate import merge_histograms, merge_snapshots
from racon_tpu_torch.obs.calhealth import DRIFT_BAND
from racon_tpu_torch.obs.context import (JobContext, current, job_context,
                                         jobs_for_tenant, valid_trace_id)
from racon_tpu_torch.obs.decision import DECISIONS, DecisionRecorder
from racon_tpu_torch.obs.devutil import DEVICE_UTIL, DeviceUtil
from racon_tpu_torch.obs.flight import FLIGHT, FlightRecorder
from racon_tpu_torch.obs.metrics import (HIST_BUCKETS, REGISTRY,
                                         MetricAttr, Registry,
                                         hist_quantile)
from racon_tpu_torch.obs.trace import (TRACER, device_span, enable_trace,
                                       now, span, wall_now, write_trace)

__all__ = [
    "REGISTRY", "Registry", "MetricAttr", "TRACER", "HIST_BUCKETS",
    "hist_quantile", "DEVICE_UTIL", "DeviceUtil", "now", "wall_now",
    "span", "device_span", "enable_trace", "write_trace", "JobContext",
    "job_context", "current", "jobs_for_tenant", "valid_trace_id",
    "FLIGHT", "FlightRecorder", "DECISIONS", "DecisionRecorder",
    "DRIFT_BAND", "merge_histograms", "merge_snapshots",
]
