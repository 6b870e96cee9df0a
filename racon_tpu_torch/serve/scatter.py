"""Scatter/gather planning of target-sharded jobs (JAX package:
racon_tpu/serve/scatter.py).

The router (racon_tpu_torch/serve/router.py) turns one large submit
into K target-sharded sub-jobs and concatenates their FASTA in shard
order.  This module is the pure half: how many shards, each shard's
spec and idempotence key, and how the shard responses fold into one
client frame.  Placement, fan-out threads, failover and fault sites stay
in the router.

The byte contract rides on ``target_slice``
(racon_tpu_torch/parallel/multihost.py): shard ``i`` of ``k`` owns
exactly ``target_slice(n_targets, k, i)`` and the polisher emits only
owned targets in target order (racon_tpu_torch/core/polisher.py), so
gathering in index order is the unsharded byte stream.  Sharding is a
placement decision, never a bytes decision, which is why the
RACON_TPU_TORCH_SCATTER_* knobs are in keying.EPOCH_EXCLUDE.

Keys: shard ``i`` of a job keyed ``K`` planned at ``k`` shards runs
under ``K-shard-<i>of<k>``.  The daemons' write-ahead journals and the
router's crash failover then give exactly-once per shard: a backend
death mid-shard re-places only that shard under the same key, and a
survivor (or the restarted owner) answers a duplicate from its journal.
The count is part of the key because the journal dedups by key alone: a
duplicate that re-planned another ``k`` must miss the old records, whose
slices differ, rather than gather the wrong bytes.

Rebalance keys: a straggling shard's speculative replacement runs under
``K-shard-<i>of<k>-r<n>``, distinct from the original's, so it is a
fresh exactly-once unit at its own backend's journal.  The first
successful attempt wins the shard at the router; the superseded one is
canceled after its checkpoint and its ``job_canceled`` reply dropped.

Knobs (provenance.KNOWN_KNOBS; all epoch-excluded):

* ``RACON_TPU_TORCH_SCATTER_MIN_WALL_S`` (default "" = off): the
  predicted wall above which the router scatters a submit by itself.
  An explicit ``shards`` on the submit always wins.
* ``RACON_TPU_TORCH_SCATTER_REBALANCE`` (default 2.5; 0 = off): the
  straggler factor, see :func:`rebalance_factor`.
* ``RACON_TPU_TORCH_SCATTER_MAX_SHARDS`` (default 8): the cap on the
  shard count.  Automatic plans are also capped by the eligible
  backends; an explicit ``shards`` is not, so that a keyed retry
  derives the same plan while part of the fleet is dark.
"""

from __future__ import annotations

import base64
import hashlib
import math
import os


def min_wall_s():
    """The auto-scatter threshold, or None when auto-scatter is off
    (the default: unsharded routing unless the client opts in)."""
    raw = os.environ.get("RACON_TPU_TORCH_SCATTER_MIN_WALL_S", "")
    if not raw:
        return None
    try:
        value = float(raw)
    except ValueError:
        return None
    return value if value > 0 else None


def rebalance_factor():
    """The straggler threshold factor for cross-shard
    rebalancing, or None when rebalancing is off.  A live shard whose
    elapsed wall exceeds ``factor x p50(predicted shard walls)`` (and
    at least four probe periods, so a fast plan never trips on probe
    jitter) gets a speculative replacement attempt under a derived
    ``-r<n>`` key.  Default 2.5; ``0`` (or any non-positive value)
    disables, unparsable input falls back to the default — placement
    policy only, epoch-excluded like every other scatter knob."""
    raw = os.environ.get("RACON_TPU_TORCH_SCATTER_REBALANCE", "")
    try:
        value = float(raw or "2.5")
    except ValueError:
        value = 2.5
    return value if value > 0 else None


def max_shards() -> int:
    try:
        value = int(os.environ.get("RACON_TPU_TORCH_SCATTER_MAX_SHARDS",
                                   "8") or "8")
    except ValueError:
        value = 8
    return max(1, value)


def parse_requested(value):
    """Normalize a submit frame's ``shards`` field.

    Returns None (absent — planner decides from the threshold),
    ``"auto"`` (one shard per eligible backend), or an int.  Raises
    ValueError on anything else so the router can answer
    ``bad_request`` before taking ownership of the job.
    """
    if value is None:
        return None
    if isinstance(value, str):
        text = value.strip().lower()
        if text == "auto":
            return "auto"
        try:
            value = int(text)
        except ValueError:
            raise ValueError(
                "shards must be an integer or 'auto'") from None
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValueError("shards must be an integer or 'auto'")
    if not 0 <= value <= 4096:
        raise ValueError("shards must be in 0..4096 or 'auto'")
    return value


def plan_shards(requested, predicted_wall_s, n_eligible) -> int:
    """The shard count for one submit; <= 1 means run unsharded.

    * explicit K >= 1: honored, capped ONLY by
      RACON_TPU_TORCH_SCATTER_MAX_SHARDS — never by the momentary eligible
      backend count.  A keyed retry must re-derive the same plan the
      original ran under (same derived keys → journal dedup), and
      eligibility is transient: a breaker that opened between the
      original and the retry must not change the plan.  Shards beyond
      the live backend count just queue behind siblings;
    * ``"auto"``: one shard per eligible backend, capped by
      MAX_SHARDS;
    * 0 / absent with no threshold: unsharded;
    * absent with RACON_TPU_TORCH_SCATTER_MIN_WALL_S set: scatter only when
      the admission estimate exceeds the threshold, sized so each
      shard's predicted slice comes back under it (capped like auto).
    """
    cap = max(1, min(int(n_eligible), max_shards()))
    if isinstance(requested, int) and requested >= 1:
        return min(requested, max_shards())
    if requested == "auto":
        return cap
    threshold = min_wall_s()
    if requested == 0 or threshold is None \
            or predicted_wall_s is None \
            or predicted_wall_s <= threshold:
        return 1
    return min(math.ceil(predicted_wall_s / threshold), cap)


def shard_key(job_key: str, index: int, count: int) -> str:
    """The derived idempotence key for shard ``index`` of ``count``:
    ``<job_key>-shard-<i>of<k>``, kept inside the journal's key
    contract (1..128 chars of [A-Za-z0-9._:-]).  The count is baked
    in because the journal dedups by key alone — a duplicate that
    re-planned a different ``k`` must MISS the old records (its
    shards own different target slices) rather than be answered with
    the wrong bytes.  A base key too long to carry the suffix is
    folded to a digest — still deterministic in the base key, so a
    duplicate mega-job submit derives the same shard keys and dedups
    at the backend journals."""
    suffix = f"-shard-{index}of{count}"
    if len(job_key) + len(suffix) > 128:
        job_key = "sc-" + hashlib.sha256(
            job_key.encode("utf-8")).hexdigest()[:32]
    return job_key + suffix


def rebalance_key(job_key: str, index: int, count: int,
                  attempt: int) -> str:
    """The derived key for rebalance attempt ``n`` of shard ``i``:
    ``<job_key>-shard-<i>of<k>-r<n>`` (straggler rebalancing).
    A DISTINCT key from the original's on purpose: the replacement
    is a fresh exactly-once unit at its own backend's journal, so it
    can never be answered from the straggler's records — first
    successful attempt wins the shard slot at the router.  Same
    length-folding rule as :func:`shard_key`, applied with the full
    suffix so the derived key stays inside the 128-char contract."""
    suffix = f"-shard-{index}of{count}-r{int(attempt)}"
    if len(job_key) + len(suffix) > 128:
        job_key = "sc-" + hashlib.sha256(
            job_key.encode("utf-8")).hexdigest()[:32]
    return job_key + suffix


def shard_spec(spec: dict, index: int, count: int,
               stage: dict = None) -> dict:
    """Shard ``index``'s sub-job spec: the mega-job's spec (tenant,
    inputs, options all inherited) plus the target shard and, when
    the router built a slice index at plan time, the shard's staged
    -input hint (the receiving daemon validates it against its
    own view of the file before trusting it)."""
    sub = dict(spec)
    sub["shard"] = [int(index), int(count)]
    if stage is not None:
        sub["stage"] = stage
    return sub


def merge_responses(responses, keys) -> dict:
    """Gather: fold the K shard responses (in shard order) into one
    client frame.  The FASTA is a plain concatenation — byte-identical
    to the unsharded run by the target_slice contract — and the
    report is a merged metrics doc with per-shard sub-blocks.

    ``responses[i]`` is shard i's successful response frame body (the
    router already annotated ``routed_backend``); ``keys[i]`` its
    derived idempotence key.  The caller fills ``wall_s`` with the
    measured scatter wall (fan-out is concurrent, so shard walls
    don't sum).
    """
    fasta = b"".join(base64.b64decode(r["fasta_b64"])
                     for r in responses)
    per_shard = []
    for i, resp in enumerate(responses):
        est = resp.get("estimate") or {}
        per_shard.append({
            "shard": i,
            "job_key": keys[i],
            "backend": resp.get("routed_backend"),
            "job_id": resp.get("job_id"),
            "trace_id": resp.get("trace_id"),
            "n_sequences": resp.get("n_sequences"),
            "wall_s": resp.get("wall_s"),
            "predicted_wall_s": est.get("predicted_wall_s"),
        })
    return {
        "ok": True,
        "job_id": responses[0].get("job_id"),
        "n_sequences": fasta.count(b">"),
        "wall_s": None,   # router fills with the measured gather wall
        "fasta_b64": base64.b64encode(fasta).decode("ascii"),
        "report": {
            "schema": "racon-tpu-scatter-v1",
            "shards": len(responses),
            "per_shard": per_shard,
            "shard_reports": [r.get("report") for r in responses],
        },
    }
