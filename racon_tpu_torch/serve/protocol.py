"""Wire protocol: length-prefixed JSON frames over a unix socket (JAX
package: racon_tpu/serve/protocol.py; the same bytes both ways).

Every message in both directions is one frame::

    +----------------+----------------------+
    | 4 bytes, u32BE |  <length> JSON bytes |
    +----------------+----------------------+

The document is always an object.  Requests carry an ``op``: ``submit``,
``status``, ``metrics``, ``health``, ``watch``, ``flight``,
``journal_query``, ``trace_query``, ``explain``, ``cancel``, ``pause``,
``resume``, ``shutdown``.  Responses carry ``ok`` and, when it is false,
a machine-readable ``error``::

    {"ok": false, "error": {"code": "queue_full", "reason": "...", ...}}

Error codes: ``queue_full`` (the bounded queue is at capacity; carries
``retry_after_s``), ``draining`` (SIGTERM or ``shutdown`` received:
running and queued jobs finish, new ones are rejected),
``job_too_large`` (the admission price exceeds
``RACON_TPU_TORCH_SERVE_MAX_WALL_S``), ``input_not_found``,
``missing_overlaps`` (no overlaps input and no ``rounds`` field: its
``hint`` names the ``--rounds`` opt-in), ``bad_request`` (a malformed
frame or spec, and the fleet fields ``stage`` and ``shard``, which the
port does not serve yet), ``job_failed`` (the polish raised; the queue
and the warm kernels survive) and ``job_canceled``.

``submit`` carries ``job`` (the spec: input paths and the one-shot
CLI's options, ``serve/session.py``), optional ``priority``,
``trace`` (attach the job's trace slice and flight events),
``trace_context`` (a caller's trace id) and ``job_key`` (the
idempotence key: a duplicate joins the live job or is answered from
the write-ahead journal's record, across daemon restarts).  The
polished FASTA rides base64-encoded in ``fasta_b64``; the client
decodes it back to the exact bytes.  A spec's ``tenant`` names the job's
tenant in the device executor, ``class`` (``interactive`` or
``batch``) its deadline class, ``rounds`` the polish rounds (with no
``overlaps``, the built-in mapper finds them); none of them changes
output bytes beyond what the one-shot CLI's same options do.

``metrics`` answers the registry as Prometheus text and JSON with
percentiles (``obs/export.py``), device utilization, the executor's
fusion stats and the result cache's; ``watch`` streams the same frame
minus the text every ``interval_s`` (0.05-60 s) until ``count`` frames
or the drain; ``health`` is the cheap liveness document, with the
journal block and ``recovered_jobs``; ``journal_query`` and
``trace_query`` are bounded reads of the journal and of a job's trace
slice (a key filter and a record cap are required).

The journal (``serve/journal.py``) reuses this framing, one record per
frame.
"""

from __future__ import annotations

import json
import struct

#: refuse frames past this size (a corrupt length prefix must not make
#: the server allocate gigabytes)
FRAME_MAX = 1 << 30

_LEN = struct.Struct(">I")


class ProtocolError(RuntimeError):
    """Malformed frame (bad length prefix, truncated body, non-JSON
    payload).  The server answers one ``bad_request`` frame when it can
    and drops the connection; the warm state is untouched."""


def send_frame(sock, obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > FRAME_MAX:
        raise ProtocolError(f"frame too large ({len(payload)} bytes)")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ProtocolError(
                f"connection closed mid-frame ({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock):
    """Read one frame; the decoded object, or None on a clean EOF at a
    frame boundary."""
    head = b""
    while len(head) < _LEN.size:
        chunk = sock.recv(_LEN.size - len(head))
        if not chunk:
            if head:
                raise ProtocolError("connection closed mid-prefix")
            return None
        head += chunk
    (n,) = _LEN.unpack(head)
    if n > FRAME_MAX:
        raise ProtocolError(f"frame length {n} exceeds FRAME_MAX")
    try:
        return json.loads(_recv_exact(sock, n))
    except ValueError as exc:
        raise ProtocolError(f"frame body is not JSON ({exc})") from exc


def error_frame(code: str, reason: str, **extra) -> dict:
    err = {"code": code, "reason": reason}
    err.update(extra)
    return {"ok": False, "error": err}
