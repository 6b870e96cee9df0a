"""The serve daemon of the port (JAX package: racon_tpu/serve/).

One-shot runs pay the process setup every time: the torch import, the
kernels' build check and load, the native engine, the CUDA context.
The daemon pays it once and serves polish jobs over a unix socket:

* :mod:`~racon_tpu_torch.serve.server` -- the daemon
  (``python -m racon_tpu_torch.cli serve --socket PATH``);
* :mod:`~racon_tpu_torch.serve.scheduler` -- the bounded priority
  queue with priced admission and the worker pool, each job a tenant
  of the device executor;
* :mod:`~racon_tpu_torch.serve.session` -- one job's polish and
  report;
* :mod:`~racon_tpu_torch.serve.journal` and
  :mod:`~racon_tpu_torch.serve.recover` -- the write-ahead journal and
  its replay after a crash;
* :mod:`~racon_tpu_torch.serve.affinity` -- the job content digests
  noted into the result cache's sketch, and scored against a backend's
  sketch by the router;
* :mod:`~racon_tpu_torch.serve.router` -- the fleet router in front of
  several daemons (``python -m racon_tpu_torch.cli route``): priced
  placement, spillover, breakers, crash failover, scatter/gather;
* :mod:`~racon_tpu_torch.serve.scatter` -- the scatter planner, the
  shard keys and the gather;
* :mod:`~racon_tpu_torch.serve.fleet` -- the fleet scrape and the
  ``metrics`` subcommand;
* :mod:`~racon_tpu_torch.serve.client` -- the blocking client and the
  ``submit`` / ``status`` subcommands;
* :mod:`~racon_tpu_torch.serve.protocol` -- the framing, byte-equal to
  the JAX package's.

The contract: a served job's FASTA is byte-identical to the one-shot
CLI's for the same inputs and options on the same device, with other
jobs in flight, after a SIGKILL and a restart on the same journal, and
routed or scattered through a router whose backend dies mid-shard
(tests/test_torch_serve.py, tests/test_torch_durable.py,
tests/test_torch_fleet.py).
"""

from racon_tpu_torch.serve.protocol import (ProtocolError,  # noqa: F401
                                            recv_frame, send_frame)
