"""Multi-process scale-out of the port (JAX package: racon_tpu/parallel/).

* :mod:`~racon_tpu_torch.parallel.multihost` -- target-sharded ranks:
  each process owns a contiguous slice of the targets and emits it.
"""
