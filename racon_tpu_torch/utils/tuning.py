"""Shared shape policies of the POA kernel."""

from __future__ import annotations


def pow2_at_least(n: int, floor: int) -> int:
    """Round ``n`` up to the next power of two, no lower than
    ``floor`` -- the bucketing used to bound the number of distinct
    batch shapes."""
    b = floor
    while b < n:
        b <<= 1
    return b


def poa_band_cols(l_bucket: int, banded: bool = False) -> int:
    """Effective POA band width for a layer bucket (0 = unbanded).

    The auto band is a quarter of the bucket; -b halves it to an eighth
    (the cudapoa banded-kernel analog, reference
    src/cuda/cudabatch.cpp:54-62).  Both floor at 256 columns: the band
    quantum is 128 and placement centers the expected diagonal half a
    quantum into the band, so 256 is the narrowest band that keeps the
    diagonal in reach.  A band at least as wide as the whole row
    degenerates to unbanded."""
    wb = max(256, l_bucket // (8 if banded else 4))
    return 0 if wb >= l_bucket + 1 else wb
