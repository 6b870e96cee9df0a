"""Sequence and overlap file parsers (bioparser-equivalent).

gzip-transparent, chunked parsers for FASTA/FASTQ sequence files and
MHAP/PAF/SAM overlap files.  ``parse(dst, max_bytes)`` appends parsed
records to ``dst`` and returns True while more data remains, mirroring
the streaming semantics used by Polisher::initialize
(reference: src/polisher.cpp:228-263).  Every format goes through the
vectorized scan parsers of :mod:`racon_tpu_torch.io.fastio`; the
overlap line parsers here supply their per-row fallback.
"""

from __future__ import annotations

import gzip
import os
from typing import Callable, List, Optional

from racon_tpu_torch.core.overlap import Overlap
from racon_tpu_torch.core.sequence import Sequence


class UnsupportedFormatError(ValueError):
    pass


class MalformedInputError(ValueError):
    """A record violates its declared format (path:line diagnostics)."""


def _open(path: str):
    """Open a possibly-gzipped file in binary mode."""
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


class _OverlapLineParser:
    """Line-oriented overlap parser with byte-budget chunking."""

    record_from_line: Callable[[bytes], Optional[Overlap]]

    def __init__(self, path: str):
        if not os.path.isfile(path):
            raise FileNotFoundError(path)
        self.path = path
        self._fh = None
        self._line_no = 0

    def reset(self) -> None:
        self.close()
        self._fh = _open(self.path)
        self._line_no = 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def parse(self, dst: List[Overlap], max_bytes: int) -> bool:
        if self._fh is None:
            self.reset()
        budget = max_bytes if max_bytes >= 0 else float("inf")
        consumed = 0
        for raw in self._fh:
            self._line_no += 1
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            try:
                record = self.record_from_line(line)
            except (IndexError, ValueError, UnicodeDecodeError) as exc:
                raise MalformedInputError(
                    f"{self.path}:{self._line_no}: malformed "
                    f"{type(self).__name__.replace('Parser', '')} "
                    f"record ({exc})") from exc
            if record is not None:
                dst.append(record)
            consumed += len(raw)
            if consumed >= budget:
                return True
        return False


class PafParser(_OverlapLineParser):
    """PAF: qname qlen qstart qend strand tname tlen tstart tend ..."""

    @staticmethod
    def record_from_line(line: bytes) -> Optional[Overlap]:
        f = line.split(b"\t")
        return Overlap.from_paf(
            q_name=f[0].decode(), q_length=int(f[1]), q_begin=int(f[2]),
            q_end=int(f[3]), orientation=f[4].decode(),
            t_name=f[5].decode(), t_length=int(f[6]), t_begin=int(f[7]),
            t_end=int(f[8]))


class MhapParser(_OverlapLineParser):
    """MHAP: aid bid jaccard minmers arc abeg aend alen brc bbeg bend blen.

    Ids are 1-based in the file; Overlap.from_mhap subtracts 1
    (reference: src/overlap.cpp:15-27).
    """

    @staticmethod
    def record_from_line(line: bytes) -> Optional[Overlap]:
        f = line.split()
        return Overlap.from_mhap(
            a_id=int(f[0]), b_id=int(f[1]),
            a_rc=int(f[4]), a_begin=int(f[5]), a_end=int(f[6]),
            a_length=int(f[7]), b_rc=int(f[8]), b_begin=int(f[9]),
            b_end=int(f[10]), b_length=int(f[11]))


class SamParser(_OverlapLineParser):
    """SAM alignment lines; headers skipped; unmapped flagged invalid."""

    @staticmethod
    def record_from_line(line: bytes) -> Optional[Overlap]:
        if line.startswith(b"@"):
            return None
        f = line.split(b"\t")
        return Overlap.from_sam_bytes(
            q_name=f[0].decode(), flag=int(f[1]), t_name=f[2].decode(),
            t_begin=int(f[3]), cigar=f[5])


_SEQUENCE_EXTENSIONS_FASTA = (".fasta", ".fasta.gz", ".fna", ".fna.gz",
                              ".fa", ".fa.gz")
_SEQUENCE_EXTENSIONS_FASTQ = (".fastq", ".fastq.gz", ".fq", ".fq.gz")


def create_sequence_parser(path: str):
    """Extension-sniffing factory (reference: src/polisher.cpp:83-99)."""
    from racon_tpu_torch.io import fastio

    if path.endswith(_SEQUENCE_EXTENSIONS_FASTA):
        return fastio.FastaScanParser(path)
    if path.endswith(_SEQUENCE_EXTENSIONS_FASTQ):
        return fastio.FastqScanParser(path)
    raise UnsupportedFormatError(
        f"file {path} has unsupported format extension (valid extensions: "
        ".fasta, .fasta.gz, .fna, .fna.gz, .fa, .fa.gz, .fastq, .fastq.gz, "
        ".fq, .fq.gz)")


def create_overlap_parser(path: str):
    """Extension-sniffing factory (reference: src/polisher.cpp:101-115)."""
    from racon_tpu_torch.io import fastio

    if path.endswith((".mhap", ".mhap.gz")):
        return fastio.MhapScanParser(path)
    if path.endswith((".paf", ".paf.gz")):
        return fastio.PafScanParser(path)
    if path.endswith((".sam", ".sam.gz")):
        return fastio.SamScanParser(path)
    raise UnsupportedFormatError(
        f"file {path} has unsupported format extension (valid extensions: "
        ".mhap, .mhap.gz, .paf, .paf.gz, .sam, .sam.gz)")
