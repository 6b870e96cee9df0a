"""racon's wrapper: subsample and split around the port's polisher
(JAX package: racon_tpu/tools/wrapper.py; reference:
scripts/racon_wrapper.py).

The polisher's options plus ``--split <bytes>`` (cut the target
sequences into chunks and polish them one after the other, to bound
memory) and ``--subsample <reference length> <coverage>`` (thin the
reads).  The data is staged by the in-package rampler
(``racon_tpu_torch/tools/rampler.py``) in a work directory of the run,
removed at exit.  Each chunk is one ``python -m racon_tpu_torch.cli``
process, in split order, its FASTA on stdout, as the reference's
wrapper runs racon (racon_wrapper.py:118-141); a chunk that fails
fails the wrapper (exit 1), with no fallback to the CPU.  The options'
defaults are the reference wrapper's (m 5, x -4, g -8;
racon_wrapper.py:178-183), and ``--device`` is forwarded when given
(the card by default).

With two positionals (reads, draft) the overlaps are found by the
port's mapper and ``--rounds N`` is forwarded.  ``--server TARGETS``
submits each chunk as a job to a running ``serve`` daemon or ``route``
router instead of starting a process per chunk: each chunk's job key is
derived from its content (``wrap-<sha256[:32]>`` of the parameters and
the input files' bytes), so a repeated run is answered from the
daemons' journals; a comma-separated daemon list runs the chunks round
robin with failover; a single scatter-capable router takes the whole
job with ``shards="auto"`` and no client-side split; ``--rounds N``
runs one job per round under ``<key>-round-<i>``.

    python -m racon_tpu_torch.tools.wrapper [options] <sequences> \\
        [<overlaps>] <target sequences>
    racon-tpu-torch-wrapper [options] ...
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import os
import shutil
import subprocess
import sys

from racon_tpu_torch.obs import trace as obs_trace
from racon_tpu_torch.tools import rampler


def eprint(*args, **kwargs):
    print(*args, file=sys.stderr, flush=True, **kwargs)


class Wrapper:
    def __init__(self, sequences, overlaps, target_sequences, split,
                 subsample, include_unpolished, fragment_correction,
                 window_length, quality_threshold, error_threshold,
                 match, mismatch, gap, threads, cudaaligner_batches,
                 cudapoa_batches, cuda_banded_alignment, server=None,
                 rounds=1, device=None):
        self.sequences = os.path.abspath(sequences)
        self.subsampled_sequences = None
        # no overlaps: the polisher maps the reads itself
        self.overlaps = (os.path.abspath(overlaps)
                         if overlaps is not None else None)
        self.target_sequences = os.path.abspath(target_sequences)
        self.split_target_sequences = []
        self.chunk_size = split
        self.reference_length, self.coverage = (
            subsample if subsample is not None else (None, None))
        self.include_unpolished = include_unpolished
        self.fragment_correction = fragment_correction
        self.window_length = window_length
        self.quality_threshold = quality_threshold
        self.error_threshold = error_threshold
        self.match = match
        self.mismatch = mismatch
        self.gap = gap
        self.threads = threads
        self.cudaaligner_batches = cudaaligner_batches
        self.cudapoa_batches = cudapoa_batches
        self.cuda_banded_alignment = cuda_banded_alignment
        self.device = device
        # a daemon, a router, or a comma-separated daemon list
        self.server = server
        # set when --server is one router that scatters: the whole job
        # goes to it with shards="auto" (a client-side split on top
        # would shard the shards)
        self.scatter = False
        self.rounds = max(1, int(rounds))
        # per run (time, pid, random), so that concurrent runs in one
        # directory never share, and then remove, one work directory
        self.work_directory = os.path.join(
            os.getcwd(), "racon_work_directory_%s_%d_%s" % (
                obs_trace.wall_now(), os.getpid(), os.urandom(4).hex()))

    def __enter__(self):
        try:
            os.makedirs(self.work_directory)
        except OSError:
            eprint("[racon_tpu_torch::Wrapper::__enter__] error: unable to "
                   "create work directory!")
            sys.exit(1)
        return self

    def __exit__(self, exception_type, exception_value, traceback):
        try:
            shutil.rmtree(self.work_directory)
        except OSError:
            eprint("[racon_tpu_torch::Wrapper::__exit__] warning: unable to "
                   "clean work directory!")

    def run(self):
        eprint("[racon_tpu_torch::Wrapper::run] staging inputs "
               "(subsample/split)")
        if self.reference_length is not None and self.coverage is not None:
            self.subsampled_sequences = rampler.subsample(
                self.sequences, int(self.reference_length),
                int(self.coverage), self.work_directory)
            if not os.path.isfile(self.subsampled_sequences):
                eprint("[racon_tpu_torch::Wrapper::run] error: unable to "
                       "find subsampled sequences!")
                sys.exit(1)
        else:
            self.subsampled_sequences = self.sequences

        if self.chunk_size is not None and self.server \
                and self._router_scatters():
            self.scatter = True
            self.split_target_sequences.append(self.target_sequences)
            eprint("[racon_tpu_torch::Wrapper::run] --server is a "
                   "scatter-capable router: skipping client-side "
                   "--split, forwarding whole job with shards=auto")
        elif self.chunk_size is not None:
            self.split_target_sequences = rampler.split(
                self.target_sequences, int(self.chunk_size),
                self.work_directory)
            eprint(f"[racon_tpu_torch::Wrapper::run] target split into "
                   f"{len(self.split_target_sequences)} chunk(s)")
            if not self.split_target_sequences:
                eprint("[racon_tpu_torch::Wrapper::run] error: unable to "
                       "find split target sequences!")
                sys.exit(1)
        else:
            self.split_target_sequences.append(self.target_sequences)

        if self.rounds > 1 and len(self.split_target_sequences) > 1:
            # a second round would re-split the chunks' concatenation; a
            # scattering router re-shards every round itself
            eprint("[racon_tpu_torch::Wrapper::run] error: --rounds > 1 "
                   "cannot be combined with client-side --split")
            sys.exit(1)

        if self.server:
            self._run_served_chunks()
            return

        params = [sys.executable, "-m", "racon_tpu_torch.cli"]
        if self.include_unpolished:
            params.append("-u")
        if self.fragment_correction:
            params.append("-f")
        if self.cuda_banded_alignment:
            params.append("-b")
        params.extend(["-w", str(self.window_length),
                       "-q", str(self.quality_threshold),
                       "-e", str(self.error_threshold),
                       "-m", str(self.match),
                       "-x", str(self.mismatch),
                       "-g", str(self.gap),
                       "-t", str(self.threads),
                       "--cudaaligner-batches",
                       str(self.cudaaligner_batches),
                       "-c", str(self.cudapoa_batches)])
        if self.device is not None:
            params.extend(["--device", str(self.device)])
        if self.rounds > 1:
            params.extend(["--rounds", str(self.rounds)])
        params.append(self.subsampled_sequences)
        if self.overlaps is not None:
            params.append(self.overlaps)

        for target_part in self.split_target_sequences:
            eprint(f"[racon_tpu_torch::Wrapper::run] polishing chunk "
                   f"{target_part}")
            try:
                p = subprocess.Popen(params + [target_part])
            except OSError:
                eprint("[racon_tpu_torch::Wrapper::run] error: unable to "
                       "run racon_tpu_torch!")
                sys.exit(1)
            p.communicate()
            if p.returncode != 0:
                sys.exit(1)

        self.subsampled_sequences = None
        self.split_target_sequences = []

    def _router_scatters(self) -> bool:
        """Whether ``--server`` names one router that scatters: its
        health document carries ``router`` and ``scatter``.  A failed
        probe means no: the client-side split works against anything."""
        from racon_tpu_torch.serve import client

        targets = [t for t in self.server.split(",") if t]
        if len(targets) != 1:
            return False
        try:
            doc = client.health(targets[0], timeout=10.0)
        except client.ServeError:
            return False
        return bool(doc.get("router")) and bool(doc.get("scatter"))

    def _chunk_job_key(self, spec: dict, target_part: str) -> str:
        """The idempotence key of one served chunk: the polish
        parameters and the bytes of the three input files (the staged
        files' paths differ between runs, their contents do not), so a
        repeat of the same invocation gets the same key per chunk and
        the daemon's journal answers it without polishing again."""
        h = hashlib.sha256()
        for name in sorted(spec):
            if name in ("sequences", "overlaps", "targets"):
                continue          # paths: their content is hashed below
            h.update(f"{name}={spec[name]!r}\n".encode())
        for path in (self.subsampled_sequences, self.overlaps,
                     target_part):
            if path is None:          # no overlaps: the mapper's
                h.update(b"<none>")
            else:
                with open(path, "rb") as f:
                    for block in iter(lambda: f.read(1 << 20), b""):
                        h.update(block)
            h.update(b"|")
        return f"wrap-{h.hexdigest()[:32]}"

    def _run_served_chunks(self):
        """Submit every chunk as a job to ``self.server``, one after the
        other, and write each FASTA to stdout in split order, as the
        subprocess path does.  Submissions go through
        ``client.submit_with_retry`` under the chunk's content key, so a
        chunk interrupted by a daemon's crash and restart joins the
        recovered job or is answered from the journal; a failure that
        is not retryable exits 1.  With ``--rounds N`` each round is
        one job under ``<key>-round-<i>`` of the first round's key,
        every round starting at the same daemon (its warm cache)."""
        out = sys.stdout.buffer
        if self.rounds > 1:
            target_part = self.split_target_sequences[0]
            base_spec = self._round_spec(target_part, first=True)
            base_key = self._chunk_job_key(base_spec, target_part)
            current = target_part
            for rnd in range(1, self.rounds + 1):
                final = rnd == self.rounds
                spec = self._round_spec(current, first=rnd == 1,
                                        final=final)
                fasta = self._submit_chunk(0, current, spec,
                                           f"{base_key}-round-{rnd}")
                if final:
                    out.write(fasta)
                    out.flush()
                else:
                    current = os.path.join(self.work_directory,
                                           f"round{rnd}.fasta")
                    with open(current, "wb") as fh:
                        fh.write(fasta)
        else:
            for idx, target_part in enumerate(self.split_target_sequences):
                spec = self._round_spec(target_part, first=True)
                key = self._chunk_job_key(spec, target_part)
                out.write(self._submit_chunk(idx, target_part, spec, key))
                out.flush()
        self.subsampled_sequences = None
        self.split_target_sequences = []

    def _round_spec(self, target_part: str, first: bool,
                    final: bool = True) -> dict:
        """The job spec of one chunk or round, in the port's keys
        (``serve/client.py:spec_from_opts``).  Round 1 carries the
        user's overlaps (or asks for the mapper when there are none);
        a later round maps against the new draft; a round before the
        last keeps unpolished targets, so that each is polished again."""
        overlaps = self.overlaps if first else None
        spec = {
            "sequences": self.subsampled_sequences,
            "overlaps": overlaps,
            "targets": target_part,
            "type": "kF" if self.fragment_correction else "kC",
            "window_length": int(self.window_length),
            "quality_threshold": float(self.quality_threshold),
            "error_threshold": float(self.error_threshold),
            "match": int(self.match),
            "mismatch": int(self.mismatch),
            "gap": int(self.gap),
            "threads": int(self.threads),
            "drop_unpolished": (not self.include_unpolished
                                if final else False),
            "cuda_poa_batches": int(self.cudapoa_batches),
            "cuda_banded_alignment": self.cuda_banded_alignment,
            "cuda_aligner_batches": int(self.cudaaligner_batches),
        }
        if overlaps is None:
            spec["rounds"] = 1       # the mapper's opt-in
        return spec

    def _submit_chunk(self, idx: int, target_part: str, spec: dict,
                      key: str) -> bytes:
        """Submit one job, starting at daemon ``idx`` of the list and
        walking on past transport errors and retryable rejects; returns
        the FASTA bytes, or exits 1 as the subprocess path does."""
        from racon_tpu_torch.serve import client

        targets = [t for t in self.server.split(",") if t]
        resp = None
        last_error = None
        for attempt in range(len(targets)):
            target = targets[(idx + attempt) % len(targets)]
            eprint(f"[racon_tpu_torch::Wrapper::run] submitting chunk "
                   f"{target_part} to {target}")
            try:
                # one target: retry in place (a restart of the one
                # daemon); a list: move on to the next daemon quickly
                resp = client.submit_with_retry(
                    target, spec,
                    retries=8 if len(targets) == 1 else 2,
                    job_key=key,
                    shards="auto" if self.scatter else None)
            except client.ServeError as exc:
                last_error = str(exc)
                resp = None
                eprint(f"[racon_tpu_torch::Wrapper::run] warning: "
                       f"{target} unreachable ({exc})")
                continue
            code = (resp.get("error") or {}).get("code")
            if resp.get("ok") or code not in client.RETRYABLE:
                break
            last_error = code
            eprint(f"[racon_tpu_torch::Wrapper::run] warning: "
                   f"{target} rejected chunk ({code}); trying "
                   f"next daemon")
        if resp is None:
            eprint(f"[racon_tpu_torch::Wrapper::run] error: no daemon "
                   f"reachable for chunk ({last_error})")
            sys.exit(1)
        if not resp.get("ok"):
            err = resp.get("error", {})
            eprint("[racon_tpu_torch::Wrapper::run] error: chunk job "
                   f"failed: {json.dumps(err)}")
            sys.exit(1)
        return base64.b64decode(resp["fasta_b64"])


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="racon-tpu-torch-wrapper",
        description="Encapsulates the polisher and adds dataset "
        "subsampling (lower runtime) and target splitting with "
        "sequential chunk runs (lower memory). Usage equals "
        "racon_tpu_torch.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("sequences")
    parser.add_argument("overlaps")
    parser.add_argument("target_sequences", nargs="?", default=None,
                        help="omit to polish without an overlaps file: "
                        "the second positional is then the target and "
                        "the polisher maps the reads itself")
    parser.add_argument("--split", type=int,
                        help="split target sequences into chunks of "
                        "desired size in bytes")
    parser.add_argument("--subsample", nargs=2, type=int,
                        metavar=("REFERENCE_LENGTH", "COVERAGE"),
                        help="subsample sequences to desired coverage "
                        "given the reference length")
    parser.add_argument("--server", metavar="TARGETS",
                        help="submit chunks as jobs to a running 'serve' "
                        "daemon or 'route' router (unix socket path or "
                        "host:port) instead of starting one process per "
                        "chunk; a comma-separated daemon list runs the "
                        "chunks round robin with failover; a "
                        "scatter-capable router takes the whole job "
                        "with shards=auto instead of client-side "
                        "--split chunks")
    parser.add_argument("-u", "--include-unpolished",
                        action="store_true")
    parser.add_argument("-f", "--fragment-correction",
                        action="store_true")
    parser.add_argument("-w", "--window-length", default=500)
    parser.add_argument("-q", "--quality-threshold", default=10.0)
    parser.add_argument("-e", "--error-threshold", default=0.3)
    parser.add_argument("-m", "--match", default=5)
    parser.add_argument("-x", "--mismatch", default=-4)
    parser.add_argument("-g", "--gap", default=-8)
    parser.add_argument("-t", "--threads", default=1)
    parser.add_argument("--cudaaligner-batches", default=0,
                        dest="cudaaligner_batches")
    parser.add_argument("-c", "--cudapoa-batches", default=0,
                        dest="cudapoa_batches")
    parser.add_argument("-b", "--cuda-banded-alignment",
                        action="store_true", dest="cuda_banded_alignment")
    parser.add_argument("--rounds", type=int, default=1,
                        help="polish N rounds, each later round mapping "
                        "the reads against the previous round's draft; "
                        "served rounds each get the journal key "
                        "'<digest>-round-<i>'")
    parser.add_argument("--device", default=None,
                        help="forwarded to every chunk's polisher "
                        "(cuda or cpu; the card when left out)")
    return parser


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    overlaps, target = args.overlaps, args.target_sequences
    if target is None:
        # two positionals: reads and draft, the mapper finds overlaps
        overlaps, target = None, overlaps
    wrapper = Wrapper(
        args.sequences, overlaps, target, args.split,
        args.subsample, args.include_unpolished,
        args.fragment_correction, args.window_length,
        args.quality_threshold, args.error_threshold, args.match,
        args.mismatch, args.gap, args.threads, args.cudaaligner_batches,
        args.cudapoa_batches, args.cuda_banded_alignment,
        server=args.server, rounds=args.rounds, device=args.device)
    with wrapper:
        wrapper.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
