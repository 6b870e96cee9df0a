"""Command-line interface (reference: src/main.cpp).

racon's one-shot contract: three positional inputs (sequences,
overlaps, target sequences), polished FASTA on stdout.  Two positionals
(sequences, target sequences) discover the overlaps internally
(``racon_tpu_torch/overlap``), and ``--rounds N`` polishes N rounds,
re-mapping the reads against each round's draft, as the JAX package's
CLI does (racon_tpu/cli.py:314-327); ``run`` is an alias of the
one-shot form.  ``-c`` keeps
racon's optional-argument behaviour (bare -c means 1,
src/main.cpp:111-123) and offloads the POA stage to the card;
``--cudaaligner-batches`` offloads the overlap alignment; ``--device
cpu`` runs the port on the CPU (the kernels' plain versions), and
without it a machine with no card is an error.  ``--trace`` writes a
Chrome trace of the run and ``--metrics-json`` its run report
(``racon_tpu_torch/obs``), both after the FASTA is flushed, as the JAX
package's CLI does (racon_tpu/cli.py:393-444).

``serve``, ``submit`` and ``status`` are the serve daemon's subcommands,
``route`` the fleet router's and ``metrics`` the fleet scrape's
(``racon_tpu_torch/serve``), dispatched before option parsing, as the
JAX package's CLI does (racon_tpu/cli.py:286-307).  With
``RACON_TPU_TORCH_COORD`` set and ``RACON_TPU_TORCH_NPROC`` > 1 the
one-shot form polishes and emits only rank ``RACON_TPU_TORCH_RANK``'s
slice of the targets (``racon_tpu_torch/parallel/multihost.py``), on
``cuda:{rank % device count}`` unless ``--device`` names one.

    python -m racon_tpu_torch.cli [options] <sequences> <overlaps> <targets>
    python -m racon_tpu_torch.cli [run] [options] [--rounds N] <sequences> <targets>
    python -m racon_tpu_torch.cli serve --socket PATH [--jobs N] [--device D]
    python -m racon_tpu_torch.cli submit --socket PATH [options] <inputs>
    python -m racon_tpu_torch.cli status --socket PATH [--json]
    python -m racon_tpu_torch.cli route --socket PATH --backends S1,S2,...
    python -m racon_tpu_torch.cli metrics (--socket PATH | --fleet S1,S2,...)
"""

from __future__ import annotations

import os
import sys

from racon_tpu_torch import __version__, obs, resolve_device
from racon_tpu_torch.core.overlap import InvalidInputError
from racon_tpu_torch.core.polisher import PolisherType
from racon_tpu_torch.io.parsers import (MalformedInputError,
                                        UnsupportedFormatError)
from racon_tpu_torch.obs import flight as obs_flight
from racon_tpu_torch.obs import provenance
from racon_tpu_torch.overlap.rounds import polish_rounds
from racon_tpu_torch.parallel import multihost

USAGE = """usage: racon_tpu_torch [options ...] <sequences> <overlaps> <target sequences>
       racon_tpu_torch [run] [options ...] [--rounds N] <sequences> <target sequences>
       racon_tpu_torch serve --socket PATH [--jobs N] [--queue N]
                       [--idle-timeout S] [--device cuda|cpu]
       racon_tpu_torch submit --socket PATH [--priority P] [--tenant T]
                       [--class interactive|batch] [--job-key K]
                       [--retry N] [--shards K|auto] [options ...]
                       <inputs as above>
       racon_tpu_torch status --socket PATH [--json]
       racon_tpu_torch route --socket PATH --backends S1,S2,... [--tcp H:P]
       racon_tpu_torch metrics (--socket PATH | --fleet S1,S2,...)
                       [--json | --prometheus]

    <sequences>  FASTA/FASTQ (gzip allowed) reads used for correction
    <overlaps>   MHAP/PAF/SAM (gzip allowed) overlaps of reads and
                 targets; left out, the reads are mapped against the
                 targets internally (RACON_TPU_TORCH_MAP_* knobs)
    <target sequences>  FASTA/FASTQ (gzip allowed) sequences to correct

    options:
        -u, --include-unpolished   output unpolished target sequences
        -f, --fragment-correction  fragment correction instead of
                                   contig polishing
        -w, --window-length <int>  default 500
        -q, --quality-threshold <float>  default 10.0
        -e, --error-threshold <float>    default 0.3
                                   (these three, --cudapoa-batches,
                                   --cudaaligner-batches and --rounds
                                   also as --window-length=<int> etc.)
        -T, --no-trimming          do not trim the consensus windows
        -m, --match <int>          default 3
        -x, --mismatch <int>       default -5
        -g, --gap <int>            default -4
        -t, --threads <int>        default 1
        -c, --cudapoa-batches [<int>]  default 0 (bare -c = 1):
                                   POA consensus on the card
        -b, --cuda-banded-alignment  narrower POA band
        --cudaaligner-batches <int>  default 0: overlap alignment on
                                   the card (pairs over 16384 bases
                                   stay on the CPU)
        --rounds <int>             default 1: polish N rounds, each
                                   later round re-mapping the reads
                                   against the previous round's draft
        --device <cuda|cpu>        default cuda
        --trace <path>             write a Chrome trace of the run
                                   (Perfetto, chrome://tracing); also
                                   RACON_TPU_TORCH_TRACE
        --metrics-json <path>      write the run report; also
                                   RACON_TPU_TORCH_METRICS_JSON
                                   (both also as --trace=<path> etc.)
        --version, -h/--help
"""


def parse_args(argv):
    """getopt-style parse preserving racon's -c optional-arg quirk."""
    opts = {"window_length": 500, "quality_threshold": 10.0,
            "error_threshold": 0.3, "trim": True, "match": 3,
            "mismatch": -5, "gap": -4, "threads": 1,
            "type": PolisherType.kC, "drop_unpolished": True,
            "cuda_poa_batches": 0, "cuda_banded_alignment": False,
            "cuda_aligner_batches": 0, "device": None, "rounds": 1,
            # the environment twins keep library and CLI runs on one
            # switch
            "trace": os.environ.get("RACON_TPU_TORCH_TRACE") or None,
            "metrics_json": os.environ.get("RACON_TPU_TORCH_METRICS_JSON")
            or None}
    value_opts = {"-w": ("window_length", int),
                  "--window-length": ("window_length", int),
                  "-q": ("quality_threshold", float),
                  "--quality-threshold": ("quality_threshold", float),
                  "-e": ("error_threshold", float),
                  "--error-threshold": ("error_threshold", float),
                  "-m": ("match", int), "--match": ("match", int),
                  "-x": ("mismatch", int), "--mismatch": ("mismatch", int),
                  "-g": ("gap", int), "--gap": ("gap", int),
                  "-t": ("threads", int), "--threads": ("threads", int),
                  "--cudaaligner-batches": ("cuda_aligner_batches", int),
                  "--cudapoa-batches": ("cuda_poa_batches", int),
                  "--rounds": ("rounds", int),
                  "--device": ("device", str),
                  "--trace": ("trace", str),
                  "--metrics-json": ("metrics_json", str)}
    # long options that also take their value after "=" (the option
    # with an optional value, --cudapoa-batches, only there)
    eq_opts = ("--window-length", "--quality-threshold",
               "--error-threshold", "--cudapoa-batches",
               "--cudaaligner-batches", "--rounds", "--trace",
               "--metrics-json")
    positionals = []
    i, n = 0, len(argv)
    while i < n:
        a = argv[i]
        name, eq, value = a.partition("=")
        if eq and name in eq_opts:
            key, conv = value_opts[name]
            opts[key] = conv(value)
        elif a in value_opts and a != "--cudapoa-batches":
            key, conv = value_opts[a]
            i += 1
            if i >= n:
                raise ValueError(f"missing argument for {a}")
            opts[key] = conv(argv[i])
        elif a in ("-u", "--include-unpolished"):
            opts["drop_unpolished"] = False
        elif a in ("-f", "--fragment-correction"):
            opts["type"] = PolisherType.kF
        elif a in ("-T", "--no-trimming"):
            opts["trim"] = False
        elif a in ("-c", "--cudapoa-batches"):
            opts["cuda_poa_batches"] = 1
            if i + 1 < n and argv[i + 1] and \
                    not argv[i + 1].startswith("-") and \
                    argv[i + 1].isdigit():
                i += 1
                opts["cuda_poa_batches"] = int(argv[i])
        elif a in ("-b", "--cuda-banded-alignment"):
            opts["cuda_banded_alignment"] = True
        elif a == "--version":
            print(__version__)
            raise SystemExit(0)
        elif a in ("-h", "--help"):
            print(USAGE, end="")
            raise SystemExit(0)
        elif a.startswith("-") and a != "-":
            raise ValueError(f"unknown option {a}")
        else:
            positionals.append(a)
        i += 1
    return opts, positionals


def _log_run_summary(polisher, opts) -> None:
    """The end-of-run summary on stderr (racon_tpu/cli.py:251-281): the
    streaming pipeline's counters when the POA stage ran on the card,
    and the host budget."""
    m = polisher.metrics
    if opts["cuda_poa_batches"] > 0:
        print("[racon_tpu_torch::] pipeline summary: "
              f"spec used {int(m.value('poa_spec_used'))}"
              f"/wasted {int(m.value('poa_spec_wasted'))} window(s), "
              "ledger ready peak "
              f"{int(m.value('ledger_ready_high_water'))}, "
              f"overlap {float(m.value('pipeline_overlap_s')):.2f} s, "
              f"device poa {float(m.value('poa_device_s')):.2f} s / "
              f"align {float(m.value('align_device_s')):.2f} s",
              file=sys.stderr)
    print("[racon_tpu_torch::] host budget: "
          f"parse {float(m.value('host.parse_s')):.2f} s, "
          f"map {float(m.value('host.map_s')):.2f} s, "
          f"bp decode {float(m.value('host.bp_decode_s')):.2f} s, "
          f"fragment {float(m.value('host.fragment_s')):.2f} s, "
          f"stitch {float(m.value('host.stitch_s')):.2f} s, "
          f"host share {float(m.value('host.share')):.3f}",
          file=sys.stderr)


def _report_details(polisher, device) -> dict:
    """The run report's ``details``."""
    def strkeys(name):
        return {str(k): v for k, v in getattr(polisher, name, {}).items()}

    return {"device": str(device),
            "rounds": getattr(polisher, "rounds_report", []),
            "stage_walls": {k: round(v, 6)
                            for k, v in polisher.stage_walls.items()},
            "poa_split_detail": getattr(polisher, "poa_split_detail", {}),
            "align_split_detail": getattr(polisher, "align_split_detail",
                                          {}),
            "align_rungs": getattr(polisher, "align_rungs", {}),
            "align_retry_counts": strkeys("align_retry_counts"),
            "poa_reject_counts": strkeys("poa_reject_counts")}


def main(argv=None, out=None):
    """Run one polish of ``--rounds`` rounds; writes FASTA to ``out``
    (default stdout) and returns the last round's polisher (its stage
    walls, kernel counters and ``rounds_report``).  Then,
    with ``--metrics-json``, the run report and, with ``--trace``, the
    trace; with ``RACON_TPU_TORCH_FLIGHT_DUMP`` set, the flight ring,
    which an unhandled exception also dumps there."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("serve", "route", "submit", "status",
                            "metrics"):
        # the serve tier's subcommands parse their own flags and exit
        if argv[0] == "serve":
            from racon_tpu_torch.serve.server import main as entry
        elif argv[0] == "route":
            from racon_tpu_torch.serve.router import main as entry
        elif argv[0] == "submit":
            from racon_tpu_torch.serve.client import main_submit as entry
        elif argv[0] == "status":
            from racon_tpu_torch.serve.client import main_status as entry
        else:
            from racon_tpu_torch.serve.fleet import main_metrics as entry
        raise SystemExit(entry(argv[1:]))
    if argv and argv[0] == "run":
        # the one-shot form by name: `run reads draft` maps and polishes
        argv = argv[1:]
    try:
        opts, inputs = parse_args(argv)
    except ValueError as exc:
        print(f"[racon_tpu_torch::] error: {exc}!", file=sys.stderr)
        raise SystemExit(1)
    if len(inputs) == 2:
        # two positionals = reads + draft: internal overlap discovery
        inputs = [inputs[0], None, inputs[1]]
    elif len(inputs) < 3:
        print("[racon_tpu_torch::] error: missing input file(s)!",
              file=sys.stderr)
        print(USAGE, end="", file=sys.stderr)
        raise SystemExit(1)
    try:
        # a rank of the multi-process mode takes its own card
        device = resolve_device(multihost.rank_device(opts["device"]))
    except ValueError as exc:
        print(f"[racon_tpu_torch::] error: {exc}!", file=sys.stderr)
        raise SystemExit(1)
    if opts["trace"]:
        # one run per trace file
        obs.TRACER.clear()
        obs.enable_trace(opts["trace"])
    flight_dump = os.environ.get(obs_flight.DUMP_ENV)
    if flight_dump:
        obs_flight.FLIGHT.install_dump_on_crash(flight_dump)
    obs_flight.FLIGHT.record(
        "run", inputs=[os.path.basename(p) for p in inputs[:3]
                       if p is not None],
        rounds=opts["rounds"], threads=opts["threads"], device=str(device))
    try:
        with obs.span("racon_tpu_torch.run", cat="stage"):
            polished, polisher = polish_rounds(
                inputs[0], inputs[1], inputs[2], opts["type"],
                opts["window_length"], opts["quality_threshold"],
                opts["error_threshold"], opts["trim"], opts["match"],
                opts["mismatch"], opts["gap"], opts["threads"],
                rounds=opts["rounds"],
                drop_unpolished=opts["drop_unpolished"],
                cuda_poa_batches=opts["cuda_poa_batches"],
                cuda_banded_alignment=opts["cuda_banded_alignment"],
                cuda_aligner_batches=opts["cuda_aligner_batches"],
                device=device)
            # polish_rounds hands the last polisher back open
            polisher.close()
        polisher.total_log()
        _log_run_summary(polisher, opts)
    except (InvalidInputError, UnsupportedFormatError,
            MalformedInputError, FileNotFoundError) as exc:
        print(f"[racon_tpu_torch::] error: {exc}", file=sys.stderr)
        raise SystemExit(1)
    out = sys.stdout.buffer if out is None else out
    out.write(b"".join(b">" + seq.name.encode() + b"\n" + seq.data + b"\n"
                       for seq in polished))
    out.flush()
    # the report, the trace and the flight dump come after the FASTA is
    # flushed: the stdout contract comes first
    if opts["metrics_json"]:
        provenance.write_metrics_json(
            opts["metrics_json"], run_registry=polisher.metrics,
            details=_report_details(polisher, device),
            device_util=getattr(polisher, "device_util", None))
        print(f"[racon_tpu_torch::] metrics report written to "
              f"{opts['metrics_json']}", file=sys.stderr)
    if opts["trace"]:
        path = obs.write_trace(opts["trace"])
        obs.TRACER.disable()
        print(f"[racon_tpu_torch::] trace written to {path} (open in "
              "Perfetto / chrome://tracing)", file=sys.stderr)
    if flight_dump:
        obs_flight.FLIGHT.record("run_done", n_sequences=len(polished))
        path = obs_flight.FLIGHT.dump(flight_dump, reason="run_done")
        print(f"[racon_tpu_torch::] flight dump written to {path}",
              file=sys.stderr)
    return polisher


if __name__ == "__main__":
    main()
