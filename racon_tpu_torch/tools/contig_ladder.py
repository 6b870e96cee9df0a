"""The align ladder on a fragmented draft, on the card.

The simulated whole set of ``chip_smoke.py`` (an E. coli-sized ONT
genome at 30x) is cut into N contiguous draft regions with the reads
whose PAF records fall inside them, and the regions are joined into one
N-contig job (``tools/simulate.py:concat_sets``).  A run polishes that
job on the staged all-device path (``chip_smoke.py``'s phase 6: pipeline
off, every pair and window on the card, result cache off) and prints
one JSON line: the polish's wall, the align stage's wall, the divergence
probe's pairs and seconds, the rung mix (pairs certified per rung), each
kernel's launches and a digest of the output.

    python3 racon_tpu_torch/tools/contig_ladder.py make DIR \\
        [--contigs 4,100] [--genome-len N]
    python3 racon_tpu_torch/tools/contig_ladder.py run DIR/c100 \\
        [--threads T] [--repeat R] [--set NAME=VALUE ...]

``make`` writes ``DIR/c<N>/{reads.fastq,reads2draft.paf,draft.fasta}``
for each N.  ``run`` polishes with the ``racon_tpu_torch`` found first
on ``sys.path``, so ``PYTHONPATH=<checkout>`` measures that checkout on
the same files; ``--set`` overrides a ``CudaPolisher`` class attribute
(the probe's ``PROBE_*``, say).  ``run`` needs one CUDA card unless
``--device cpu`` asks for the kernels' plain versions (a dry run).
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys

STAGED_ENV = {"RACON_TPU_TORCH_PIPELINE": "0",
              "RACON_TPU_TORCH_ALIGN_DEVICE_ONLY": "1",
              "RACON_TPU_TORCH_POA_DEVICE_ONLY": "1",
              "RACON_TPU_TORCH_CACHE": "0",
              "RACON_TPU_TORCH_CACHE_DIR": ""}


def _read_draft(path: str) -> bytes:
    with open(path, "rb") as fh:
        return b"".join(l.strip() for l in fh if not l.startswith(b">"))


def cut(src: str, dst: str, start: int, length: int) -> tuple:
    """The draft's ``length`` bases from ``start`` with the reads whose
    PAF records fall inside them (``chip_smoke.py:cut_region``)."""
    os.makedirs(dst, exist_ok=True)
    draft = _read_draft(os.path.join(src, "draft.fasta"))
    names, lines = set(), []
    with open(os.path.join(src, "reads2draft.paf"), "rb") as fh:
        for line in fh:
            f = line.split(b"\t")
            if int(f[7]) >= start and int(f[8]) <= start + length:
                f[6] = b"%d" % length
                f[7] = b"%d" % (int(f[7]) - start)
                f[8] = b"%d" % (int(f[8]) - start)
                names.add(f[0])
                lines.append(b"\t".join(f))
    paths = tuple(os.path.join(dst, n) for n in
                  ("reads.fastq", "reads2draft.paf", "draft.fasta"))
    with open(os.path.join(src, "reads.fastq"), "rb") as fh, \
            open(paths[0], "wb") as out:
        while True:
            rec = [fh.readline() for _ in range(4)]
            if not rec[0]:
                break
            if rec[0][1:].strip() in names:
                out.write(b"".join(rec))
    with open(paths[1], "wb") as out:
        out.write(b"".join(lines))
    with open(paths[2], "wb") as out:
        out.write(b">draft\n" + draft[start:start + length] + b"\n")
    return paths


def make(out_dir: str, contigs, genome_len: int) -> dict:
    from racon_tpu_torch import obs
    from racon_tpu_torch.tools import simulate

    whole = os.path.join(out_dir, "whole")
    t0 = obs.now()
    simulate.simulate(whole, genome_len=genome_len, coverage=30,
                      read_len=8000, seed=7, ont=True)
    draft_len = len(_read_draft(os.path.join(whole, "draft.fasta")))
    made = {}
    for n in contigs:
        step = draft_len // n
        bounds = [i * step for i in range(n)] + [draft_len]
        parts = [cut(whole, os.path.join(out_dir, f"cut{n}", str(i)),
                     bounds[i], bounds[i + 1] - bounds[i])
                 for i in range(n)]
        paths = simulate.concat_sets(parts, os.path.join(out_dir, f"c{n}"))
        with open(paths[1], "rb") as fh:
            made[n] = sum(1 for _ in fh)
    return {"draft_len": draft_len, "overlaps": made,
            "make_s": round(obs.now() - t0, 3)}


def launch_counts() -> dict:
    """Each kernel's launches so far: the registry's counters, or the
    wrappers' module counts in a checkout from before them."""
    from racon_tpu_torch.cuda import build

    if hasattr(build, "launch_counts"):
        return build.launch_counts()
    from racon_tpu_torch.cuda import align_band, align_wfa, poa_full

    return {"poa_full": poa_full.LAUNCHES, "align_wfa": align_wfa.LAUNCHES,
            "align_band": align_band.LAUNCHES}


def run(data: str, threads: int, repeat: int, overrides,
        device: str = "cuda") -> list:
    os.environ.update(STAGED_ENV)
    import torch

    from racon_tpu_torch import cli, obs
    from racon_tpu_torch.cuda import build
    from racon_tpu_torch.cuda.polisher import CudaPolisher

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("contig_ladder run: no CUDA device")
    for name, value in overrides.items():
        if not hasattr(CudaPolisher, name):
            raise SystemExit(f"CudaPolisher has no {name}")
        setattr(CudaPolisher, name, type(getattr(CudaPolisher, name))(
            value))
    if device == "cuda":
        build.build_all()
    probe_s = []
    real_probe = CudaPolisher._probe_divergence

    def timed_probe(self, pending):
        t0 = obs.now()
        try:
            return real_probe(self, pending)
        finally:
            probe_s.append(obs.now() - t0)

    CudaPolisher._probe_divergence = timed_probe
    argv = ["--device", device, "-t", str(threads), "-m", "5", "-x", "-4",
            "-g", "-8", "-c", "1", "--cudaaligner-batches", "1",
            *(os.path.join(data, n) for n in
              ("reads.fastq", "reads2draft.paf", "draft.fasta"))]
    lines = []
    for rep in range(repeat):
        before = launch_counts()
        probe_s.clear()
        out = io.BytesIO()
        t0 = obs.now()
        polisher = cli.main(argv, out=out)
        wall = obs.now() - t0
        after = launch_counts()
        rungs = getattr(polisher, "align_rungs", {})
        lines.append({
            "data": os.path.basename(os.path.normpath(data)),
            "repeat": rep, "overrides": overrides,
            "contigs": out.getvalue().count(b">"),
            "wall_s": round(wall, 3),
            "align_s": round(polisher.stage_walls.get("align", 0.0), 3),
            "probe_s": round(sum(probe_s), 3),
            "probed_pairs": getattr(polisher, "align_probed", None),
            "rungs": {name: r.get("certified") for name, r in
                      rungs.items()},
            "launches": {k: after[k] - before.get(k, 0) for k in after},
            "sha256": hashlib.sha256(out.getvalue()).hexdigest()[:16]})
        polisher.close()
        print(json.dumps(lines[-1]), flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("dir")
    mk.add_argument("--contigs", default="4,100")
    mk.add_argument("--genome-len", type=int, default=4_641_652)
    rn = sub.add_parser("run")
    rn.add_argument("dir")
    rn.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    rn.add_argument("--repeat", type=int, default=1)
    rn.add_argument("--device", default="cuda",
                    help="cpu: the kernels' plain versions, a dry run")
    rn.add_argument("--set", action="append", default=[],
                    metavar="NAME=VALUE")
    args = ap.parse_args(argv)
    if args.cmd == "make":
        print(json.dumps(make(args.dir, [int(n) for n in
                                         args.contigs.split(",")],
                              args.genome_len)), flush=True)
        return 0
    overrides = dict(kv.split("=", 1) for kv in args.set)
    run(args.dir, args.threads, args.repeat, overrides, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
