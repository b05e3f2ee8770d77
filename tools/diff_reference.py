#!/usr/bin/env python
"""Differential harness: bronko-tpu vs the reference `bronko` binary.

Runs both pipelines on identical inputs and diffs every output artifact
byte-for-byte (VCFs, pileup TSVs, bronko_overview.tsv, .mfa alignments).
The reference binary needs KMC3 (`kmc`, `kmc_tools`) on PATH for `call`;
`build` needs only the binary. Skips cleanly (exit 0, "SKIP") when tools
are absent, so this can sit in CI and light up the moment a toolchain
appears (BASELINE.md correctness criterion: bit-identical VCFs).

Usage:
  python tools/diff_reference.py                      # synthetic end-to-end
  python tools/diff_reference.py --genomes a.fa b.fa --reads r.fastq.gz
  python tools/diff_reference.py --bronko /path/to/bronko --keep

Exit codes: 0 = identical (or SKIP), 1 = any byte difference, 2 = a
pipeline crashed.
"""

from __future__ import annotations

import argparse
import filecmp
import os
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def which(prog: str) -> str | None:
    return shutil.which(prog)


def run(cmd: list[str], **kw) -> subprocess.CompletedProcess:
    print("+", " ".join(cmd), file=sys.stderr)
    return subprocess.run(cmd, capture_output=True, text=True, **kw)


def make_synthetic(tmp: str) -> tuple[list[str], list[str]]:
    sys.path.insert(0, REPO)
    import numpy as np

    from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq

    rng = np.random.default_rng(11)
    genomes = []
    for g in range(2):
        seq = make_genome(rng, 5000)
        p = os.path.join(tmp, f"ref{g}.fasta")
        write_fasta(p, f"ref{g}", seq)
        genomes.append(p)
        if g == 0:
            majors = {1200: 0.95, 3300: 0.9}
            reads, _ = make_sample(seq, rng, read_len=150, depth=120,
                                   major_positions=majors, minor_positions={},
                                   error_rate=0.002)
            fq = os.path.join(tmp, "sample.fastq.gz")
            write_fastq(fq, reads)
    return genomes, [fq]


def diff_trees(a: str, b: str) -> list[str]:
    """Byte-compare every regular file present in either tree."""
    bad: list[str] = []
    files_a = {os.path.relpath(os.path.join(r, f), a)
               for r, _, fs in os.walk(a) for f in fs}
    files_b = {os.path.relpath(os.path.join(r, f), b)
               for r, _, fs in os.walk(b) for f in fs}
    for rel in sorted(files_a | files_b):
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if not os.path.exists(pa):
            bad.append(f"only in reference output: {rel}")
        elif not os.path.exists(pb):
            bad.append(f"only in bronko-tpu output: {rel}")
        elif not filecmp.cmp(pa, pb, shallow=False):
            bad.append(f"differs: {rel}")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bronko", default=None, help="path to the reference binary (default: PATH)")
    ap.add_argument("--genomes", nargs="+", default=None)
    ap.add_argument("--reads", nargs="+", default=None)
    ap.add_argument("--kmer", type=int, default=21)
    ap.add_argument("--keep", action="store_true", help="keep the work dir")
    args = ap.parse_args()

    bronko = args.bronko or which("bronko")
    if not bronko:
        print("SKIP: no `bronko` binary on PATH (pass --bronko to point at one)")
        return 0
    if not which("kmc") or not which("kmc_tools"):
        print("SKIP: KMC3 (`kmc`, `kmc_tools`) not on PATH — reference `call` needs it")
        return 0

    tmp = tempfile.mkdtemp(prefix="bronko_diff_")
    try:
        if args.genomes and args.reads:
            genomes, reads = args.genomes, args.reads
        else:
            genomes, reads = make_synthetic(tmp)

        env = dict(os.environ, JAX_PLATFORMS=os.environ.get("JAX_PLATFORMS", "cpu"),
                   PYTHONPATH=REPO)
        out_ref = os.path.join(tmp, "out_ref")
        out_ours = os.path.join(tmp, "out_ours")

        # build + call with the reference binary
        r = run([bronko, "call", "-g", *genomes, "-r", *reads,
                 "-k", str(args.kmer), "-o", out_ref, "--pileup"], cwd=tmp)
        if r.returncode != 0:
            print(f"reference pipeline failed ({r.returncode}):\n{r.stderr[-2000:]}")
            return 2
        # the same flags through bronko-tpu
        r = run([sys.executable, "-m", "bronko_tpu", "call", "-g", *genomes,
                 "-r", *reads, "-k", str(args.kmer), "-o", out_ours, "--pileup"],
                cwd=tmp, env=env)
        if r.returncode != 0:
            print(f"bronko-tpu pipeline failed ({r.returncode}):\n{r.stderr[-2000:]}")
            return 2

        bad = diff_trees(out_ref, out_ours)
        if bad:
            print("DIFFERS:")
            for b in bad:
                print(" ", b)
            print(f"work dir kept at {tmp}")
            return 1
        print(f"IDENTICAL: every output file byte-equal across "
              f"{len(os.listdir(out_ours))} artifacts")
        return 0
    finally:
        if not args.keep and os.path.isdir(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
