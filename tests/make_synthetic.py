"""Synthetic genome + reads generator for end-to-end tests and benches.

Generates a random viral-sized genome, tiles deep-coverage reads over it
(both strands), plants major and minor SNVs at known positions, and writes
FASTA/FASTQ files.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

COMP = {65: 84, 67: 71, 71: 67, 84: 65}


def revcomp_bytes(seq: bytes) -> bytes:
    return bytes(COMP[b] for b in reversed(seq))


def make_genome(rng, length: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length))


def mutate(base: int, rng) -> int:
    choices = [b for b in b"ACGT" if b != base]
    return choices[rng.integers(3)]


def make_sample(
    genome: bytes,
    rng,
    read_len: int = 100,
    depth: int = 60,
    major_positions: dict[int, float] | None = None,
    minor_positions: dict[int, float] | None = None,
    error_rate: float = 0.0,
):
    """Tile reads uniformly; at planted positions substitute the alt base
    with the given fraction. Returns list of read bytes."""
    L = len(genome)
    majors = major_positions or {}
    minors = minor_positions or {}
    alts = {p: mutate(genome[p], rng) for p in {**majors, **minors}}
    fracs = {**majors, **minors}
    reads = []
    n_reads = depth * L // read_len
    for _ in range(n_reads):
        start = int(rng.integers(0, L - read_len + 1))
        r = bytearray(genome[start:start + read_len])
        for p, frac in fracs.items():
            if start <= p < start + read_len and rng.random() < frac:
                r[p - start] = alts[p]
        if error_rate > 0:
            for j in range(read_len):
                if rng.random() < error_rate:
                    r[j] = mutate(r[j], rng)
        r = bytes(r)
        if rng.random() < 0.5:
            r = revcomp_bytes(r)
        reads.append(r)
    return reads, alts


_COMP_CODES = np.zeros(256, np.uint8)
for _a, _b in COMP.items():
    _COMP_CODES[_a] = _b


def make_reads(genome: bytes, rng, n: int, read_len: int,
               planted: dict[int, tuple[int, float]],
               error_rate: float = 0.0) -> np.ndarray:
    """Vectorized read sampler: (n, read_len) uint8 ASCII bases.

    Reads start uniformly; a read covering planted position p carries the
    alt base a with probability f (planted[p] = (a, f)); every base is
    then substituted with probability error_rate; half the reads are
    reverse-complemented."""
    g = np.frombuffer(genome, np.uint8)
    starts = rng.integers(0, len(g) - read_len + 1, n)
    reads = g[starts[:, None] + np.arange(read_len)]
    for p, (alt, frac) in sorted(planted.items()):
        hit = (starts <= p) & (p < starts + read_len) & (rng.random(n) < frac)
        reads[hit, p - starts[hit]] = alt
    if error_rate > 0:
        err = rng.random(reads.shape) < error_rate
        code = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), reads[err])
        shift = rng.integers(1, 4, code.size)
        reads[err] = np.frombuffer(b"ACGT", np.uint8)[(code + shift) % 4]
    flip = rng.random(n) < 0.5
    reads[flip] = _COMP_CODES[reads[flip, ::-1]]
    return reads


def plant_variants(genome: bytes, rng, n_major: int, n_minor: int,
                   margin: int = 1000) -> dict[int, tuple[int, float]]:
    """Major (fraction 0.9) and minor (0.05-0.25) SNVs at random positions
    at least `margin` bp from either end: {pos: (alt base, fraction)}."""
    L = len(genome)
    out = {}
    for p in rng.integers(margin, L - margin, n_major):
        out[int(p)] = (mutate(genome[p], rng), 0.9)
    for p, f in zip(rng.integers(margin, L - margin, n_minor),
                    0.05 + 0.2 * rng.random(n_minor)):
        out.setdefault(int(p), (mutate(genome[p], rng), float(f)))
    return out


def write_fastq_array(path: str, reads: np.ndarray,
                      compresslevel: int = 1) -> None:
    """Write an (n, L) uint8 read matrix as (gzipped) FASTQ."""
    qual = b"I" * reads.shape[1]
    text = b"".join(b"@read%d\n%s\n+\n%s\n" % (i, r.tobytes(), qual)
                    for i, r in enumerate(reads))
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=compresslevel) as fh:
            fh.write(text)
    else:
        with open(path, "wb") as fh:
            fh.write(text)


def write_pairs(path1: str, path2: str, genome: bytes, rng, n_pairs: int,
                read_len: int, insert: int,
                planted: dict[int, tuple[int, float]],
                error_rate: float = 0.0) -> None:
    """Paired-end reads: fragments of `insert` bp (strand-flipped like
    make_reads); mate 1 is the fragment's first read_len bases, mate 2 the
    reverse complement of its last read_len bases."""
    frags = make_reads(genome, rng, n_pairs, insert, planted, error_rate)
    r1 = np.ascontiguousarray(frags[:, :read_len])
    r2 = _COMP_CODES[frags[:, ::-1][:, :read_len]]
    write_fastq_array(path1, r1)
    write_fastq_array(path2, r2)


def write_fasta(path: str, name: str, seq: bytes) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i:i + 70].decode() + "\n")


def write_fastq(path: str, reads: list[bytes]) -> None:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@read{i}\n{r.decode()}\n+\n{'I' * len(r)}\n")


def main(out_dir: str = "/tmp/bronko_synth", seed: int = 0):
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    genome = make_genome(rng, 3000)
    majors = {500: 0.95, 1500: 0.8}
    minors = {900: 0.15, 2100: 0.10}
    reads, alts = make_sample(genome, rng, depth=80,
                              major_positions=majors, minor_positions=minors)
    write_fasta(os.path.join(out_dir, "ref.fasta"), "synth_ref", genome)
    write_fastq(os.path.join(out_dir, "sample.fastq.gz"), reads)
    planted = {p: (chr(genome[p]), chr(a)) for p, a in alts.items()}
    print(f"genome=3000bp reads={len(reads)} planted={planted}")
    return out_dir, planted


if __name__ == "__main__":
    main()
