"""End-to-end oracle fuzz: the ENGINE's VCF vs a fully composed oracle
pipeline that shares no compute code with the product.

The existing oracle tests validate each stage in isolation (counter,
mapper, noise scan, caller); golden files only protect against
regressions of the pipeline against itself (VERDICT r1 weak #4). This
test closes the composition gap: random panels and read sets go through

  count   — collections.Counter over read windows (KMC -b -ci -cs
            semantics, N-reset), pure test code;
  map     — tests/oracle/map_oracle (scalar transcription of
            build.rs:145-231 + call.rs:1257-1434);
  select  — argmax perfect/(2*len) transcribed inline (call.rs:422-450);
  noise   — tests/oracle/noise_oracle (independent transcription of
            call.rs:799-967; tau from the mpmath-pinned table);
  call    — tests/oracle/variants_oracle with the oracle noise injected;
  format  — the reference's VCF row spec (call.rs:763-772) transcribed
            inline;

and the resulting data lines must equal the engine's VCF byte-for-byte
(including float formatting), plus the overview's selected genome."""

from __future__ import annotations

import os

import numpy as np
import pytest

from bronko_tpu.call.engine import run_call
from bronko_tpu.call.noise import _tau
from bronko_tpu.config import CallConfig
from bronko_tpu.index.build import build_index
from bronko_tpu.index.layout import build_device_index
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq
from tests.oracle.lcb_oracle import kmer_to_u64
from tests.oracle.map_oracle import build_oracle_index, map_kmers_oracle
from tests.oracle.noise_oracle import reference_noise_scan
from tests.oracle.variants_oracle import call_variants_oracle

_ACGT = frozenset(b"ACGT")


def _count_oracle(reads: list[bytes], k: int, ci: int = 3,
                  cs: int = 1_000_000) -> list[tuple[int, int]]:
    """KMC `-b -ci<ci> -cs<cs>` semantics: non-canonical k-mer counts,
    windows containing non-ACGT dropped, floor ci, cap cs."""
    from collections import Counter

    c: Counter = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i:i + k]
            if all(b in _ACGT for b in w):
                c[kmer_to_u64(w)] += 1
    return [(km, min(n, cs)) for km, n in sorted(c.items()) if n >= ci]


def _oracle_vcf_lines(files, kmer_counts, k: int,
                      n_fixed: int = 2, use_full_kmer: bool = False,
                      **caller_kw) -> tuple[list[str], str]:
    """Compose the oracle stages into VCF data lines + the selected name.
    caller_kw forwards filter-cascade flags to the caller oracle."""
    idx = build_oracle_index(k, files)
    maps, tallies = map_kmers_oracle(kmer_counts, idx, n_fixed=n_fixed,
                                     use_full_kmer=use_full_kmer)

    best, best_score = None, 0.0
    for fid, (fname, seqs) in enumerate(files):
        glen = sum(len(s) for _, s in seqs)
        score = tallies.get(fid, [0, 0, 0])[0] / glen / 2.0
        if score > best_score:
            best, best_score = fid, score
    assert best is not None, "oracle picked no genome"

    lines = []
    for sname, seq in files[best][1]:
        m = maps[best][sname]
        noise = reference_noise_scan(m["fwd"], m["rev"], _tau)
        recs, *_ = call_variants_oracle(
            sname, seq, m["fwd"], m["rev"], m["fwd_cnt"], m["rev_cnt"],
            k=k, noise_max=noise[:, 0], **caller_kw)
        for r in recs:
            # VCF row spec transcribed from call.rs:763-772
            lines.append(
                f"{r['seq']}\t{r['pos']}\t.\t{'ACGT'[r['ref_base']]}\t"
                f"{'ACGT'[r['alt_base']]}\t.\tPASS\t"
                f"DP={r['depth']};AF={r['af']:.3f};"
                f"DP4={r['fwd_ref']},{r['rev_ref']},{r['fwd_alt']},{r['rev_alt']};"
                f"SOR={r['sor']:.3f}")
    return lines, files[best][0]


def _engine_vcf_lines(tmp_path, fasta_paths, fq, tag, **cfg_kw):
    out = str(tmp_path / f"out_{tag}")
    cfg = CallConfig(genomes=list(fasta_paths), reads=[fq], output=out,
                     batch_size=4096, chunk_reads=8192, **cfg_kw)
    index = build_index(cfg.kmer, list(fasta_paths))
    run_call(cfg, index, build_device_index(index))
    vcf = [f for f in os.listdir(out) if f.endswith(".vcf")]
    assert len(vcf) == 1
    with open(os.path.join(out, vcf[0])) as fh:
        lines = [ln.rstrip("\n") for ln in fh
                 if not ln.startswith("#")]
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        fh.readline()
        selected = fh.readline().split("\t")[1]
    return lines, selected


CASES = [
    # (seed, n_genomes, glen, depth, err, n_major, n_minor, reads_from)
    (11, 3, 500, 350, 0.004, 2, 3, 0),
    (22, 2, 700, 120, 0.01, 3, 0, 1),   # shallow: minors blocked by depth
    (33, 4, 450, 320, 0.002, 1, 4, 2),  # selection among 4 genomes
]


@pytest.mark.parametrize("seed,n_g,glen,depth,err,n_maj,n_min,src", CASES)
def test_engine_equals_composed_oracle(tmp_path, seed, n_g, glen, depth,
                                       err, n_maj, n_min, src):
    rng = np.random.default_rng(seed)
    k = 21
    files = []
    fasta_paths = []
    for g in range(n_g):
        seq = make_genome(rng, glen + 40 * g)
        p = str(tmp_path / f"g{seed}_{g}.fasta")
        write_fasta(p, f"seq{g}", seq)
        fasta_paths.append(p)
        files.append((f"g{seed}_{g}", [(f"seq{g}", seq)]))

    genome = files[src][1][0][1]
    L = len(genome)
    majors = {int(p): 0.9 for p in rng.integers(50, L - 50, n_maj)}
    minors = {int(p): float(f) for p, f in zip(
        rng.integers(50, L - 50, n_min), 0.08 + 0.3 * rng.random(n_min))}
    reads, _ = make_sample(genome, rng, read_len=100, depth=depth,
                           major_positions=majors, minor_positions=minors,
                           error_rate=err)
    fq = str(tmp_path / f"s{seed}.fastq.gz")
    write_fastq(fq, reads)

    kmer_counts = _count_oracle(reads, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)
    got_lines, got_name = _engine_vcf_lines(tmp_path, fasta_paths, fq, seed)

    assert got_name == want_name
    assert got_lines == want_lines
    # the fuzz must exercise real calls, not vacuous empty VCFs
    if n_maj and depth >= 60:
        assert len(got_lines) >= 1


FLAG_COMBOS = [
    # (CallConfig kwargs, oracle kwargs)
    (dict(use_full_kmer=True), dict(use_full_kmer=True)),
    (dict(no_end_filter=True), dict(caller=dict(filter_end_seq=False))),
    (dict(no_strand_filter=True), dict(caller=dict(strand_filter=False))),
    (dict(no_strand_balance_filter=True),
     dict(caller=dict(no_strand_balance_filter=True))),
    (dict(min_af=0.1, min_depth=50, min_variant_depth=2,
          variant_multiplier=2.0, strand_odds_max=3.0, n_per_strand=1),
     dict(caller=dict(min_af=0.1, min_depth=50, min_variant_depth=2,
                      variant_multiplier=2.0, strand_odds_max=3.0,
                      n_per_strand=1))),
    (dict(n_fixed=4), dict(n_fixed=4)),
]


@pytest.mark.parametrize("cfg_kw,oracle_kw", FLAG_COMBOS)
def test_engine_equals_oracle_flag_combos(tmp_path, cfg_kw, oracle_kw):
    """The filter cascade's flag surface composed end-to-end: each flag
    must steer the ENGINE and the ORACLE identically (call.rs:30-136
    flags through the full pipeline, not just the caller unit)."""
    rng = np.random.default_rng(99)
    k = 21
    seq = make_genome(rng, 520)
    p = str(tmp_path / "fc.fasta")
    write_fasta(p, "fcseq", seq)
    files = [("fc", [("fcseq", seq)])]
    majors = {int(q): 0.85 for q in rng.integers(60, 460, 2)}
    minors = {int(rng.integers(60, 460)): 0.25}
    reads, _ = make_sample(seq, rng, read_len=100, depth=330,
                           major_positions=majors, minor_positions=minors,
                           error_rate=0.004)
    fq = str(tmp_path / "fc.fastq.gz")
    write_fastq(fq, reads)

    kmer_counts = _count_oracle(reads, k)
    ok = dict(oracle_kw)
    caller_kw = ok.pop("caller", {})
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k,
                                              **ok, **caller_kw)
    got_lines, got_name = _engine_vcf_lines(
        tmp_path, [p], fq, "fc" + str(hash(str(cfg_kw)) % 1000), **cfg_kw)

    assert got_name == want_name
    assert got_lines == want_lines


def test_engine_equals_oracle_paired(tmp_path):
    """Paired-end composition: the reference counts R1 and R2 as SEPARATE
    k-mer streams (two KMC runs) and maps both into shared pileups
    (call.rs:301-320) — a k-mer present in both mates scatters twice with
    each mate's own count (depth max per entry, +1 count per entry). The
    oracle reproduces that by concatenating the two counted streams as
    independent entries; the engine's concatenated-stream path must
    match byte-for-byte."""
    rng = np.random.default_rng(44)
    k = 21
    files = []
    fasta_paths = []
    for g in range(2):
        seq = make_genome(rng, 600 + 50 * g)
        p = str(tmp_path / f"pg{g}.fasta")
        write_fasta(p, f"seq{g}", seq)
        fasta_paths.append(p)
        files.append((f"pg{g}", [(f"seq{g}", seq)]))
    genome = files[0][1][0][1]
    L = len(genome)
    majors = {int(q): 0.88 for q in rng.integers(50, L - 50, 2)}
    minors = {int(rng.integers(50, L - 50)): 0.22}
    r1, _ = make_sample(genome, rng, read_len=100, depth=180,
                        major_positions=majors, minor_positions=minors,
                        error_rate=0.003)
    r2, _ = make_sample(genome, rng, read_len=100, depth=180,
                        major_positions=majors, minor_positions=minors,
                        error_rate=0.003)
    fq1 = str(tmp_path / "p_R1.fastq.gz")
    fq2 = str(tmp_path / "p_R2.fastq.gz")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)

    kmer_counts = _count_oracle(r1, k) + _count_oracle(r2, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)

    out = str(tmp_path / "out_paired")
    cfg = CallConfig(genomes=fasta_paths, first_pairs=[fq1],
                     second_pairs=[fq2], output=out,
                     batch_size=4096, chunk_reads=8192)
    index = build_index(cfg.kmer, fasta_paths)
    run_call(cfg, index, build_device_index(index))
    vcf = [f for f in os.listdir(out) if f.endswith(".vcf")]
    assert len(vcf) == 1
    with open(os.path.join(out, vcf[0])) as fh:
        got_lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        fh.readline()
        got_name = fh.readline().split("\t")[1]

    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 1  # non-vacuous (filters may eat some plants)


def test_engine_equals_oracle_with_n_bases(tmp_path):
    """Reads containing N: the counter must drop every window that covers
    an N (KMC behavior); the oracle counter does the same, so the VCFs
    must still agree exactly."""
    rng = np.random.default_rng(55)
    k = 21
    seq = make_genome(rng, 550)
    p = str(tmp_path / "ng.fasta")
    write_fasta(p, "seqN", seq)
    files = [("ng", [("seqN", seq)])]
    majors = {int(q): 0.9 for q in rng.integers(50, 500, 2)}
    reads, _ = make_sample(seq, rng, read_len=100, depth=340,
                           major_positions=majors,
                           minor_positions={260: 0.18}, error_rate=0.003)
    # sprinkle N into ~20% of reads at random offsets
    noisy = []
    for r in reads:
        if rng.random() < 0.2:
            b = bytearray(r)
            for _ in range(int(rng.integers(1, 4))):
                b[int(rng.integers(0, len(b)))] = ord("N")
            r = bytes(b)
        noisy.append(r)
    fq = str(tmp_path / "n.fastq.gz")
    write_fastq(fq, noisy)

    kmer_counts = _count_oracle(noisy, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)
    got_lines, got_name = _engine_vcf_lines(tmp_path, [p], fq, "nb")

    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 1


def test_engine_equals_oracle_alignment(tmp_path):
    """--alignment composed end-to-end: four samples on one genome, the
    .mfa must equal an inline transcription of build_alignments
    (call.rs:504-628: breadth >= 0.90 filter, >= 3 samples per genome,
    union of major-variant positions, ref row + per-sample rows)."""
    rng = np.random.default_rng(77)
    k = 21
    seq = make_genome(rng, 600)
    p = str(tmp_path / "al.fasta")
    write_fasta(p, "alseq", seq)
    files = [("al", [("alseq", seq)])]

    fqs, per_sample = [], []
    for s_i in range(4):
        majors = {int(q): 0.9 for q in rng.integers(60, 540, 2 + s_i % 2)}
        reads, _ = make_sample(seq, rng, read_len=100, depth=320,
                               major_positions=majors,
                               minor_positions={}, error_rate=0.003)
        fq = str(tmp_path / f"al{s_i}.fastq.gz")
        write_fastq(fq, reads)
        fqs.append(fq)
        per_sample.append(reads)

    # engine with --alignment
    out = str(tmp_path / "out_al")
    cfg = CallConfig(genomes=[p], reads=fqs, output=out,
                     output_alignment=True, batch_size=4096,
                     chunk_reads=8192)
    index = build_index(k, [p])
    run_call(cfg, index, build_device_index(index))

    # oracle: per-sample records + breadth through the composed stages
    idx = build_oracle_index(k, files)
    sample_rows = []           # (sample_path, {(seq,pos): alt}, breadth)
    all_positions = {}         # (seq,pos) -> ref_base  (majors only)
    for fq, reads in zip(fqs, per_sample):
        maps, tallies = map_kmers_oracle(_count_oracle(reads, k), idx)
        m = maps[0]["alseq"]
        noise = reference_noise_scan(m["fwd"], m["rev"], _tau)
        recs, n_maj, n_min, cov, _tot, L = call_variants_oracle(
            "alseq", seq, m["fwd"], m["rev"], m["fwd_cnt"], m["rev_cnt"],
            k=k, noise_max=noise[:, 0])
        breadth = cov / L
        if breadth < 0.90:
            continue  # filtered samples contribute NO positions
        smap = {}
        for r in recs:
            if r["af"] >= 0.5:
                all_positions[(r["seq"], r["pos"])] = r["ref_base"]
                smap[(r["seq"], r["pos"])] = r["alt_base"]
        sample_rows.append((fq, smap))
    assert len(sample_rows) >= 3, "fixture must clear the >=3-sample gate"
    positions = sorted(all_positions)
    want = [">al", "".join("ACGT"[all_positions[q]] for q in positions)]
    from bronko_tpu.io.naming import clean_sample_id

    for fq, smap in sample_rows:
        want.append(f">{clean_sample_id(fq)}")
        want.append("".join(
            "ACGT"[smap.get(q, all_positions[q])] for q in positions))

    mfa = os.path.join(out, "al.mfa")
    assert os.path.exists(mfa)
    got = open(mfa).read().splitlines()
    assert got == want


def test_engine_equals_oracle_multicontig(tmp_path):
    """Best file with two contigs: per-sequence noise windows, per-contig
    VCF ordering, and contig-local coordinates all composed."""
    rng = np.random.default_rng(7)
    k = 21
    seq_a = make_genome(rng, 520)
    seq_b = make_genome(rng, 430)
    p = str(tmp_path / "multi.fasta")
    with open(p, "w") as fh:
        fh.write(f">ctgA\n{seq_a.decode()}\n>ctgB\n{seq_b.decode()}\n")
    files = [("multi", [("ctgA", seq_a), ("ctgB", seq_b)])]

    reads = []
    for seq in (seq_a, seq_b):
        majors = {int(q): 0.85 for q in rng.integers(60, len(seq) - 60, 2)}
        rs, _ = make_sample(seq, rng, read_len=100, depth=330,
                            major_positions=majors,
                            minor_positions={int(rng.integers(60, len(seq) - 60)): 0.2},
                            error_rate=0.003)
        reads.extend(rs)
    fq = str(tmp_path / "multi.fastq.gz")
    write_fastq(fq, reads)

    kmer_counts = _count_oracle(reads, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)
    got_lines, got_name = _engine_vcf_lines(tmp_path, [p], fq, "mc")

    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 2


def test_engine_equals_oracle_via_bincode_roundtrip(tmp_path):
    """Interop composition (VERDICT r2 item 8): the engine `call` fed by a
    reference-format bincode .bkdb that OUR writer produced and OUR reader
    loaded back (writer -> reader -> engine) must byte-equal the composed
    oracle — the db that round-trips through the reference's on-disk
    format carries exactly the same index semantics as the in-memory
    build (build.rs:122-143 + call.rs:179-200)."""
    from bronko_tpu.index.bincode_compat import (
        load_reference_bkdb, save_reference_bkdb,
    )

    rng = np.random.default_rng(77)
    k = 21
    files = []
    fasta_paths = []
    for g in range(3):
        seq = make_genome(rng, 480 + 35 * g)
        p = str(tmp_path / f"bg{g}.fasta")
        write_fasta(p, f"seq{g}", seq)
        fasta_paths.append(p)
        files.append((f"bg{g}", [(f"seq{g}", seq)]))
    genome = files[1][1][0][1]
    L = len(genome)
    majors = {int(q): 0.9 for q in rng.integers(50, L - 50, 2)}
    minors = {int(rng.integers(50, L - 50)): 0.2}
    reads, _ = make_sample(genome, rng, read_len=100, depth=300,
                           major_positions=majors, minor_positions=minors,
                           error_rate=0.003)
    fq = str(tmp_path / "bk.fastq.gz")
    write_fastq(fq, reads)

    kmer_counts = _count_oracle(reads, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)

    # build -> reference-format write -> read back -> call
    index0 = build_index(k, fasta_paths)
    bkdb = str(tmp_path / "roundtrip.bkdb")
    save_reference_bkdb(index0, bkdb)
    index = load_reference_bkdb(bkdb)

    out = str(tmp_path / "out_bincode")
    cfg = CallConfig(db=bkdb, reads=[fq], output=out,
                     batch_size=4096, chunk_reads=8192)
    run_call(cfg, index, build_device_index(index))
    vcf = [f for f in os.listdir(out) if f.endswith(".vcf")]
    assert len(vcf) == 1
    with open(os.path.join(out, vcf[0])) as fh:
        got_lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        fh.readline()
        got_name = fh.readline().split("\t")[1]

    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 1


def test_engine_oracle_paired_mesh_pileup_combo(tmp_path):
    """Combined-flag composition (VERDICT r2 item 8): paired-end + --mesh
    2x2 + --pileup in ONE run. The VCF must byte-equal the composed
    paired oracle AND the single-device engine run (mesh collectives are
    order-independent integer merges), and the pileup TSV must match the
    single-device run byte-for-byte."""
    import jax

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    rng = np.random.default_rng(55)
    k = 21
    files = []
    fasta_paths = []
    for g in range(3):
        seq = make_genome(rng, 520 + 45 * g)
        p = str(tmp_path / f"mg{g}.fasta")
        write_fasta(p, f"seq{g}", seq)
        fasta_paths.append(p)
        files.append((f"mg{g}", [(f"seq{g}", seq)]))
    genome = files[0][1][0][1]
    L = len(genome)
    majors = {int(q): 0.9 for q in rng.integers(50, L - 50, 3)}
    minors = {int(rng.integers(50, L - 50)): 0.24}
    r1, _ = make_sample(genome, rng, read_len=100, depth=200,
                        major_positions=majors, minor_positions=minors,
                        error_rate=0.003)
    r2, _ = make_sample(genome, rng, read_len=100, depth=200,
                        major_positions=majors, minor_positions=minors,
                        error_rate=0.003)
    fq1 = str(tmp_path / "m_R1.fastq.gz")
    fq2 = str(tmp_path / "m_R2.fastq.gz")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)

    kmer_counts = _count_oracle(r1, k) + _count_oracle(r2, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)

    def run(tag, **kw):
        out = str(tmp_path / f"out_{tag}")
        cfg = CallConfig(genomes=fasta_paths, first_pairs=[fq1],
                         second_pairs=[fq2], output=out, output_pileup=True,
                         batch_size=4096, chunk_reads=8192, **kw)
        index = build_index(cfg.kmer, fasta_paths)
        run_call(cfg, index, build_device_index(index))
        vcf = [f for f in os.listdir(out) if f.endswith(".vcf")]
        assert len(vcf) == 1
        with open(os.path.join(out, vcf[0])) as fh:
            lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
        pil = [f for f in os.listdir(out)
               if f.endswith(".tsv") and f != "bronko_overview.tsv"]
        assert len(pil) == 1
        with open(os.path.join(out, pil[0]), "rb") as fh:
            pileup_bytes = fh.read()
        with open(os.path.join(out, "bronko_overview.tsv")) as fh:
            fh.readline()
            name = fh.readline().split("\t")[1]
        return lines, name, pileup_bytes

    got_m, name_m, pil_m = run("combo_mesh", mesh="2x2")
    got_s, name_s, pil_s = run("combo_single")

    assert name_m == want_name == name_s
    assert got_m == want_lines
    assert got_s == want_lines
    assert pil_m == pil_s
    assert len(got_m) >= 1


EXTRA_CASES = [
    # new seeds widening the fuzz surface (VERDICT r2 item 8)
    (101, 5, 400, 340, 0.006, 2, 2, 3),   # 5-genome selection, noisier
    (202, 2, 900, 500, 0.001, 4, 5, 1),   # long genome, deep, many plants
]


@pytest.mark.parametrize("seed,n_g,glen,depth,err,n_maj,n_min,src",
                         EXTRA_CASES)
def test_engine_equals_composed_oracle_extra(tmp_path, seed, n_g, glen,
                                             depth, err, n_maj, n_min, src):
    test_engine_equals_composed_oracle(tmp_path, seed, n_g, glen, depth,
                                       err, n_maj, n_min, src)


def _mesh_engine_vcf_lines(tmp_path, fasta_paths, fq, tag, expect_layout,
                           **cfg_kw):
    """Run the engine with --mesh and return (data lines, selected name),
    asserting the intended intra-batch layout actually engaged
    (engine.LAST_MESH_LAYOUTS)."""
    import bronko_tpu.call.engine as eng

    out = str(tmp_path / f"out_{tag}")
    cfg = CallConfig(genomes=list(fasta_paths), reads=[fq], output=out,
                     chunk_reads=8192, **cfg_kw)
    index = build_index(cfg.kmer, list(fasta_paths))
    run_call(cfg, index, build_device_index(index))
    assert expect_layout in eng.LAST_MESH_LAYOUTS, (
        f"{tag}: wanted layout {expect_layout}, engine took "
        f"{set(eng.LAST_MESH_LAYOUTS)}")
    vcf = [f for f in os.listdir(out) if f.endswith(".vcf")]
    assert len(vcf) == 1
    with open(os.path.join(out, vcf[0])) as fh:
        lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        fh.readline()
        selected = fh.readline().split("\t")[1]
    return lines, selected


@pytest.mark.parametrize("tag,mesh,batch,expect_layout", [
    # single-batch panel big enough that (D-1)*U*20 > 3*N2 -> ROUTED
    # (the production single-batch layout: key table range-partitioned
    # over 'data', queries travel via all_to_all)
    ("mesh_routed", "4x2", 4096, "routed"),
    # small batches force nb >= n_data (nb rounds to a power of two,
    # engine.py batching) -> whole-batch BATCHWISE sharding
    ("mesh_batchwise", "8x1", 256, "batchwise"),
])
def test_engine_equals_oracle_mesh_layouts(tmp_path, tag, mesh, batch,
                                           expect_layout):
    """VERDICT r4 item 6: the e2e oracle composition run through the
    --mesh engine on the 8-device CPU mesh, per intra-batch layout. The
    mesh engine's VCF must byte-equal the composed scalar oracle (not
    just the single-device engine), and the test asserts which layout
    ran so the routed path is oracle-covered by construction."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(77)
    k = 21
    files = []
    fasta_paths = []
    for g in range(3):
        seq = make_genome(rng, 500 + 40 * g)
        p = str(tmp_path / f"ml{g}.fasta")
        write_fasta(p, f"seq{g}", seq)
        fasta_paths.append(p)
        files.append((f"ml{g}", [(f"seq{g}", seq)]))
    genome = files[1][1][0][1]
    L = len(genome)
    majors = {int(q): 0.9 for q in rng.integers(50, L - 50, 2)}
    minors = {int(rng.integers(50, L - 50)): 0.22}
    reads, _ = make_sample(genome, rng, read_len=100, depth=340,
                           major_positions=majors, minor_positions=minors,
                           error_rate=0.004)
    fq = str(tmp_path / "ml.fastq.gz")
    write_fastq(fq, reads)

    kmer_counts = _count_oracle(reads, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)

    got_lines, got_name = _mesh_engine_vcf_lines(
        tmp_path, fasta_paths, fq, tag, expect_layout,
        mesh=mesh, batch_size=batch)
    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 1


def test_engine_equals_oracle_mesh_bsplit(tmp_path):
    """The B-SPLIT layout (tiny panel: (D-1)*U*20 <= 3*N2 flips the
    routed crossover) through the oracle composition — the third and
    last production intra-batch layout, oracle-checked."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    rng = np.random.default_rng(88)
    k = 21
    seq = make_genome(rng, 120)
    p = str(tmp_path / "bs.fasta")
    write_fasta(p, "bsq", seq)
    files = [("bs", [("bsq", seq)])]
    majors = {60: 0.9}
    reads, _ = make_sample(seq, rng, read_len=60, depth=300,
                           major_positions=majors, minor_positions={},
                           error_rate=0.002)
    fq = str(tmp_path / "bs.fastq.gz")
    write_fastq(fq, reads)

    kmer_counts = _count_oracle(reads, k)
    want_lines, want_name = _oracle_vcf_lines(files, kmer_counts, k)

    got_lines, got_name = _mesh_engine_vcf_lines(
        tmp_path, [p], fq, "mesh_bsplit", "bsplit",
        mesh="8x1", batch_size=8192)
    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 1


def test_engine_equals_oracle_with_merge_expand(tmp_path, monkeypatch):
    """Full engine -> VCF with the merge-based _expand_lanes FORCED (the
    CPU defaults to the scatter form, so without this the merge form had
    only unit-level coverage). Byte-equality against the composed scalar
    oracle."""
    import bronko_tpu.ops.map as m

    monkeypatch.setenv("BRONKO_EXPAND_MERGE", "1")
    m._expand_merge_enabled.cache_clear()
    try:
        test_engine_equals_composed_oracle(tmp_path, 11, 3, 500, 350,
                                           0.004, 2, 3, 0)
    finally:
        m._expand_merge_enabled.cache_clear()


WIDENED_CASES = [
    # round-5 fuzz widening: new seeds + shapes not previously drawn
    (311, 6, 380, 360, 0.008, 3, 2, 4),   # 6-genome selection, high err
    (422, 2, 1100, 420, 0.002, 5, 4, 0),  # longest genome yet, many plants
    (533, 3, 520, 640, 0.005, 1, 6, 2),   # deep + minor-heavy
]


@pytest.mark.parametrize("seed,n_g,glen,depth,err,n_maj,n_min,src",
                         WIDENED_CASES)
def test_engine_equals_composed_oracle_widened(tmp_path, seed, n_g, glen,
                                               depth, err, n_maj, n_min,
                                               src):
    test_engine_equals_composed_oracle(tmp_path, seed, n_g, glen, depth,
                                       err, n_maj, n_min, src)


def test_engine_equals_oracle_paired_with_flags(tmp_path):
    """Paired-end COMPOSED with non-default filter flags (n_fixed=4 +
    use_full_kmer) — the two quirks interact with the concatenated-stream
    paired semantics (bucket trim changes which positions probe; full-
    k-mer matching changes the perfect/variant split), and no prior case
    drove them together."""
    rng = np.random.default_rng(66)
    k = 21
    seq = make_genome(rng, 700)
    p = str(tmp_path / "pf.fasta")
    write_fasta(p, "pfseq", seq)
    files = [("pf", [("pfseq", seq)])]
    majors = {int(q): 0.88 for q in rng.integers(60, 640, 3)}
    r1, _ = make_sample(seq, rng, read_len=100, depth=180,
                        major_positions=majors, minor_positions={},
                        error_rate=0.003)
    r2, _ = make_sample(seq, rng, read_len=100, depth=180,
                        major_positions=majors, minor_positions={},
                        error_rate=0.003)
    fq1 = str(tmp_path / "pf_R1.fastq.gz")
    fq2 = str(tmp_path / "pf_R2.fastq.gz")
    write_fastq(fq1, r1)
    write_fastq(fq2, r2)

    kmer_counts = _count_oracle(r1, k) + _count_oracle(r2, k)
    want_lines, want_name = _oracle_vcf_lines(
        files, kmer_counts, k, n_fixed=4, use_full_kmer=True)

    out = str(tmp_path / "out_pf")
    cfg = CallConfig(genomes=[p], first_pairs=[fq1], second_pairs=[fq2],
                     output=out, batch_size=4096, chunk_reads=8192,
                     n_fixed=4, use_full_kmer=True)
    index = build_index(cfg.kmer, [p])
    run_call(cfg, index, build_device_index(index))
    vcf = [f for f in os.listdir(out) if f.endswith(".vcf")]
    assert len(vcf) == 1
    with open(os.path.join(out, vcf[0])) as fh:
        got_lines = [ln.rstrip("\n") for ln in fh if not ln.startswith("#")]
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        fh.readline()
        got_name = fh.readline().split("\t")[1]
    assert got_name == want_name
    assert got_lines == want_lines
    assert len(got_lines) >= 1
