"""End-to-end engine tests on synthetic data (small shapes, CPU-fast)."""

import gzip
import os

import numpy as np
import pytest

from bronko_tpu.call.engine import run_call
from bronko_tpu.config import CallConfig
from bronko_tpu.index.build import build_index
from bronko_tpu.index.layout import build_device_index
from bronko_tpu.index.store import load_index, save_index
from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("synth")
    rng = np.random.default_rng(17)
    genome = make_genome(rng, 1200)
    majors = {300: 0.92}
    minors = {700: 0.15}
    reads, alts = make_sample(genome, rng, read_len=80, depth=700,
                              major_positions=majors, minor_positions=minors,
                              error_rate=0.004)
    ref = tmp / "ref.fasta"
    fq = tmp / "samp.fastq.gz"
    write_fasta(str(ref), "sref", genome)
    write_fastq(str(fq), reads)
    return tmp, str(ref), str(fq), genome, alts


def small_cfg(**kw):
    kw.setdefault("batch_size", 4096)
    kw.setdefault("chunk_reads", 8192)
    return CallConfig(**kw)


def test_end_to_end_single(synth):
    tmp, ref, fq, genome, alts = synth
    out = str(tmp / "out1")
    cfg = small_cfg(genomes=[ref], reads=[fq], output=out)
    index = build_index(cfg.kmer, [ref])
    dev = build_device_index(index)
    summaries = run_call(cfg, index, dev)

    assert len(summaries) == 1
    s = summaries[0]
    assert s.selected_genome == "ref"
    assert s.stats.num_major >= 1
    vcf = os.path.join(out, "samp.vcf")
    assert os.path.exists(vcf)
    rows = [l for l in open(vcf) if not l.startswith("#")]
    positions = {int(r.split("\t")[1]) for r in rows}
    assert 301 in positions  # planted major
    assert 701 in positions  # planted minor (deep + errors -> callable)
    overview = open(os.path.join(out, "bronko_overview.tsv")).read().splitlines()
    assert len(overview) == 2 and overview[1].startswith(fq)


def test_end_to_end_paired_and_roundtrip(synth):
    tmp, ref, fq, genome, alts = synth
    # index save/load roundtrip
    index = build_index(21, [ref])
    db = str(tmp / "db.bkdb")
    save_index(db, index)
    index2 = load_index(db, expect_k=21)
    assert np.array_equal(index.keys, index2.keys)
    assert np.array_equal(index.post_meta, index2.post_meta)
    assert index2.files[0].sequences[0].seq == genome

    with pytest.raises(ValueError, match="Database k"):
        load_index(db, expect_k=19)

    out = str(tmp / "out2")
    cfg = small_cfg(db=db, first_pairs=[fq], second_pairs=[fq], output=out)
    dev = build_device_index(index2)
    summaries = run_call(cfg, index2, dev)
    assert summaries[0].stats.num_major >= 1
    # paired doubles the depth estimate relative to single-end
    assert os.path.exists(os.path.join(out, "samp.vcf"))


def test_pileup_and_alignment_outputs(synth):
    tmp, ref, fq, genome, alts = synth
    out = str(tmp / "out3")
    # three "samples" (same file) so the alignment builder has >= 3
    cfg = small_cfg(genomes=[ref], reads=[fq, fq, fq], output=out,
                    output_pileup=True, output_alignment=True)
    index = build_index(cfg.kmer, [ref])
    dev = build_device_index(index)
    run_call(cfg, index, dev)
    tsv = os.path.join(out, "samp.tsv")
    assert os.path.exists(tsv)
    lines = open(tsv).read().splitlines()
    assert lines[0].startswith("reference\tindex\tref")
    assert len(lines) == 1 + len(genome)
    mfa = os.path.join(out, "ref.mfa")
    assert os.path.exists(mfa)
    mfa_lines = open(mfa).read().splitlines()
    # ref row + 3 sample rows (same sample id deduped by name? no — 3 rows)
    assert mfa_lines[0] == ">ref"
    assert len([l for l in mfa_lines if l.startswith(">")]) >= 2


def test_device_counter_path(synth):
    """The on-device sort counter must produce identical results to the
    host C++ counter through the engine."""
    tmp, ref, fq, genome, alts = synth
    out_h = str(tmp / "out_host")
    out_d = str(tmp / "out_dev")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_h, counter="host"),
             index, dev)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_d, counter="device"),
             index, dev)
    vcf_h = open(os.path.join(out_h, "samp.vcf")).read()
    vcf_d = open(os.path.join(out_d, "samp.vcf")).read()
    assert vcf_h == vcf_d
    ov_h = open(os.path.join(out_h, "bronko_overview.tsv")).read()
    ov_d = open(os.path.join(out_d, "bronko_overview.tsv")).read()
    assert ov_h == ov_d


def test_keep_kmer_info_and_isolation(synth, tmp_path):
    tmp, ref, fq, genome, alts = synth
    out = str(tmp_path / "outk")
    bad = str(tmp_path / "missing.fastq.gz")
    cfg = small_cfg(genomes=[ref], reads=[bad, fq], output=out,
                    keep_kmer_counts=True)
    index = build_index(cfg.kmer, [ref])
    dev = build_device_index(index)
    summaries = run_call(cfg, index, dev)  # bad sample isolated, good processed
    assert len(summaries) == 1
    dump = os.path.join(out, "samp_counts.txt")
    assert os.path.exists(dump)
    line = open(dump).readline().split()
    assert len(line[0]) == 21 and int(line[1]) >= cfg.min_kmers


def test_cohort_scale_prefetch_and_isolation(synth, tmp_path, monkeypatch):
    """A 16-sample cohort through the prefetch pipeline with interleaved
    failure modes (missing file, truncated gzip, malformed FASTQ, empty
    file), two count workers, and a deliberately tiny inflate-ahead
    budget (forces budget-skip + inline inflate). All good samples must
    produce summaries, identical inputs must produce byte-identical VCFs,
    and the overview must carry exactly the successes."""
    tmp, ref, fq, genome, alts = synth
    out = str(tmp_path / "out_cohort")
    good = []
    for i in range(12):
        p = str(tmp_path / f"c{i}.fastq.gz")
        with open(fq, "rb") as src, open(p, "wb") as dst:
            dst.write(src.read())
        good.append(p)
    missing = str(tmp_path / "missing.fastq.gz")
    truncated = str(tmp_path / "trunc.fastq.gz")
    with open(fq, "rb") as src, open(truncated, "wb") as dst:
        dst.write(src.read()[:200])  # mid-stream cut: corrupt gzip
    malformed = str(tmp_path / "bad.fastq.gz")
    with gzip.open(malformed, "wt") as fh:
        fh.write("this is not\na fastq at all\n")
    empty = str(tmp_path / "empty.fastq.gz")
    with gzip.open(empty, "wt") as fh:
        fh.write("")

    reads = (good[:3] + [missing] + good[3:6] + [truncated] + good[6:9]
             + [malformed] + good[9:] + [empty])
    monkeypatch.setenv("BRONKO_COUNT_WORKERS", "2")
    monkeypatch.setenv("BRONKO_INFLATE_BUDGET", str(64 << 10))  # 64 KB
    cfg = small_cfg(genomes=[ref], reads=reads, output=out)
    index = build_index(cfg.kmer, [ref])
    dev = build_device_index(index)
    summaries = run_call(cfg, index, dev)
    # empty counts zero kmers -> "Unable to pick a best genome" -> isolated
    assert len(summaries) == len(good)
    vcfs = sorted(f for f in os.listdir(out) if f.endswith(".vcf"))
    assert len(vcfs) == len(good)
    bodies = set()
    for v in vcfs:  # identical inputs => identical data lines
        with open(os.path.join(out, v)) as fh:
            bodies.add("".join(ln for ln in fh if not ln.startswith("#")))
    assert len(bodies) == 1 and next(iter(bodies)).strip()
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        assert len(fh.readlines()) == 1 + len(good)


def test_large_panel_flat_tally(tmp_path):
    """>8 genomes forces the flat tally fallback (no histogram); results
    must match the small-panel semantics (selection + variant calls)."""
    import numpy as np
    from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq

    rng = np.random.default_rng(55)
    base = make_genome(rng, 900)
    paths = []
    for g in range(12):
        gen = bytearray(base)
        for p in rng.integers(0, len(base), 25):  # ~3% divergence per strain
            gen[p] = b"ACGT"[rng.integers(4)]
        p_ = tmp_path / f"strain{g:02d}.fasta"
        write_fasta(str(p_), f"strain{g:02d}", bytes(gen))
        paths.append(str(p_))

    # reads from strain 7
    truth = open(paths[7]).read().split("\n", 1)[1].replace("\n", "").encode()
    reads, _ = make_sample(truth, rng, read_len=80, depth=60)
    fq = str(tmp_path / "p.fastq.gz")
    write_fastq(fq, reads)

    index = build_index(21, paths)
    dev = build_device_index(index)
    assert dev.hist is None  # flat fallback in play
    out = str(tmp_path / "out")
    cfg = small_cfg(genomes=paths, reads=[fq], output=out)
    summaries = run_call(cfg, index, dev)
    assert summaries[0].selected_genome == "strain07"
    assert summaries[0].stats.num_major <= 1


def test_streaming_single_sample_byte_identical(synth):
    """The streamed single-sample path (partitioned count->tally overlap)
    must be byte-identical to the batch path with the same host counter."""
    from bronko_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native counter unavailable")
    tmp, ref, fq, genome, alts = synth
    index = build_index(21, [ref])
    dev = build_device_index(index)
    out_s = str(tmp / "out_stream")
    out_b = str(tmp / "out_nostream")
    # single job + host counter -> streams
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_s,
                       output_pileup=True), index, dev)
    # keep_kmer_counts disables streaming -> the classic prefetch path
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_b,
                       output_pileup=True, keep_kmer_counts=True), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_b, fname)).read(), fname


def test_batch_streamed_first_byte_identical(synth, tmp_path, monkeypatch):
    """BRONKO_STREAM_FIRST=1 streams the FIRST sample's count->tally on
    multi-sample cohorts (pipeline-fill cut, which loses where a dispatch
    is slow); outputs must be
    byte-identical to the pure prefetch path (keep_kmer_counts disables
    streaming)."""
    from bronko_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native counter unavailable")
    tmp, ref, fq, genome, alts = synth
    index = build_index(21, [ref])
    dev = build_device_index(index)
    out_s = str(tmp_path / "bs")
    out_b = str(tmp_path / "bb")
    monkeypatch.setenv("BRONKO_STREAM_FIRST", "1")
    run_call(small_cfg(genomes=[ref], reads=[fq, fq], output=out_s,
                       output_pileup=True), index, dev)
    monkeypatch.delenv("BRONKO_STREAM_FIRST")
    run_call(small_cfg(genomes=[ref], reads=[fq, fq], output=out_b,
                       output_pileup=True, keep_kmer_counts=True), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_b, fname)).read(), fname


def test_streaming_paired_byte_identical(synth, tmp_path):
    """Paired-end streamed run == paired non-streamed run (per-mate
    separate counting semantics preserved)."""
    from bronko_tpu.io.native import get_lib

    if get_lib() is None:
        pytest.skip("native counter unavailable")
    tmp, ref, fq, genome, alts = synth
    index = build_index(21, [ref])
    dev = build_device_index(index)
    out_s = str(tmp_path / "ps")
    out_b = str(tmp_path / "pb")
    run_call(small_cfg(genomes=[ref], first_pairs=[fq], second_pairs=[fq],
                       output=out_s), index, dev)
    run_call(small_cfg(genomes=[ref], first_pairs=[fq], second_pairs=[fq],
                       output=out_b, keep_kmer_counts=True), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv"):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_b, fname)).read(), fname


def test_mesh_sharded_engine(synth):
    """--mesh DxG: the FULLY sharded engine (tally pass 1 + pileup pass 2
    over the mesh) must produce byte-identical outputs to the single-device
    engine — VCF, overview, and pileup TSV (8 virtual CPU devices)."""
    import jax

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 devices")
    tmp, ref, fq, genome, alts = synth
    out_s = str(tmp / "out_mesh")
    out_1 = str(tmp / "out_singledev")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_1,
                       output_pileup=True), index, dev)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_s, mesh="4x2",
                       output_pileup=True), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname


def test_mesh_sharded_engine_batchwise(synth):
    """Multi-batch samples shard WHOLE batches over the mesh (nb axis —
    each device pays the per-batch index-key sort only for its own
    batches). Forcing nb >= devices with a tiny batch size must stay
    byte-identical to the single-device engine AND to the B-split layout
    (a batch size that leaves nb=1)."""
    import jax

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 devices")
    tmp, ref, fq, genome, alts = synth
    out_1 = str(tmp / "out_bw_single")
    out_bw = str(tmp / "out_bw_mesh")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_1,
                       output_pileup=True), index, dev)
    # batch_size 256 on ~3k unique kmers -> nb >= 16 (padded pow2), so both
    # the tally (nb % n_data == 0) and the pileup (nb % 8 == 0) take the
    # batchwise layout on a 4x2 mesh
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_bw, mesh="4x2",
                       output_pileup=True, batch_size=256), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        assert open(os.path.join(out_bw, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname


def test_mesh_data_parallel_only(synth, tmp_path):
    """mesh='8x1' (genome axis 1): the ShardedMapper reuses the per-bucket
    genome HISTOGRAM for tallies (tally_mode='hist'/'words') instead of
    the flat posting expansion — a distinct code path from the DxG>1
    meshes the other tests cover. Byte-identical to single device."""
    import jax

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 devices")
    tmp, ref, fq, genome, alts = synth
    out_1 = str(tmp_path / "out_d1_single")
    out_m = str(tmp_path / "out_d1_mesh")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_1,
                       output_pileup=True), index, dev)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_m, mesh="8x1",
                       output_pileup=True), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        assert open(os.path.join(out_m, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname


def test_mesh_sharded_engine_paired(synth, tmp_path):
    """Paired-end + mesh: the concatenated mate k-mer stream shards over
    the mesh like any batch stream; outputs must equal the single-device
    paired run byte-for-byte."""
    import jax

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 devices")
    tmp, ref, fq, genome, alts = synth
    rng = np.random.default_rng(29)
    reads2, _ = make_sample(genome, rng, read_len=80, depth=300,
                            major_positions={300: 0.92},
                            minor_positions={700: 0.15}, error_rate=0.004)
    fq2 = str(tmp_path / "mate2.fastq.gz")
    write_fastq(fq2, reads2)
    out_1 = str(tmp_path / "out_pair_single")
    out_m = str(tmp_path / "out_pair_mesh")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(small_cfg(genomes=[ref], first_pairs=[fq], second_pairs=[fq2],
                       output=out_1), index, dev)
    run_call(small_cfg(genomes=[ref], first_pairs=[fq], second_pairs=[fq2],
                       output=out_m, mesh="4x2"), index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv"):
        assert open(os.path.join(out_m, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname


def test_mesh_sharded_engine_multigenome(tmp_path):
    """Mesh run on a 4-genome panel where reads pick genome 2: pass-2
    sharding must land on the right sub-index and stay byte-identical."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    rng = np.random.default_rng(23)
    base = make_genome(rng, 1500)
    paths = []
    for g in range(4):
        gen = bytearray(base)
        for p in rng.integers(0, len(base), 40):
            gen[p] = b"ACGT"[rng.integers(4)]
        p_ = tmp_path / f"g{g}.fasta"
        write_fasta(str(p_), f"g{g}", bytes(gen))
        paths.append(str(p_))
    truth = open(paths[2]).read().split("\n", 1)[1].replace("\n", "").encode()
    reads, _ = make_sample(truth, rng, read_len=80, depth=200,
                           major_positions={400: 0.9}, minor_positions={},
                           error_rate=0.003)
    fq = str(tmp_path / "m.fastq.gz")
    write_fastq(fq, reads)

    index = build_index(21, paths)
    dev = build_device_index(index)
    out_1 = str(tmp_path / "o1")
    out_s = str(tmp_path / "os")
    run_call(small_cfg(genomes=paths, reads=[fq], output=out_1,
                       output_pileup=True), index, dev)
    run_call(small_cfg(genomes=paths, reads=[fq], output=out_s, mesh="2x4",
                       output_pileup=True), index, dev)
    for fname in ("m.vcf", "bronko_overview.tsv", "m.tsv"):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname
    assert "g2" in open(os.path.join(out_s, "bronko_overview.tsv")).read()


def test_count_concurrency_paths_byte_identical(synth, tmp_path, monkeypatch):
    """The inflate-ahead prefetch (default), the budget-exhausted skip path
    (BRONKO_INFLATE_BUDGET=0), and two concurrent count workers must all
    produce byte-identical outputs on a 3-sample cohort."""
    tmp, ref, fq, genome, alts = synth
    index = build_index(21, [ref])
    dev = build_device_index(index)
    outs = {}
    for name, env in [
        ("default", {}),
        ("nobudget", {"BRONKO_INFLATE_BUDGET": "0"}),
        ("workers2", {"BRONKO_COUNT_WORKERS": "2"}),
    ]:
        for k in ("BRONKO_INFLATE_BUDGET", "BRONKO_COUNT_WORKERS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        out = str(tmp_path / f"out_{name}")
        run_call(small_cfg(genomes=[ref], reads=[fq, fq, fq], output=out),
                 index, dev)
        outs[name] = {
            f: open(os.path.join(out, f), "rb").read()
            for f in sorted(os.listdir(out))
        }
    assert outs["default"] == outs["nobudget"] == outs["workers2"]
    assert any(f.endswith(".vcf") for f in outs["default"])


def test_mesh_more_shards_than_genomes(tmp_path):
    """A genome axis wider than the panel (G=3 files on a 2x4 mesh) leaves
    one shard EMPTY (all-sentinel keys, zero-length CSR rows); the sharded
    engine must still match the single-device run byte-for-byte."""
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    rng = np.random.default_rng(31)
    base = make_genome(rng, 1100)
    paths = []
    for g in range(3):
        gen = bytearray(base)
        for p in rng.integers(0, len(base), 30):
            gen[p] = b"ACGT"[rng.integers(4)]
        p_ = tmp_path / f"e{g}.fasta"
        write_fasta(str(p_), f"e{g}", bytes(gen))
        paths.append(str(p_))
    truth = open(paths[1]).read().split("\n", 1)[1].replace("\n", "").encode()
    reads, _ = make_sample(truth, rng, read_len=80, depth=150,
                           major_positions={250: 0.85}, minor_positions={},
                           error_rate=0.003)
    fq = str(tmp_path / "e.fastq.gz")
    write_fastq(fq, reads)

    index = build_index(21, paths)
    dev = build_device_index(index)
    out_1 = str(tmp_path / "eo1")
    out_s = str(tmp_path / "eos")
    run_call(small_cfg(genomes=paths, reads=[fq], output=out_1), index, dev)
    run_call(small_cfg(genomes=paths, reads=[fq], output=out_s, mesh="2x4"),
             index, dev)
    for fname in ("e.vcf", "bronko_overview.tsv"):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname


def test_streamed_probe_budget_cap_byte_identical(synth, tmp_path, monkeypatch):
    """With the saved-probe memory cap forced to 1 byte, every streamed
    partition takes the tally-only path and resolve() re-probes the
    selected genome's sub-index — outputs must stay byte-identical."""
    import bronko_tpu.call.engine as engine

    tmp, ref, fq, genome, alts = synth
    index = build_index(21, [ref])
    dev = build_device_index(index)
    out_s = str(tmp_path / "out_capped")
    out_b = str(tmp_path / "out_plain")
    monkeypatch.setattr(engine, "PROBE_BYTES_CAP", 1)
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_s,
                       output_pileup=True), index, dev)
    monkeypatch.setattr(engine, "PROBE_BYTES_CAP", 512 << 20)
    monkeypatch.setenv("BRONKO_NO_STREAM", "1")
    run_call(small_cfg(genomes=[ref], reads=[fq], output=out_b,
                       output_pileup=True), index, dev)
    for fname in sorted(os.listdir(out_b)):
        assert open(os.path.join(out_s, fname)).read() == \
            open(os.path.join(out_b, fname)).read(), fname


def test_mesh_multi_genome_hist_mode(synth, tmp_path):
    """Genome-sharded mesh on a MULTI-genome panel must take the per-shard
    histogram tally (tally_mode='hist' — VERDICT r2 item 4: previously DxG
    meshes fell back to the flat posting expansion) and stay byte-identical
    to the single-device engine."""
    import jax

    if len(jax.devices()) < 8:
        import pytest

        pytest.skip("needs 8 devices")
    from bronko_tpu.call.engine import ShardedMapper

    tmp, ref, fq, genome, alts = synth
    rng = np.random.default_rng(53)
    # 5-genome panel: the synth reference plus four mutated decoys
    paths = [ref]
    for i in range(4):
        g = bytearray(genome)
        for p in rng.integers(0, len(genome), 60):
            g[p] = b"ACGT"[rng.integers(4)]
        p_i = tmp_path / f"decoy{i}.fasta"
        write_fasta(str(p_i), f"decoy{i}", bytes(g))
        paths.append(str(p_i))
    out_1 = str(tmp_path / "out_mg_single")
    out_m = str(tmp_path / "out_mg_mesh")
    index = build_index(21, paths)
    dev = build_device_index(index)
    cfg_m = small_cfg(genomes=paths, reads=[fq], output=out_m, mesh="4x2",
                      output_pileup=True)
    assert ShardedMapper(index, cfg_m, dev).tally_mode == "hist"
    run_call(small_cfg(genomes=paths, reads=[fq], output=out_1,
                       output_pileup=True), index, dev)
    run_call(cfg_m, index, dev)
    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        assert open(os.path.join(out_m, fname)).read() == \
            open(os.path.join(out_1, fname)).read(), fname


def test_fused_dispatch_byte_identical(synth, tmp_path, caplog):
    """FUSED single-dispatch map (pass 1 + device genome selection +
    pass 2, static rolling budget) must produce byte-identical outputs to
    the two-pass path. A 3-sample cohort exercises the transition: sample
    1 runs exact two-pass (no ratio yet), samples 2-3 take the fused path
    — every VCF must equal the corresponding exact single-sample run."""
    import shutil

    tmp, ref, fq, genome, alts = synth
    cohort = []
    for i in range(3):
        p = str(tmp_path / f"fused_{i}.fastq.gz")
        shutil.copy(fq, p)
        cohort.append(p)

    out_c = str(tmp_path / "out_fused_cohort")
    cfg = small_cfg(genomes=[ref], reads=cohort, output=out_c)
    index = build_index(cfg.kmer, [ref])
    dev = build_device_index(index)
    assert dev.hist is not None
    # pre-seed a generous ratio so every sample takes the fused dispatch
    # deterministically (organically the ratio arrives from sample 1's
    # worker-thread resolve, engaging fused a sample or two later)
    dev.fused_ratio = 8.0
    import logging

    import bronko_tpu.call.engine  # noqa: F401 — logger registration

    with caplog.at_level(logging.INFO, logger="bronko"):
        run_call(cfg, index, dev)
    assert any("(fused)" in r.message for r in caplog.records)

    # exact single-sample reference run (fresh dev: ratio 0 -> two-pass)
    out_s = str(tmp_path / "out_fused_single")
    dev2 = build_device_index(index)
    run_call(small_cfg(genomes=[ref], reads=[cohort[0]], output=out_s),
             index, dev2)

    want = open(os.path.join(out_s, "fused_0.vcf"), "rb").read().split(b"\n")
    want_rows = [r for r in want if not r.startswith(b"##reference")]
    for i in range(3):
        got = open(os.path.join(out_c, f"fused_{i}.vcf"), "rb").read().split(b"\n")
        got_rows = [r for r in got if not r.startswith(b"##reference")]
        assert got_rows == want_rows


def test_fused_budget_overflow_falls_back(synth, tmp_path, monkeypatch, caplog):
    """A deliberately absurd fused ratio still yields correct output: the
    tiny static budget overflows, the guard re-runs pass 2 with the exact
    budget, and the VCF is unchanged."""
    import shutil

    import bronko_tpu.call.engine as eng

    tmp, ref, fq, genome, alts = synth
    cohort = []
    for i in range(2):
        p = str(tmp_path / f"ovf_{i}.fastq.gz")
        shutil.copy(fq, p)
        cohort.append(p)

    index = build_index(21, [ref])
    dev = build_device_index(index)
    # force a ~vanishing budget for the fused dispatch on sample 2: patch
    # _note_fused_ratio so the fused path engages, AND _pass2_budget so
    # the fused static budget is 1024 lanes (the exact-fallback's own
    # overflow-retry loop still converges, so output stays correct)
    monkeypatch.setattr(eng, "_note_fused_ratio",
                        lambda d, lanes, n: setattr(d, "fused_ratio", 1e-9))
    dev.fused_ratio = 1e-9  # fused from sample 1 onward
    real_budget = eng._pass2_budget
    monkeypatch.setattr(
        eng, "_pass2_budget",
        lambda kj, mcfg, n_kmers, exact_lanes=None:
        1024 if n_kmers is None and exact_lanes is not None
        and exact_lanes < (1 << 16)
        else real_budget(kj, mcfg, n_kmers, exact_lanes))
    out_c = str(tmp_path / "out_ovf")
    import logging

    with caplog.at_level(logging.INFO, logger="bronko"):
        run_call(small_cfg(genomes=[ref], reads=cohort, output=out_c),
                 index, dev)
    assert any("fused pass-2 budget overflowed" in r.message
               for r in caplog.records)

    out_s = str(tmp_path / "out_ovf_single")
    run_call(small_cfg(genomes=[ref], reads=[cohort[0]], output=out_s),
             index, build_device_index(index))
    want = [r for r in open(os.path.join(out_s, "ovf_0.vcf"), "rb").read().split(b"\n")
            if not r.startswith(b"##reference")]
    for i in range(2):
        got = [r for r in open(os.path.join(out_c, f"ovf_{i}.vcf"), "rb").read().split(b"\n")
               if not r.startswith(b"##reference")]
        assert got == want
