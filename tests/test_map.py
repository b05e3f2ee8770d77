"""Device mapper vs scalar oracle: pileups and tallies must match exactly."""

import numpy as np
import pytest

import jax.numpy as jnp

from bronko_tpu.index.build import build_index
from bronko_tpu.index.layout import build_device_index
from bronko_tpu.index.model import BronkoIndex
from bronko_tpu.ops.map import (
    PLANE_CNT_FWD, PLANE_CNT_REV, PLANE_DEPTH_FWD, PLANE_DEPTH_REV, map_batch_jit,
)
from tests.oracle.lcb_oracle import kmer_to_u64, reverse_complement_u64
from tests.oracle.map_oracle import build_oracle_index, map_kmers_oracle


def random_genome(rng, n):
    return bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))


def make_index(tmp_path, files, k=21):
    paths = []
    for fname, seqs in files:
        p = tmp_path / f"{fname}.fasta"
        with open(p, "w") as fh:
            for sname, seq in seqs:
                fh.write(f">{sname}\n{seq.decode()}\n")
        paths.append(str(p))
    return build_index(k, paths)


def run_device_map(index: BronkoIndex, kmer_counts, n_fixed=2, use_full_kmer=False, batch=64):
    dev = build_device_index(index)
    mcfg = dev.map_config(n_fixed, use_full_kmer)
    T = dev.total_len
    pileup = jnp.zeros((4, T + 1, 4), jnp.int32)
    tallies = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    for lo in range(0, len(kmers), batch):
        kb = kmers[lo:lo + batch]
        cb = counts[lo:lo + batch]
        if kb.shape[0] < batch:
            kb = np.pad(kb, (0, batch - kb.shape[0]))
            cb = np.pad(cb, (0, batch - cb.shape[0]))
        pileup, tallies, overflow = map_batch_jit(
            jnp.asarray(kb), jnp.asarray(cb), dev.keys, dev.offsets,
            dev.postings, pileup, tallies, mcfg)
        assert int(overflow) == 0
    return dev, np.asarray(pileup), np.asarray(tallies)


def sample_kmers(rng, files, k, n_exact=200, n_mut=100, n_junk=20):
    """Draw genome k-mers (some reverse-complemented), mutated ones, junk."""
    out = {}
    seqs = [seq for _, fseqs in files for _, seq in fseqs]
    for _ in range(n_exact + n_mut):
        seq = seqs[rng.integers(len(seqs))]
        i = int(rng.integers(0, len(seq) - k + 1))
        km = kmer_to_u64(seq[i:i + k])
        if len(out) >= n_exact or rng.random() < 0.4:
            # mutate one position
            p = int(rng.integers(0, k))
            shift = 2 * (k - 1 - p)
            old = (km >> shift) & 3
            km = (km & ~(3 << shift)) | (int((old + 1 + rng.integers(3)) % 4) << shift)
        if rng.random() < 0.5:
            km = reverse_complement_u64(km, k)
        out[km] = int(rng.integers(3, 200))
    for _ in range(n_junk):
        out[int(rng.integers(0, 1 << (2 * k), dtype=np.uint64))] = int(rng.integers(3, 50))
    return list(out.items())


@pytest.mark.parametrize("n_files,seqs_per_file", [(1, 1), (3, 2)])
def test_map_matches_oracle(tmp_path, n_files, seqs_per_file):
    rng = np.random.default_rng(42 + n_files)
    k = 21
    files = []
    for f in range(n_files):
        seqs = [(f"seq{f}_{s}", random_genome(rng, 300 + 40 * s))
                for s in range(seqs_per_file)]
        files.append((f"genome{f}", seqs))

    index = make_index(tmp_path, files, k)
    oracle_idx = build_oracle_index(k, files)
    kmer_counts = sample_kmers(rng, files, k)

    o_maps, o_tallies = map_kmers_oracle(kmer_counts, oracle_idx)
    dev, pileup, tallies = run_device_map(index, kmer_counts)

    # tallies
    for fid in range(n_files):
        exp = o_tallies.get(fid, [0, 0, 0])
        assert tallies[fid].tolist() == exp, (fid, tallies[fid], exp)

    # pileups per sequence slice
    for sl in dev.seq_slices:
        sname = files[sl.file_id][1][sl.seq_id][0]
        om = o_maps[sl.file_id][sname]
        rng_ = slice(sl.offset, sl.offset + sl.length)
        assert np.array_equal(pileup[PLANE_DEPTH_FWD, rng_], om["fwd"]), (sname, "fwd")
        assert np.array_equal(pileup[PLANE_DEPTH_REV, rng_], om["rev"]), (sname, "rev")
        assert np.array_equal(pileup[PLANE_CNT_FWD, rng_], om["fwd_cnt"]), (sname, "fwd_cnt")
        assert np.array_equal(pileup[PLANE_CNT_REV, rng_], om["rev_cnt"]), (sname, "rev_cnt")
    # dump row should have seen only masked lanes
    assert pileup[:, :-1].sum() > 0


def test_map_use_full_kmer(tmp_path):
    rng = np.random.default_rng(7)
    k = 15
    files = [("g", [("s", random_genome(rng, 200))])]
    index = make_index(tmp_path, files, k)
    oracle_idx = build_oracle_index(k, files)
    kmer_counts = sample_kmers(rng, files, k, n_exact=50, n_mut=30, n_junk=5)
    o_maps, o_tallies = map_kmers_oracle(kmer_counts, oracle_idx, use_full_kmer=True)
    dev, pileup, tallies = run_device_map(index, kmer_counts, use_full_kmer=True)
    assert tallies[0].tolist() == o_tallies.get(0, [0, 0, 0])
    om = o_maps[0]["s"]
    sl = dev.seq_slices[0]
    rng_ = slice(sl.offset, sl.offset + sl.length)
    assert np.array_equal(pileup[PLANE_DEPTH_FWD, rng_], om["fwd"])
    assert np.array_equal(pileup[PLANE_CNT_REV, rng_], om["rev_cnt"])


def test_overflow_flag(tmp_path):
    """A lane budget smaller than the true posting load must raise the
    overflow flag instead of silently dropping postings."""
    from dataclasses import replace

    import jax.numpy as jnp
    from bronko_tpu.ops.map import map_batch_jit

    rng = np.random.default_rng(11)
    k = 21
    # 6 identical genomes -> every bucket has ~6 postings
    seq = random_genome(rng, 300)
    files = [(f"g{i}", [(f"s{i}", seq)]) for i in range(6)]
    index = make_index(tmp_path, files, k)
    from bronko_tpu.index.layout import build_device_index
    dev = build_device_index(index)
    mcfg = replace(dev.map_config(2, False), lane_factor=1)
    kmer_counts = sample_kmers(rng, files, k, n_exact=64, n_mut=0, n_junk=0)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    T = dev.total_len
    pileup = jnp.zeros((4, T + 1, 4), jnp.int32)
    tallies = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    _, _, overflow = map_batch_jit(
        jnp.asarray(kmers), jnp.asarray(counts), dev.keys, dev.offsets,
        dev.postings, pileup, tallies, mcfg)
    assert int(overflow) == 1


def test_tally_hist_matches_flat_and_oracle(tmp_path):
    """Histogram tally pass (G<=8) must equal the flat-join tallies and the
    scalar oracle."""
    from bronko_tpu.ops.map import tally_all_jit

    rng = np.random.default_rng(21)
    k = 21
    files = [(f"g{i}", [(f"s{i}", random_genome(rng, 260 + 20 * i))]) for i in range(5)]
    index = make_index(tmp_path, files, k)
    dev = build_device_index(index)
    assert dev.hist is not None
    mcfg = dev.map_config(2, False)
    kmer_counts = sample_kmers(rng, files, k, n_exact=120, n_mut=60, n_junk=10)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 128
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    kj = jnp.asarray(kb.reshape(nb, B)); cj = jnp.asarray(cb.reshape(nb, B))

    t0 = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    t_hist, ov1 = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                                dev.hist, t0, mcfg, "hist")
    t1 = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    t_flat, ov2 = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                                jnp.zeros(1, jnp.int64), t1, mcfg, "flat")
    assert int(ov2) == 0
    assert np.array_equal(np.asarray(t_hist), np.asarray(t_flat))

    from tests.oracle.map_oracle import build_oracle_index, map_kmers_oracle
    oracle_idx = build_oracle_index(k, files)
    _, o_tallies = map_kmers_oracle(kmer_counts, oracle_idx)
    for fid in range(len(files)):
        assert np.asarray(t_hist)[fid].tolist() == o_tallies.get(fid, [0, 0, 0])


def test_pileup_pass_matches_oracle(tmp_path):
    """Pass-2 per-genome pileup must equal the oracle's pileup for that genome."""
    from bronko_tpu.ops.map import pileup_all_jit
    from tests.oracle.map_oracle import build_oracle_index, map_kmers_oracle

    rng = np.random.default_rng(22)
    k = 21
    files = [(f"g{i}", [(f"s{i}a", random_genome(rng, 250)),
                        (f"s{i}b", random_genome(rng, 150))]) for i in range(3)]
    index = make_index(tmp_path, files, k)
    dev = build_device_index(index)
    mcfg = dev.map_config(2, False)
    kmer_counts = sample_kmers(rng, files, k, n_exact=150, n_mut=80, n_junk=10)
    oracle_idx = build_oracle_index(k, files)
    o_maps, _ = map_kmers_oracle(kmer_counts, oracle_idx)

    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 128
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    kj = jnp.asarray(kb.reshape(nb, B)); cj = jnp.asarray(cb.reshape(nb, B))

    from dataclasses import replace
    dev.ensure_subindex()  # direct g_* access; engine defers this build
    for best in range(3):
        gcfg = replace(mcfg, total_len=dev.g_total_len,
                       max_bucket=dev.g_max_bucket, lane_factor=mcfg.lane_factor)
        pileup = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
        pileup, ov = pileup_all_jit(kj, cj, dev.g_keys[best], dev.g_offsets[best],
                                    dev.g_postings[best], pileup, gcfg)
        assert int(ov) == 0
        pileup = np.asarray(pileup)
        base = 0
        for sname, seq in files[best][1]:
            om = o_maps[best][sname]
            L = len(seq)
            assert np.array_equal(pileup[0, base:base+L], om["fwd"]), (best, sname)
            assert np.array_equal(pileup[1, base:base+L], om["rev"])
            assert np.array_equal(pileup[2, base:base+L], om["fwd_cnt"])
            assert np.array_equal(pileup[3, base:base+L], om["rev_cnt"])
            base += L


def test_pileup_saved_equals_subindex_path(tmp_path):
    """Probe-reuse pass 2 must equal the sub-index pass 2 for every genome."""
    from bronko_tpu.call.engine import (
        _prepare_batches, run_pileup_pass, run_pileup_saved,
    )
    from bronko_tpu.ops.map import tally_save_jit

    rng = np.random.default_rng(77)
    k = 21
    files = [(f"g{i}", [(f"s{i}", random_genome(rng, 300 + 10 * i))]) for i in range(4)]
    index = make_index(tmp_path, files, k)
    dev = build_device_index(index)
    assert dev.hist is not None and dev.fid_grouped
    mcfg = dev.map_config(2, False)
    kmer_counts = sample_kmers(rng, files, k, n_exact=150, n_mut=60, n_junk=8)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int64)
    kj, cj = _prepare_batches(kmers, counts, 128)

    tj = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    tj, lane_tot, start_all, h_all = tally_save_jit(kj, cj, dev.keys, dev.offsets, dev.hist, tj, mcfg)
    for best in range(4):
        p_saved = np.asarray(run_pileup_saved(kj, cj, (start_all, h_all), dev, best,
                                              mcfg, n_kmers=len(kmers),
                                              exact_lanes=int(np.asarray(lane_tot)[best])))
        p_sub = np.asarray(run_pileup_pass(kj, cj, dev, best, mcfg,
                                           n_kmers=len(kmers)))
        L = int(dev.genome_lens[best])
        assert np.array_equal(p_saved[:, :L], p_sub[:, :L]), best


def test_tally_words_large_panel(tmp_path):
    """Multi-word histogram tally (8<G<=256) equals flat tallies and oracle."""
    from bronko_tpu.ops.map import tally_all_jit

    rng = np.random.default_rng(31)
    k = 21
    base = random_genome(rng, 250)
    files = []
    for i in range(13):
        g = bytearray(base)
        for p in rng.integers(0, len(base), 8):
            g[p] = b"ACGT"[rng.integers(4)]
        files.append((f"g{i:02d}", [(f"s{i}", bytes(g))]))
    index = make_index(tmp_path, files, k)
    dev = build_device_index(index)
    assert dev.hist is None and dev.hist_words is not None
    assert dev.hist_words.shape[1] == 2
    mcfg = dev.map_config(2, False)
    kmer_counts = sample_kmers(rng, files, k, n_exact=120, n_mut=50, n_junk=8)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 128
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    kj = jnp.asarray(kb.reshape(nb, B)); cj = jnp.asarray(cb.reshape(nb, B))

    t0 = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    t_words, _ = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                               dev.hist_words, t0, mcfg, "words")
    t1 = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    t_flat, ov = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                               jnp.zeros(1, jnp.int64), t1, mcfg, "flat")
    assert int(ov) == 0
    assert np.array_equal(np.asarray(t_words), np.asarray(t_flat))

    from tests.oracle.map_oracle import build_oracle_index, map_kmers_oracle
    _, o_tallies = map_kmers_oracle(kmer_counts, build_oracle_index(k, files))
    for fid in range(len(files)):
        assert np.asarray(t_words)[fid].tolist() == o_tallies.get(fid, [0, 0, 0])


def test_words_probe_reuse_large_panel(tmp_path):
    """G=13 (> 8): the multi-word saved-probe pass (tally_save_words_jit +
    pileup_from_saved_words_jit) must reproduce the sub-index pileup and
    the flat tallies exactly, for every selectable genome."""
    from dataclasses import replace

    from bronko_tpu.call.engine import _lane_class, run_pileup_pass
    from bronko_tpu.ops.map import tally_all_jit, tally_save_words_jit, \
        pileup_from_saved_words_jit

    rng = np.random.default_rng(61)
    k = 21
    base = random_genome(rng, 260)
    files = []
    for i in range(13):
        g = bytearray(base)
        for p in rng.integers(0, len(base), 10):
            g[p] = b"ACGT"[rng.integers(4)]
        files.append((f"g{i:02d}", [(f"s{i}", bytes(g))]))
    index = make_index(tmp_path, files, k)
    dev = build_device_index(index)
    assert dev.hist is None and dev.hist_words is not None and dev.fid_grouped
    assert dev.g_keys is None  # deferred: probe-reuse path needs no sub-index
    mcfg = dev.map_config(2, False)

    kmer_counts = sample_kmers(rng, files, k, n_exact=140, n_mut=60, n_junk=10)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 128
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    kj = jnp.asarray(kb.reshape(nb, B)); cj = jnp.asarray(cb.reshape(nb, B))

    t0 = jnp.zeros((13, 3), jnp.int32)
    tj, lane_tot, start_all, hw_all = tally_save_words_jit(
        kj, cj, dev.keys, dev.offsets, dev.hist_words, t0, mcfg)
    t1 = jnp.zeros((13, 3), jnp.int32)
    t_words, _ = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                               dev.hist_words, t1, mcfg, "words")
    assert np.array_equal(np.asarray(tj), np.asarray(t_words))

    lane_tot = np.asarray(lane_tot)
    for best in range(13):
        gcfg = replace(mcfg, total_len=dev.g_total_len,
                       max_bucket=dev.g_max_bucket,
                       lane_budget=_lane_class(int(lane_tot[best]), floor=1 << 10))
        pileup = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
        pileup, ov = pileup_from_saved_words_jit(
            kj, cj, start_all, hw_all, dev.postings, pileup,
            jnp.int32(best), jnp.int32(int(dev.file_bases[best])), gcfg)
        assert int(ov) == 0, best
        p_sub = np.asarray(run_pileup_pass(kj, cj, dev, best, mcfg,
                                           n_kmers=len(kmers)))
        L = int(dev.genome_lens[best])
        assert np.array_equal(np.asarray(pileup)[:, :L], p_sub[:, :L]), best


def test_pileup_saved_narrow_equals_wide(tmp_path):
    """The int32 genome-local posting layout (postings_local32) must produce
    bit-identical pass-2 pileups to the int64 global layout."""
    from bronko_tpu.call.engine import _prepare_batches
    from bronko_tpu.ops.map import pileup_from_saved_jit, tally_save_jit

    rng = np.random.default_rng(99)
    k = 21
    files = [(f"g{i}", [(f"s{i}a", random_genome(rng, 280)),
                        (f"s{i}b", random_genome(rng, 190))]) for i in range(3)]
    index = make_index(tmp_path, files, k)
    dev = build_device_index(index)
    assert dev.postings_local32 is not None
    assert dev.hist is not None and dev.fid_grouped
    mcfg = dev.map_config(2, False)
    kmer_counts = sample_kmers(rng, files, k, n_exact=140, n_mut=50, n_junk=6)
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int64)
    kj, cj = _prepare_batches(kmers, counts, 128)

    tj = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    tj, lane_tot, start_all, h_all = tally_save_jit(
        kj, cj, dev.keys, dev.offsets, dev.hist, tj, mcfg)
    from dataclasses import replace
    for best in range(3):
        gcfg = replace(mcfg, total_len=dev.g_total_len,
                       max_bucket=dev.g_max_bucket, lane_budget=1 << 14)
        fbase = jnp.int32(int(dev.file_bases[best]))
        args = (kj, cj, start_all, h_all)
        tail = (jnp.int32(best), fbase, gcfg)
        p64 = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
        p64, ov64 = pileup_from_saved_jit(*args, dev.postings, p64, *tail)
        p32 = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
        p32, ov32 = pileup_from_saved_jit(*args, dev.postings_local32, p32, *tail)
        assert int(ov64) == 0 and int(ov32) == 0
        assert np.array_equal(np.asarray(p64), np.asarray(p32)), best


def test_sentinel_key_collision_resolves_to_real_range():
    """The bucket hash wraps mod 2^64, so a REAL bucket id can equal the
    pad sentinel 2^64-1. The merge probe picks the LAST equal row, so
    fix_sentinel_collision must move the real bucket's CSR range onto the
    last padded row or its postings silently vanish."""
    import jax.numpy as jnp
    import numpy as np

    from bronko_tpu.index.layout import KEY_SENTINEL, fix_sentinel_collision
    from bronko_tpu.ops.map import _merge_probe

    ukeys = np.array([5, 9, 0xFFFFFFFFFFFFFFFF], np.uint64)
    soff = np.array([0, 2, 3, 7], np.int32)  # sentinel bucket: 4 postings
    u_max = 6
    keys = np.full(u_max, KEY_SENTINEL, np.uint64)
    keys[:3] = ukeys
    offsets = np.zeros(u_max + 1, np.int32)
    offsets[:4] = soff
    offsets[4:] = 7
    fix_sentinel_collision(ukeys, offsets, u_max)

    # the probe picks up each query's CSR [start, end) inside the merge;
    # a miss returns (0, 0)
    q = jnp.asarray(np.array([[5, 0xFFFFFFFFFFFFFFFF, 7]], np.uint64))
    off = jnp.asarray(offsets)
    start, end = _merge_probe(q, jnp.asarray(keys),
                              (off[:u_max], off[1:u_max + 1]))
    lens = np.asarray(end) - np.asarray(start)
    assert lens[0, 0] == 2 and int(start[0, 0]) == 0   # bucket 5
    assert lens[0, 1] == 4 and int(start[0, 1]) == 3   # sentinel bucket
    assert lens[0, 2] == 0                             # miss -> empty range


def test_pileup_u16_export_roundtrip():
    """_pileup_export_u16 / pileup_from_u16: the uint16 D2H twin must
    round-trip int32 pileups exactly when every value fits uint16, and
    the embedded-max guard must reject (return None) when any value
    exceeds it (KMER_COUNT_CAP=1e6 makes that possible at extreme
    coverage) — the engine then refetches the int32 tensor."""
    import jax.numpy as jnp

    from bronko_tpu.ops.map import _pileup_export_u16, pileup_from_u16

    rng = np.random.default_rng(9)
    pl = rng.integers(0, 65536, size=(4, 50, 4)).astype(np.int32)
    pl[1, 3, 2] = 65535  # boundary value fits
    p16 = np.asarray(_pileup_export_u16(jnp.asarray(pl)))
    assert p16.shape == (4, 51, 4) and p16.dtype == np.uint16
    back = pileup_from_u16(p16)
    assert back is not None and back.dtype == np.int32
    assert np.array_equal(back, pl)

    pl[2, 7, 1] = 65536  # first value past uint16 -> guard trips
    p16 = np.asarray(_pileup_export_u16(jnp.asarray(pl)))
    assert pileup_from_u16(p16) is None

    pl[2, 7, 1] = 1_000_000  # cap-scale value
    p16 = np.asarray(_pileup_export_u16(jnp.asarray(pl)))
    assert pileup_from_u16(p16) is None

    # negative values would wrap into uint16 with max alone looking fine;
    # the embedded-min guard must reject them (no signed plane exists
    # today — this pins the contract for any future one)
    pl[2, 7, 1] = -1
    p16 = np.asarray(_pileup_export_u16(jnp.asarray(pl)))
    assert pileup_from_u16(p16) is None


def test_expand_lanes_merge_equals_scatter():
    """The merge-based _expand_lanes owner derivation must equal the
    scatter-max formulation elementwise on randomized CSR range inputs,
    including zero-length runs, budget overflow tails, and the all-empty
    case. CPU runs take the scatter form by default, so the merge is
    FORCED here for coverage."""
    import os

    import bronko_tpu.ops.map as m

    rng = np.random.default_rng(17)
    try:
        m._expand_merge_enabled.cache_clear()
        for trial in range(40):
            N2 = int(rng.integers(4, 200))
            LB = int(rng.integers(4, 300))
            lensf = jnp.asarray(rng.integers(0, 5, N2).astype(np.int32))
            if trial % 7 == 0:
                lensf = jnp.zeros(N2, jnp.int32)      # all-empty
            startf = jnp.asarray(rng.integers(0, 1000, N2).astype(np.int32))

            os.environ["BRONKO_EXPAND_MERGE"] = "0"
            m._expand_merge_enabled.cache_clear()
            o0 = [np.asarray(x) for x in m._expand_lanes(startf, lensf, LB)]

            os.environ["BRONKO_EXPAND_MERGE"] = "1"
            m._expand_merge_enabled.cache_clear()
            o1 = [np.asarray(x) for x in m._expand_lanes(startf, lensf, LB)]

            for a, b in zip(o0, o1):
                np.testing.assert_array_equal(a, b, err_msg=f"trial {trial}")
    finally:
        os.environ.pop("BRONKO_EXPAND_MERGE", None)
        m._expand_merge_enabled.cache_clear()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_expand_merge_default_is_backend_gated(monkeypatch, backend):
    """Unset env: the scatter form on the CPU and on the GPU (the merge
    measured slower on both); BRONKO_EXPAND_MERGE=1 forces the merge."""
    import jax

    import bronko_tpu.ops.map as m

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.delenv("BRONKO_EXPAND_MERGE", raising=False)
    m._expand_merge_enabled.cache_clear()
    try:
        assert m._expand_merge_enabled() is False
        monkeypatch.setenv("BRONKO_EXPAND_MERGE", "1")
        m._expand_merge_enabled.cache_clear()
        assert m._expand_merge_enabled() is True
    finally:
        m._expand_merge_enabled.cache_clear()
