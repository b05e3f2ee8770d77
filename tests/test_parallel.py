"""Sharded ('data' x 'genome') pipeline must reproduce the single-device
mapper exactly on an 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bronko_tpu.index.layout import build_device_index
from bronko_tpu.parallel.mesh import make_mesh
from bronko_tpu.parallel.pipeline import make_merge_step, make_sharded_map_step, split_index
from tests.oracle.map_oracle import build_oracle_index, map_kmers_oracle
from tests.test_map import make_index, random_genome, run_device_map, sample_kmers


@pytest.mark.parametrize("n_data,n_genome", [(8, 1), (2, 4), (4, 2)])
def test_sharded_matches_single(tmp_path, n_data, n_genome):
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    rng = np.random.default_rng(123)
    k = 21
    n_files = 5
    files = []
    for f in range(n_files):
        seqs = [(f"s{f}_0", random_genome(rng, 250 + 30 * f))]
        files.append((f"g{f}", seqs))
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=150, n_mut=80, n_junk=16)

    # single-device reference result
    dev, pileup1, tallies1 = run_device_map(index, kmer_counts, batch=256)

    # sharded result
    mesh = make_mesh(n_data, n_genome)
    sharded = split_index(index, n_genome)
    mcfg = sharded.map_config(2, False)
    step = make_sharded_map_step(mesh, mcfg)
    merge = make_merge_step(mesh)

    S, T = n_genome, sharded.t_pad
    D, G = n_data, sharded.num_genomes
    pileup = jnp.zeros((D, S, 4, T + 1, 4), jnp.int32)
    tallies = jnp.zeros((D, G, 3), jnp.int32)
    keys = jnp.asarray(sharded.keys)
    offsets = jnp.asarray(sharded.offsets)
    postings = jnp.asarray(sharded.postings)

    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 256
    assert B % D == 0
    for lo in range(0, len(kmers), B):
        kb = np.zeros(B, np.uint64)
        cb = np.zeros(B, np.int32)
        kb[: len(kmers[lo:lo + B])] = kmers[lo:lo + B]
        cb[: len(counts[lo:lo + B])] = counts[lo:lo + B]
        pileup, tallies, overflow = step(jnp.asarray(kb), jnp.asarray(cb),
                                         keys, offsets, postings, pileup, tallies)
        assert int(np.asarray(overflow)[0]) == 0
    mpileup, mtallies = merge(pileup, tallies)
    mpileup = np.asarray(mpileup)[0]    # (S, 4, T+1, 4)
    mtallies = np.asarray(mtallies)[0]  # (G, 3)

    assert np.array_equal(mtallies, tallies1)

    # compare each sequence's pileup slice between layouts
    single_slices = {(s.file_id, s.seq_id): s for s in dev.seq_slices}
    for sl in sharded.seq_slices:
        shard = next(s for s, fl in enumerate(sharded.shard_files) if sl.file_id in fl)
        got = mpileup[shard, :, sl.offset: sl.offset + sl.length]
        ref_sl = single_slices[(sl.file_id, sl.seq_id)]
        want = pileup1[:, ref_sl.offset: ref_sl.offset + ref_sl.length]
        assert np.array_equal(got, want), (sl.file_id, sl.seq_id)


def test_split_index_balance(tmp_path):
    rng = np.random.default_rng(3)
    k = 15
    files = [(f"g{f}", [(f"s{f}", random_genome(rng, 100 + 50 * f))]) for f in range(6)]
    index = make_index(tmp_path, files, k)
    sh = split_index(index, 3)
    assert sorted(f for fl in sh.shard_files for f in fl) == list(range(6))
    assert sh.t_pad >= max(sh.shard_len)


@pytest.mark.parametrize("n_data,n_genome", [(4, 2), (2, 4)])
def test_sharded_tally_hist_matches_flat(tmp_path, n_data, n_genome):
    """Per-SHARD per-bucket genome histograms (split_index.hist) carry the
    one-gather-per-query tally to genome-sharded meshes: each shard's
    packed word holds bytes only for its OWN genomes (global fid slots),
    so the psum over 'genome' reassembles the global word carry-free.
    Must equal both the flat sharded tally and the single-device tallies
    exactly (call.rs:1390-1418 semantics on a DxG mesh)."""
    from bronko_tpu.parallel.pipeline import make_sharded_tally_scan

    rng = np.random.default_rng(17)
    k = 21
    files = [(f"g{f}", [(f"s{f}", random_genome(rng, 200 + 25 * f))])
             for f in range(5)]
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=120, n_mut=60, n_junk=12)

    _, _, tallies1 = run_device_map(index, kmer_counts, batch=256)

    mesh = make_mesh(n_data, n_genome)
    sharded = split_index(index, n_genome)
    assert sharded.hist is not None  # G=5 packs into int64 single words
    mcfg = sharded.map_config(2, False)

    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 256
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    kj, cj = jnp.asarray(kb.reshape(nb, B)), jnp.asarray(cb.reshape(nb, B))
    keys = jnp.asarray(sharded.keys)
    offsets = jnp.asarray(sharded.offsets)
    postings = jnp.asarray(sharded.postings)

    t_hist, ov_h = make_sharded_tally_scan(mesh, mcfg, "hist")(
        kj, cj, keys, offsets, postings, jnp.asarray(sharded.hist))
    t_flat, ov_f = make_sharded_tally_scan(mesh, mcfg, "flat")(
        kj, cj, keys, offsets, postings, jnp.zeros(1, jnp.int64))
    assert int(np.asarray(ov_h)[0]) == 0 and int(np.asarray(ov_f)[0]) == 0
    assert np.array_equal(np.asarray(t_hist), np.asarray(t_flat))
    assert np.array_equal(np.asarray(t_hist), tallies1)


def test_sharded_tally_words_300_strains(tmp_path):
    """300-strain capacity panel on a genome-sharded mesh: the per-shard
    multi-word histograms (words mode, 38 int64 words/bucket) must tally
    identically to the single-device multi-word path — the layout the
    reference's 'hundreds of strains' (README.md:12) needs on a pod."""
    from bronko_tpu.parallel.pipeline import make_sharded_tally_scan

    rng = np.random.default_rng(41)
    k = 21
    base = random_genome(rng, 150)
    files = []
    for i in range(300):
        g = bytearray(base)
        for p in rng.integers(0, len(base), 6):
            g[p] = b"ACGT"[rng.integers(4)]
        files.append((f"g{i:03d}", [(f"s{i}", bytes(g))]))
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=60, n_mut=25, n_junk=6)

    dev = build_device_index(index)
    assert dev.hist_words is not None
    from bronko_tpu.ops.map import tally_all_jit

    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = 128
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    kj, cj = jnp.asarray(kb.reshape(nb, B)), jnp.asarray(cb.reshape(nb, B))

    mcfg1 = dev.map_config(2, False)
    t0 = jnp.zeros((300, 3), jnp.int32)
    t_single, _ = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                                dev.hist_words, t0, mcfg1, "words")

    mesh = make_mesh(2, 4)
    sharded = split_index(index, 4)
    assert sharded.hist is None and sharded.hist_words is not None
    mcfg = sharded.map_config(2, False)
    t_mesh, ov = make_sharded_tally_scan(mesh, mcfg, "words")(
        kj, cj, jnp.asarray(sharded.keys), jnp.asarray(sharded.offsets),
        jnp.asarray(sharded.postings), jnp.asarray(sharded.hist_words))
    assert int(np.asarray(ov)[0]) == 0
    assert np.array_equal(np.asarray(t_mesh), np.asarray(t_single))

    # the ROUTED layout must carry the same 300-strain panel (words mode:
    # 38 int64 histogram words ride the routed return trip per query)
    from bronko_tpu.parallel.pipeline import (
        make_routed_tally_scan, route_split,
    )

    keys_r, hist_r, starts_r, bounds = route_split(sharded, 2)
    t_rt, _, ov_r = make_routed_tally_scan(mesh, mcfg, "words", C=1024)(
        kj, cj, jnp.asarray(keys_r), jnp.asarray(hist_r),
        jnp.asarray(starts_r), jnp.asarray(bounds))
    assert int(np.asarray(ov_r)[0]) == 0
    assert np.array_equal(np.asarray(t_rt), np.asarray(t_single))


def _pad_batches(kmer_counts, B):
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    nb = -(-len(kmers) // B)
    kb = np.zeros(nb * B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(nb * B, np.int32); cb[:len(counts)] = counts
    return jnp.asarray(kb.reshape(nb, B)), jnp.asarray(cb.reshape(nb, B))


@pytest.mark.parametrize("n_data,n_genome", [(8, 1), (4, 2), (2, 4)])
def test_routed_tally_matches_single(tmp_path, n_data, n_genome):
    """Hash-range ROUTED tally (key table partitioned over 'data', queries
    travel via all_to_all) must equal the single-device tallies exactly on
    any DxG mesh — this is the intra-batch layout that replaces the
    B-split's fixed per-device U-key re-sort (VERDICT r2 item 3)."""
    from bronko_tpu.parallel.pipeline import (
        make_routed_tally_scan, route_split,
    )

    rng = np.random.default_rng(29)
    k = 21
    files = [(f"g{f}", [(f"s{f}", random_genome(rng, 220 + 20 * f))])
             for f in range(5)]
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=130, n_mut=70, n_junk=14)

    _, _, tallies1 = run_device_map(index, kmer_counts, batch=256)

    mesh = make_mesh(n_data, n_genome)
    sharded = split_index(index, n_genome)
    assert sharded.hist is not None
    mcfg = sharded.map_config(2, False)
    kj, cj = _pad_batches(kmer_counts, 256)

    keys_r, hist_r, starts_r, bounds = route_split(sharded, n_data)
    # per-(src, dst) budget ~2x the uniform expectation (engine uses 1.35x)
    C = 2 * (256 // n_data) * 16 // n_data
    step = make_routed_tally_scan(mesh, mcfg, "hist", C=C)
    tl, lt, ov = step(kj, cj, jnp.asarray(keys_r), jnp.asarray(hist_r),
                      jnp.asarray(starts_r), jnp.asarray(bounds))
    assert int(np.asarray(ov)[0]) == 0
    assert np.array_equal(np.asarray(tl), tallies1)

    # a too-small routing budget must FLAG, not silently drop
    step_tiny = make_routed_tally_scan(mesh, mcfg, "hist", C=1)
    _, _, ov_tiny = step_tiny(kj, cj, jnp.asarray(keys_r),
                              jnp.asarray(hist_r), jnp.asarray(starts_r),
                              jnp.asarray(bounds))
    assert int(np.asarray(ov_tiny)[0]) != 0

    # MULTI-BATCH (nb > 1) routed scan: a live production path — the
    # engine takes routed whenever nb doesn't divide the device count —
    # previously only covered at nb == 1
    kj2, cj2 = _pad_batches(kmer_counts, 128)
    assert kj2.shape[0] >= 2
    # C = the device's whole per-batch query load: cannot overflow
    C2 = (128 // n_data) * 16
    step2 = make_routed_tally_scan(mesh, mcfg, "hist", C=C2)
    tl2, _, ov2 = step2(kj2, cj2, jnp.asarray(keys_r), jnp.asarray(hist_r),
                        jnp.asarray(starts_r), jnp.asarray(bounds))
    assert int(np.asarray(ov2)[0]) == 0
    assert np.array_equal(np.asarray(tl2), tallies1)


def test_routed_tally_words_matches_single(tmp_path):
    """Routed tally in multi-word histogram mode (G > 8) on a 4x2 mesh."""
    from bronko_tpu.ops.map import tally_all_jit
    from bronko_tpu.parallel.pipeline import (
        make_routed_tally_scan, route_split,
    )

    rng = np.random.default_rng(31)
    k = 21
    base = random_genome(rng, 160)
    files = []
    for i in range(12):
        g = bytearray(base)
        for p in rng.integers(0, len(base), 5):
            g[p] = b"ACGT"[rng.integers(4)]
        files.append((f"g{i:02d}", [(f"s{i}", bytes(g))]))
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=80, n_mut=40, n_junk=8)

    dev = build_device_index(index)
    assert dev.hist_words is not None
    kj, cj = _pad_batches(kmer_counts, 128)
    mcfg1 = dev.map_config(2, False)
    t0 = jnp.zeros((12, 3), jnp.int32)
    t_single, _ = tally_all_jit(kj, cj, dev.keys, dev.offsets, dev.postings,
                                dev.hist_words, t0, mcfg1, "words")

    mesh = make_mesh(4, 2)
    sharded = split_index(index, 2)
    assert sharded.hist_words is not None
    mcfg = sharded.map_config(2, False)
    keys_r, hist_r, starts_r, bounds = route_split(sharded, 4)
    step = make_routed_tally_scan(mesh, mcfg, "words", C=512)
    tl, lt, ov = step(kj, cj, jnp.asarray(keys_r), jnp.asarray(hist_r),
                      jnp.asarray(starts_r), jnp.asarray(bounds))
    assert int(np.asarray(ov)[0]) == 0
    assert np.array_equal(np.asarray(tl), np.asarray(t_single))


def test_routed_saved_pileup_matches_single(tmp_path):
    """Dx1 routed pass 1 (save=True) feeding the routed pass 2: the merged
    pileup must byte-equal the single-device saved-artifact pass 2 for the
    selected genome (depth pmax / count psum merge, call.rs:1420-1431)."""
    from dataclasses import replace

    from bronko_tpu.call.engine import pick_best_genome
    from bronko_tpu.ops.map import pileup_from_saved_jit, tally_save_jit
    from bronko_tpu.parallel.pipeline import (
        make_routed_pileup_scan, make_routed_tally_scan, route_split,
    )

    rng = np.random.default_rng(37)
    k = 21
    files = [(f"g{f}", [(f"s{f}", random_genome(rng, 300 + 40 * f))])
             for f in range(4)]
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=150, n_mut=70, n_junk=10)

    dev = build_device_index(index)
    assert dev.hist is not None and dev.fid_grouped
    kj, cj = _pad_batches(kmer_counts, 256)
    mcfg1 = dev.map_config(2, False)

    # single-device product path: tally_save -> pileup_from_saved
    t0 = jnp.zeros((4, 3), jnp.int32)
    tj, lt1, st1, h1 = tally_save_jit(kj, cj, dev.keys, dev.offsets,
                                      dev.hist, t0, mcfg1)
    tallies1 = np.asarray(tj).astype(np.int64)
    best = pick_best_genome(tallies1, dev)
    gcfg1 = replace(mcfg1, total_len=dev.g_total_len,
                    max_bucket=dev.g_max_bucket, lane_budget=1 << 14)
    pl0 = jnp.zeros((4, dev.g_total_len + 1, 4), jnp.int32)
    post = (dev.postings_local32 if dev.postings_local32 is not None
            else dev.postings)
    pl1, ov1 = pileup_from_saved_jit(kj, cj, st1, h1, post, pl0,
                                     jnp.int32(best),
                                     jnp.int32(int(dev.file_bases[best])),
                                     gcfg1)
    assert int(ov1) == 0

    # routed mesh path (8x1)
    mesh = make_mesh(8, 1)
    sharded = split_index(index, 1)
    assert sharded.hist is not None
    mcfg = sharded.map_config(2, False)
    keys_r, hist_r, starts_r, bounds = route_split(sharded, 8)
    step = make_routed_tally_scan(mesh, mcfg, "hist", C=256, save=True)
    tl, lt, ov, st_all, h_all = step(
        kj, cj, jnp.asarray(keys_r), jnp.asarray(hist_r),
        jnp.asarray(starts_r), jnp.asarray(bounds))
    assert int(np.asarray(ov)[0]) == 0
    assert np.array_equal(np.asarray(tl), tallies1)
    assert int(np.asarray(lt)[best]) == int(np.asarray(lt1)[best])

    gcfg = replace(mcfg, total_len=dev.g_total_len,
                   max_bucket=dev.g_max_bucket, lane_budget=1 << 12)
    pstep = make_routed_pileup_scan(mesh, gcfg)
    pl2, ov2 = pstep(kj, cj, st_all, h_all,
                     jnp.asarray(sharded.postings[0]),
                     jnp.asarray([best], jnp.int32),
                     jnp.asarray([int(dev.file_bases[best])], jnp.int32))
    assert int(np.asarray(ov2)[0]) == 0
    assert np.array_equal(np.asarray(pl2), np.asarray(pl1))


def test_place_batches_deinterleaves_bsplit(tmp_path):
    """B-split shards get STRIDED lane slices (device d holds kj[:, d::D]).

    The unique-k-mer array is value-sorted and bucket values correlate
    with k-mer value, so contiguous B/D slices concentrate each device's
    routed queries on a few key chunks — measured 7.7x the equal
    per-(src, dst) share at D=16 on the bench sample, which blew the
    1.35x routing budget. Strided slices restore the global spread.
    Checks (a) the permutation semantics, (b) that per-destination
    routing counts on a sorted input fit the engine's 1.35x budget and
    beat the contiguous layout's worst destination, (c) batchwise
    layouts stay untouched."""
    from bronko_tpu.call.engine import ShardedMapper
    from bronko_tpu.config import CallConfig
    from bronko_tpu.ops.map import _bucket_q
    from bronko_tpu.parallel.pipeline import route_split

    rng = np.random.default_rng(77)
    k = 21
    files = [(f"g{f}", [(f"s{f}", random_genome(rng, 400 + 40 * f))])
             for f in range(4)]
    index = make_index(tmp_path, files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=400, n_mut=100,
                               n_junk=40)
    kmer_counts.sort()  # value-sorted, like _prepare_batches output
    D = 8
    sm = ShardedMapper(index, CallConfig(db="x", reads=["r"], output="o",
                                         mesh=f"{D}x1"))
    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = -(-len(kmers) // D) * D
    kj = np.zeros((1, B), np.uint64); kj[0, :len(kmers)] = kmers
    cj = np.zeros((1, B), np.int32); cj[0, :len(counts)] = counts

    kg, cg = sm.place_batches(kj, cj)
    assert not sm._batchwise
    got = np.asarray(kg)
    for d in range(D):
        sl = got[0, d * (B // D):(d + 1) * (B // D)]
        assert np.array_equal(sl, kj[0, d::D]), d

    # routing-budget check on the engine's own chunking
    sharded = split_index(index, 1)
    mcfg = sharded.map_config(2, False)
    _, _, _, bounds = route_split(sharded, D)
    bd = np.asarray(bounds[0])
    J = len(mcfg.positions)
    N2l = (B // D) * J
    from bronko_tpu.parallel.pipeline import route_budget
    C_budget = route_budget(N2l, D)

    def worst_dest(karr, carr):
        q, _, _ = _bucket_q(jnp.asarray(karr), cfg=mcfg)
        q = np.asarray(q)
        worst = 0
        for d in range(D):
            lo, hi = d * (B // D), (d + 1) * (B // D)
            qd = q[lo:hi].ravel()
            valid = np.repeat(carr[lo:hi] > 0, J)
            dest = np.sum(qd[:, None] >= bd[None, 1:], axis=1)
            dest = np.where(valid, dest, D)
            worst = max(worst, int(np.bincount(dest, minlength=D + 1)[:D].max()))
        return worst

    w_strided = worst_dest(np.asarray(kg)[0], np.asarray(cg)[0])
    w_contig = worst_dest(kj[0], cj[0])
    # at this toy scale small-sample noise dominates, so the engine's
    # exact 1.35x budget is not assertable — pin the structural claims:
    # strided strictly beats contiguous and stays within 2x equal share
    # (the contiguous layout concentrates near-everything on one chunk)
    assert w_strided < w_contig, (w_strided, w_contig)
    assert w_strided <= 2 * (N2l // D) + 128, (w_strided, N2l // D, C_budget)

    # batchwise layouts (nb % D == 0) must NOT be permuted
    kjm = np.tile(kj, (D, 1))
    cjm = np.tile(cj, (D, 1))
    kgm, _ = sm.place_batches(kjm, cjm)
    assert sm._batchwise
    assert np.array_equal(np.asarray(kgm), kjm)


def test_route_place_matches_scatter_semantics():
    """_route_place (contiguous copies in place of a u64 slot scatter)
    must reproduce the
    scattered routing buffer exactly: group d's queries at slots
    [d*C, d*C+cnt), zeros elsewhere, virtual-chunk (invalid) lanes
    never placed, within-budget groups unaffected by an overflowing
    neighbor (the flag covers the retry)."""
    from bronko_tpu.parallel.pipeline import _route_group, _route_place

    rng = np.random.default_rng(5)
    D, C = 4, 8
    N = 64
    qf = jnp.asarray(rng.integers(1, 1000, N).astype(np.uint64))
    valid = jnp.asarray(rng.random(N) > 0.2)
    bd = jnp.asarray(np.array([1, 250, 500, 750], np.uint64))

    q_s, ord_s, slot, groups, ov = _route_group(qf, valid, bd, D, C)
    buf = np.asarray(_route_place(q_s, groups, D, C))

    # oracle: dest per lane, group-by-dest in lane order
    qn = np.asarray(qf)
    vn = np.asarray(valid)
    dest = (qn[:, None] >= np.asarray(bd)[None, 1:]).sum(axis=1)
    dest = np.where(vn, dest, D)
    want = np.zeros(D * C, np.uint64)
    overflow = False
    for d in range(D):
        lanes = qn[dest == d]
        overflow |= len(lanes) > C
        want[d * C:d * C + min(len(lanes), C)] = lanes[:C]
    assert bool(np.asarray(ov)) == overflow
    if not overflow:
        assert np.array_equal(buf, want)
    else:
        # within-budget groups still placed exactly
        for d in range(D):
            lanes = qn[dest == d]
            if len(lanes) <= C:
                assert np.array_equal(buf[d * C:d * C + len(lanes)],
                                      lanes), d

    # ord_s must invert the grouping (restore original lane ids)
    assert sorted(np.asarray(ord_s).tolist()) == list(range(N))


def test_route_budget_invariants():
    """route_budget: 128-multiple, floor 128, cap N2l, and >= the uniform
    per-destination expectation N2l/D times the slack."""
    from bronko_tpu.parallel.pipeline import (
        ROUTE_SLACK_DEN, ROUTE_SLACK_NUM, route_budget,
    )

    for N2l in (1, 100, 1024, 154973 * 16, 999999):
        for D in (2, 4, 16, 64):
            C = route_budget(N2l, D)
            assert C >= 128
            assert C <= max(128, N2l)
            assert C % 128 == 0 or C == N2l
            want = -(-(N2l * ROUTE_SLACK_NUM // ROUTE_SLACK_DEN) // D)
            assert C >= min(N2l, want)


def test_route_budget_exact_covers_worst_group():
    """route_budget_exact's C must cover the true per-(src,dst) max dest
    count (so the device overflow flag can never trip on host-derived
    budgets), be a 128-multiple-quantized class value, and respect the
    [128, N2l] clamps."""
    from bronko_tpu.index.layout import build_device_index
    from bronko_tpu.ops.buckets import assign_buckets
    from bronko_tpu.ops.codec import canonical
    from bronko_tpu.parallel.pipeline import (
        route_budget_exact, route_split, split_index,
    )
    from tests.test_map import make_index, random_genome, sample_kmers
    import tempfile

    rng = np.random.default_rng(77)
    k = 21
    with tempfile.TemporaryDirectory() as td:
        import pathlib
        files = [(f"g{f}", [(f"s{f}", random_genome(rng, 400))])
                 for f in range(3)]
        index = make_index(pathlib.Path(td), files, k)
    kmer_counts = sample_kmers(rng, files, k, n_exact=200, n_mut=100,
                               n_junk=30)
    dev = build_device_index(index)
    mcfg = dev.map_config(2, False)

    D = 4
    sharded = split_index(index, 1)
    _, _, _, bounds = route_split(sharded, D)

    kmers = np.asarray([kc[0] for kc in kmer_counts], np.uint64)
    counts = np.asarray([kc[1] for kc in kmer_counts], np.int32)
    B = (len(kmers) + D - 1) // D * D
    kb = np.zeros(B, np.uint64); kb[:len(kmers)] = kmers
    cb = np.zeros(B, np.int32); cb[:len(counts)] = counts
    kj, cj = kb.reshape(1, B), cb.reshape(1, B)

    C = route_budget_exact(kj, cj, mcfg, bounds, D)

    # oracle: true worst per-(src,dst) count
    Bl = B // D
    J = len(mcfg.positions)
    canon, _ = canonical(kb, k, np)
    q = assign_buckets(canon, k, np)[:, np.asarray(mcfg.positions)]
    qf = q.reshape(D, Bl * J)
    v = np.repeat((cb > 0).reshape(D, Bl), J, axis=1)
    worst = 0
    for s in range(bounds.shape[0]):
        for d in range(D):
            dest = (qf[d][:, None] >= bounds[s, None, 1:]).sum(axis=1)
            dest = np.where(v[d], dest, D)
            for dst in range(D):
                worst = max(worst, int((dest == dst).sum()))

    N2l = Bl * J
    assert C >= worst
    assert 128 <= C <= max(128, N2l)
    # quantization never inflates by more than one class width
    share = -(-N2l // D)
    Q = max(128, (-(-share // 16) + 127) & ~127)
    assert C - worst < Q or C == 128


def test_unroute_grouped_equals_gather_fallback():
    """The grouped DMA de-group path of _unroute (production: D
    contiguous dynamic_update_slice copies, relying on the ascending-
    write overwrite of each group's tail garbage) must equal the
    slot-gather fallback on every VALID lane, for 1-D and 2-D payloads,
    across randomized group shapes including empty groups."""
    from bronko_tpu.parallel.pipeline import _unroute

    rng = np.random.default_rng(41)
    for trial in range(25):
        D = int(rng.choice([2, 4, 8]))
        Bl = int(rng.integers(1, 7))
        J = int(rng.integers(1, 5))
        N2l = Bl * J
        # C must admit the worst group (within-budget — overflow retries
        # rebuild the step, so equality is only promised within budget)
        C = int(-(-N2l // D) + rng.integers(1, 5))
        # random destination assignment (some groups may be empty);
        # deterministically drain overfull groups into the emptiest
        dest = rng.integers(0, D, N2l)
        while True:
            cnts = np.bincount(dest, minlength=D)
            over = np.where(cnts > C)[0]
            if len(over) == 0:
                break
            idx = np.where(dest == over[0])[0][0]
            dest[idx] = int(np.argmin(cnts))
        order = np.argsort(dest, kind="stable")
        ord_s = jnp.asarray(order.astype(np.int32))
        starts = np.concatenate([[0], np.cumsum(cnts)]).astype(np.int32)
        pos = np.arange(N2l) - starts[dest[order]]
        slot = jnp.asarray((dest[order] * C + pos).astype(np.int32))
        groups = (jnp.asarray(starts), jnp.asarray(cnts.astype(np.int32)))

        v1 = rng.integers(0, 1000, D * C).astype(np.int32)
        v2 = rng.integers(0, 1000, (D * C, 3)).astype(np.int32)
        backs = [jnp.asarray(v1), jnp.asarray(v2)]

        got_g = _unroute(backs, slot, ord_s, Bl, J, groups=groups, C=C)
        got_f = _unroute(backs, slot, ord_s, Bl, J)
        for a, b in zip(got_g, got_f):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"trial {trial}")
