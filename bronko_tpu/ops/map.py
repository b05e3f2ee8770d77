"""Device k-mer mapper: probe the bucket index and scatter pileups.

Batched-tensor redesign of the reference hot loop (call.rs:1257-1434). The
reference walks a hashmap per k-mer per bucket and mutates DashMap pileups
under sharded locks; here mapping is two batched tensor passes:

PASS 1 — genome tallies (tally_hist / tally_flat):
  1. canonicalize the batch, compute bucket ids for the filtered wildcard
     positions, and find them in the sorted key array by one merge sort
     of keys and queries (_merge_probe);
  2. per-(kmer, genome) posting-hit counts either from a per-bucket genome
     histogram (one int64 gather per query; panels <= 8 genomes) or a
     flat-join posting expansion; classify perfect / variant /
     unique-perfect (call.rs:1390-1418) and pick the best genome.

PASS 2 — pileup scatter for the SELECTED genome only (probe_scatter over
its sub-index):
  3. expand each hit's CSR posting range via a sorted-merge run-length
     ("flat join") expansion into a lane array sized by the true posting
     load (overflow flag -> exact retry with a doubled budget);
  4. compute every posting's scatter target = (strand, semantic, genome
     position, base) as pure functions of (posting meta, read k-mer) — one
     gather into a per-(kmer, position) fold table carries base, mirrored
     complement, rc flag, and count;
  5. one scatter-add (+1 per distinct k-mer, the "counts" semantic,
     call.rs:1337-1339) and one scatter-max (KMC count, the depth-estimate
     semantic, call.rs:1342-1344) into the flat pileup tensor.

Scatter semantics notes (verified against the reference, see
docs/mapping_semantics.md):
  * the recorded genome position is location + idx for BOTH canonical
    orientations (call.rs:1334, 1361);
  * recorded base: read-canonical base at idx when the stored posting is
    non-canonical; complement of the read-canonical base at k-1-idx when it
    is canonical (call.rs:1333, 1360);
  * strand: forward iff posting.canonical == read.is_rc (call.rs:1331-1384);
  * per-genome hit counts are per POSTING, not per bucket, so duplicated
    k-mers within a genome can push a k-mer out of "perfect" (call.rs:1316).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from bronko_tpu.ops.buckets import assign_buckets
from bronko_tpu.ops.codec import canonical

# pileup tensor layout: (n_planes=4, T+1, 4 bases)
# plane 0: depth fwd, 1: depth rev, 2: counts fwd, 3: counts rev
PLANE_DEPTH_FWD = 0
PLANE_DEPTH_REV = 1
PLANE_CNT_FWD = 2
PLANE_CNT_REV = 3

# jax.named_scope of the probe front end (_bucket_q)
PROBE_FRONT_END_SCOPE = "probe_front_end"


@dataclass(frozen=True)
class MapConfig:
    k: int
    positions: tuple[int, ...]  # filtered wildcard positions (static)
    max_bucket: int             # E: max bucket size (info only)
    num_genomes: int            # G
    total_len: int              # T: sum of all sequence lengths (all genomes)
    lane_factor: int = 6        # lane budget = B * J * lane_factor (avg bucket
                                # size + slack; overflow flag triggers retry
                                # with a doubled factor)
    lane_budget: int | None = None  # explicit budget override (takes priority)


def make_map_config(*, k: int, n_buckets: int, n_postings: int,
                    max_bucket: int, num_genomes: int, total_len: int,
                    n_fixed: int, use_full_kmer: bool) -> MapConfig:
    """Shared MapConfig constructor for the single-device and sharded
    index layouts (one copy of the lane-factor heuristic — the two layouts
    only differ in which shapes feed the average)."""
    from bronko_tpu.ops.buckets import filtered_bucket_positions

    avg = n_postings / max(1, n_buckets)
    return MapConfig(
        k=k,
        positions=tuple(filtered_bucket_positions(k, n_fixed, use_full_kmer)),
        max_bucket=max_bucket,
        num_genomes=num_genomes,
        total_len=total_len,
        lane_factor=min(max_bucket, max(4, int(np.ceil(avg)) + 2)),
    )


def probe_scatter(
    kmers,        # (B,) uint64 non-canonical read k-mers
    counts,       # (B,) int32 KMC-equivalent counts; 0 marks padding
    keys,         # (U,) uint64 sorted bucket ids
    offsets,      # (U+1,) int32 CSR
    postings,     # (P,) int64 packed: gpos(31b) << 22 | idx(5b) | canon(1b) | file_id(16b)
    pileup,       # (4, T+1, 4) int32; row T is the dump row for masked lanes
    *,
    cfg: MapConfig,
):
    """Probe + pileup scatter for one batch against one index (shard).

    Expansion uses a dynamic flat join: per-hit posting ranges are unrolled
    into a flat lane array sized by the AVERAGE bucket load (lane budget =
    B*J*lane_factor) via a sorted-merge run-length expansion, instead of
    padding every hit to the maximum bucket size. Heavy-tailed bucket
    distributions (near-identical strains, low-complexity repeats) then cost
    their true posting count. If a batch's true lane total exceeds the
    budget, the returned overflow flag is nonzero and the caller retries
    with a doubled factor — no postings are ever silently dropped.

    Returns (pileup, hits, overflow) where hits is the (B, G) per-kmer
    per-genome posting-hit count — in the genome-sharded pipeline this is
    psum'ed over the 'genome' axis before classification.
    """
    k = cfg.k
    B = kmers.shape[0]
    J = len(cfg.positions)
    N2 = B * J
    LB = cfg.lane_budget if cfg.lane_budget else B * J * cfg.lane_factor

    start, lens, canon, is_rc = _probe_ranges(kmers, counts, keys, offsets,
                                              cfg=cfg)
    pc = _fold_pc(kmers, counts, cfg=cfg, canon=canon, is_rc=is_rc)

    startf = start.reshape(N2)
    lensf = lens.reshape(N2)

    own_c, pidx_s, lane_valid, total = _expand_lanes(startf, lensf, LB)
    pileup, b, fid = _scatter_lanes(
        pileup, pc, postings[pidx_s], own_c, lane_valid, J=J, k=k)

    # per-(kmer, genome) posting-hit counts
    hits = jnp.zeros((B, cfg.num_genomes), jnp.int32).at[b, fid].add(
        lane_valid.astype(jnp.int32), mode="drop"
    )
    overflow = (total > LB).astype(jnp.int32)
    return pileup, hits, overflow


def _fold_table(canon, is_rc, counts, k: int):
    """Per-(kmer, position) fold table: one int32 gather yields the
    non-canonical base, the mirrored-complement base, the kmer's rc flag,
    and its count (bits 0-1, 2-3, 4, 5+). Cuts 4 random gathers per lane
    to 1."""
    B = canon.shape[0]
    shifts = jnp.uint64(2) * jnp.arange(k - 1, -1, -1, dtype=jnp.uint64)
    bases = ((canon[:, None] >> shifts) & jnp.uint64(3)).astype(jnp.int32)  # (B,k)
    mirror = 3 - bases[:, ::-1]
    return (bases | (mirror << 2)
            | (is_rc.astype(jnp.int32) << 4)[:, None]
            | (counts << 5)[:, None]).reshape(B * k)


def _fold_pc(kmers, counts, *, cfg: MapConfig, canon=None, is_rc=None):
    """Fold table of a batch, reusing canon/is_rc when the caller already
    has them."""
    if canon is None:
        canon, is_rc = canonical(kmers, cfg.k, jnp)
    return _fold_table(canon, is_rc, counts, cfg.k)


def _expand_lanes(startf, lensf, LB: int):
    """Flat-join run-length expansion: per-(kmer,bucket) posting ranges ->
    a lane array of LB posting indices.
    Returns (owner index, posting index, lane validity, true lane total).

    Two formulations of the owner derivation, bit-identical
    (tests/test_map.py), chosen by _expand_merge_enabled:

      * scatter: a sorted scatter-max of row ids at their exclusive-cumsum
        offsets, a cummax to fill each run, and a diff[own_c] gather;
      * merge: a single-key MERGE of the (sorted) exclusive cumsum against
        the (sorted) lane ids — an i64 sort with the row's CSR offset
        riding as a sort operand, propagated to its run by a packed
        (rank+1)<<32|value cummax (the _merge_probe pickup scheme).

    Merge key layout: (value << (SH+1)) | (is_query << SH) | ordinal — queries
    sort AFTER equal-valued key rows (side='right' semantics) and the
    ordinal tiebreak orders equal-excl key rows (zero-length runs) by row
    index, so the cummax propagates the LAST equal row's offset — the
    same owner the scatter-max-of-row-index rule picked."""
    N2 = startf.shape[0]
    cum = jnp.cumsum(lensf, dtype=jnp.int32)             # inclusive
    # exact int64 total: if the true posting load ever exceeded 2^31 the
    # int32 cumsum would wrap and the overflow flag computed from it could
    # read "fits" — postings silently dropped instead of retried. The
    # expansion itself only needs the wrap-free prefix when total <= LB
    # (LB < 2^31 always), so int32 cum stays valid whenever we don't retry.
    total = jnp.sum(lensf.astype(jnp.int64))
    excl = cum - lensf                                   # exclusive cumsum
    diff = startf - excl
    lane_ids = jnp.arange(LB, dtype=jnp.int32)
    rows = jnp.arange(N2, dtype=jnp.int32)
    if not _expand_merge_enabled():
        marks = jnp.full(LB + 1, -1, jnp.int32).at[jnp.minimum(excl, LB)].max(
            rows, indices_are_sorted=True, mode="drop")
        own_c = jnp.maximum(jax.lax.cummax(marks[:LB]), 0)
        lane_valid = lane_ids < jnp.minimum(total, LB)
        pidx_s = jnp.where(lane_valid, lane_ids + diff[own_c], 0)
        return own_c, pidx_s, lane_valid, total
    SH = max(int(max(N2, LB) - 1).bit_length(), 1)
    xs = jnp.concatenate([
        (excl.astype(jnp.int64) << (SH + 1)) | rows.astype(jnp.int64),
        (lane_ids.astype(jnp.int64) << (SH + 1)) | (jnp.int64(1) << SH)
        | lane_ids.astype(jnp.int64),
    ])
    dv = jnp.concatenate([
        jax.lax.bitcast_convert_type(diff, jnp.uint32),
        jnp.zeros(LB, jnp.uint32),
    ])
    xs_s, dv_s = jax.lax.sort((xs, dv), num_keys=1, is_stable=False)
    is_key = ((xs_s >> SH) & 1) == 0
    rank = jnp.cumsum(is_key.astype(jnp.int32)) - 1
    packed = jnp.where(
        is_key,
        ((rank + 1).astype(jnp.int64) << 32) | dv_s.astype(jnp.int64),
        jnp.int64(0))
    dprop = jax.lax.cummax(packed).astype(jnp.uint32)
    ordq = jnp.where(is_key, jnp.int32(2**31 - 1),
                     (xs_s & ((jnp.int64(1) << SH) - 1)).astype(jnp.int32))
    out = jax.lax.sort((ordq, rank, dprop), num_keys=1, is_stable=False)
    own_c = jnp.maximum(out[1][:LB], 0)
    dq = jax.lax.bitcast_convert_type(out[2][:LB], jnp.int32)
    lane_valid = lane_ids < jnp.minimum(total, LB)
    pidx_s = jnp.where(lane_valid, lane_ids + dq, 0)
    return own_c, pidx_s, lane_valid, total


@functools.lru_cache(maxsize=1)
def _expand_merge_enabled() -> bool:
    """Merge-based _expand_lanes owner derivation, forced by
    BRONKO_EXPAND_MERGE=1. The default on every backend is the scatter
    form, which measured faster on the CPU and on the H100 (PERF.md)."""
    return os.environ.get("BRONKO_EXPAND_MERGE", "").strip().lower() in (
        "1", "true", "yes", "on")


def _scatter_lanes(pileup, pc, post, own_c, lane_valid, *, J: int, k: int,
                   pos_base=0):
    """Decode posting lanes and scatter the depth-max / count-add planes.
    pos_base shifts global posting positions into the pileup's local space
    (0 for a global pileup; the genome's base offset for pass 2).
    Returns (pileup, owner kmer index b, posting file_id) for tallies.

    int32 postings (the pass-2 narrow layout, lpos<<6 | canon<<5 | idx) are
    already genome-local — pos_base is ignored and fid decodes to 0 (pass 2
    never reads it)."""
    T = pileup.shape[1] - 1
    if post.dtype == jnp.int32:
        g = post >> 6
        m = post & 63
        fid = jnp.zeros_like(m)
    else:
        g = (post >> 22).astype(jnp.int32) - pos_base
        m = (post & 0x3FFFFF).astype(jnp.int32)
        fid = m >> 6
    idx = m & 31
    is_canon = (m >> 5) & 1

    b = own_c // J
    v = pc[b * k + idx]   # mirror bits already hold the k-1-idx complement
    base = jnp.where(is_canon == 1, (v >> 2) & 3, v & 3)
    fwd = (is_canon == ((v >> 4) & 1))
    n_lane = v >> 5
    pos = jnp.where(lane_valid, g, T)                    # dump row for masked
    cell = pos * 4 + base                                # (LB,) in [0, 4T+4)

    row_len = (T + 1) * 4
    flat = pileup.reshape(4 * row_len)
    depth_target = jnp.where(fwd, PLANE_DEPTH_FWD * row_len, PLANE_DEPTH_REV * row_len) + cell
    cnt_target = jnp.where(fwd, PLANE_CNT_FWD * row_len, PLANE_CNT_REV * row_len) + cell
    flat = flat.at[depth_target].max(jnp.where(lane_valid, n_lane, 0))
    flat = flat.at[cnt_target].add(lane_valid.astype(jnp.int32))
    return flat.reshape(4, T + 1, 4), b, fid


def classify_tallies(hits, valid_kmer, nb: int):
    """Perfect / variant / unique-perfect classification (call.rs:1390-1418).

    hits must be the GLOBAL per-genome posting count for each k-mer (psum'ed
    over genome shards if the index is sharded). Duplicate postings within a
    genome can push hits past nb — then the k-mer counts as 'variant', same
    as the reference.
    """
    perfect = (hits == nb) & valid_kmer[:, None]
    variant = (hits > 0) & (hits != nb) & valid_kmer[:, None]
    n_perfect = jnp.sum(perfect, axis=1)
    unique = perfect & (n_perfect[:, None] == 1)
    return jnp.stack(
        [perfect.sum(0), variant.sum(0), unique.sum(0)], axis=1
    ).astype(jnp.int32)


def map_batch(kmers, counts, keys, offsets, postings, pileup, tallies, *, cfg: MapConfig):
    """Single-shard mapping step; returns (pileup, tallies, overflow)."""
    pileup, hits, overflow = probe_scatter(
        kmers, counts, keys, offsets, postings, pileup, cfg=cfg
    )
    batch = classify_tallies(hits, counts > 0, len(cfg.positions))
    return pileup, tallies + batch, overflow


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5, 6))
def map_batch_jit(kmers, counts, keys, offsets, postings, pileup, tallies, cfg: MapConfig):
    return map_batch(kmers, counts, keys, offsets, postings, pileup, tallies, cfg=cfg)


_SORTOP_COLS = 4  # max u32 payload columns carried as merge-sort operands


def _scan1(body, init, xs):
    """lax.scan that skips the scan machinery when the batch axis is 1
    (the common case: a sample of up to one batch of unique k-mers). The
    scan's ys stacking copies each step's outputs into the stacked
    result, and unroll=True does not remove that copy; calling the body
    directly does."""
    n = jax.tree_util.tree_leaves(xs)[0].shape[0]
    if n == 1:
        carry, y = body(init, jax.tree.map(lambda a: a[0], xs))
        return carry, jax.tree.map(lambda a: a[None], y)
    return jax.lax.scan(body, init, xs)


def _merge_probe(q, keys, payloads, sortops: bool = True):
    """Sorted-merge probe: one sort of concat(keys, queries) finds, for
    every query, the last key <= it and whether that key equals it —
    replacing jnp.searchsorted(method='sort') + the key-verification
    gather (searchsorted internally pays TWO argsorts plus two rank
    scatters).

    The equality check rides a u64 cummax instead of gathering
    keys[rank]: xs_s ascends, so the LAST key <= x is also the MAX key
    value so far — a scan instead of a random 8-byte gather per query.

    `payloads` is a tuple of per-key-row arrays ((U,) or (U, W) — e.g.
    the bucket genome histogram, the CSR row starts/ends), zeroed on miss
    — so misses need no explicit hit flag (a real bucket's histogram word
    is >= 1 and its CSR extent has end > start; zeros encode 'no
    postings' in both). Pickup scheme, chosen by payload width:

      * narrow (<= _SORTOP_COLS u32 columns; 64-bit columns split lo/hi):
        the columns enter the MERGE SORT as extra operands (key rows carry
        the value, query rows 0) and propagate from each key row to its
        equal-query run via a packed (rank+1)<<32 | value int64 cummax —
        rank is non-decreasing along the sorted stream, so the running max
        always carries the LAST key row's value and query rows (packed 0)
        never dominate. No random gather is left in the probe.
      * wide (multi-word histograms), or sortops=False: post-sort row
        gathers at rank — past _SORTOP_COLS columns the extra sort
        operands move more bytes than the gathers.

    Returns a tuple of per-query payload value arrays, each (B, J) (or
    (B, J, W) for 2-D payloads), zeroed where the query missed."""
    U = keys.shape[0]
    Bq = q.size
    xs = jnp.concatenate([keys, q.reshape(Bq)])
    # ONE packed secondary operand: keys get row - U (negative, so they
    # precede equal queries AND equal-valued key rows keep their original
    # order — the narrow path's payload columns travel inside the sort, so
    # without this the sentinel-duplicate run could place the
    # collision-carrying last row anywhere); queries get 1 + their ordinal
    # (so the later unsort can recover the original position and equal
    # queries order deterministically)
    ot = jnp.concatenate(
        [jnp.arange(U, dtype=jnp.int32) - jnp.int32(U),
         1 + jnp.arange(Bq, dtype=jnp.int32)])

    # flatten payloads into u32 key-row columns (64-bit -> lo, hi)
    kcols = []
    for p in payloads:
        p2 = p if p.ndim == 2 else p[:, None]
        for w in range(p2.shape[1]):
            c = p2[:, w]
            if c.dtype.itemsize == 8:
                cu = c.astype(jnp.uint64)
                kcols.append(cu.astype(jnp.uint32))
                kcols.append((cu >> jnp.uint64(32)).astype(jnp.uint32))
            else:
                kcols.append(c.astype(jnp.uint32))

    if sortops and len(kcols) <= _SORTOP_COLS:
        qpad = jnp.zeros(Bq, jnp.uint32)
        ops = jax.lax.sort(
            (xs, ot) + tuple(jnp.concatenate([c, qpad]) for c in kcols),
            num_keys=2, is_stable=False)
        xs_s, ot_s = ops[0], ops[1]
        is_key = ot_s < 0
        prop = jax.lax.cummax(jnp.where(is_key, xs_s,
                                        jnp.zeros((), xs.dtype)))
        # POSITION-packed pickup, not rank-packed: positions strictly
        # increase, so the cummax still carries the LAST key row's value,
        # and the rank cumsum (a full extra scan over U+N2 lanes) is
        # dropped. The
        # "any key row seen yet" guard (old rank >= 0, needed when a
        # query value equals cummax's 0 init — possible since bucket
        # hashes can wrap to 0 at k=31) falls out of the first packed
        # cummax: any key row packs >= 1<<32 > 0.
        pos1 = (jnp.arange(xs.shape[0], dtype=jnp.int32)
                + jnp.int32(1)).astype(jnp.int64) << 32
        cols = []
        seen_key = None
        for c_s in ops[2:]:
            packed = jnp.where(is_key, pos1 | c_s.astype(jnp.int64),
                               jnp.int64(0))
            vp = jax.lax.cummax(packed)
            if seen_key is None:
                seen_key = vp != 0
                eq = (prop == xs_s) & seen_key
            cols.append(jnp.where(eq, vp.astype(jnp.uint32),
                                  jnp.uint32(0)))
    else:
        xs_s, ot_s = jax.lax.sort((xs, ot), num_keys=2, is_stable=False)
        is_key = ot_s < 0
        rank = jnp.cumsum(is_key.astype(jnp.int32)) - 1  # row of last key <= x
        rank_c = jnp.maximum(rank, 0)
        # duplicate keys resolve to the LAST equal row (rank counts all of
        # them), which the sentinel-collision fix relies on; rank >= 0
        # guards queries below every key (and queries equal to key value 0)
        prop = jax.lax.cummax(jnp.where(is_key, xs_s,
                                        jnp.zeros((), xs.dtype)))
        eq = (prop == xs_s) & (rank >= 0)
        cols = [jnp.where(eq, c[rank_c], jnp.uint32(0)) for c in kcols]

    # unsort the queries: keys push to the end with an out-of-range ordinal
    ordk = jnp.where(is_key, jnp.int32(2**31 - 1), ot_s)
    out = jax.lax.sort((ordk, *cols), num_keys=1, is_stable=False)
    # reassemble payload values (u32 columns -> original dtypes/shapes)
    vals = []
    ci = 1

    def take(i):
        return out[i][:Bq].reshape(q.shape)

    for p in payloads:
        w = 1 if p.ndim == 1 else p.shape[1]
        wide = p.dtype.itemsize == 8
        h_cols = []
        for _ in range(w):
            if wide:
                lo = take(ci).astype(jnp.uint64)
                hi = take(ci + 1).astype(jnp.uint64)
                h_cols.append((lo | (hi << jnp.uint64(32))).astype(p.dtype))
                ci += 2
            else:
                h_cols.append(take(ci).astype(p.dtype))
                ci += 1
        vals.append(h_cols[0] if p.ndim == 1 else jnp.stack(h_cols, axis=-1))
    return tuple(vals)


def _bucket_q(kmers, *, cfg: MapConfig):
    """Probe front end: canonical form + the filtered bucket queries, as
    XLA closed forms (elementwise integer math that fuses into the
    operand preparation of the merge-probe sort). The named scope lets a
    profiler trace attribute these fusions (chip_smoke.py)."""
    with jax.named_scope(PROBE_FRONT_END_SCOPE):
        canon, is_rc = canonical(kmers, cfg.k, jnp)
        buckets = assign_buckets(canon, cfg.k, jnp)
        return buckets[:, np.asarray(cfg.positions)], canon, is_rc


def _probe_ranges(kmers, counts, keys, offsets, *, cfg: MapConfig):
    """Probe + CSR range pickup: the matching bucket's posting range
    [start, end) rides the merge probe's own unsort (two monotone int32
    gathers in merge order) instead of two random offsets[ii] gathers in
    query order afterwards.

    Returns (start (B,J) i32, lens (B,J) i32 — 0 on miss and on padding
    k-mers, canon, is_rc)."""
    q, canon, is_rc = _bucket_q(kmers, cfg=cfg)
    U = keys.shape[0]
    start, end = _merge_probe(q, keys, (offsets[:U], offsets[1:U + 1]))
    lens = jnp.where((counts > 0)[:, None], end - start, 0)
    return start, lens, canon, is_rc


def _probe_hist(kmers, counts, keys, payload, *, cfg: MapConfig,
                offsets=None, sortops: bool = True):
    """Probe with the per-bucket histogram fused into the merge sort:
    the histogram row rides the probe's own unsort as extra sort operands
    (picked up by a MONOTONE gather in merge order) instead of a separate
    random `hist[ii]` gather after the probe. With `offsets`, the CSR row
    start is picked up too (the probe-reuse pass 2 then needs no gather
    of its own — it derives posting ranges from start + histogram
    prefixes alone).

    Returns (h, start_or_None, canon, is_rc) with h zeroed on miss AND on
    padding k-mers."""
    q, canon, is_rc = _bucket_q(kmers, cfg=cfg)
    if offsets is None:
        (h,) = _merge_probe(q, keys, (payload,), sortops=sortops)
        start = None
    else:
        h, start = _merge_probe(q, keys,
                                (payload, offsets[:keys.shape[0]]),
                                sortops=sortops)
    valid = (counts > 0)[:, None]
    mask = valid if h.ndim == valid.ndim else valid[..., None]
    h = jnp.where(mask, h, jnp.zeros((), h.dtype))
    return h, start, canon, is_rc


def _hist_hits(h, G: int):
    """(B, J) packed per-bucket genome histogram (8 bits/genome) ->
    (B, G) per-kmer hit counts. Summing the packed words directly could
    carry across byte fields (J buckets x <=255 each), so the bytes first
    WIDEN to 16-bit slots — even genomes in one masked word, odd in the
    other — and the two words sum over J with headroom (J <= 31 so
    fields stay < 2^13); no (B, J, G) intermediate materializes."""
    even_mask = h.dtype.type(0x00FF00FF if h.dtype == jnp.int32
                             else 0x00FF00FF00FF00FF)
    lo = (h & even_mask).sum(axis=1)           # genomes 0,2,4,6 in 16-bit slots
    hi = ((h >> h.dtype.type(8)) & even_mask).sum(axis=1)  # genomes 1,3,5,7
    cols = [(((lo, hi)[g & 1]) >> ((g >> 1) * 16)).astype(jnp.int32) & 0xFFFF
            for g in range(G)]
    return jnp.stack(cols, axis=1)             # (B,G)


def _hist_hits_words(hw, G: int):
    """Multi-word variant: (B, J, W) int64 words, 8 genomes per word ->
    (B, G) hit counts."""
    cols = []
    for g in range(G):
        byte = (hw[..., g // 8] >> (8 * (g % 8))) & 0xFF
        cols.append(byte.sum(axis=1))
    return jnp.stack(cols, axis=1).astype(jnp.int32)        # (B,G)


def tally_hist(kmers, counts, keys, hist, *, cfg: MapConfig):
    """Tally pass via the per-bucket genome histogram: ONE packed gather
    per (kmer, bucket) query instead of one per posting lane. Valid for
    G <= 8 genomes with bucket sizes <= 255 (checked at index load)."""
    h, _, _, _ = _probe_hist(kmers, counts, keys, hist, cfg=cfg)
    return _hist_hits(h, cfg.num_genomes)


def tally_hist_multi(kmers, counts, keys, hist_words, *, cfg: MapConfig):
    """Large-panel tally (any G > 8): per-bucket genome counts packed 8
    per int64 word. ceil(G/8) gathers per query — independent of how many
    postings the panel piles into each bucket."""
    hw, _, _, _ = _probe_hist(kmers, counts, keys, hist_words, cfg=cfg)
    return _hist_hits_words(hw, cfg.num_genomes)


def tally_flat(kmers, counts, keys, offsets, postings, *, cfg: MapConfig):
    """Tally pass without the histogram (any G): flat-join expansion of
    posting fids only — no pileup work."""
    B = kmers.shape[0]
    J = len(cfg.positions)
    N2 = B * J
    LB = cfg.lane_budget if cfg.lane_budget else B * J * cfg.lane_factor
    start, lens, _, _ = _probe_ranges(kmers, counts, keys, offsets, cfg=cfg)
    own_c, pidx, lane_valid, total = _expand_lanes(
        start.reshape(N2), lens.reshape(N2), LB)
    fid = (postings[pidx] & 0x3FFFFF).astype(jnp.int32) >> 6
    hits = jnp.zeros((B, cfg.num_genomes), jnp.int32).at[own_c // J, fid].add(
        lane_valid.astype(jnp.int32), mode="drop")
    overflow = (total > LB).astype(jnp.int32)
    return hits, overflow


@functools.partial(jax.jit, static_argnames=("cfg", "mode"), donate_argnums=(6,))
def tally_all_jit(kmers, counts, keys, offsets, postings, hist, tallies,
                  cfg: MapConfig, mode: str):
    """Pass 1: per-genome tallies over (nb, B) batches, single dispatch.

    mode: 'hist' (packed single-word histogram, G<=8), 'words' (multi-word
    histogram, G>8), or 'flat' (posting-lane expansion, any G)."""
    nb_pos = len(cfg.positions)

    def body(carry, batch):
        tl, ov = carry
        km, ct = batch
        if mode == "hist":
            hits = tally_hist(km, ct, keys, hist, cfg=cfg)
            ov2 = jnp.int32(0)
        elif mode == "words":
            hits = tally_hist_multi(km, ct, keys, hist, cfg=cfg)
            ov2 = jnp.int32(0)
        else:
            hits, ov2 = tally_flat(km, ct, keys, offsets, postings, cfg=cfg)
        tl = tl + classify_tallies(hits, ct > 0, nb_pos)
        return (tl, ov | ov2), None

    (tallies, overflow), _ = _scan1(
        body, (tallies, jnp.int32(0)), (kmers, counts))
    return tallies, overflow


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def tally_save_jit(kmers, counts, keys, offsets, hist, tallies, cfg: MapConfig):
    """Pass 1 with probe reuse: histogram tallies PLUS the per-batch probe
    artifacts (the matching bucket's CSR row START, packed histogram) that
    let pass 2 skip its own search entirely. The start rides the probe's
    own unsort, so pass 2 pays no random offsets[row] gather.

    Also returns lane_totals (G,) int64 — the EXACT per-batch posting-lane
    load each genome would incur in pass 2, maxed over batches (so it
    bounds every batch of the scan). The engine sizes the pass-2 lane
    budget from lane_totals[best]: the expansion then processes ~the true
    load instead of a 1.5x-then-pow2 guess, and can never overflow-retry."""
    return _tally_save_body(kmers, counts, keys, offsets, hist, tallies,
                            cfg)


def _tally_save_body(kmers, counts, keys, offsets, hist, tallies,
                     cfg: MapConfig):
    nb_pos = len(cfg.positions)
    G = cfg.num_genomes
    # multi-batch scans pick the probe payloads up by gather, the nb==1
    # case (scan skipped by _scan1) by sort operands; the two pickups are
    # bit-identical (whether one suffices on the GPU is ROADMAP 3.2)
    sortops = kmers.shape[0] == 1

    def body(carry, batch):
        tl, lt = carry
        km, ct = batch
        h, start, _, _ = _probe_hist(km, ct, keys, hist, cfg=cfg,
                                     offsets=offsets, sortops=sortops)
        hits = _hist_hits(h, G)
        tl = tl + classify_tallies(hits, ct > 0, nb_pos)
        lt = jnp.maximum(lt, hits.sum(axis=0, dtype=jnp.int64))
        return (tl, lt), (start, h)  # h keeps the hist dtype (int64, G > 4)

    (tallies, lane_totals), (start_all, h_all) = _scan1(
        body, (tallies, jnp.zeros(G, jnp.int64)), (kmers, counts))
    return tallies, lane_totals, start_all, h_all


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def tally_save_words_jit(kmers, counts, keys, offsets, hist_words, tallies,
                         cfg: MapConfig):
    """Large-panel (G > 8) pass 1 with probe reuse: multi-word histogram
    tallies plus the saved probe artifacts (bucket rows + histogram words)
    so pass 2 needs no search and no per-genome sub-index — for a
    32-strain panel this removes the duplicated sub-index upload entirely.

    Returns (tallies, lane_totals (G,) int64 per-batch max, start_all,
    hw_all) where hw_all is (nb, B, J, W) int64 and start_all carries the
    matching bucket's CSR row start (pass 2 needs no gather of its own)."""
    nb_pos = len(cfg.positions)
    G = cfg.num_genomes

    def body(carry, batch):
        tl, lt = carry
        km, ct = batch
        hw, start, _, _ = _probe_hist(km, ct, keys, hist_words, cfg=cfg,
                                      offsets=offsets)
        hits = _hist_hits_words(hw, G)
        tl = tl + classify_tallies(hits, ct > 0, nb_pos)
        lt = jnp.maximum(lt, hits.sum(axis=0, dtype=jnp.int64))
        return (tl, lt), (start, hw)

    (tallies, lane_totals), (start_all, hw_all) = _scan1(
        body, (tallies, jnp.zeros(G, jnp.int64)), (kmers, counts))
    return tallies, lane_totals, start_all, hw_all


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def pileup_from_saved_words_jit(kmers, counts, start_all, hw_all,
                                postings, pileup, best, file_base,
                                cfg: MapConfig):
    """Pass 2 from the multi-word saved probe (G > 8): the selected
    genome's posting range within each bucket derives from the SAVED CSR
    row start plus its histogram byte (length) and the sum of all lower
    genomes' bytes (prefix), split into whole-words-below + partial-word
    parts so no (B,J,G) intermediate materializes — and no gather at all
    (the start already rode pass 1's merge unsort). `best` is a traced
    scalar — one executable serves every selected genome."""
    k = cfg.k
    J = len(cfg.positions)
    W = hw_all.shape[-1]
    word_ids = jnp.arange(W, dtype=jnp.int32)

    def body(carry, batch):
        pl, ov = carry
        km, ct, start, hw = batch
        B = km.shape[0]
        N2 = B * J
        LB = cfg.lane_budget if cfg.lane_budget else B * J * cfg.lane_factor

        pc = _fold_pc(km, ct, cfg=cfg)

        wb = best // 8
        sb = best % 8
        sel_w = (word_ids == wb)                               # (W,)
        h_wb = jnp.sum(jnp.where(sel_w, hw, 0), axis=-1)       # (B,J) int64
        # per-word byte sums + partial-word prefix, 8-slot unrolled
        slot_bytes = jnp.stack([(h_wb >> (8 * s)) & 0xFF for s in range(8)], -1)
        lens = jnp.sum(jnp.where(jnp.arange(8) == sb, slot_bytes, 0), axis=-1)
        part_prefix = jnp.sum(jnp.where(jnp.arange(8) < sb, slot_bytes, 0), axis=-1)
        bs = None
        for s in range(8):
            b_s = (hw >> (8 * s)) & 0xFF                       # (B,J,W)
            bs = b_s if bs is None else bs + b_s
        full_prefix = jnp.sum(jnp.where(word_ids < wb, bs, 0), axis=-1)
        prefix = (full_prefix + part_prefix).astype(jnp.int32)
        lensf = lens.astype(jnp.int32).reshape(N2)
        startf = (start + prefix).reshape(N2).astype(jnp.int32)

        own_c, pidx_s, lane_valid, total = _expand_lanes(startf, lensf, LB)
        pl, _, _ = _scatter_lanes(pl, pc, postings[pidx_s], own_c, lane_valid,
                                  J=J, k=k, pos_base=file_base)
        return (pl, ov | (total > LB).astype(jnp.int32)), None

    (pileup, overflow), _ = _scan1(
        body, (pileup, jnp.int32(0)), (kmers, counts, start_all, hw_all))
    return pileup, overflow


def _pick_best_device(tallies, glen2):
    """Device twin of engine.pick_best_genome (call.rs:422-450): score =
    perfect / (2*glen) in f64 — bit-identical to the host's
    float(t)/glen/2.0 because dividing by 2 is exact, so the single
    rounding lands on the same value — zero-length genomes excluded,
    first maximum wins (argmax first-occurrence == the reference's
    strict-> keeping the earliest). The caller still recomputes the host
    pick from the returned tallies for the None case (no positive
    score)."""
    scores = jnp.where(glen2 > 0,
                       tallies[:, 0].astype(jnp.float64)
                       / jnp.maximum(glen2, 1).astype(jnp.float64),
                       jnp.float64(-1.0))
    return jnp.argmax(scores).astype(jnp.int32)


def _pileup_export_u16(pileup):
    """D2H-optimized pileup twin: uint16 halves the int32 transfer, and
    the extra row T+1 carries the tensor's int32 max split lo/hi so the host can
    validate the narrow cast with NO extra device sync. KMER_COUNT_CAP is
    1e6, so depth planes CAN exceed 65535 at extreme coverage — the guard
    then refetches the int32 tensor (one extra transfer, bit-identical
    results either way).

    The tail also embeds the tensor's MIN (bitcast lo/hi at [0,0,2:4]):
    today's planes are provably non-negative (scatter-max of counts and
    +1 adds from zeros), but a future signed plane would wrap into uint16
    while the max-only guard still passed — the min guard makes
    pileup_from_u16 reject any negative value instead."""
    mx = jnp.max(pileup).astype(jnp.uint32)
    mn = jax.lax.bitcast_convert_type(jnp.min(pileup).astype(jnp.int32),
                                      jnp.uint32)
    tail = jnp.zeros((4, 1, 4), jnp.uint16)
    tail = tail.at[0, 0, 0].set((mx & jnp.uint32(0xFFFF)).astype(jnp.uint16))
    tail = tail.at[0, 0, 1].set((mx >> jnp.uint32(16)).astype(jnp.uint16))
    tail = tail.at[0, 0, 2].set((mn & jnp.uint32(0xFFFF)).astype(jnp.uint16))
    tail = tail.at[0, 0, 3].set((mn >> jnp.uint32(16)).astype(jnp.uint16))
    return jnp.concatenate([pileup.astype(jnp.uint16), tail], axis=1)


pileup_export_u16_jit = jax.jit(_pileup_export_u16)


def pileup_from_u16(p16: "np.ndarray"):
    """Host-side inverse of _pileup_export_u16: returns the int32 pileup
    when the embedded max fits uint16 AND the embedded min is
    non-negative, else None (caller refetches the int32 tensor)."""
    mx = int(p16[0, -1, 0]) | (int(p16[0, -1, 1]) << 16)
    mn = np.uint32(int(p16[0, -1, 2]) | (int(p16[0, -1, 3]) << 16))
    if mx > 0xFFFF or int(mn.view(np.int32)) < 0:
        return None
    return p16[:, :-1].astype(np.int32)


@functools.partial(jax.jit, static_argnames=("cfg", "gcfg"),
                   donate_argnums=(6,))
def map_fused_jit(kmers, counts, keys, offsets, hist, postings, tallies,
                  glen2, file_bases, cfg: MapConfig, gcfg: MapConfig):
    """BOTH passes + genome selection in ONE dispatch (single-word
    histogram panels): pass 1 saves the probe artifacts, the best genome
    is picked on device (_pick_best_device), and pass 2 expands the saved
    artifacts for it immediately — no host round-trip between the passes.

    The pass-2 lane budget (gcfg.lane_budget) must be STATIC, so the
    engine sizes it from a rolling lanes-per-kmer ratio observed on
    earlier samples (x1.25 slack); the overflow flag falls back to the
    exact-budget two-pass path using the returned artifacts — nothing is
    ever dropped, a mis-sized budget only costs the fallback dispatch.

    Returns (tallies, lane_totals, best, start_all, h_all, pileup,
    overflow, meta, p16): `meta` packs tallies + lane_totals + best +
    overflow into ONE int64 vector so the resolve worker pays a single
    device-to-host sync instead of four, and `p16` is the uint16 pileup export
    (_pileup_export_u16) that halves the D2H bytes."""
    tallies, lane_totals, start_all, h_all = _tally_save_body(
        kmers, counts, keys, offsets, hist, tallies, cfg)
    best = _pick_best_device(tallies, glen2)
    fbase = file_bases[best]
    pileup0 = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
    pileup, overflow = _pileup_from_saved_body(
        kmers, counts, start_all, h_all, postings, pileup0, best, fbase,
        gcfg)
    meta = jnp.concatenate([
        tallies.astype(jnp.int64).reshape(-1),
        lane_totals.astype(jnp.int64),
        best.astype(jnp.int64)[None],
        overflow.astype(jnp.int64)[None],
    ])
    return (tallies, lane_totals, best, start_all, h_all, pileup,
            overflow, meta, _pileup_export_u16(pileup))


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def pileup_from_saved_jit(kmers, counts, start_all, h_all, postings,
                          pileup, best, file_base, cfg: MapConfig):
    """Pass 2 without a probe and without gathers: per-genome posting
    ranges derive from the SAVED CSR row starts + histogram bytes
    (postings are fid-grouped within a bucket, asserted at index load).
    `best` and `file_base` are traced scalars, so one executable serves
    every selected genome."""
    return _pileup_from_saved_body(kmers, counts, start_all, h_all,
                                   postings, pileup, best, file_base, cfg)


def _saved_lens_prefix(h, best):
    """Selected genome's in-bucket posting (length, prefix) from the saved
    single-word histogram: the byte at `best` is a direct dynamic shift;
    the bytes BELOW it (its in-bucket posting prefix) are a mask + fixed
    byte sum — no (B, J, G) broadcast materializes. Shared by the
    single-device saved pass 2 AND the routed mesh pass 2 so the
    fid-grouped-posting parity invariant lives in exactly one place."""
    one = h.dtype.type(1)
    shift = (best * 8).astype(h.dtype)
    lens = ((h >> shift) & h.dtype.type(0xFF)).astype(jnp.int32)
    below = h & ((one << shift) - one)
    prefix = jnp.zeros_like(lens)
    for byte in range(h.dtype.itemsize):
        prefix = prefix + (((below >> h.dtype.type(8 * byte))
                            & h.dtype.type(0xFF)).astype(jnp.int32))
    return lens, prefix


def _pileup_from_saved_body(kmers, counts, start_all, h_all, postings,
                            pileup, best, file_base, cfg: MapConfig):
    k = cfg.k
    J = len(cfg.positions)
    def body(carry, batch):
        pl, ov = carry
        km, ct, start, h = batch
        B = km.shape[0]
        N2 = B * J
        LB = cfg.lane_budget if cfg.lane_budget else B * J * cfg.lane_factor

        pc = _fold_pc(km, ct, cfg=cfg)

        lens, prefix = _saved_lens_prefix(h, best)
        startf = (start + prefix).reshape(N2).astype(jnp.int32)
        lensf = lens.reshape(N2)

        own_c, pidx_s, lane_valid, total = _expand_lanes(startf, lensf, LB)
        pl, _, _ = _scatter_lanes(pl, pc, postings[pidx_s], own_c, lane_valid,
                                  J=J, k=k, pos_base=file_base)
        return (pl, ov | (total > LB).astype(jnp.int32)), None

    (pileup, overflow), _ = _scan1(
        body, (pileup, jnp.int32(0)), (kmers, counts, start_all, h_all))
    return pileup, overflow


@functools.partial(jax.jit, static_argnames=("cfg",), donate_argnums=(5,))
def pileup_all_jit(kmers, counts, keys_g, offsets_g, postings_g, pileup, cfg: MapConfig):
    """Pass 2: scatter the selected genome's pileup over (nb, B) batches.

    keys_g/offsets_g/postings_g are the genome's sub-index rows; gpos in
    postings_g is local to the genome's pileup space (cfg.total_len =
    padded per-genome length).

    The overflow flag rides the CARRY, not the ys, so the scan stacks no
    per-batch outputs."""

    def body(carry, batch):
        pl, ov = carry
        km, ct = batch
        pl, _hits, ov2 = probe_scatter(km, ct, keys_g, offsets_g, postings_g,
                                       pl, cfg=cfg)
        return (pl, ov | ov2), None

    (pileup, overflow), _ = _scan1(body, (pileup, jnp.int32(0)),
                                   (kmers, counts))
    return pileup, overflow
