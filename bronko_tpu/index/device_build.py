"""Device-side index construction: FASTA -> DeviceIndex entirely on device.

A 32-strain panel's derived arrays make a ~308 MB device image (even with
the sub-index deferred); its raw 2-bit genome codes are ~1 MB. So upload
the codes and derive keys/offsets/postings/histograms ON the device — the
same sorts the mapper already rides. Whether this beats the host build
plus upload on a GPU is unmeasured (ROADMAP 1.9, 3.9).

Bit-identical to the host builder (index/build.py + index/layout.py),
property-tested in tests/test_device_build.py:

  * posting append order (files, seqs, windows, wildcard idx) is the flat
    memory order of the concatenated code array, so a STABLE key sort
    reproduces the host's stable argsort exactly;
  * windows crossing sequence boundaries are masked via a validity sort
    key (not by key sentinels — a real bucket id may equal any sentinel
    under the u64 wrap-around hash);
  * the (key, fid) run lengths build the per-bucket genome histograms via
    int32 HALF-WORD scatter-adds (int32 wraparound is safe because
    consumers mask bytes after shifting),
    then combine into the exact int32/int64 formats layout.py produces.

Shapes: the flat posting count P_valid is static (computed from sequence
lengths); only the unique-bucket count U is data-dependent — one scalar
sync between phase A (sort) and phase B (compaction, padded to a
{2^m, 1.5*2^m} class; pad buckets carry zero postings and zero histogram
rows, so probes of padded rows are harmless by construction).

Reference semantics: build.rs:145-231 (builder), lcb.rs:1-45 (buckets).
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from bronko_tpu.index.layout import DeviceIndex, SeqSlice
from bronko_tpu.index.model import BronkoIndex
from bronko_tpu.ops.buckets import assign_buckets
from bronko_tpu.ops.codec import canonical, seq_bytes_to_bits

log = logging.getLogger("bronko")


def _size_class(n: int) -> int:
    n = max(int(n), 1 << 10)
    p = 1 << (n - 1).bit_length()
    three_q = (p >> 1) + (p >> 2)
    return three_q if three_q >= n else p


@functools.partial(jax.jit, static_argnames=("k",))
def _phase_a(codes, starts, goffs, fids, valid, k: int):
    """Sort-ready posting columns from the concatenated genome codes.

    codes (N,) uint8 0..3; starts (S,) int32 seq start in codes; goffs (S,)
    int64 global pileup offset per seq; fids (S,) int32; valid (NW,) bool.
    Returns sorted (invalid, keys, postings, fid) columns plus is_new over
    the full flat space and the unique/max-bucket scalars."""
    N = codes.shape[0]
    NW = N - k + 1

    c64 = codes.astype(jnp.uint64)
    fwd = jnp.zeros(NW, jnp.uint64)
    for t in range(k):
        fwd = (fwd << jnp.uint64(2)) | (c64[t:t + NW] & jnp.uint64(3))
    canon, is_rc = canonical(fwd, k, jnp)
    buckets = assign_buckets(canon, k, jnp)                   # (NW, k)

    pos = jnp.arange(NW, dtype=jnp.int32)
    seq = (jnp.searchsorted(starts, pos, side="right") - 1).astype(jnp.int32)
    loc = (pos - starts[seq]).astype(jnp.int64)
    gbase = goffs[seq] + loc                                  # (NW,) int64
    fid = fids[seq]                                           # (NW,) int32

    idxs = jnp.arange(k, dtype=jnp.int64)                     # wildcard idx
    gpos = gbase[:, None] + idxs[None, :]                     # (NW, k)
    meta = (idxs[None, :]
            | (is_rc.astype(jnp.int64) << 5)[:, None]
            | (fid.astype(jnp.int64) << 6)[:, None])
    postings = ((gpos << 22) | meta).reshape(-1)              # (NW*k,)
    keys = buckets.reshape(-1)
    fid_flat = jnp.repeat(fid, k, total_repeat_length=NW * k)
    invalid = jnp.repeat((~valid).astype(jnp.int32), k,
                         total_repeat_length=NW * k)

    inv_s, keys_s, post_s, fid_s = jax.lax.sort(
        (invalid, keys, postings, fid_flat), num_keys=2, is_stable=True)

    is_new = jnp.concatenate(
        [jnp.ones(1, bool), (keys_s[1:] != keys_s[:-1]) | (inv_s[1:] != inv_s[:-1])])
    is_new = is_new & (inv_s == 0)
    n_unique = is_new.sum(dtype=jnp.int32)

    # per-bucket size (for the E <= 255 histogram gate): boundary deltas
    P = keys_s.shape[0]
    lane = jnp.arange(P, dtype=jnp.int32)
    b = jnp.where(is_new, lane, P)
    nxt = jax.lax.cummin(b[::-1])[::-1]
    nxt_after = jnp.concatenate([nxt[1:], jnp.asarray([P], jnp.int32)])
    bsize = jnp.where(is_new, jnp.minimum(nxt_after, (inv_s == 0).sum()) - lane, 0)
    max_bucket = bsize.max()
    return inv_s, keys_s, post_s, fid_s, is_new, n_unique, max_bucket


@functools.partial(jax.jit,
                   static_argnames=("u_pad", "n_words", "p_valid",
                                    "want_hist"))
def _phase_b(keys_s, post_s, fid_s, is_new, u_pad: int, n_words: int,
             p_valid: int, want_hist: bool):
    """Compact unique keys + CSR offsets; build histogram half-words.

    Returns (keys_u (u_pad,), offsets (u_pad+1,) i32,
             hist_halves (u_pad, 2*n_words) i32 — a (1, 2) dummy when
             want_hist is False, skipping the run-length scatter)."""
    P = keys_s.shape[0]
    lane = jnp.arange(P, dtype=jnp.int32)
    rank = jnp.cumsum(is_new.astype(jnp.int32)) - 1           # bucket row

    # compaction: float boundary lanes to the front, stably (ascending)
    keyc = (~is_new).astype(jnp.int32)
    _, keys_b, starts_b = jax.lax.sort((keyc, keys_s, lane), num_keys=1,
                                       is_stable=True)
    if u_pad > P:  # tiny panels: pad class exceeds the posting count
        extra = u_pad - P
        keys_b = jnp.concatenate(
            [keys_b, jnp.zeros(extra, keys_b.dtype)])
        starts_b = jnp.concatenate(
            [starts_b, jnp.zeros(extra, starts_b.dtype)])
    keys_u = keys_b[:u_pad]
    starts_u = starts_b[:u_pad]
    n_real = is_new.sum(dtype=jnp.int32)
    row = jnp.arange(u_pad, dtype=jnp.int32)
    keys_u = jnp.where(row < n_real, keys_u,
                       jnp.uint64(0xFFFFFFFFFFFFFFFF))
    starts_u = jnp.where(row < n_real, starts_u, p_valid).astype(jnp.int32)
    # sentinel collision (the bucket hash wraps mod 2^64, so a REAL bucket
    # can equal the pad sentinel): the merge probe picks the LAST equal
    # row, which would be an empty pad row — move the real bucket's CSR
    # start (and, below, its histogram row) onto row u_pad-1; the rows in
    # between are never selected
    nr0 = jnp.maximum(n_real - 1, 0)
    collide = ((n_real > 0) & (n_real < u_pad)
               & (keys_b[nr0] == jnp.uint64(0xFFFFFFFFFFFFFFFF)))
    last_start = starts_b[nr0].astype(jnp.int32)
    starts_u = jnp.where(collide & (row == u_pad - 1), last_start, starts_u)
    offsets = jnp.concatenate([starts_u, jnp.asarray([p_valid], jnp.int32)])

    W2 = 2 * n_words
    if not want_hist:
        return keys_u, offsets, jnp.zeros((1, 2), jnp.int32)

    # histogram runs: (bucket, fid) segments of the sorted postings
    run_new = is_new | jnp.concatenate(
        [jnp.ones(1, bool), fid_s[1:] != fid_s[:-1]])
    run_new = run_new & (lane < p_valid)
    b = jnp.where(run_new, lane, P)
    nxt = jax.lax.cummin(b[::-1])[::-1]
    nxt_after = jnp.concatenate([nxt[1:], jnp.asarray([P], jnp.int32)])
    run_len = jnp.minimum(nxt_after, p_valid) - lane          # at boundaries

    slot = fid_s % 8
    half = slot // 4
    shift = 8 * (slot % 4)
    col = (fid_s // 8) * 2 + half
    value = (run_len.astype(jnp.int32) << shift)
    target = jnp.where(run_new, rank * W2 + col, u_pad * W2)  # dump row
    hist = jnp.zeros(u_pad * W2 + 1, jnp.int32).at[target].add(
        jnp.where(run_new, value, 0), mode="drop")
    hist2d = hist[:-1].reshape(u_pad, W2)
    hist2d = jnp.where((collide & (row == u_pad - 1))[:, None],
                       hist2d[nr0][None, :], hist2d)
    return keys_u, offsets, hist2d


@jax.jit
def _narrow_postings(post, file_bases):
    """int64 global postings -> int32 genome-local pass-2 layout
    (lpos<<6 | canon<<5 | idx)."""
    fid = ((post >> 6) & 0xFFFF).astype(jnp.int32)
    lpos = (post >> 22) - file_bases[fid]
    return ((lpos << 6) | (post & 63)).astype(jnp.int32)


def _combine_halves(hist_halves, G: int, E: int):
    """Half-word planes -> the exact layout.py histogram formats."""
    lo = hist_halves[:, 0::2].astype(jnp.uint32).astype(jnp.int64)
    hi = hist_halves[:, 1::2].astype(jnp.uint32).astype(jnp.int64)
    words = lo | (hi << 32)                                   # (U, W)
    if G <= 8:
        packed = words[:, 0]
        if G <= 4 and (G < 4 or E <= 127):
            return jnp.asarray(packed.astype(jnp.int32)), None
        return packed, None
    return None, words


def build_device_index_on_device(k: int, genome_paths: list[str]
                                 ) -> tuple[BronkoIndex, DeviceIndex]:
    """FASTA -> (metadata-only BronkoIndex, DeviceIndex): parse on host,
    build arrays on device. The returned BronkoIndex carries files/
    sequences metadata and EMPTY posting arrays (persistence and the mesh
    splitter need the host build; the call engine does not)."""
    from bronko_tpu.index.build import parse_genomes

    files = parse_genomes(genome_paths)
    index = BronkoIndex(
        k=k,
        keys=np.empty(0, np.uint64), offsets=np.asarray([0], np.int64),
        post_loc=np.empty(0, np.uint32), post_meta=np.empty(0, np.uint32),
        files=files,
    )
    return index, device_build(index)


def device_build(index: BronkoIndex) -> DeviceIndex:
    """Derive the DeviceIndex from an index's embedded sequences entirely
    on device (works for freshly parsed FASTAs and for loaded .bkdb files —
    SeqMeta embeds the raw sequence either way, matching the reference's
    ViralMetadata, build.rs:43-52)."""
    k = index.k
    files = index.files
    codes_parts: list[np.ndarray] = []
    starts, goffs, fids = [], [], []
    seq_slices: list[SeqSlice] = []
    cursor = 0      # codes position
    gcursor = 0     # global pileup position
    for file_id, fmeta in enumerate(files):
        for seq_id, rec in enumerate(fmeta.sequences):
            seq_slices.append(SeqSlice(file_id, seq_id, rec.name, gcursor, rec.length))
            if rec.length < k:
                log.warning("sequence %s shorter than k=%d, skipped", rec.name, k)
                gcursor += rec.length
                continue
            codes_parts.append(seq_bytes_to_bits(rec.seq))
            starts.append(cursor)
            goffs.append(gcursor)
            fids.append(file_id)
            cursor += rec.length
            gcursor += rec.length

    G = len(files)
    genome_lens = np.asarray([f.total_len for f in files], np.int64)
    total_len = int(genome_lens.sum())
    if not codes_parts:
        from bronko_tpu.index.layout import build_device_index

        return build_device_index(index)

    codes = np.concatenate(codes_parts)
    N = codes.shape[0]
    NW = N - k + 1
    starts_np = np.asarray(starts, np.int32)
    lens_np = np.diff(np.concatenate([starts_np, [N]])).astype(np.int64)
    # window validity: fits inside its own sequence
    valid = np.zeros(NW, bool)
    for s0, L in zip(starts_np, lens_np):
        if L >= k:
            valid[s0:s0 + L - k + 1] = True
    p_valid = int(valid.sum()) * k  # static from lengths

    inv_s, keys_s, post_s, fid_s, is_new, n_unique, max_b = _phase_a(
        jnp.asarray(codes), jnp.asarray(starts_np),
        jnp.asarray(np.asarray(goffs, np.int64)),
        jnp.asarray(np.asarray(fids, np.int32)),
        jnp.asarray(valid), k)
    U = int(n_unique)
    E = int(max_b)
    u_pad = _size_class(U)
    n_words = max(1, -(-G // 8))

    want_hist = E <= 255 and (
        G <= 8 or u_pad * n_words * 8 <= (2 << 30))
    keys_u, offsets, hist_halves = _phase_b(
        keys_s, post_s, fid_s, is_new, u_pad, n_words, p_valid, want_hist)
    hist = hist_words = None
    if want_hist:
        hist, hist_words = _combine_halves(hist_halves, G, E)

    postings = post_s[:p_valid]

    # narrow pass-2 postings (genome-local int32; see layout.py) derived on
    # device — one elementwise pass, no transfer
    file_bases = (np.concatenate([[0], np.cumsum(genome_lens)[:-1]])
                  .astype(np.int64) if G else np.zeros(0, np.int64))
    postings_local32 = None
    if G and int(genome_lens.max()) < (1 << 25):
        postings_local32 = _narrow_postings(postings, jnp.asarray(file_bases))

    log.info(
        "device index built: %d postings, %d buckets (padded %d), "
        "max bucket size %d", p_valid, U, u_pad, E)

    def _host_subindex(dev: DeviceIndex) -> None:
        # rare fallback: rebuild on host to materialize the per-genome
        # sub-index (device arrays round-tripping would cost the very
        # transfer this module exists to avoid)
        from bronko_tpu.index.build import build_index_from_files
        from bronko_tpu.index.layout import build_device_index

        log.info("materializing per-genome sub-index via host rebuild")
        host_index = (index if index.post_loc.size
                      else build_index_from_files(k, files))
        host_dev = build_device_index(host_index)
        host_dev.ensure_subindex()
        # g_keys LAST: ensure_subindex's lock-free completion gate
        dev.g_offsets = host_dev.g_offsets
        dev.g_postings = host_dev.g_postings
        dev.g_max_bucket = host_dev.g_max_bucket
        dev.g_keys = host_dev.g_keys

    dev = DeviceIndex(
        k=k,
        keys=keys_u,
        offsets=offsets,
        postings=postings,
        num_genomes=G,
        total_len=total_len,
        max_bucket=E,
        seq_slices=seq_slices,
        genome_lens=genome_lens,
        hist=hist,
        hist_words=hist_words,
        g_max_bucket=max(1, E),
        g_total_len=int(genome_lens.max()) if G else 0,
        fid_grouped=True,
        file_bases=file_bases,
        postings_local32=postings_local32,
        _subindex_builder=_host_subindex,
    )
    return dev
