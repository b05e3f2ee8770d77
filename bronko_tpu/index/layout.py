"""Device-facing index layout.

Derives, from the host BronkoIndex, the flat device arrays the mapper
consumes. Global pileup space: all sequences of all genomes concatenated
(files in order, sequences in order), so one scatter covers every genome —
the reference's per-genome DashMaps (call.rs:1437-1480) become slices of a
single (4, T+1, 4) tensor. Per-posting scatter positions are precomputed at
load time: gpos = seq_offset + location + idx (the mapper adds idx for both
orientations, call.rs:1334/1361, so it folds into the posting itself).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from bronko_tpu.index.model import (
    BronkoIndex, CANON_SHIFT, FILE_MASK, FILE_SHIFT, IDX_MASK, SEQ_MASK, SEQ_SHIFT,
)
from bronko_tpu.ops.map import MapConfig

KEY_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def fix_sentinel_collision(ukeys: np.ndarray, offsets_row: np.ndarray,
                           u_max: int) -> None:
    """Padded key tables carry the sentinel 2^64-1 with empty CSR rows —
    but the bucket hash wraps mod 2^64, so a REAL bucket can equal the
    sentinel. The merge probe resolves duplicate keys to the LAST equal
    row, which would be an empty pad row; move the real bucket's CSR range
    onto that last row (the in-between duplicates are never selected)."""
    u = ukeys.shape[0]
    if u and u < u_max and ukeys[-1] == KEY_SENTINEL:
        offsets_row[u_max - 1] = offsets_row[u - 1]
        offsets_row[u_max] = offsets_row[u]



@dataclass
class SeqSlice:
    file_id: int
    seq_id: int
    name: str
    offset: int  # offset into the global pileup position space
    length: int


@dataclass
class DeviceIndex:
    k: int
    keys: jnp.ndarray      # (U,) uint64
    offsets: jnp.ndarray   # (U+1,) int32
    postings: jnp.ndarray  # (P,) int64: gpos<<22 | idx | canonical<<5 | file_id<<6
    num_genomes: int
    total_len: int
    max_bucket: int
    seq_slices: list[SeqSlice]
    genome_lens: np.ndarray  # (G,) int64
    # two-pass acceleration structures:
    # per-bucket per-genome posting-count histogram, packed 8 bits/genome
    # (G <= 8 and max bucket <= 255 only; None otherwise)
    hist: jnp.ndarray | None = None
    # large-panel variant: (U, ceil(G/8)) int64 words (8 < G, <=2GB table)
    hist_words: jnp.ndarray | None = None
    # per-genome sub-index, padded to common shapes across genomes:
    # g_keys (G, Ug) sentinel-padded, g_offsets (G, Ug+1),
    # g_postings (G, Pg) with gpos local to the genome's own pileup space
    g_keys: jnp.ndarray | None = None
    g_offsets: jnp.ndarray | None = None
    g_postings: jnp.ndarray | None = None
    g_max_bucket: int = 1
    g_total_len: int = 0   # padded per-genome pileup length
    # probe-reuse pileup pass prerequisites: postings fid-grouped per bucket
    fid_grouped: bool = False
    file_bases: np.ndarray | None = None  # (G,) global offset of each file
    # pass-2 narrow postings: genome-LOCAL scatter position and fold bits in
    # one int32 (lpos<<6 | canonical<<5 | idx): half the bytes of each
    # random posting gather, and pass 2 needs neither file_id nor global
    # positions. Present when every
    # genome is < 2^25 bp (any viral panel); None otherwise.
    postings_local32: jnp.ndarray | None = None
    # fused-dispatch budget state: rolling max of observed pass-2
    # lanes-per-kmer, refreshed by the engine after every resolved sample.
    # Nonzero enables map_fused_jit's single-dispatch path (pass 1 +
    # device genome selection + pass 2, static budget = ratio * n_kmers *
    # 1.25) on subsequent samples; a mis-sized budget only costs the
    # exact-budget fallback dispatch (ops/map.py:map_fused_jit)
    fused_ratio: float = 0.0
    _glen2_dev: object = None    # (G,) f64 2*genome_lens, device-cached
    _fbases_dev: object = None   # (G,) int32 file_bases, device-cached
    # deferred sub-index constructor: the per-genome sub-index duplicates
    # the whole posting space (about half of a 32-strain panel's device
    # image), and the probe-reuse pass-2 never touches it — so when a
    # histogram exists it is built only if a fallback path asks
    _subindex_builder: object = None
    _subindex_lock: threading.Lock = field(default_factory=threading.Lock,
                                           repr=False, compare=False)

    def ensure_subindex(self) -> None:
        """Materialize g_keys/g_offsets/g_postings if they were deferred.

        Thread-safe: the engine calls this from both the main dispatch
        loop and the _finish_one worker (PendingStream.resolve), and the
        builder assigns fields one slow device upload at a time. The
        lock-free early return is safe because the builder publishes
        g_keys LAST (all other fields are set once g_keys is non-None)."""
        if self.g_keys is not None or self._subindex_builder is None:
            return
        with self._subindex_lock:
            if self.g_keys is None and self._subindex_builder is not None:
                self._subindex_builder(self)
                self._subindex_builder = None

    def map_config(self, n_fixed: int, use_full_kmer: bool) -> MapConfig:
        from bronko_tpu.ops.map import make_map_config

        return make_map_config(
            k=self.k,
            n_buckets=max(1, int(self.offsets.shape[0]) - 1),
            n_postings=int(self.postings.shape[0]),
            max_bucket=self.max_bucket,
            num_genomes=self.num_genomes,
            total_len=self.total_len,
            n_fixed=n_fixed,
            use_full_kmer=use_full_kmer,
        )

    def slices_for_file(self, file_id: int) -> list[SeqSlice]:
        return [s for s in self.seq_slices if s.file_id == file_id]


def build_device_index(index: BronkoIndex) -> DeviceIndex:
    seq_slices: list[SeqSlice] = []
    offset_table: dict[tuple[int, int], int] = {}
    cursor = 0
    for file_id, f in enumerate(index.files):
        for seq_id, s in enumerate(f.sequences):
            offset_table[(file_id, seq_id)] = cursor
            seq_slices.append(SeqSlice(file_id, seq_id, s.name, cursor, s.length))
            cursor += s.length
    total_len = cursor

    meta = index.post_meta
    idx = (meta & IDX_MASK).astype(np.int64)
    seq_id = ((meta >> SEQ_SHIFT) & SEQ_MASK).astype(np.int64)
    file_id = ((meta >> FILE_SHIFT) & FILE_MASK).astype(np.int64)
    canon = ((meta >> CANON_SHIFT) & 1).astype(np.int64)

    # (file,seq) -> offset as a flat lookup
    max_seq = int(seq_id.max()) + 1 if seq_id.size else 1
    table = np.zeros((len(index.files), max_seq), np.int64)
    for (fid, sid), off in offset_table.items():
        if sid < max_seq:
            table[fid, sid] = off
    seq_off = table[file_id, seq_id] if meta.size else np.zeros(0, np.int64)

    gpos = seq_off + index.post_loc.astype(np.int64) + idx
    pmeta = idx | (canon << 5) | (file_id << 6)
    postings = (gpos << 22) | pmeta

    # narrow pass-2 postings (genome-local coordinates, int32)
    file_bases_arr = np.concatenate(
        [[0], np.cumsum([f.total_len for f in index.files])[:-1]]
    ).astype(np.int64) if index.files else np.zeros(0, np.int64)
    postings_local32 = None
    if meta.size and index.files and max(
            f.total_len for f in index.files) < (1 << 25):
        lpos = gpos - file_bases_arr[file_id]
        postings_local32 = ((lpos << 6) | (canon << 5) | idx).astype(np.int32)

    genome_lens = np.asarray([f.total_len for f in index.files], np.int64)
    G = len(index.files)
    E = index.max_postings_per_bucket
    U = index.num_buckets

    # --- two-pass structures ---
    # per-bucket per-genome histogram (tally pass needs 1 gather per query
    # instead of 1 per posting lane)
    hist = None
    hist_words = None
    fid_grouped = False
    if meta.size:
        # postings within a bucket are genome-grouped (build appends
        # file-major and sorts stably); required by the probe-reuse pileup
        bucket_of_post = np.repeat(np.arange(U, dtype=np.int64), np.diff(index.offsets))
        same_bucket = bucket_of_post[1:] == bucket_of_post[:-1]
        fid_grouped = bool(np.all(file_id[1:][same_bucket] >= file_id[:-1][same_bucket]))
    if 0 < G <= 8 and E <= 255 and meta.size:
        h = np.zeros((U, G), np.int64)
        np.add.at(h, (bucket_of_post, file_id), 1)
        packed = (h << (8 * np.arange(G, dtype=np.int64))).sum(axis=1)
        # int32 histogram gathers are ~2x cheaper; fits when G <= 4 and the
        # top byte stays below the sign bit (E <= 127 for the 4th genome)
        if G <= 4 and (G < 4 or E <= 127):
            hist = jnp.asarray(packed.astype(np.int32))
        else:
            hist = jnp.asarray(packed)
    elif 8 < G and E <= 255 and meta.size and (
            U * (-(-G // 8)) * 8 <= (2 << 30)):
        # large-panel histogram, any G: 8 genomes per int64 word — the
        # tally pass gathers ceil(G/8) words per bucket query instead of
        # expanding every posting lane (which scales with the panel size;
        # for a 300-strain panel of near-identical genomes the flat path
        # would pay ~300 lanes per hit bucket). Guarded to <=2 GB of device memory;
        # beyond that the flat path with overflow retry takes over.
        h = np.zeros((U, G), np.int64)
        np.add.at(h, (bucket_of_post, file_id), 1)
        n_words = -(-G // 8)
        hw = np.zeros((U, n_words), np.int64)
        for g in range(G):
            hw[:, g // 8] |= h[:, g] << (8 * (g % 8))
        hist_words = jnp.asarray(hw)

    # per-genome sub-index for the pileup pass (only the selected genome's
    # postings are ever scattered). When a histogram exists the probe-reuse
    # pass 2 never reads these arrays, so construction + upload (which
    # duplicates the whole posting space) is DEFERRED until a fallback
    # path asks via dev.ensure_subindex().
    g_keys = g_offsets = g_postings = None
    g_max_bucket = max(1, E)
    g_total_len = int(genome_lens.max()) if G else 0
    subindex_builder = None

    def _build_subindex(dev: "DeviceIndex") -> None:
        nposts = np.diff(index.offsets)
        post_keys = np.repeat(index.keys, nposts)
        # genome-local scatter position: offset of (fid, sid) within its file
        local_tab = np.zeros((G, max_seq), np.int64)
        for fid_ in range(G):
            cur = 0
            for sid_, s in enumerate(index.files[fid_].sequences):
                if sid_ < max_seq:
                    local_tab[fid_, sid_] = cur
                cur += s.length
        lpos = local_tab[file_id, seq_id] + index.post_loc.astype(np.int64) + idx
        lpost = (lpos << 22) | (idx | (canon << 5) | (file_id << 6))
        g_max_b = 1
        per_g = []
        for fid_ in range(G):
            sel = file_id == fid_
            skeys = post_keys[sel]
            order = np.argsort(skeys, kind="stable")
            skeys = skeys[order]
            spost = lpost[sel][order]
            ukeys, start = np.unique(skeys, return_index=True)
            soff = np.concatenate([start, [skeys.shape[0]]]).astype(np.int32)
            per_g.append((ukeys, soff, spost))
        U_max = max(1, max(p[0].shape[0] for p in per_g))
        P_max = max(1, max(p[2].shape[0] for p in per_g))
        gk = np.full((G, U_max), np.uint64(0xFFFFFFFFFFFFFFFF), np.uint64)
        go = np.zeros((G, U_max + 1), np.int32)
        gp = np.zeros((G, P_max), np.int64)
        for fid_, (ukeys, soff, spost) in enumerate(per_g):
            u = ukeys.shape[0]
            gk[fid_, :u] = ukeys
            go[fid_, :u + 1] = soff
            go[fid_, u + 1:] = soff[-1] if u else 0
            fix_sentinel_collision(ukeys, go[fid_], U_max)
            gp[fid_, :spost.shape[0]] = spost
            if u:
                g_max_b = max(g_max_b, int(np.max(np.diff(soff[:u + 1]))))
        # g_keys LAST: it is ensure_subindex's lock-free completion gate
        dev.g_offsets = jnp.asarray(go)
        dev.g_postings = jnp.asarray(gp)
        dev.g_max_bucket = g_max_b
        dev.g_keys = jnp.asarray(gk)

    if meta.size:
        if (hist is not None or hist_words is not None) and fid_grouped:
            subindex_builder = _build_subindex
        else:
            pass  # built eagerly below

    dev_index = DeviceIndex(
        k=index.k,
        keys=jnp.asarray(index.keys),
        offsets=jnp.asarray(index.offsets.astype(np.int32)),
        postings=jnp.asarray(postings),
        num_genomes=G,
        total_len=total_len,
        max_bucket=E,
        seq_slices=seq_slices,
        genome_lens=genome_lens,
        hist=hist,
        hist_words=hist_words,
        g_keys=g_keys,
        g_offsets=g_offsets,
        g_postings=g_postings,
        g_max_bucket=g_max_bucket,
        g_total_len=g_total_len,
        fid_grouped=fid_grouped,
        file_bases=file_bases_arr if G else np.zeros(0, np.int64),
        postings_local32=(jnp.asarray(postings_local32)
                          if postings_local32 is not None else None),
        _subindex_builder=subindex_builder,
    )
    if meta.size and subindex_builder is None:
        _build_subindex(dev_index)
    return dev_index
