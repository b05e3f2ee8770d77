"""Device-side read k-mer counting — the KMC3 replacement.

The reference shells out to KMC3 (call.rs:1152-1226) with `-b -ci<min>
-cs1000000`: non-canonical counting, k-mers containing non-ACGT skipped,
counts floored at ci and capped at cs. Here the counter is an on-device
sort-based pipeline (`--counter device`; the host C++ counter in
io/native.py is the default):

  reads (R, L) base codes --window-pack--> (R, W) uint64 k-mers + validity
  --sort--> boundaries --segment-sum--> (unique k-mer, count) pairs

Sorting stands in for a hash table: it needs no dynamic memory and no
scatter. Chunks of reads are
counted on device and merged on host (sample-level counts must be global
before the ci filter is applied, so per-chunk results stay unfiltered).

Statistics mirror KMC's stdout stats consumed at call.rs:1190-1200:
total reads, total (valid) k-mers, unique k-mers, unique counted k-mers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

SENTINEL = jnp.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class CountStats:
    total_reads: int = 0
    total_kmers: int = 0
    unique_kmers: int = 0
    unique_counted_kmers: int = 0


# jax.named_scope of the window pack (_pack_windows_xla)
WINDOW_PACK_SCOPE = "window_pack"


def _pack_windows_xla(codes, lengths, k: int):
    """(R, L) base codes -> ((R, W) uint64 k-mer windows, (R, W) validity),
    W = L - k + 1: a window is valid when it lies inside its read and holds
    no code >= 4."""
    with jax.named_scope(WINDOW_PACK_SCOPE):
        return _pack_windows_body(codes, lengths, k)


def _pack_windows_body(codes, lengths, k: int):
    R, L = codes.shape
    W = L - k + 1
    c64 = codes.astype(jnp.uint64)
    acc = jnp.zeros((R, W), jnp.uint64)
    for t in range(k):
        acc = (acc << jnp.uint64(2)) | (c64[:, t:t + W] & jnp.uint64(3))
    bad = (codes >= 4).astype(jnp.int32)
    badps = jnp.concatenate([jnp.zeros((R, 1), jnp.int32), jnp.cumsum(bad, axis=1)], axis=1)
    nbad = badps[:, k:] - badps[:, :W]
    in_read = jnp.arange(W, dtype=jnp.int32)[None, :] + k <= lengths[:, None]
    return acc, (nbad == 0) & in_read


@functools.partial(jax.jit, static_argnames=("k",))
def extract_and_count_chunk(codes, lengths, k: int):
    """Count k-mers in one padded read chunk.

    Args:
      codes: (R, L) uint8 base codes, 0..3 = ACGT, >=4 = invalid/padding.
      lengths: (R,) int32 true read lengths.
      k: k-mer size (static).

    Returns:
      ukmers: (N,) uint64 — rank-indexed unique k-mers (tail is sentinel)
      ucounts: (N,) int32 — counts aligned with ukmers
      n_unique: () int32 — number of valid unique k-mers
      n_total: () int32 — number of valid k-mer instances
    """
    acc, valid = _pack_windows_xla(codes, lengths, k)

    flat = jnp.where(valid, acc, SENTINEL).reshape(-1)
    n_total = valid.sum(dtype=jnp.int32)

    # scatter-free segment counting: counts are next-boundary deltas, and
    # compaction is a stable sort that floats boundaries to the front
    s = jnp.sort(flat)
    N = s.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    is_new = jnp.concatenate([jnp.ones(1, bool), s[1:] != s[:-1]])
    b = jnp.where(is_new, idx, N)
    nxt_incl = jax.lax.cummin(b[::-1])[::-1]       # first boundary >= i
    nxt_after = jnp.concatenate([nxt_incl[1:], jnp.asarray([N], jnp.int32)])
    cnt_at = nxt_after - idx                        # segment size at boundaries
    is_real = is_new & (s != SENTINEL)
    keyc = (~is_real).astype(jnp.int32)
    _, ukmers, ucounts = jax.lax.sort((keyc, s, cnt_at), num_keys=1, is_stable=True)
    n_unique = is_real.sum(dtype=jnp.int32)
    return ukmers, ucounts, n_unique, n_total


class KmerCounter:
    """Streaming sample-level counter with host-side chunk merge."""

    def __init__(self, k: int, min_count: int, count_cap: int | None = None):
        from bronko_tpu.consts import KMER_COUNT_CAP

        if count_cap is None:
            count_cap = KMER_COUNT_CAP
        self.k = k
        self.min_count = min_count
        self.count_cap = count_cap
        self._chunks: list[tuple[np.ndarray, np.ndarray]] = []
        self.stats = CountStats()

    def add_chunk(self, codes: np.ndarray, lengths: np.ndarray, n_reads: int) -> None:
        if codes.shape[1] < self.k:
            # every read shorter than k: zero k-mers, like KMC (a negative
            # window count would fail the jit trace)
            self.stats.total_reads += n_reads
            return
        ukmers, ucounts, n_unique, n_total = extract_and_count_chunk(
            jnp.asarray(codes), jnp.asarray(lengths), self.k)
        n_unique = int(n_unique)
        self.stats.total_reads += n_reads
        self.stats.total_kmers += int(n_total)
        self._chunks.append(
            (np.asarray(ukmers[:n_unique]), np.asarray(ucounts[:n_unique]))
        )

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        """Merge chunks; apply ci floor / cs cap; fill unique-kmer stats.

        Returns (kmers, counts) of k-mers with count >= min_count.
        """
        if not self._chunks:
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        all_k = np.concatenate([c[0] for c in self._chunks])
        all_c = np.concatenate([c[1] for c in self._chunks])
        if all_k.size == 0:
            # chunks existed but yielded no valid k-mers (all reads shorter
            # than k / all-N): the [True] boundary seed below would have
            # shape (1,) against a (0,) array and raise
            self._chunks.clear()
            return np.empty(0, np.uint64), np.empty(0, np.int64)
        order = np.argsort(all_k)
        all_k = all_k[order]
        all_c = all_c[order]
        # all_k is sorted: boundaries by comparison, not a second sort
        is_new = np.concatenate([[True], all_k[1:] != all_k[:-1]])
        uniq = all_k[is_new]
        start = np.flatnonzero(is_new)
        counts = np.add.reduceat(all_c.astype(np.int64), start) if uniq.size else np.empty(0, np.int64)
        counts = np.minimum(counts, self.count_cap)
        self.stats.unique_kmers = int(uniq.size)
        keep = counts >= self.min_count
        self.stats.unique_counted_kmers = int(keep.sum())
        self._chunks.clear()
        return uniq[keep], counts[keep]
