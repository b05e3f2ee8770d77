"""Probe front end and fold table vs scalar oracles.

_bucket_q (canonical form + filtered bucket queries) and _fold_table (the
per-(kmer, position) base/mirror/rc/count word) are the XLA closed forms
the mapper feeds into its merge sort and its pileup scatter. Each is
checked element by element against a step-by-step transcription of the
reference semantics (tests/oracle/lcb_oracle.py, lcb.rs)."""

from __future__ import annotations

import numpy as np
import pytest

from bronko_tpu.ops.buckets import filtered_bucket_positions
from bronko_tpu.ops.map import MapConfig, _bucket_q, _fold_table
from tests.oracle.lcb_oracle import assign_buckets, canonical_kmer_u64


def _cfg(k: int, positions) -> MapConfig:
    return MapConfig(k=k, positions=tuple(positions), max_bucket=8,
                     num_genomes=1, total_len=1)


def _oracle_queries(kmers, k, positions):
    q, canon, rc = [], [], []
    for km in kmers.tolist():
        c, is_rc = canonical_kmer_u64(km, k)
        b = assign_buckets(c, k)
        q.append([b[p] for p in positions])
        canon.append(c)
        rc.append(is_rc)
    return (np.asarray(q, np.uint64), np.asarray(canon, np.uint64),
            np.asarray(rc, bool))


def _check_queries(kmers, k, positions):
    q, canon, is_rc = _bucket_q(kmers, cfg=_cfg(k, positions))
    q_o, canon_o, rc_o = _oracle_queries(kmers, k, positions)
    np.testing.assert_array_equal(np.asarray(canon), canon_o)
    np.testing.assert_array_equal(np.asarray(is_rc), rc_o)
    np.testing.assert_array_equal(np.asarray(q), q_o)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_bucket_queries_match_oracle(k):
    rng = np.random.default_rng(7 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=300, dtype=np.uint64)
    _check_queries(kmers, k, filtered_bucket_positions(k, 2, False))


def test_bucket_queries_full_kmer_positions():
    """--use-full-kmer keeps all k wildcard positions (J = k)."""
    k = 15
    kmers = np.random.default_rng(3).integers(0, 1 << (2 * k), size=200,
                                              dtype=np.uint64)
    positions = filtered_bucket_positions(k, 2, True)
    assert list(positions) == list(range(k))
    _check_queries(kmers, k, positions)


def test_bucket_queries_u64_wrap_at_k31():
    """Near-all-T k = 31 k-mers push the bucket sums past 2^64: the wrap
    must match the reference's release-mode u64 arithmetic."""
    k = 31
    top = (1 << 62) - 1
    rng = np.random.default_rng(99)
    kmers = (np.uint64(top)
             - rng.integers(0, 1 << 20, size=256, dtype=np.uint64))
    canon = [canonical_kmer_u64(km, k)[0] for km in kmers.tolist()]
    sums = [sum(assign_buckets(c, k)) for c in canon]
    assert max(sums) >= 1 << 64  # the inputs really wrap
    _check_queries(kmers, k, filtered_bucket_positions(k, 2, False))


def _oracle_fold(canon, is_rc, counts, k):
    out = []
    for c, rc, n in zip(canon.tolist(), is_rc.tolist(), counts.tolist()):
        bases = [(c >> (2 * (k - 1 - t))) & 3 for t in range(k)]
        for t in range(k):
            mirror = 3 - bases[k - 1 - t]
            out.append(bases[t] | mirror << 2 | int(rc) << 4 | n << 5)
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("k", [15, 21, 31])
def test_fold_table_matches_oracle(k):
    rng = np.random.default_rng(13 + k)
    kmers = rng.integers(0, 1 << (2 * k), size=200, dtype=np.uint64)
    counts = rng.integers(0, 1_000_000, size=200).astype(np.int32)
    canon, is_rc = [], []
    for km in kmers.tolist():
        c, rc = canonical_kmer_u64(km, k)
        canon.append(c)
        is_rc.append(rc)
    canon = np.asarray(canon, np.uint64)
    is_rc = np.asarray(is_rc, bool)
    got = np.asarray(_fold_table(canon, is_rc, counts, k))
    assert got.dtype == np.int32 and got.shape == (200 * k,)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  _oracle_fold(canon, is_rc, counts, k))
