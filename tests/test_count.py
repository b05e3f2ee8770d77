"""Device k-mer counter vs a Python Counter oracle (KMC -b -ci -cs parity)."""

from collections import Counter

import numpy as np

from bronko_tpu.io.fastq import CODES, _encode_reads
from bronko_tpu.ops.count import KmerCounter
from tests.oracle.lcb_oracle import kmer_to_u64


def oracle_count(reads: list[bytes], k: int):
    counter = Counter()
    total = 0
    for r in reads:
        for i in range(max(0, len(r) - k + 1)):
            w = r[i:i + k]
            if all(chr(c) in "ACGTacgt" for c in w):
                counter[kmer_to_u64(w)] += 1
                total += 1
    return counter, total


def random_reads(rng, n, lmin=30, lmax=80, with_n=True):
    reads = []
    alphabet = b"ACGT" + (b"N" if with_n else b"")
    for _ in range(n):
        ln = int(rng.integers(lmin, lmax + 1))
        # skew towards duplicate reads so counts exceed 1
        if reads and rng.random() < 0.5:
            reads.append(reads[rng.integers(len(reads))])
        else:
            reads.append(bytes(rng.choice(np.frombuffer(alphabet, np.uint8),
                                          size=ln, p=None)))
    return reads


def test_counter_matches_oracle():
    rng = np.random.default_rng(11)
    k = 21
    reads = random_reads(rng, 300)
    expected, total = oracle_count(reads, k)

    counter = KmerCounter(k, min_count=3)
    # split into chunks to exercise the host merge
    for lo in range(0, len(reads), 100):
        chunk = reads[lo:lo + 100]
        codes, lengths = _encode_reads(chunk)
        counter.add_chunk(codes, lengths, len(chunk))
    kmers, counts = counter.finalize()

    assert counter.stats.total_reads == len(reads)
    assert counter.stats.total_kmers == total
    assert counter.stats.unique_kmers == len(expected)
    exp_kept = {km: c for km, c in expected.items() if c >= 3}
    assert counter.stats.unique_counted_kmers == len(exp_kept)
    got = dict(zip(kmers.tolist(), counts.tolist()))
    assert got == exp_kept


def test_counter_count_cap():
    k = 15
    read = b"A" * 40
    counter = KmerCounter(k, min_count=1, count_cap=10)
    codes, lengths = _encode_reads([read] * 5)
    counter.add_chunk(codes, lengths, 5)
    kmers, counts = counter.finalize()
    assert kmers.tolist() == [0]
    assert counts.tolist() == [10]  # capped (26 windows * 5 reads -> 10)


def test_encode_reads_layout():
    codes, lengths = _encode_reads([b"ACGTN", b"tt"])
    assert lengths.tolist() == [5, 2]
    assert codes[0, :5].tolist() == [0, 1, 2, 3, 4]
    assert codes[1, :2].tolist() == [3, 3]
    assert (codes[1, 2:] == 4).all()
    assert CODES[ord("G")] == 2


def _scalar_pack(codes, lengths, k):
    """Window pack by hand: window w of read r is valid when it lies in the
    read and holds no code >= 4; its value packs 2 bits per base."""
    R, L = codes.shape
    W = L - k + 1
    acc = np.zeros((R, W), np.uint64)
    valid = np.zeros((R, W), bool)
    for r in range(R):
        for w in range(W):
            win = codes[r, w:w + k].tolist()
            valid[r, w] = w + k <= lengths[r] and max(win) < 4
            v = 0
            for c in win:
                v = (v << 2) | (c & 3)
            acc[r, w] = v
    return acc, valid


def test_pack_windows_matches_scalar_pack():
    """The XLA window pack (device counter front end) vs a scalar pack, with
    N bases, padding codes and reads shorter than k."""
    import jax
    import jax.numpy as jnp

    from bronko_tpu.ops.count import _pack_windows_xla

    rng = np.random.default_rng(3)
    k = 21
    codes = rng.integers(0, 4, size=(48, 64)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4           # N bases
    lengths = rng.integers(5, 65, size=48).astype(np.int32)
    lengths[:4] = [0, 3, k - 1, k]                      # empty / short reads
    for r, n in enumerate(lengths):
        codes[r, n:] = 4                                # row padding
    acc, valid = jax.jit(lambda c, l: _pack_windows_xla(c, l, k))(
        jnp.asarray(codes), jnp.asarray(lengths))
    want_acc, want_valid = _scalar_pack(codes, lengths, k)
    np.testing.assert_array_equal(np.asarray(valid), want_valid)
    np.testing.assert_array_equal(np.asarray(acc)[want_valid],
                                  want_acc[want_valid])
    assert want_valid[:3].sum() == 0 and want_valid[3].sum() <= 1


def test_counter_reads_shorter_than_k():
    """A chunk whose padded width is below k yields zero k-mers (KMC
    semantics), not a negative-window trace error."""
    import numpy as np

    from bronko_tpu.ops.count import KmerCounter

    counter = KmerCounter(31, 1)
    codes = np.full((4, 16), 4, np.uint8)
    codes[:, :10] = 0
    counter.add_chunk(codes, np.full(4, 10, np.int32), 4)
    kmers, counts = counter.finalize()
    assert kmers.size == 0
    assert counter.stats.total_reads == 4
    assert counter.stats.total_kmers == 0


def test_python_fastq_parser_rejects_malformed(tmp_path):
    """The Python fallback parser must reject desynchronizing inputs (the
    native reader already does) instead of silently corrupting counts."""
    import pytest

    from bronko_tpu.io.fastq import read_fastq_chunks

    bad_header = tmp_path / "h.fastq"
    bad_header.write_text("@a\nACGT\n+\nIIII\nnothdr\nACGT\n+\nIIII\n")
    with pytest.raises(ValueError):
        list(read_fastq_chunks(str(bad_header)))

    bad_plus = tmp_path / "p.fastq"
    bad_plus.write_text("@a\nACGT\nIIII\n+\n")  # qual/plus swapped
    with pytest.raises(ValueError):
        list(read_fastq_chunks(str(bad_plus)))


def test_device_counter_all_invalid_reads():
    """Chunks that yield ZERO valid k-mers (all-N / shorter-than-k reads)
    must finalize to empty arrays, not crash on the boundary seed."""
    from bronko_tpu.ops.count import KmerCounter

    c = KmerCounter(21, 3)
    codes = np.full((8, 32), 4, np.uint8)  # every base non-ACGT
    lengths = np.full(8, 30, np.int32)
    c.add_chunk(codes, lengths, 8)
    kmers, counts = c.finalize()
    assert kmers.size == 0 and counts.size == 0
    assert c.stats.total_reads == 8 and c.stats.unique_counted_kmers == 0
