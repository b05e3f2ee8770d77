"""Tests that need an NVIDIA GPU (marker `chip`).

They skip elsewhere; on the card, `python3 chip_smoke.py` runs them in its
own process (`pytest -m chip --noconftest tests/test_chip.py`). Each
compiles a device path for the GPU at small shapes and compares it with a
scalar oracle or with the host path, exactly.

Helpers load the oracles by file path: a `tests` package installed
elsewhere must not shadow this directory's.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from collections import Counter

import numpy as np
import pytest

import bronko_tpu  # noqa: F401  (x64 before any array)

pytestmark = pytest.mark.chip

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run through chip_smoke.py")
    return dev


def _oracle(name: str):
    pkg = os.path.join(HERE, "oracle")
    if "bronko_chip_oracle" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "bronko_chip_oracle", os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bronko_chip_oracle"] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"bronko_chip_oracle.{name}")


def _panel(tmp_path, rng, n_files=3, length=400):
    paths, files = [], []
    for f in range(n_files):
        seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length))
        p = tmp_path / f"g{f}.fasta"
        p.write_text(f">s{f}\n{seq.decode()}\n")
        paths.append(str(p))
        files.append((f"g{f}", [(f"s{f}", seq)]))
    return paths, files


@pytest.mark.parametrize("merge", ["0", "1"])
def test_map_batch_matches_oracle_on_gpu(gpu, tmp_path, monkeypatch, merge):
    """The mapper compiled for the GPU, in both _expand_lanes forms, equals
    the scalar oracle of the reference's map_kmers."""
    import jax.numpy as jnp

    import bronko_tpu.ops.map as m
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    monkeypatch.setenv("BRONKO_EXPAND_MERGE", merge)
    m._expand_merge_enabled.cache_clear()
    lcb = _oracle("lcb_oracle")
    orc = _oracle("map_oracle")
    rng = np.random.default_rng(5)
    k = 21
    paths, files = _panel(tmp_path, rng)
    kc = {}
    for _ in range(300):
        _, seqs = files[rng.integers(len(files))]
        seq = seqs[0][1]
        i = int(rng.integers(0, len(seq) - k + 1))
        km = lcb.kmer_to_u64(seq[i:i + k])
        if rng.random() < 0.3:
            km ^= 1 << (2 * int(rng.integers(k)))
        if rng.random() < 0.5:
            km = lcb.reverse_complement_u64(km, k)
        kc[km] = int(rng.integers(3, 90))
    o_maps, o_tallies = orc.map_kmers_oracle(
        list(kc.items()), orc.build_oracle_index(k, files))

    dev = build_device_index(build_index(k, paths))
    try:
        pileup, tallies, ov = m.map_batch_jit(
            jnp.asarray(np.fromiter(kc, np.uint64)),
            jnp.asarray(np.fromiter(kc.values(), np.int32)),
            dev.keys, dev.offsets, dev.postings,
            jnp.zeros((4, dev.total_len + 1, 4), jnp.int32),
            jnp.zeros((dev.num_genomes, 3), jnp.int32),
            dev.map_config(2, False))
    finally:
        m._expand_merge_enabled.cache_clear()
    assert int(ov) == 0
    pileup, tallies = np.asarray(pileup), np.asarray(tallies)
    for fid in range(len(files)):
        assert tallies[fid].tolist() == o_tallies.get(fid, [0, 0, 0])
    for sl in dev.seq_slices:
        om = o_maps[sl.file_id][files[sl.file_id][1][0][0]]
        rows = slice(sl.offset, sl.offset + sl.length)
        for plane, key in ((m.PLANE_DEPTH_FWD, "fwd"),
                           (m.PLANE_DEPTH_REV, "rev"),
                           (m.PLANE_CNT_FWD, "fwd_cnt"),
                           (m.PLANE_CNT_REV, "rev_cnt")):
            np.testing.assert_array_equal(pileup[plane, rows], om[key])


def test_device_build_matches_host_on_gpu(gpu, tmp_path):
    """The on-card index build (int32 half-word scatters) equals the host
    build, array for array."""
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.device_build import build_device_index_on_device
    from bronko_tpu.index.layout import build_device_index

    paths, _ = _panel(tmp_path, np.random.default_rng(8), n_files=5)
    host = build_device_index(build_index(21, paths))
    _, card = build_device_index_on_device(21, paths)
    U = np.asarray(host.keys).shape[0]
    np.testing.assert_array_equal(np.asarray(card.keys)[:U],
                                  np.asarray(host.keys))
    np.testing.assert_array_equal(np.asarray(card.offsets)[:U + 1],
                                  np.asarray(host.offsets))
    np.testing.assert_array_equal(np.asarray(card.postings),
                                  np.asarray(host.postings))
    np.testing.assert_array_equal(np.asarray(card.hist)[:U],
                                  np.asarray(host.hist))
    np.testing.assert_array_equal(np.asarray(card.postings_local32),
                                  np.asarray(host.postings_local32))


def test_device_counter_matches_oracle_on_gpu(gpu):
    """The device sort counter compiled for the GPU equals a Counter over
    the valid windows (KMC -b -ci -cs semantics)."""
    from bronko_tpu.io.fastq import _encode_reads
    from bronko_tpu.ops.count import KmerCounter

    lcb = _oracle("lcb_oracle")
    rng = np.random.default_rng(12)
    k = 21
    reads = [bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                              size=int(rng.integers(20, 120))))
             for _ in range(200)]
    reads += reads[:100]
    want = Counter()
    for r in reads:
        for i in range(len(r) - k + 1):
            w = r[i:i + k]
            if b"N" not in w:
                want[lcb.kmer_to_u64(w)] += 1
    counter = KmerCounter(k, min_count=2)
    codes, lengths = _encode_reads(reads)
    counter.add_chunk(codes, lengths, len(reads))
    kmers, counts = counter.finalize()
    assert dict(zip(kmers.tolist(), counts.tolist())) == {
        km: c for km, c in want.items() if c >= 2}
