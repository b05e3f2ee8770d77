"""Scalar Python oracle of the reference build+map pipeline.

Step-by-step transcription of build_indexes (build.rs:145-231) and
map_kmers (call.rs:1257-1434) semantics, used to validate the vectorized
device path bit-for-bit on small inputs.
"""

from collections import defaultdict

import numpy as np

from .lcb_oracle import (
    assign_buckets, canonical_kmer_u64, kmer_to_u64,
)


class OracleIndex:
    def __init__(self, k):
        self.k = k
        self.buckets = defaultdict(list)  # key -> [(file_id, seq_id, loc, idx, canonical)]
        self.files = []  # [(file_name, [(seq_name, seq_bytes)])]


def build_oracle_index(k, files):
    """files: list of (file_name, [(seq_name, seq_bytes)])."""
    idx = OracleIndex(k)
    idx.files = files
    for file_id, (fname, seqs) in enumerate(files):
        for seq_id, (sname, seq) in enumerate(seqs):
            if len(seq) < k:
                continue
            for i in range(len(seq) - k + 1):
                kmer = seq[i:i + k]
                kbin, canonical = canonical_kmer_u64(kmer_to_u64(kmer), k)
                for j, b in enumerate(assign_buckets(kbin, k)):
                    idx.buckets[b].append((file_id, seq_id, i, j, canonical))
    return idx


def map_kmers_oracle(kmer_counts, idx: OracleIndex, n_fixed=2, use_full_kmer=False):
    """kmer_counts: list of (kmer_u64, count). Returns (output_maps, tallies).

    output_maps[file_id][seq_name] = dict with 'fwd','rev','fwd_cnt','rev_cnt'
    (L,4) int64 arrays. tallies[file_id] = [perfect, variant, unique].
    """
    k = idx.k
    output_maps = {}
    for file_id, (fname, seqs) in enumerate(idx.files):
        per_seq = {}
        for sname, seq in seqs:
            L = len(seq)
            per_seq[sname] = {
                key: np.zeros((L, 4), np.int64)
                for key in ("fwd", "rev", "fwd_cnt", "rev_cnt")
            }
        output_maps[file_id] = per_seq

    tallies = defaultdict(lambda: [0, 0, 0])

    for kmer, n in kmer_counts:
        kbin, rc = canonical_kmer_u64(kmer, k)
        buckets = assign_buckets(kbin, k)
        if use_full_kmer:
            filtered = buckets
        elif n_fixed * 2 + 1 >= len(buckets):
            filtered = []
        else:
            filtered = buckets[n_fixed:len(buckets) - n_fixed - 1]

        nb = len(filtered)
        per_genome_hits = defaultdict(int)

        for bucket in filtered:
            for (file_id, seq_id, loc, j, canonical) in idx.buckets.get(bucket, []):
                per_genome_hits[file_id] += 1
                sname = idx.files[file_id][1][seq_id][0]
                maps = output_maps[file_id][sname]
                if canonical:
                    pos = k - j - 1
                    bit = ((kbin >> (2 * (k - pos - 1))) & 0b11) ^ 0b11
                    tgt = loc + j
                    strand = ("fwd", "fwd_cnt") if rc else ("rev", "rev_cnt")
                else:
                    bit = (kbin >> (2 * (k - j - 1))) & 0b11
                    tgt = loc + j
                    strand = ("rev", "rev_cnt") if rc else ("fwd", "fwd_cnt")
                depth_key, cnt_key = strand
                maps[cnt_key][tgt, bit] += 1
                if maps[depth_key][tgt, bit] < n:
                    maps[depth_key][tgt, bit] = n

        unique_flag = None
        multi = False
        for fid, hits in per_genome_hits.items():
            if hits == nb:
                if unique_flag is None:
                    unique_flag = fid
                else:
                    unique_flag = None
                    multi = True
                    break
        for fid, hits in per_genome_hits.items():
            if hits == nb:
                tallies[fid][0] += 1
            elif hits > 0:
                tallies[fid][1] += 1
        if unique_flag is not None and not multi:
            tallies[unique_flag][2] += 1

    return output_maps, dict(tallies)
