"""Index data model.

Device-first re-design of the reference's BronkoIndex (build.rs:23-60): instead
of a hashmap of posting vectors, the index is a set of dense, sorted arrays
(CSR) that device-put directly:

  keys      (U,)   uint64  sorted unique bucket ids
  offsets   (U+1,) int64   CSR row pointers into the posting arrays
  post_loc  (P,)   uint32  k-mer location within its sequence
  post_meta (P,)   uint32  packed: idx(5b) | seq_id(10b) | file_id(16b) | canonical(1b)

Posting order within a bucket preserves the reference's append order
(files, then sequences, then windows, then wildcard idx).

seq_id is 10-bit (1024 sequences per file) — wider than the reference's u8
(build.rs:55) so draft assemblies with >256 contigs index cleanly; the
uint32 word had exactly the spare bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# post_meta bit layout
IDX_BITS = 5
SEQ_BITS = 10
FILE_BITS = 16
SEQ_SHIFT = IDX_BITS
FILE_SHIFT = IDX_BITS + SEQ_BITS
CANON_SHIFT = IDX_BITS + SEQ_BITS + FILE_BITS
IDX_MASK = (1 << IDX_BITS) - 1
SEQ_MASK = (1 << SEQ_BITS) - 1
FILE_MASK = (1 << FILE_BITS) - 1


def pack_meta(idx, seq_id, file_id, canonical):
    return (
        np.asarray(idx, np.uint32)
        | (np.asarray(seq_id, np.uint32) << SEQ_SHIFT)
        | (np.asarray(file_id, np.uint32) << FILE_SHIFT)
        | (np.asarray(canonical, np.uint32) << CANON_SHIFT)
    )


@dataclass
class SeqMeta:
    name: str
    length: int
    seq: bytes  # raw bytes as read from the FASTA (case/N preserved)


@dataclass
class FileMeta:
    name: str  # display name: basename minus final extension (build.rs:161-165)
    sequences: list[SeqMeta] = field(default_factory=list)

    @property
    def total_len(self) -> int:
        return sum(s.length for s in self.sequences)


@dataclass
class BronkoIndex:
    k: int
    keys: np.ndarray       # (U,) uint64
    offsets: np.ndarray    # (U+1,) int64
    post_loc: np.ndarray   # (P,) uint32
    post_meta: np.ndarray  # (P,) uint32
    files: list[FileMeta]

    @property
    def num_postings(self) -> int:
        return int(self.post_loc.shape[0])

    @property
    def num_buckets(self) -> int:
        return int(self.keys.shape[0])

    @property
    def max_postings_per_bucket(self) -> int:
        if self.num_buckets == 0:
            return 0
        return int(np.max(np.diff(self.offsets)))
