"""Vectorized variant caller: the per-position filter cascade.

Reimplements call_variants (call.rs:969-1150) as one fused (L, 4) tensor
pass in float64 on host — the arrays are genome-length (kb..Mb), so this is
microseconds of work, and f64 keeps threshold decisions bit-compatible with
the reference (f32 would not).

Filter cascade per (position, alt base):
  1. GATK-style strand odds ratio with +1 pseudocounts; reject > max
     (call.rs:1058-1084). When the strand-balance bypass applies
     (call.rs:1072), SOR is skipped and reported as -1.0.
  2. unique-k-mer support: need >= n_per_strand distinct k-mers on at least
     one strand (call.rs:1087-1091) — only evaluated when SOR was evaluated.
  3. allele frequency >= min_af and >= noise-floor * multiplier, with the
     multiplier tightening exponentially below ~1% AF (call.rs:1099-1109).
  4. major (af >= 0.5) always passes; minor additionally needs
     total depth >= min_depth and alt count >= min_variant_depth
     (call.rs:1113-1123).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bronko_tpu.ops.codec import NT_TO_BITS


@dataclass
class VCFRecord:
    seq: str
    pos: int        # 1-based
    ref_base: int   # 2-bit code
    alt_base: int
    fwd_ref: int
    rev_ref: int
    fwd_alt: int
    rev_alt: int
    depth: int
    af: float
    sor: float


@dataclass
class CallStats:
    num_major: int = 0
    num_minor: int = 0
    positions_covered: int = 0
    total_positions: int = 0
    total_coverage: int = 0

    @property
    def breadth(self) -> float:
        return self.positions_covered / self.total_positions if self.total_positions else float("nan")

    @property
    def depth(self) -> float:
        return self.total_coverage / self.positions_covered if self.positions_covered else float("nan")


def call_variants_for_seq(
    seq_name: str,
    ref_bytes: bytes,
    fwd_depth: np.ndarray, rev_depth: np.ndarray,   # (L,4) depth-estimate pileups
    fwd_cnt: np.ndarray, rev_cnt: np.ndarray,       # (L,4) distinct-k-mer pileups
    noise_max: np.ndarray,                          # (L,) baseline noise maxima
    *,
    k: int,
    min_af: float,
    filter_end_seq: bool,
    strand_filter: bool,
    no_strand_balance_filter: bool,
    strand_balance_ratio: float,
    strand_odds_max: float,
    n_per_strand: int,
    min_depth: int,
    min_variant_depth: int,
    variant_multiplier: float,
    stats: CallStats,
) -> list[VCFRecord]:
    L = fwd_depth.shape[0]
    ref_bits = NT_TO_BITS[np.frombuffer(ref_bytes, np.uint8)].astype(np.int64)

    fwd = fwd_depth.astype(np.int64)
    rev = rev_depth.astype(np.int64)
    row_total = fwd + rev
    total_depth = row_total.sum(axis=1)

    start, end = (k, L - k) if filter_end_seq else (0, L)
    in_range = np.zeros(L, bool)
    if end > start:
        in_range[start:end] = True

    stats.total_positions += L
    covered = in_range & (total_depth > 0)
    stats.positions_covered += int(covered.sum())
    stats.total_coverage += int(total_depth[covered].sum())

    pos_idx = np.arange(L)
    alt = np.arange(4)[None, :]
    is_ref = alt == ref_bits[:, None]
    candidate = covered[:, None] & ~is_ref & (row_total > 0)

    sor = np.full((L, 4), strand_odds_max + 1.0)
    keep = candidate.copy()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if strand_filter:
            a = fwd[pos_idx, ref_bits].astype(np.float64)[:, None] + 1.0
            b = rev[pos_idx, ref_bits].astype(np.float64)[:, None] + 1.0
            c = fwd.astype(np.float64) + 1.0
            d = rev.astype(np.float64) + 1.0
            ref_total = a + b + c + d
            min_strand = np.minimum(a + c, b + d)
            msp = min_strand / ref_total
            do_sor = (not no_strand_balance_filter) | (msp >= strand_balance_ratio)
            r = (a * d) / (b * c)
            rr = np.minimum(a, b) / np.maximum(a, b)
            ar = np.minimum(c, d) / np.maximum(c, d)
            sor_val = np.log(r + 1.0 / r) + np.log(rr) - np.log(ar)
            sor = np.where(do_sor, sor_val, -1.0)
            kmer_ok = (fwd_cnt >= n_per_strand) | (rev_cnt >= n_per_strand)
            keep &= np.where(do_sor, (sor_val <= strand_odds_max) & kmer_ok, True)

        alt_count = row_total
        af = np.where(total_depth[:, None] > 0, alt_count / np.maximum(total_depth[:, None], 1), 0.0)
        factor = variant_multiplier + 0.5 * np.power(0.03, 100.0 * af)
        noise_thresh = np.maximum(factor, variant_multiplier) * noise_max[:, None]
        keep &= (af >= min_af) & (af >= noise_thresh)

        is_major = af >= 0.5
        minor_ok = (total_depth[:, None] >= min_depth) & (alt_count >= min_variant_depth)
        keep &= is_major | minor_ok

    records: list[VCFRecord] = []
    li, ai = np.nonzero(keep)
    stats.num_major += int(is_major[li, ai].sum())
    stats.num_minor += int((~is_major[li, ai]).sum())
    for i, a_ in zip(li.tolist(), ai.tolist()):
        rb = int(ref_bits[i])
        records.append(VCFRecord(
            seq=seq_name,
            pos=i + 1,
            ref_base=rb,
            alt_base=a_,
            fwd_ref=int(fwd[i, rb]),
            rev_ref=int(rev[i, rb]),
            fwd_alt=int(fwd[i, a_]),
            rev_alt=int(rev[i, a_]),
            depth=int(total_depth[i]),
            af=float(af[i, a_]),
            sor=float(sor[i, a_]),
        ))
    return records
