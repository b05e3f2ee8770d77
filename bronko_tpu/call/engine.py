"""Call orchestrator: count -> map -> select -> call -> write, per sample.

The device pipeline equivalent of call() (call.rs:151-402):
  * read k-mer counting runs on device (ops/count.py), replacing the KMC3
    subprocess;
  * mapping runs on device in fixed-size jitted batches (ops/map.py),
    replacing the rayon/DashMap scatter loop;
  * genome selection is an argmax over psum-able per-genome tallies
    (pick_best_genome, call.rs:422-450);
  * the noise scan + filter cascade run on host in f64 for bit-parity
    (call/noise.py, call/variants.py);
  * paired-end samples are counted per mate and mapped as one concatenated
    batch stream — the depth max / count add / tally sum semantics are
    identical to the reference's two map_kmers passes into shared pileups
    (call.rs:301-320).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from bronko_tpu.call.noise import baseline_noise
from bronko_tpu.call.outputs import (
    SampleSummary, write_alignments, write_overview, write_pileup, write_vcf,
)
from bronko_tpu.call.variants import CallStats, VCFRecord, call_variants_for_seq
from bronko_tpu.config import CallConfig
from bronko_tpu.index.layout import DeviceIndex
from bronko_tpu.index.model import BronkoIndex
from bronko_tpu.io.fastq import read_fastq_chunks
from bronko_tpu.ops.count import CountStats, KmerCounter
from bronko_tpu.ops.map import (
    PLANE_CNT_FWD, PLANE_CNT_REV, PLANE_DEPTH_FWD, PLANE_DEPTH_REV,
    map_fused_jit, pileup_all_jit, pileup_from_saved_jit,
    pileup_from_saved_words_jit, tally_all_jit, tally_save_jit,
    tally_save_words_jit,
)

log = logging.getLogger("bronko")

# HBM cap on saved pass-1 probe artifacts (the probe-reuse fast path and
# the streamed path both hold (nb, B) row indices + histogram words per
# batch until pass 2 consumes them)
PROBE_BYTES_CAP = 512 << 20


def _read_chunks(path: str, cfg: CallConfig):
    """Prefer the native C++ FASTQ reader; fall back to the Python parser
    (also used when reads exceed the native row width)."""
    try:
        from bronko_tpu.io.native import get_lib, native_read_fastq_chunks

        if get_lib() is not None:
            return native_read_fastq_chunks(path, cfg.chunk_reads, max_len=512), 512
    except Exception:  # noqa: BLE001
        pass
    return read_fastq_chunks(path, cfg.chunk_reads), None


def count_sample(path: str, cfg: CallConfig, k: int,
                 threads: int | None = None,
                 text=None) -> tuple[np.ndarray, np.ndarray, CountStats]:
    """Count one sample's read k-mers.

    Counter selection (cfg.counter): 'host' = C++ streaming hash counter —
    IO-optimal, ships only unique k-mers to the device; 'device' = the
    on-device sort-based counter (ops/count.py); 'auto' = host when the
    native lib is
    available. `threads` overrides cfg.threads (the batch prefetcher splits
    the budget across concurrently-counted samples). `text` is an already-
    inflated buffer from the engine's inflate-ahead worker (native path
    only; closed by the counter)."""
    if cfg.counter in ("auto", "host"):
        try:
            from bronko_tpu.io.native import get_lib, native_count_fastq

            if get_lib() is not None:
                from bronko_tpu.consts import KMER_COUNT_CAP

                kmers, counts, st = native_count_fastq(
                    path, k, cfg.min_kmers, KMER_COUNT_CAP,
                    threads=max(1, threads or cfg.threads), text=text)
                log.info("Counted %s with the host counter", path)
                return kmers, counts, CountStats(**st)
        except Exception as e:  # noqa: BLE001
            if cfg.counter == "host":
                raise
            log.warning("host counter unavailable (%s); using the device "
                        "counter", e)
    log.info("Counting %s with the device counter", path)
    return _count_sample_device(path, cfg, k, *_read_chunks(path, cfg))


def _count_sample_device(path, cfg, k, iterator, native_width):
    """Feed read chunks to the device counter with shape-stable padding.
    native_width is the C++ reader's fixed row width (None for the Python
    parser); overlong reads restart the file on the Python parser."""
    counter = KmerCounter(k, cfg.min_kmers)
    lpad = 0
    for codes, lengths, n_reads in iterator:
        max_len = int(lengths[:n_reads].max()) if n_reads else 0
        if native_width is not None and max_len > native_width:
            log.warning("reads longer than %d in %s; using Python parser",
                        native_width, path)
            return _count_sample_device(
                path, cfg, k, read_fastq_chunks(path, cfg.chunk_reads), None)
        # stabilize shapes across chunks to avoid jit recompiles
        lpad = max(lpad, -(-max(max_len, 1) // 32) * 32)
        padded = np.full((cfg.chunk_reads, lpad), 4, np.uint8)
        w = min(lpad, codes.shape[1])
        padded[: codes.shape[0], :w] = codes[:, :w]
        if lengths.shape[0] < cfg.chunk_reads:
            lengths = np.pad(lengths, (0, cfg.chunk_reads - lengths.shape[0]))
        counter.add_chunk(padded, lengths, n_reads)
    kmers, counts = counter.finalize()
    return kmers, counts, counter.stats


def _prepare_batches(kmers: np.ndarray, counts: np.ndarray, B: int,
                     upload: bool = True, multiple: int = 1):
    """Batch the k-mer stream with shape-stable padding; returns (kj, cj)
    shaped (nb, B_eff). Samples that fit one batch get a TIGHT width from
    the quarter-octave class ladder (a 155k-kmer sample padded to the
    fixed 262k batch would waste 41% of every probe/gather/sort lane);
    larger samples use a power-of-two count of full-size batches. Class
    widths are multiples of `multiple` (the mesh device count). With
    upload=False the host arrays are returned for the caller to place."""
    n = kmers.shape[0]
    if n <= B:
        nb = 1
        B = min(B, _lane_class(n, floor=1 << 14, multiple=multiple))
    else:
        nb = -(-n // B)
        nb = 1 << (nb - 1).bit_length()
    kb = np.zeros(nb * B, np.uint64)
    cb = np.zeros(nb * B, np.int32)
    kb[:n] = kmers
    cb[:n] = counts
    kb = kb.reshape(nb, B)
    cb = cb.reshape(nb, B)
    if not upload:
        return kb, cb
    return jnp.asarray(kb), jnp.asarray(cb)


def run_tally_pass(kj, cj, dev: DeviceIndex, mcfg) -> np.ndarray:
    """Pass 1: per-genome perfect/variant/unique tallies (genome selection).

    Uses the per-bucket genome histogram when available (one gather per
    bucket query); otherwise the flat-join with overflow retry."""
    from dataclasses import replace

    if dev.hist is not None:
        mode, hist = "hist", dev.hist
    elif dev.hist_words is not None:
        mode, hist = "words", dev.hist_words
    else:
        mode, hist = "flat", jnp.zeros(1, jnp.int64)
    while True:
        tallies = jnp.zeros((dev.num_genomes, 3), jnp.int32)
        tallies, overflow = tally_all_jit(
            kj, cj, dev.keys, dev.offsets, dev.postings, hist, tallies,
            mcfg, mode,
        )
        if mode != "flat" or not int(overflow):
            return np.asarray(tallies).astype(np.int64)
        log.info("tally lane budget exceeded (factor %d); retrying",
                 mcfg.lane_factor)
        mcfg = replace(mcfg, lane_factor=mcfg.lane_factor * 2)


class ShardedMapper:
    """Multi-device mapping executor over a ('data', 'genome') mesh.

    Shards the WHOLE per-sample device pipeline, not just pass 1:
      * pass 1 (tally): read batches shard over 'data', the index shards
        over 'genome' (whole files per shard — "hundreds of strains" past
        one chip's HBM); per-kmer hit counts psum over 'genome' before
        classification; ONE dispatch scans every batch (no per-batch host
        round-trips).
      * pass 2 (pileup): the selected genome's sub-index is tiny, so it is
        replicated and the batch axis shards over ALL D*G devices; partial
        pileups merge with pmax (depth planes) / psum (count planes) — the
        collective form of the reference's DashMap merge
        (call.rs:1420-1431). Bit-identical to the single-device pass.
    """

    def __init__(self, index: BronkoIndex, cfg: CallConfig,
                 dev: DeviceIndex | None = None):
        import jax as _jax

        from bronko_tpu.parallel.mesh import make_mesh
        from bronko_tpu.parallel.pipeline import split_index

        d_str, g_str = cfg.mesh.split("x")
        self.n_data, self.n_genome = int(d_str), int(g_str)
        n_need = self.n_data * self.n_genome
        if n_need > len(_jax.devices()):
            raise SystemExit(
                f"mesh {cfg.mesh} needs {n_need} devices, have {len(_jax.devices())}")
        self.n_devices = n_need
        self.mesh = make_mesh(self.n_data, self.n_genome)
        self.sharded = split_index(index, self.n_genome)
        self.mcfg = self.sharded.map_config(cfg.n_fixed, cfg.use_full_kmer)
        from jax.sharding import PartitionSpec as P

        from bronko_tpu.parallel.distributed import globalize

        self._P = P
        self._globalize = globalize
        # index shards placed with their SPMD layout up front — on a
        # multi-host run each process materializes only its own shards
        self.keys = globalize(self.sharded.keys, self.mesh, P("genome", None))
        self.offsets = globalize(self.sharded.offsets, self.mesh, P("genome", None))
        self.postings = globalize(self.sharded.postings, self.mesh, P("genome", None))
        # per-SHARD per-bucket genome histograms (split_index): one gather
        # per query vs the posting lane expansion, valid on ANY DxG mesh —
        # each shard's packed word carries only its own genomes' bytes, so
        # the psum over 'genome' reassembles the global word carry-free
        # ('flat' would scale with panel size per hit bucket)
        if self.sharded.hist is not None:
            self.tally_mode = "hist"
            self.hist = globalize(self.sharded.hist, self.mesh,
                                  P("genome", None))
        elif self.sharded.hist_words is not None:
            self.tally_mode = "words"
            self.hist = globalize(self.sharded.hist_words, self.mesh,
                                  P("genome", None, None))
        else:
            self.tally_mode = "flat"
            self.hist = globalize(jnp.zeros(1, jnp.int64), self.mesh, P(None))
        self._tally_steps: dict = {}   # keyed by batchwise bool
        self._batchwise = False        # layout of the last place_batches
        self._pileup_steps: dict = {}  # keyed by (budget, total_len, batchwise)
        # ROUTED intra-batch layout (single/few-batch samples): the key
        # table itself range-partitions over 'data' and queries travel to
        # their chunk via all_to_all, so the per-device probe sorts
        # (U + B*J)/D lanes instead of U + B*J/D — the B-split's fixed-U
        # term scales away. Built lazily on first non-batchwise sample.
        self._routed: tuple | None = None
        self._routed_post = None       # replicated postings for routed pass 2
        # routed pass-2 eligibility (mirrors run_pileup's guard): saving
        # probe artifacts only pays when the fid-grouped posting layout
        # lets pass 2 consume them
        self._fid_grouped = bool(dev.fid_grouped) if dev is not None else False
        self._routed_steps: dict = {}  # keyed by (C, save)
        # names of intra-batch layouts this mapper actually ran
        # ("batchwise" / "bsplit" / "routed") — evidence for
        # dryrun_multichip and chip_smoke.py --four-gpus
        self.layouts_used: set = set()
        self._routed_pileups: dict = {}  # keyed by (budget, total_len)
        self._saved_probe = None       # (start_all, h_all) from last tally
        self._lane_totals = None
        self._bounds_np = None         # (S, D) chunk-start keys (host copy)
        self._placed_np = None         # host copy of the last placed batches
        self._route_np = None          # host route_split outputs (cached)
        import threading
        self._route_lock = threading.Lock()
        self._budget_job = None        # (thread, box) for the exact budget

    def _route_split_np(self):
        """Host-side route_split outputs, cached — the index is static per
        run, so the chunking and its (S, D) bounds are computed once. Safe
        from the budget worker thread (ADVICE r4: route_budget_exact used
        to run on the dispatch critical path of every routed sample)."""
        with self._route_lock:
            if self._route_np is None:
                from bronko_tpu.parallel.pipeline import route_split

                self._route_np = route_split(self.sharded, self.n_data)
                self._bounds_np = np.asarray(self._route_np[3])
        return self._route_np

    def _routed_arrays(self):
        if self._routed is None and self.n_data > 1 and \
                self.tally_mode in ("hist", "words"):
            P = self._P
            keys_r, hist_r, starts_r, bounds = self._route_split_np()
            self._routed = (
                self._globalize(keys_r, self.mesh, P("data", "genome", None)),
                self._globalize(hist_r, self.mesh, P("data", "genome", None)),
                self._globalize(starts_r, self.mesh, P("data", "genome", None)),
                self._globalize(bounds, self.mesh, P("genome", None)),
            )
            # only bounds (kept separately in _bounds_np) is consulted
            # after the upload — drop the host copies of the routed
            # tables (another full padded index copy) rather than caching
            # them for the run's lifetime. The budget worker only calls
            # _route_split_np when _bounds_np is still None, so this
            # cannot force a recompute.
            with self._route_lock:
                self._route_np = None
        return self._routed

    def _tally_step(self, batchwise: bool):
        from bronko_tpu.parallel.pipeline import make_sharded_tally_scan

        step = self._tally_steps.get(batchwise)
        if step is None:
            step = self._tally_steps[batchwise] = make_sharded_tally_scan(
                self.mesh, self.mcfg, self.tally_mode,
                shard_batches=batchwise)
        return step

    def place_batches(self, kj: np.ndarray, cj: np.ndarray):
        """Shard the (nb, B) batch arrays over the 'data' axis.

        Multi-batch samples shard WHOLE batches (nb axis): the probe
        re-sorts the U index keys once per (device, batch), so splitting
        each batch's B lanes makes every device pay that fixed term for
        every batch, while whole-batch sharding keeps aggregate sort work
        at the single-device total (near-perfect scaling; bit-identical —
        tallies and scatters are order-independent). Single-batch samples
        fall back to the B-split layout. Pass 2 reshards device-side.

        B-split lanes are DEINTERLEAVED first: device d gets the strided
        slice kj[:, d::D], not a contiguous one. The unique-k-mer array is
        value-sorted and bucket values correlate with k-mer value, so a
        contiguous slice concentrates its routed queries on a few key
        chunks — 7.7x the equal share at D=16 on the benchmark sample,
        blowing the 1.35x routing budget (and the global query spread over
        chunks is only 1.13x, so strided slices restore it).
        Every consumer is an order-independent reduction (tally sums,
        pileup scatter-max/add), so the permutation is output-invariant;
        pass 2 reuses the SAME placed arrays, keeping saved probe
        artifacts lane-consistent."""
        self._batchwise = kj.shape[0] % self.n_data == 0 and kj.shape[0] >= self.n_data
        D = self.n_data
        if not self._batchwise and D > 1 and kj.shape[1] % D == 0:
            nb, B = kj.shape
            kj = kj.reshape(nb, B // D, D).transpose(0, 2, 1).reshape(nb, B)
            cj = cj.reshape(nb, B // D, D).transpose(0, 2, 1).reshape(nb, B)
        # host copy for the routed layout's EXACT per-(src,dst) budget
        # (route_budget_exact re-derives dest counts host-side)
        self._placed_np = ((kj, cj) if not self._batchwise and D > 1
                           else None)
        # overlap the exact-budget host scan (canonical + buckets +
        # searchsorted over every placed lane, scales with nb*B*J*S) with
        # the upload + routed-array build instead of blocking dispatch in
        # _run_tallies_routed
        self._budget_job = None
        if (self._placed_np is not None
                and self.tally_mode in ("hist", "words")
                and self._routed_wins(kj)):
            import threading

            from bronko_tpu.parallel.pipeline import route_budget_exact

            box: dict = {}
            kj_np, cj_np = self._placed_np

            def _work():
                try:
                    if self._bounds_np is None:
                        self._route_split_np()
                    box["C"] = route_budget_exact(
                        kj_np, cj_np, self.mcfg, self._bounds_np,
                        self.n_data)
                except Exception as e:     # pragma: no cover - diagnostic
                    box["err"] = e

            t = threading.Thread(target=_work, daemon=True,
                                 name="route-budget")
            t.start()
            self._budget_job = (t, box)
        spec = (self._P("data", None) if self._batchwise
                else self._P(None, "data"))
        return (self._globalize(kj, self.mesh, spec),
                self._globalize(cj, self.mesh, spec))

    def run_tallies(self, kj, cj) -> np.ndarray:
        from dataclasses import replace

        self._saved_probe = None
        self._lane_totals = None
        # _routed_wins FIRST: _routed_arrays builds + uploads three
        # index-sized tables (route_split), which must not happen for
        # layouts where the B-split always wins
        if (not self._batchwise and self.n_data > 1
                and self.tally_mode in ("hist", "words")
                and self._routed_wins(kj)
                and self._routed_arrays() is not None):
            self.layouts_used.add("routed")
            return self._run_tallies_routed(kj, cj)
        self.layouts_used.add("batchwise" if self._batchwise else "bsplit")
        while True:
            tl, ov = self._tally_step(self._batchwise)(
                kj, cj, self.keys, self.offsets, self.postings, self.hist)
            if not int(np.asarray(ov)[0]):
                return np.asarray(tl).astype(np.int64)
            log.info("sharded tally lane budget exceeded (factor %d); retrying",
                     self.mcfg.lane_factor)
            self.mcfg = replace(self.mcfg, lane_factor=self.mcfg.lane_factor * 2)
            self._tally_steps.clear()

    def _routed_wins(self, kj) -> bool:
        """Intra-batch layout crossover: the B-split's per-device U-key
        re-sort costs U*(D-1)/D extra lanes, while routed's machinery
        (grouping sort, place copies, return unsort) rides 1/D terms. So
        B-split wins only when the replicated-U term is small next to the
        per-device query load (tiny panels): routed once
        (D-1)*U > 0.15*N2.

        The 0.15 constant was fitted to two proxy points of an earlier
        accelerator and has not been measured on a GPU mesh (ROADMAP 1.7).
        Perf-only risk — both layouts are bit-identical."""
        U = int(self.sharded.keys.shape[1])
        N2 = int(kj.shape[1]) * len(self.mcfg.positions)
        return (self.n_data - 1) * U * 20 > 3 * N2

    def _run_tallies_routed(self, kj, cj) -> np.ndarray:
        from bronko_tpu.parallel.pipeline import make_routed_tally_scan

        keys_r, hist_r, starts_r, bounds = self._routed
        D = self.n_data
        B = kj.shape[1]
        J = len(self.mcfg.positions)
        from bronko_tpu.parallel.pipeline import (route_budget,
                                                  route_budget_exact)

        N2l = (B // D) * J
        # per-(src, dst) routing budget: EXACT host-measured max dest
        # count, quantized into shared-executable classes (guessed slack
        # cost ~10% of the routed row at D=16); the overflow retry stays
        # as a host/device-divergence guard only. Usually precomputed on
        # the place_batches worker thread so the host scan overlaps the
        # batch upload instead of blocking this dispatch.
        C = None
        if self._budget_job is not None:
            t, box = self._budget_job
            self._budget_job = None
            t.join()
            C = box.get("C")
            if "err" in box:
                log.warning("route-budget worker failed (%s); recomputing",
                            box["err"])
        if C is None:
            if self._placed_np is not None and self._bounds_np is not None:
                C = route_budget_exact(self._placed_np[0],
                                       self._placed_np[1],
                                       self.mcfg, self._bounds_np, D)
            else:
                C = route_budget(N2l, D)
        # probe artifacts are saved when a Dx1 mesh can feed them straight
        # to the routed pass 2 (needs the fid-grouped posting layout that
        # the histogram-prefix range derivation relies on; single-word
        # histograms only — the multi-word lens/prefix split is pass-2
        # machinery the routed pileup doesn't replicate)
        save = (self.n_genome == 1 and self.tally_mode == "hist"
                and self._fid_grouped)
        while True:
            step = self._routed_steps.get((C, save))
            if step is None:
                step = self._routed_steps[(C, save)] = make_routed_tally_scan(
                    self.mesh, self.mcfg, self.tally_mode, C, save=save)
            out = step(kj, cj, keys_r, hist_r, starts_r, bounds)
            tl, lt, ov = out[:3]
            if not int(np.asarray(ov)[0]):
                if save:
                    self._saved_probe = (out[3], out[4])
                    self._lane_totals = np.asarray(lt)
                return np.asarray(tl).astype(np.int64)
            log.info("routed tally budget exceeded (C=%d); retrying", C)
            C = min(N2l, C * 2)

    def run_pileup(self, kj, cj, dev: DeviceIndex, best: int, mcfg,
                   n_kmers: int | None = None):
        from dataclasses import replace

        from bronko_tpu.parallel.pipeline import make_sharded_pileup_scan

        if self._saved_probe is not None and dev.fid_grouped:
            return self._run_pileup_routed(kj, cj, dev, best, mcfg, n_kmers)
        dev.ensure_subindex()
        # whole-batch sharding over the flattened mesh when nb divides
        # (same fixed-sort-cost argument as place_batches; the run-owner
        # derivation sorts per batch too)
        batchwise = (kj.shape[0] % self.n_devices == 0
                     and kj.shape[0] >= self.n_devices)
        # lane budget is PER BATCH: B-split devices probe 1/(D*G) of each
        # batch (split the global budget); batchwise devices probe whole
        # batches (keep the single-device budget)
        budget = _pass2_budget(kj, mcfg, n_kmers)
        if not batchwise:
            budget = max(1024, budget // self.n_devices)
        # selected genome's sub-index, replicated on every mesh device
        P = self._P
        keys_g = self._globalize(dev.g_keys[best], self.mesh, P(None))
        offsets_g = self._globalize(dev.g_offsets[best], self.mesh, P(None))
        postings_g = self._globalize(dev.g_postings[best], self.mesh, P(None))
        while True:
            gcfg = replace(
                mcfg,
                total_len=dev.g_total_len,
                max_bucket=dev.g_max_bucket,
                lane_budget=budget,
            )
            key = (budget, gcfg.total_len, batchwise)
            step = self._pileup_steps.get(key)
            if step is None:
                step = self._pileup_steps[key] = make_sharded_pileup_scan(
                    self.mesh, gcfg, shard_batches=batchwise)
            pileup, ov = step(kj, cj, keys_g, offsets_g, postings_g)
            if not int(np.asarray(ov)[0]):
                return pileup
            log.info("sharded pileup lane budget exceeded (%d); retrying", budget)
            budget *= 2

    def _run_pileup_routed(self, kj, cj, dev: DeviceIndex, best: int, mcfg,
                           n_kmers: int | None):
        """Pass 2 from the routed pass 1's saved artifacts (Dx1): no
        re-probe — each device expands its own B/D slice; per-device lane
        budget comes from the tally's exact per-batch posting load for the
        selected genome, split over 'data' with slack for shard skew."""
        from dataclasses import replace

        from bronko_tpu.parallel.pipeline import make_routed_pileup_scan

        start_all, h_all = self._saved_probe
        exact = (int(self._lane_totals[best])
                 if self._lane_totals is not None else None)
        budget = _pass2_budget(kj, mcfg, n_kmers, exact)
        budget = max(1024, _lane_class(budget * 3 // (2 * self.n_data),
                                       floor=1024))
        P = self._P
        if self._routed_post is None:
            # placed ONCE: globalize is a plain device_put of the full
            # posting array
            self._routed_post = self._globalize(
                self.sharded.postings[0], self.mesh, P(None))
        postings = self._routed_post
        best_j = self._globalize(np.asarray([best], np.int32), self.mesh,
                                 P(None))
        fbase = self._globalize(
            np.asarray([int(dev.file_bases[best])], np.int32), self.mesh,
            P(None))
        while True:
            gcfg = replace(
                mcfg,
                total_len=dev.g_total_len,
                max_bucket=dev.g_max_bucket,
                lane_budget=budget,
            )
            key = (budget, gcfg.total_len)
            step = self._routed_pileups.get(key)
            if step is None:
                step = self._routed_pileups[key] = make_routed_pileup_scan(
                    self.mesh, gcfg)
            pileup, ov = step(kj, cj, start_all, h_all, postings,
                              best_j, fbase)
            if not int(np.asarray(ov)[0]):
                return pileup
            log.info("routed pileup lane budget exceeded (%d); retrying",
                     budget)
            budget *= 2


def _lane_class(n: int, floor: int = 1 << 16, multiple: int = 1) -> int:
    """Smallest size of the form {1, 1.25, 1.5, 1.75}*2^m covering n (and
    divisible by `multiple`). Four jit variants per octave bound recompiles
    while capping overshoot at 25% (a plain pow2 ceiling wastes up to 2x
    work; a half-octave ladder {1, 1.5} would pad the 155k-kmer benchmark
    sample 27% — to 196,608 — and every probe/sort/scatter lane in both
    passes pays the pad)."""
    n = max(int(n), floor, multiple)
    p = 1 << (n - 1).bit_length()
    h = p >> 1
    for cand in (h + (h >> 2), h + (h >> 1), h + (h >> 1) + (h >> 2),
                 p, p + (p >> 2), p + (p >> 1), p + (p >> 1) + (p >> 2),
                 p << 1):
        if cand >= n and cand % multiple == 0:
            return cand
    return -(-n // multiple) * multiple


def _pass2_budget(kj, mcfg, n_kmers, exact_lanes=None):
    """Pass-2 lane budget: exact when the tally pass reported the selected
    genome's true per-batch posting load, else 1.5x the k-mer count guess."""
    if exact_lanes is not None:
        return _lane_class(exact_lanes)
    B = kj.shape[1]
    J = len(mcfg.positions)
    n_real = n_kmers if n_kmers is not None else kj.shape[0] * B
    want = max(n_real * J * 3 // 2, 1 << 20)
    budget = _lane_class(want)
    return min(budget, B * J * max(2, mcfg.lane_factor))


def _dispatch_pileup_saved(kj, cj, start_all, h_all, dev: DeviceIndex,
                           best_j, fbase, gcfg, pileup):
    """One saved-probe pass-2 dispatch: picks the narrow int32 postings
    (genome-local coords) when the panel fits them, and the multi-word
    executable when the saved histogram is 4-D (nb, B, J, W — large
    panels). Shared by the PendingMap and PendingStream paths so their
    posting/executable selection cannot drift."""
    post = (dev.postings_local32 if dev.postings_local32 is not None
            else dev.postings)
    pileup_fn = (pileup_from_saved_words_jit if h_all.ndim == 4
                 else pileup_from_saved_jit)
    return pileup_fn(kj, cj, start_all, h_all, post, pileup,
                     best_j, fbase, gcfg)


def run_pileup_saved(kj, cj, saved, dev: DeviceIndex, best: int, mcfg,
                     n_kmers: int | None = None, exact_lanes: int | None = None):
    """Pass 2 via the probe-reuse path (no search): genome-local posting
    ranges derive from pass 1's saved probe (CSR row starts) + the bucket
    histograms. exact_lanes (from tally_save_jit's lane_totals) sizes the
    expansion to the true posting load."""
    from dataclasses import replace

    start_all, h_all = saved
    gcfg = replace(
        mcfg,
        total_len=dev.g_total_len,
        max_bucket=dev.g_max_bucket,
        lane_budget=_pass2_budget(kj, mcfg, n_kmers, exact_lanes),
    )
    best_j = jnp.int32(best)
    fbase = jnp.int32(int(dev.file_bases[best]))
    while True:
        pileup = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
        pileup, overflow = _dispatch_pileup_saved(
            kj, cj, start_all, h_all, dev, best_j, fbase, gcfg, pileup)
        if not int(overflow):
            return pileup
        log.info("pileup lane budget exceeded (%d); retrying", gcfg.lane_budget)
        gcfg = replace(gcfg, lane_budget=gcfg.lane_budget * 2)


def run_pileup_pass(kj, cj, dev: DeviceIndex, best: int, mcfg, n_kmers: int | None = None):
    """Pass 2: scatter the SELECTED genome's pileup only — pileup memory and
    scatter lanes scale with one genome, not the whole panel."""
    from dataclasses import replace

    dev.ensure_subindex()

    # a single genome's sub-index has ~1 posting per hit bucket, so the
    # expected lane load is ~1 per real query; budget from the true k-mer
    # count (power-of-two bucketed for jit reuse), widened exactly on
    # overflow if a repeat-heavy genome needs it
    gcfg = replace(
        mcfg,
        total_len=dev.g_total_len,
        max_bucket=dev.g_max_bucket,
        lane_budget=_pass2_budget(kj, mcfg, n_kmers),
    )
    keys_g = dev.g_keys[best]
    offsets_g = dev.g_offsets[best]
    postings_g = dev.g_postings[best]
    while True:
        pileup = jnp.zeros((4, gcfg.total_len + 1, 4), jnp.int32)
        pileup, overflow = pileup_all_jit(
            kj, cj, keys_g, offsets_g, postings_g, pileup, gcfg)
        if not int(overflow):
            return pileup
        log.info("pileup lane budget exceeded (%d); retrying", gcfg.lane_budget)
        gcfg = replace(gcfg, lane_budget=gcfg.lane_budget * 2)


def pick_best_genome(tallies: np.ndarray, dev: DeviceIndex) -> int | None:
    """argmax of perfect/(2*genome_len), strictly-positive only
    (call.rs:422-450)."""
    best, best_score = None, 0.0
    for fid in range(dev.num_genomes):
        glen = int(dev.genome_lens[fid])
        if glen == 0:
            continue
        score = float(tallies[fid, 0]) / glen / 2.0
        log.debug("genome %d: perfect=%d variant=%d unique=%d score=%.4f",
                  fid, tallies[fid, 0], tallies[fid, 1], tallies[fid, 2], score)
        if score > best_score:
            best_score = score
            best = fid
    return best


def call_sample_variants(
    index: BronkoIndex,
    dev: DeviceIndex,
    cfg: CallConfig,
    best: int,
    pileup: np.ndarray,
) -> tuple[list[VCFRecord], CallStats, dict[str, tuple]]:
    stats = CallStats()
    records: list[VCFRecord] = []
    seq_pileups: dict[str, tuple] = {}
    file_meta = index.files[best]
    slices = dev.slices_for_file(best)
    file_base = min(s.offset for s in slices) if slices else 0
    # ONE device->host transfer of the genome-local pileup (a per-slice
    # transfer would pay a sync per contig; bytes are the same either way)
    pileup_h = np.asarray(pileup)
    for sl in slices:
        seq_meta = file_meta.sequences[sl.seq_id]
        block = pileup_h[:, sl.offset - file_base:sl.offset - file_base + sl.length]
        fwd_depth = block[PLANE_DEPTH_FWD]
        rev_depth = block[PLANE_DEPTH_REV]
        fwd_cnt = block[PLANE_CNT_FWD]
        rev_cnt = block[PLANE_CNT_REV]
        seq_pileups[sl.name] = (fwd_depth, rev_depth)
        noise = baseline_noise(fwd_depth, rev_depth)
        records.extend(call_variants_for_seq(
            sl.name, seq_meta.seq,
            fwd_depth, rev_depth, fwd_cnt, rev_cnt, noise[:, 0],
            k=cfg.kmer,
            min_af=cfg.min_af,
            filter_end_seq=not cfg.no_end_filter,
            strand_filter=not cfg.no_strand_filter,
            no_strand_balance_filter=cfg.no_strand_balance_filter,
            strand_balance_ratio=cfg.strand_balance_ratio,
            strand_odds_max=cfg.strand_odds_max,
            n_per_strand=cfg.n_per_strand,
            min_depth=cfg.min_depth,
            min_variant_depth=cfg.min_variant_depth,
            variant_multiplier=cfg.variant_multiplier,
            stats=stats,
        ))
    log.info("Sample breadth of coverage: %s, depth of coverage: %s",
             stats.breadth, stats.depth)
    log.info("Called %d major variants, %d minor above maf = %s",
             stats.num_major, stats.num_minor, cfg.min_af)
    return records, stats, seq_pileups


def _map_one(
    kmers: np.ndarray,
    counts: np.ndarray,
    cstats: CountStats,
    index: BronkoIndex,
    dev: DeviceIndex,
    cfg: CallConfig,
    sharded: "ShardedMapper | None" = None,
    batches=None,
):
    """Device phase of one sample. On the probe-reuse fast path this ONLY
    dispatches pass 1 and returns a PendingMap of device handles — the
    tallies sync, genome selection, and pass-2 dispatch happen on the
    _finish_one worker thread, so the main loop never blocks on the device.
    Other paths return (best, pileup, triple) with the pileup still on
    device — the host phase then runs on the worker while the NEXT
    sample's device work dispatches (the reference overlaps nothing here;
    its call_variants is 1% of runtime on a thread that has nothing else
    to do, call.rs:969). `batches` carries (kj, cj) already device_put by
    the prefetch worker (upload overlapped with the previous sample's
    device phase)."""
    t0 = time.time()
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    if len(mcfg.positions) == 0 or kmers.shape[0] == 0:
        kj = cj = None
        tallies = np.zeros((dev.num_genomes, 3), np.int64)
    else:
        if batches is not None and sharded is None:
            kj, cj = batches
        else:
            kj, cj = _prepare_batches(
                kmers, counts, cfg.batch_size, upload=sharded is None,
                multiple=sharded.n_devices if sharded is not None else 1)
        if sharded is not None:
            kj, cj = sharded.place_batches(kj, cj)
        J = len(mcfg.positions)
        has_hist = dev.hist is not None or dev.hist_words is not None
        W = dev.hist_words.shape[1] if dev.hist_words is not None else 0
        # saved probe = int32 row index + histogram payload per query; the
        # single-word histogram is int32 for G<=4 panels (8 bytes/query,
        # not 12 — a hardcoded 12 pushed small panels off the fast path
        # at 2/3 of the real cap). Same formula as _stream_pass1.
        per_q = (4 + dev.hist.dtype.itemsize if dev.hist is not None
                 else 4 + 8 * W)
        probe_bytes = kj.shape[0] * kj.shape[1] * J * per_q
        if (sharded is None and has_hist and dev.fid_grouped
                and probe_bytes < PROBE_BYTES_CAP):
            # probe-reuse fast path: pass 1 saves its probe so pass 2 needs
            # no search of its own (single-word for G<=8, multi-word beyond).
            # ONLY the dispatch happens here — the tallies sync, genome
            # selection, and the pass-2 dispatch run on the _finish_one
            # worker thread, so the main loop never blocks on the device
            # and the dispatch pipeline stays full across samples.
            tj = jnp.zeros((dev.num_genomes, 3), jnp.int32)
            if dev.hist is not None and dev.fused_ratio > 0:
                # FUSED single dispatch: pass 1 + device genome selection
                # + pass 2 with a static budget from the rolling
                # lanes-per-kmer ratio (x1.25 slack); overflow or a
                # device/host selection mismatch falls back to the
                # exact-budget pass 2 from the returned artifacts
                from dataclasses import replace as _replace

                budget = _pass2_budget(
                    kj, mcfg, None,
                    int(kmers.shape[0] * dev.fused_ratio * 5 / 4) + 1024)
                gcfg = _replace(mcfg, total_len=dev.g_total_len,
                                max_bucket=dev.g_max_bucket,
                                lane_budget=budget)
                if dev._glen2_dev is None:
                    dev._glen2_dev = jnp.asarray(
                        2 * dev.genome_lens.astype(np.int64))
                    dev._fbases_dev = jnp.asarray(
                        dev.file_bases.astype(np.int32))
                post = (dev.postings_local32
                        if dev.postings_local32 is not None
                        else dev.postings)
                (_tj, _lt, _bd, start_all, h_all, pileup,
                 _ov, meta, p16) = map_fused_jit(
                    kj, cj, dev.keys, dev.offsets, dev.hist, post, tj,
                    dev._glen2_dev, dev._fbases_dev, mcfg, gcfg)
                return PendingFused(
                    kj=kj, cj=cj, meta=meta, p16=p16,
                    saved=(start_all, h_all), pileup=pileup, mcfg=mcfg,
                    n_kmers=kmers.shape[0], cstats=cstats, t_start=t0)
            if dev.hist is not None:
                tj, lane_tot, start_all, h_all = tally_save_jit(
                    kj, cj, dev.keys, dev.offsets, dev.hist, tj, mcfg)
            else:
                tj, lane_tot, start_all, h_all = tally_save_words_jit(
                    kj, cj, dev.keys, dev.offsets, dev.hist_words, tj, mcfg)
            return PendingMap(
                kj=kj, cj=cj, meta=_pack_meta_jit(tj, lane_tot),
                saved=(start_all, h_all), mcfg=mcfg,
                n_kmers=kmers.shape[0], cstats=cstats, t_start=t0)
        elif sharded is not None:
            tallies = sharded.run_tallies(kj, cj)
        else:
            tallies = run_tally_pass(kj, cj, dev, mcfg)
    log.info("Tallied %d kmers in %.2fs", kmers.shape[0], time.time() - t0)

    best, triple = _select_and_log(tallies, index, dev, cstats)

    t1 = time.time()
    if kj is not None and sharded is None:
        dev.ensure_subindex()  # fallback path needs the per-genome arrays
    if kj is not None and sharded is not None:
        # pass 2 sharded over the whole mesh (replicated sub-index,
        # batch-parallel scatter, pmax/psum merge)
        pileup = sharded.run_pileup(kj, cj, dev, best, mcfg,
                                    n_kmers=kmers.shape[0])
    elif kj is not None and dev.g_keys is not None:
        pileup = run_pileup_pass(kj, cj, dev, best, mcfg, n_kmers=kmers.shape[0])
    else:
        pileup = jnp.zeros((4, dev.g_total_len + 1, 4), jnp.int32)
    log.info("Scattered pileup in %.2fs", time.time() - t1)
    return best, pileup, triple


@jax.jit
def _pack_meta_jit(tj, lane_tot):
    """Pack the pass-1 scalars (tallies (G,3) + exact lane totals (G,))
    into ONE int64 vector: the resolve worker then pays a single
    device-to-host sync instead of two. The extra dispatch is tiny and
    asynchronous — it pipelines behind pass 1 itself."""
    return jnp.concatenate([tj.astype(jnp.int64).reshape(-1),
                            lane_tot.astype(jnp.int64)])


@dataclass
class PendingMap:
    """Fast-path device handles: pass 1 dispatched, everything else deferred
    to the worker thread (resolve())."""
    kj: object
    cj: object
    meta: object        # (4G,) int64 packed tallies + exact lane totals
    saved: tuple        # (start_all, h_all) probe artifacts on device
    mcfg: object
    n_kmers: int
    cstats: CountStats
    t_start: float

    def resolve(self, index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig):
        """Sync pass 1 (ONE packed device array), select the genome,
        dispatch pass 2 (exact budget). Runs on the _finish_one worker
        while the main loop dispatches the NEXT sample's pass 1."""
        meta = np.asarray(self.meta)
        G = dev.num_genomes
        tallies = meta[:G * 3].reshape(G, 3)
        lane_totals = meta[G * 3:G * 4]
        log.info("Tallied %d kmers in %.2fs", self.n_kmers,
                 time.time() - self.t_start)
        best, triple = _select_and_log(tallies, index, dev, self.cstats)
        _note_fused_ratio(dev, lane_totals[best], self.n_kmers)
        t1 = time.time()
        pileup = run_pileup_saved(
            self.kj, self.cj, self.saved, dev, best, self.mcfg,
            n_kmers=self.n_kmers, exact_lanes=int(lane_totals[best]))
        log.info("Scattered pileup in %.2fs", time.time() - t1)
        return best, pileup, triple


def _note_fused_ratio(dev: DeviceIndex, lanes, n_kmers: int) -> None:
    """Refresh the rolling pass-2 lanes-per-kmer ratio that sizes the
    FUSED dispatch's static budget on later samples (only grows — a
    shrinking ratio would re-risk the fallback on the next big sample)."""
    if n_kmers > 0 and dev.hist is not None:
        dev.fused_ratio = max(dev.fused_ratio, float(int(lanes)) / n_kmers)


@dataclass
class PendingFused:
    """Fused-dispatch device handles: BOTH passes + device genome
    selection already dispatched (map_fused_jit); resolve() only syncs
    and validates. Falls back to the exact-budget pass 2 from the
    returned probe artifacts when the static budget overflowed or the
    device selection disagrees with the host pick (it cannot — the score
    math is bit-identical — but selection parity is an invariant worth a
    cheap guard, docs/parity_checklist.md).

    The resolve worker syncs exactly TWO device arrays: `meta` (packed
    tallies + lane_totals + best + overflow, one int64 vector instead of
    four separate syncs) and `p16` (uint16 pileup
    export, half the D2H bytes; the embedded max guard refetches the
    int32 `pileup` when a value exceeds uint16)."""
    kj: object
    cj: object
    meta: object         # (4G+2,) int64 packed scalars (see map_fused_jit)
    p16: object          # (4, Tg+2, 4) uint16 pileup export
    saved: tuple         # (start_all, h_all) probe artifacts on device
    pileup: object       # (4, Tg+1, 4) int32 device pileup for best_dev
    mcfg: object
    n_kmers: int
    cstats: CountStats
    t_start: float

    def resolve(self, index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig):
        from bronko_tpu.ops.map import pileup_from_u16

        meta = np.asarray(self.meta)
        G = dev.num_genomes
        tallies = meta[:G * 3].reshape(G, 3)
        lane_totals = meta[G * 3:G * 4]
        best_dev = int(meta[G * 4])
        overflow = int(meta[G * 4 + 1])
        log.info("Tallied %d kmers in %.2fs (fused)", self.n_kmers,
                 time.time() - self.t_start)
        best, triple = _select_and_log(tallies, index, dev, self.cstats)
        _note_fused_ratio(dev, lane_totals[best], self.n_kmers)
        if overflow or best_dev != best:
            log.info("fused pass-2 budget overflowed or selection guard "
                     "tripped; re-running pass 2 with the exact budget")
            t1 = time.time()
            pileup = run_pileup_saved(
                self.kj, self.cj, self.saved, dev, best, self.mcfg,
                n_kmers=self.n_kmers, exact_lanes=int(lane_totals[best]))
            log.info("Scattered pileup in %.2fs", time.time() - t1)
            return best, pileup, triple
        pl = pileup_from_u16(np.asarray(self.p16))
        if pl is None:
            log.info("pileup exceeds uint16 (extreme coverage); refetching "
                     "the int32 tensor")
            pl = np.asarray(self.pileup)
        return best, pl, triple


def _select_and_log(tallies: np.ndarray, index: BronkoIndex, dev: DeviceIndex,
                    cstats: CountStats) -> tuple[int, tuple[int, int, int]]:
    """Genome selection + the reference's mapping-stat log lines
    (call.rs:238-248)."""
    best = pick_best_genome(tallies, dev)
    if best is None:
        log.error("Unable to pick a best genome")
        # a data problem of THIS sample: isolated by run_call; a run where
        # every sample fails still exits 1 (reference: call.rs:230-233)
        raise RuntimeError("Unable to pick a best genome")
    n_perfect, n_variant, n_unique = (int(x) for x in tallies[best])
    best_name = index.files[best].name
    log.info("Selected a representative genome: %s", best_name)
    n_unmapped = cstats.unique_counted_kmers - n_perfect - n_variant
    log.info(
        "Mapped %d/%d kmers perfectly (%d unique among refs), %d/%d had a variant, %d unmapped",
        n_perfect, cstats.unique_counted_kmers, n_unique,
        n_variant, cstats.unique_counted_kmers, n_unmapped,
    )
    if cstats.unique_counted_kmers and (n_variant + n_perfect) / cstats.unique_counted_kmers < 0.2:
        log.warning(
            "Percent of kmers found is very low for this reference, suggesting lack of a "
            "representative reference, a bad sequencing run, contamination in sample, or some other issue"
        )
    return best, (n_perfect, n_variant, n_unmapped)


def _fetch_pileup_host(pileup) -> np.ndarray:
    """D2H-optimized pileup fetch for device tensors: dispatch the uint16
    export (async — it pipelines behind whatever produced the pileup) and
    pull half the bytes; the embedded max
    guard refetches the int32 tensor when a value exceeds uint16
    (possible at extreme coverage, KMER_COUNT_CAP=1e6). Covers every
    resolve path that still returns a device pileup (PendingMap,
    PendingStream, fused fallback, sharded mesh); PendingFused fetches
    its own u16 export that rides the fused dispatch itself."""
    from bronko_tpu.ops.map import pileup_export_u16_jit, pileup_from_u16

    pl = pileup_from_u16(np.asarray(pileup_export_u16_jit(pileup)))
    if pl is None:
        log.info("pileup exceeds uint16 (extreme coverage); refetching "
                 "the int32 tensor")
        return np.asarray(pileup)
    return pl


def _finish_one(
    display_path: str,
    index: BronkoIndex,
    dev: DeviceIndex,
    cfg: CallConfig,
    result,
) -> tuple[SampleSummary, tuple[str, list[VCFRecord]]]:
    """Host phase of one sample: resolve the deferred device work (fast
    path), then noise scan + filter cascade (f64) + output writes. Runs on
    a worker thread overlapped with the next sample's device phase."""
    if isinstance(result, (PendingMap, PendingFused, PendingStream)):
        best, pileup, tally_triple = result.resolve(index, dev, cfg)
    else:
        best, pileup, tally_triple = result
    n_perfect, n_variant, n_unmapped = tally_triple
    if not isinstance(pileup, np.ndarray):
        pileup = _fetch_pileup_host(pileup)
    records, stats, seq_pileups = call_sample_variants(index, dev, cfg, best, pileup)

    from bronko_tpu.parallel.distributed import is_primary

    # multi-host SPMD: every process computes the same sample, rank 0
    # writes. Sample-sharded cohorts: each process OWNS its samples and
    # writes their files itself (shared output filesystem).
    if is_primary() or cfg.shard_samples:
        if cfg.output_pileup:
            write_pileup(cfg.output, display_path, index.files[best], seq_pileups)
        write_vcf(cfg.output, display_path, records, index.files[best])

    summary = SampleSummary(
        display_path, index.files[best].name, stats, n_perfect, n_variant,
        n_unmapped
    )
    return summary, (display_path, records)




@dataclass
class PendingStream:
    """Streamed-pass-1 device handles: per-partition tally dispatches done,
    tallies sync + genome selection + pass-2 dispatch deferred to the
    worker thread (resolve()), exactly like PendingMap."""
    tj: object          # (G, 3) int32 device tallies (all partitions)
    parts: list         # [(kj, cj, start_all, h_all, lane_tot)] device arrays
    mcfg: object
    n_kmers: int
    cstats: CountStats
    t_start: float

    def resolve(self, index: BronkoIndex, dev: DeviceIndex, cfg: CallConfig):
        from dataclasses import replace

        tallies = np.asarray(self.tj).astype(np.int64)
        log.info("Tallied %d kmers in %.2fs (streamed)", self.n_kmers,
                 time.time() - self.t_start)
        best, triple = _select_and_log(tallies, index, dev, self.cstats)

        t1 = time.time()
        best_j = jnp.int32(best)
        fbase = jnp.int32(int(dev.file_bases[best]))
        pileup = jnp.zeros((4, dev.g_total_len + 1, 4), jnp.int32)
        saved = [p for p in self.parts if p[2] is not None]
        unsaved = [p for p in self.parts if p[2] is None]
        if saved:
            # ONE host sync for every partition's exact lane total, and ONE
            # shared budget (their max): per-partition budgets cost a sync
            # each AND can differ, splitting pass 2 across several
            # executables
            lts = np.asarray(jnp.stack([lt for *_, lt in saved]))
            gcfg = replace(
                self.mcfg,
                total_len=dev.g_total_len,
                max_bucket=dev.g_max_bucket,
                lane_budget=_lane_class(int(lts[:, best].max())),
            )
            for kj, cj, start_all, h_all, _lt in saved:
                # exact budgets can't overflow: the flag needs no retry loop
                pileup, _ov = _dispatch_pileup_saved(
                    kj, cj, start_all, h_all, dev, best_j, fbase, gcfg, pileup)
        if unsaved:
            # probe-budget-capped partitions re-probe the selected genome's
            # sub-index; overflow retries recompute from a zeroed pileup
            # (a partial overflowed scatter must never be accumulated), so
            # they scatter into their OWN tensor and merge at the end —
            # depth planes max, count planes add, both order-independent
            dev.ensure_subindex()
            gcfg2 = replace(
                self.mcfg,
                total_len=dev.g_total_len,
                max_bucket=dev.g_max_bucket,
                lane_budget=_pass2_budget(unsaved[0][0], self.mcfg, None),
            )
            while True:
                p2 = jnp.zeros((4, dev.g_total_len + 1, 4), jnp.int32)
                ov = 0
                for kj, cj, *_ in unsaved:
                    p2, o = pileup_all_jit(
                        kj, cj, dev.g_keys[best], dev.g_offsets[best],
                        dev.g_postings[best], p2, gcfg2)
                    ov = ov | o
                if not int(ov):
                    break
                log.info("streamed pileup lane budget exceeded (%d); retrying",
                         gcfg2.lane_budget)
                gcfg2 = replace(gcfg2, lane_budget=gcfg2.lane_budget * 2)
            pileup = jnp.concatenate(
                [jnp.maximum(pileup[:2], p2[:2]), pileup[2:] + p2[2:]])
        log.info("Scattered pileup in %.2fs", time.time() - t1)
        return best, pileup, triple


def _stream_pass1(
    paths: list[str],
    index: BronkoIndex,
    dev: DeviceIndex,
    cfg: CallConfig,
) -> PendingStream:
    """Streamed count->tally: the C++ counter finalizes
    one key-range partition at a time; each partition's tally dispatch is
    asynchronous, so the device tallies partition p while the host
    sorts/uploads partition p+1 — count and map overlap instead of running
    back-to-back. Tallies chain through donated device buffers; no host
    sync happens here at all (PendingStream.resolve does them on the worker
    thread). Byte-identical to the non-streaming path: partitions cover
    disjoint sorted key ranges, and scatter-add/max are order-independent.

    Saved probe artifacts are HBM-capped like _map_one's fast path
    (PROBE_BYTES_CAP): partitions past the cap tally without saving and
    resolve() re-probes them against the selected genome's sub-index."""
    from bronko_tpu.consts import KMER_COUNT_CAP
    from bronko_tpu.io.native import native_count_fastq_stream

    t0 = time.time()
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    J = len(mcfg.positions)
    hist = dev.hist if dev.hist is not None else dev.hist_words
    h_bytes = hist.dtype.itemsize * (hist.shape[1] if hist.ndim == 2 else 1)
    tj = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    parts = []  # (kj, cj, start_all|None, h_all|None, lane_tot|None)
    stats_sum = CountStats()
    n_kmers = 0
    saved_bytes = 0
    for kmers, counts, stats in native_count_fastq_stream(
            paths, index.k, cfg.min_kmers, KMER_COUNT_CAP,
            threads=max(1, cfg.threads)):
        if stats is not None:
            stats_sum = CountStats(**{
                f: getattr(stats_sum, f) + stats[f]
                for f in ("total_reads", "total_kmers", "unique_kmers",
                          "unique_counted_kmers")})
        if kmers.shape[0] == 0:
            continue
        n_kmers += kmers.shape[0]
        kj, cj = _prepare_batches(kmers, counts, cfg.batch_size)
        saved_bytes += kj.size * J * (4 + h_bytes)
        if saved_bytes <= PROBE_BYTES_CAP:
            if dev.hist is not None:
                tj, lt, start_all, h_all = tally_save_jit(
                    kj, cj, dev.keys, dev.offsets, dev.hist, tj, mcfg)
            else:
                tj, lt, start_all, h_all = tally_save_words_jit(
                    kj, cj, dev.keys, dev.offsets, dev.hist_words, tj, mcfg)
            parts.append((kj, cj, start_all, h_all, lt))
        else:  # probe budget spent: tally only; resolve() re-probes
            mode = "hist" if dev.hist is not None else "words"
            tj, _ov = tally_all_jit(kj, cj, dev.keys, dev.offsets,
                                    dev.postings, hist, tj, mcfg, mode)
            parts.append((kj, cj, None, None, None))

    log.info("%d reads counted from %s with the host counter (streamed)",
             stats_sum.total_reads, paths[0])
    log.info(
        "%d unique kmers above %d count, %d total unique kmers, "
        "%d total kmers (~%d basepairs); dispatched in %.2fs",
        stats_sum.unique_counted_kmers, cfg.min_kmers, stats_sum.unique_kmers,
        stats_sum.total_kmers, stats_sum.total_kmers * index.k,
        time.time() - t0,
    )
    return PendingStream(tj=tj, parts=parts, mcfg=mcfg, n_kmers=n_kmers,
                         cstats=stats_sum, t_start=t0)


def _process_one_stream(
    display_path: str,
    paths: list[str],
    index: BronkoIndex,
    dev: DeviceIndex,
    cfg: CallConfig,
) -> tuple[SampleSummary, tuple[str, list[VCFRecord]]]:
    """Single-sample streaming path: streamed pass 1 + in-place finish."""
    return _finish_one(display_path, index, dev, cfg,
                       _stream_pass1(paths, index, dev, cfg))


def _env_flag(name: str) -> bool:
    """Truthiness of an env toggle: '0'/'false'/'no'/'off'/'' are OFF
    (a plain presence check would read BRONKO_X=0 as on)."""
    return os.environ.get(name, "").strip().lower() not in (
        "", "0", "false", "no", "off")


_DISPATCH_LAT: list = []


def _dispatch_latency_s() -> float:
    """Per-dispatch device round-trip, measured once per process with a
    tiny jit (compile disk-cached; the timed call is the steady second
    one). The streamed count->tally overlap pays one dispatch per
    partition, so it can only win where a dispatch costs a few ms or
    less."""
    if not _DISPATCH_LAT:
        try:
            f = jax.jit(lambda x: x + 1)
            x = jnp.zeros(8, jnp.int32)
            np.asarray(f(x))
            t0 = time.time()
            np.asarray(f(x))
            _DISPATCH_LAT.append(time.time() - t0)
        except Exception:  # noqa: BLE001
            # fail CLOSED: a failed probe must not force-enable streaming
            # on a slow-dispatch host
            _DISPATCH_LAT.append(1.0)
    return _DISPATCH_LAT[0]


_STREAM_CALIB_PATH = os.path.join(
    os.path.expanduser("~"), ".cache", "bronko_jax", "stream_calib.json")


def _load_stream_calib() -> dict | None:
    """Per-host outcome calibration for the stream gate: measured
    classic vs streamed single-sample wall times keyed by platform
    (written by bench.py's interleaved A/B).
    Returns this platform's entry or None."""
    import json

    try:
        with open(_STREAM_CALIB_PATH) as fh:
            d = json.load(fh)
        e = d.get(jax.default_backend())
        if (isinstance(e, dict) and float(e["classic_s"]) > 0
                and float(e["streamed_s"]) > 0
                and float(e["dispatch_s"]) >= 0):
            return e
    except Exception:  # noqa: BLE001 - absent/corrupt file = no calib
        pass
    return None


def save_stream_calibration(classic_s: float, streamed_s: float) -> dict:
    """Record a measured classic-vs-streamed single-sample A/B for this
    platform (merged per-platform so a CPU run can't clobber the GPU
    entry). The gate trusts the entry only while the live
    dispatch-latency probe stays within ~2.5x of the recorded one — the
    latency is the observable that tells one host class from another."""
    import json

    entry = {
        "classic_s": round(float(classic_s), 4),
        "streamed_s": round(float(streamed_s), 4),
        "dispatch_s": round(_dispatch_latency_s(), 5),
        "ts": time.time(),
    }
    try:
        os.makedirs(os.path.dirname(_STREAM_CALIB_PATH), exist_ok=True)
        try:
            with open(_STREAM_CALIB_PATH) as fh:
                d = json.load(fh)
            if not isinstance(d, dict):
                d = {}
        except Exception:  # noqa: BLE001
            d = {}
        d[jax.default_backend()] = entry
        tmp = _STREAM_CALIB_PATH + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(d, fh)
        os.replace(tmp, _STREAM_CALIB_PATH)
    except Exception as e:  # noqa: BLE001 - read-only home dirs etc.
        log.warning("could not persist stream calibration: %s", e)
    return entry


def _can_stream(cfg: CallConfig, dev: DeviceIndex, sharded,
                explicit: bool = False) -> bool:
    """Streaming pays when there is no cross-sample prefetch to hide the
    host count anyway (single job), the probe-reuse fast path applies,
    no full k-mer dump is requested, AND the path measures faster:

    1. BRONKO_STREAM / BRONKO_NO_STREAM force the decision (A/Bs);
    2. else an OUTCOME calibration (save_stream_calibration: interleaved
       measured wall times for both paths, written by bench.py) decides
       — valid while the live dispatch-latency probe stays within ~2.5x
       of the calibration's, i.e. the same class of host;
    3. else the dispatch-latency proxy (<4 ms streams): per-partition
       dispatches only pay when dispatch is cheap. The 4 ms line comes
       from an earlier accelerator behind a slow link and is unmeasured
       on the GPU (ROADMAP 1.8).

    The decision and its source are logged either way."""
    if sharded is not None or cfg.keep_kmer_counts or cfg.counter == "device":
        return False
    if _env_flag("BRONKO_NO_STREAM"):  # debug/A-B override
        return False
    stream_env = os.environ.get("BRONKO_STREAM", "").strip().lower()
    if stream_env in ("0", "false", "no", "off"):
        return False
    if (dev.hist is None and dev.hist_words is None) or not dev.fid_grouped:
        return False
    try:
        from bronko_tpu.io.native import get_lib

        if get_lib() is None:
            return False
    except Exception:  # noqa: BLE001
        return False
    if explicit or stream_env in ("1", "true", "yes", "on"):
        # an explicit opt-in (BRONKO_STREAM=1 / BRONKO_STREAM_FIRST=1)
        # bypasses the latency auto-gate — it exists for A/Bs
        return True
    lat = _dispatch_latency_s()
    calib = _load_stream_calib()
    if calib is not None:
        d0 = float(calib["dispatch_s"])
        # same host class: both sub-4ms (the exact ratio is jitter
        # there), or latencies within ~2.5x of each other
        same_epoch = ((d0 < 0.004 and lat < 0.004)
                      or (d0 > 0 and lat > 0 and 0.4 <= d0 / lat <= 2.5))
        if same_epoch:
            win = float(calib["streamed_s"]) < float(calib["classic_s"])
            log.info(
                "stream gate: calibrated -> %s (classic %.3fs vs streamed "
                "%.3fs; dispatch now %.1f ms, calibrated at %.1f ms)",
                "streamed" if win else "classic", calib["classic_s"],
                calib["streamed_s"], lat * 1e3, d0 * 1e3)
            return win
        log.info("stream gate: calibration stale (dispatch %.1f ms vs "
                 "calibrated %.1f ms); falling back to latency proxy",
                 lat * 1e3, d0 * 1e3)
    decision = lat < 0.004
    log.info("stream gate: latency proxy -> %s (dispatch %.1f ms)",
             "streamed" if decision else "classic", lat * 1e3)
    return decision


def _count_job(paths: list[str], cfg: CallConfig, k: int,
               upload: bool = False, threads: int | None = None,
               texts: list | None = None):
    """Count one sample (single-end: [r]; paired: [r1, r2] concatenated —
    semantics identical to the reference's two map_kmers passes into shared
    pileups, call.rs:301-320).

    With upload=True the mapping batches are built AND device_put here, on
    the prefetch worker thread — the ~2.4 MB k-mer payload then rides the
    host->device link while the PREVIOUS sample's device passes run,
    instead of serializing ahead of this sample's tally dispatch. `texts`
    are inflate-ahead futures, one per
    path: the single-threaded gzip inflate of THIS sample ran on the
    dedicated inflate worker while the previous sample parsed/counted."""
    try:
        parts = [count_sample(
            p, cfg, k, threads=threads,
            text=texts[i].result() if texts and texts[i] is not None else None)
                 for i, p in enumerate(paths)]
    finally:
        # a failed mate must not pin its sibling's inflated buffer (or its
        # budget reservation) for the rest of the run; close() is idempotent
        for f in texts or []:
            if f is not None:
                try:
                    f.result().close()
                except Exception:  # noqa: BLE001
                    pass
    kmers = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1] for p in parts])
    cstats = CountStats(
        total_reads=sum(p[2].total_reads for p in parts),
        total_kmers=sum(p[2].total_kmers for p in parts),
        unique_kmers=sum(p[2].unique_kmers for p in parts),
        unique_counted_kmers=sum(p[2].unique_counted_kmers for p in parts),
    )
    batches = None
    if upload and kmers.shape[0] > 0:
        batches = _prepare_batches(kmers, counts, cfg.batch_size)
    return kmers, counts, cstats, batches


# intra-batch layouts the most recent --mesh run_call exercised
# ("batchwise" / "bsplit" / "routed"); plain strings only so nothing
# device-resident is retained. Consumed by __graft_entry__.dryrun_multichip
# to name the layouts in the driver-visible tail.
LAST_MESH_LAYOUTS: frozenset = frozenset()


def run_call(cfg: CallConfig, index: BronkoIndex, dev: DeviceIndex) -> list[SampleSummary]:
    """Per-sample pipeline driver; wraps the body so an open profiler
    trace is flushed even when the run fails (the failing run is exactly
    the one whose trace you want)."""
    profiling = False
    if cfg.profile_dir:
        try:
            jax.profiler.start_trace(cfg.profile_dir)
            profiling = True
            log.info("Profiling to %s", cfg.profile_dir)
        except Exception as e:  # noqa: BLE001
            log.warning("profiler unavailable: %s", e)
    try:
        return _run_call_inner(cfg, index, dev)
    finally:
        if profiling:
            try:
                jax.profiler.stop_trace()
            except Exception as e:  # noqa: BLE001
                log.warning("profiler stop failed: %s", e)


def _run_call_inner(cfg: CallConfig, index: BronkoIndex,
                    dev: DeviceIndex) -> list[SampleSummary]:
    from concurrent.futures import ThreadPoolExecutor

    from bronko_tpu.utils.memory import log_memory_usage

    os.makedirs(cfg.output, exist_ok=True)
    summaries: list[SampleSummary] = []
    variant_info: list[tuple[str, list[VCFRecord]]] = []
    failures: list[str] = []

    sharded = None
    if cfg.mesh:
        # reset the layout evidence for THIS run — a mesh run that
        # records nothing (e.g. every sample fails) must not inherit the
        # previous run's set (dryrun/test assertions consume it)
        global LAST_MESH_LAYOUTS
        LAST_MESH_LAYOUTS = frozenset()
        log.info("Sharding the mapping pipeline over a %s device mesh", cfg.mesh)
        sharded = ShardedMapper(index, cfg, dev)
        if cfg.batch_size % sharded.n_devices:
            raise SystemExit(
                "batch size must be divisible by the mesh device count "
                f"({sharded.n_devices})")

    jobs = [[p] for p in cfg.reads] + [
        [r1, r2] for r1, r2 in zip(cfg.first_pairs, cfg.second_pairs)
    ]

    # sample-sharded cohort mode: partition whole samples round-robin
    # across processes — zero per-sample collectives, throughput scales
    # with host count (counting AND mapping); summaries gather at the end
    # so rank 0 can write the global overview/alignment in input order
    import jax as _jax

    n_total_jobs = len(jobs)
    shard_samples = cfg.shard_samples and _jax.process_count() > 1
    if shard_samples:
        rank, n_proc = _jax.process_index(), _jax.process_count()
        job_indices = list(range(n_total_jobs))[rank::n_proc]
        jobs = [jobs[i] for i in job_indices]
        log.info("sample-sharded cohort: process %d/%d owns %d of %d samples",
                 rank, n_proc, len(jobs), n_total_jobs)
    else:
        job_indices = list(range(n_total_jobs))
    # global positions are tracked EXPLICITLY per job (summary_gidx /
    # failure_gidx, parallel to summaries/failures) — a display-path map
    # would collapse e.g. the same file listed as both -r and a pair's -1
    summary_gidx: list[int] = []
    failure_gidx: list[int] = []

    # host counting (C++, GIL-free) prefetches upcoming samples while the
    # device maps the current one — the reference's rayon-join concurrency
    # (call.rs:301-307) generalized across the sample stream. TWO counts
    # in flight by default on >=4-thread hosts, so host counting, which
    # can outlast a sample's device map, keeps the device fed.
    # BRONKO_COUNT_WORKERS overrides either way.
    # Submission is bounded (<= workers+1 ahead) so counted k-mer arrays
    # don't pile up in memory on large cohorts.
    mcfg0 = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    if (len(jobs) == 1 and len(mcfg0.positions) > 0
            and _can_stream(cfg, dev, sharded)):
        # single-sample latency path: stream partitioned counting into
        # asynchronous tally dispatches (count and map overlap)
        job = jobs[0]
        label = job[0] if len(job) == 1 else f"{job[0]}, {job[1]}"
        log.info("Processing %s (streamed)", label)
        try:
            summary, vinfo = _process_one_stream(job[0], job, index, dev, cfg)
            summaries.append(summary)
            variant_info.append(vinfo)
            summary_gidx.append(job_indices[0])
            log_memory_usage("Called variants successfully")
        except SystemExit:
            raise
        except Exception:  # noqa: BLE001
            log.exception("Sample %s failed", label)
            failures.append(job[0])
            failure_gidx.append(job_indices[0])
        jobs_iter = []
        iter_gidx: list[int] = []
    else:
        jobs_iter = jobs
        iter_gidx = list(job_indices)

    from concurrent.futures import wait as _fwait

    try:
        default_cw = 2 if (os.cpu_count() or 1) >= 4 and len(jobs_iter) > 1 else 1
        count_workers = max(1, int(os.environ.get("BRONKO_COUNT_WORKERS",
                                                  str(default_cw))))
    except ValueError:
        log.warning("BRONKO_COUNT_WORKERS is not an integer; using 1")
        count_workers = 1
    count_threads = max(1, cfg.threads // count_workers)

    # pipeline-fill cut: on a cohort, every sample's count hides behind
    # the PREVIOUS sample's device work — except the first, so streaming
    # the first sample's count->tally (partitioned overlap) can fill the
    # pipeline. Where a dispatch is slow this loses: each per-partition
    # tally dispatch pays the dispatch latency. Engaged when
    # BRONKO_STREAM_FIRST=1 forces it, OR when _can_stream's non-explicit
    # decision (outcome calibration, else the latency proxy) says the
    # streamed single-sample path wins on this host.
    stream_first: list[str] | None = None
    if len(jobs_iter) > 1 and len(mcfg0.positions) > 0:
        sf_env = os.environ.get("BRONKO_STREAM_FIRST", "").strip()
        if sf_env:   # explicit 1 bypasses the auto decision; 0 = off
            sf_on = _env_flag("BRONKO_STREAM_FIRST") and _can_stream(
                cfg, dev, sharded, explicit=True)
        else:        # unset: the outcome-calibrated auto gate decides
            sf_on = _can_stream(cfg, dev, sharded)
    else:
        sf_on = False
    if sf_on:
        stream_first = jobs_iter[0]
        stream_first_gidx = iter_gidx[0]
        jobs_iter = jobs_iter[1:]
        iter_gidx = iter_gidx[1:]

    # inflate-ahead worker: read+inflate upcoming samples' gzip on a
    # dedicated thread (the inflate is the count's single-threaded section,
    # ~30% of it) so it overlaps the current sample's parse/count. Live
    # inflated bytes are capped by a byte budget (gz estimated 8x its
    # compressed size at submission; charge returned when the buffer
    # closes) — job-submission lookahead alone would let paired cohorts of
    # near-cap files hold several 1.5 GB buffers at once. Files over the
    # budget simply skip the prefetch and inflate inline as before.
    use_inflate_ahead = False
    if cfg.counter in ("auto", "host"):
        try:
            from bronko_tpu.io.native import get_lib, native_read_inflate

            use_inflate_ahead = get_lib() is not None
        except Exception:  # noqa: BLE001
            pass
    import threading as _threading

    try:  # bytes of estimated inflated text in flight (0 disables prefetch)
        inflate_budget = int(os.environ.get("BRONKO_INFLATE_BUDGET",
                                            str(512 << 20)))
    except ValueError:
        inflate_budget = 512 << 20
    inflate_out = [0]
    inflate_lock = _threading.Lock()

    def _charge(path: str):
        """Reserve budget for one file; returns a release callback or None
        (skip the prefetch) when the file is missing or over budget."""
        try:
            est = os.path.getsize(path)
        except OSError:
            return None
        if path.endswith((".gz", ".bgz", ".bgzf")):
            est *= 8
        with inflate_lock:
            if inflate_out[0] + est > inflate_budget:
                return None
            inflate_out[0] += est

        def _release():
            with inflate_lock:
                inflate_out[0] -= est

        return _release

    with ThreadPoolExecutor(max_workers=count_workers) as pool, \
            ThreadPoolExecutor(max_workers=1) as call_pool, \
            ThreadPoolExecutor(max_workers=1) as inflate_pool:
        futures: list = []
        call_futs: list[tuple[str, int, object]] = []  # (display, gidx, future)

        def _ensure_submitted(upto: int) -> None:
            while len(futures) < min(upto, len(jobs_iter)):
                job = jobs_iter[len(futures)]
                texts = None
                if use_inflate_ahead:
                    texts = []
                    for p in job:
                        release = _charge(p)
                        texts.append(None if release is None else
                                     inflate_pool.submit(
                                         native_read_inflate, p, release))
                futures.append(pool.submit(
                    _count_job, job, cfg, index.k,
                    sharded is None, count_threads, texts))

        if stream_first is not None:
            display = stream_first[0]
            label = (display if len(stream_first) == 1
                     else f"{stream_first[0]}, {stream_first[1]}")
            log.info("Processing %s (streamed)", label)
            try:
                result = _stream_pass1(stream_first, index, dev, cfg)
                call_futs.append((display, stream_first_gidx, call_pool.submit(
                    _finish_one, display, index, dev, cfg, result)))
            except SystemExit:
                raise
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception(
                    "Sample %s failed; continuing with remaining samples", label)
                failures.append(display)
                failure_gidx.append(stream_first_gidx)

        for ji, job in enumerate(jobs_iter):
            _ensure_submitted(ji + 1 + count_workers)
            # release the future: it would otherwise retain its result —
            # kmer arrays AND device-put batches — for the whole run
            fut, futures[ji] = futures[ji], None
            display = job[0]
            label = display if len(job) == 1 else f"{job[0]}, {job[1]}"
            log.info("Processing %s", label)
            try:
                kmers, counts, cstats, batches = fut.result()
                log.info("%d reads counted from %s", cstats.total_reads, display)
                log.info(
                    "%d unique kmers above %d count, %d total unique kmers, "
                    "%d total kmers (~%d basepairs)",
                    cstats.unique_counted_kmers, cfg.min_kmers, cstats.unique_kmers,
                    cstats.total_kmers, cstats.total_kmers * index.k,
                )
                log_memory_usage("Finished counting kmers")
                if cfg.keep_kmer_counts:
                    from bronko_tpu.io.naming import clean_sample_id
                    from bronko_tpu.ops.codec import kmer_to_string

                    dump = os.path.join(
                        cfg.output, clean_sample_id(display) + "_counts.txt")
                    with open(dump, "w") as fh:
                        for km, ct in zip(kmers.tolist(), counts.tolist()):
                            fh.write(f"{kmer_to_string(km, index.k)}\t{ct}\n")
                result = _map_one(
                    kmers, counts, cstats, index, dev, cfg, sharded,
                    batches=batches)
                # device syncs + pass-2 dispatch (fast path) + host phase
                # (noise scan + caller + writes) overlap the NEXT sample's
                # device phase; <=2 in flight bounds the live device pileups
                if len(call_futs) >= 2:
                    _fwait([call_futs[-2][2]])
                call_futs.append((display, iter_gidx[ji], call_pool.submit(
                    _finish_one, display, index, dev, cfg, result)))
            except SystemExit:
                raise
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", label)
                failures.append(display)
                failure_gidx.append(iter_gidx[ji])

        for display, gidx, cf in call_futs:
            try:
                summary, vinfo = cf.result()
                summaries.append(summary)
                variant_info.append(vinfo)
                summary_gidx.append(gidx)
                log_memory_usage("Called variants successfully")
            except SystemExit:
                raise
            except Exception:  # noqa: BLE001 — per-sample isolation
                log.exception("Sample %s failed; continuing with remaining samples", display)
                failures.append(display)
                failure_gidx.append(gidx)

    if shard_samples:
        # assemble the GLOBAL result set on every process (rank 0 writes
        # overview/alignment; everyone needs it for the exit decision).
        # PAYLOAD-SIZE ASSUMPTION: allgather_bytes ships the pickled
        # summaries + VCF records through device collectives (every
        # process pays max-payload padding) — fine at viral scale
        # (kB-MB per sample: summary rows + SNP records, never pileups
        # or reads); do NOT route bulk per-sample tensors through it
        import pickle

        from bronko_tpu.parallel.distributed import allgather_bytes

        payload = pickle.dumps({
            "rows": list(zip(summary_gidx, summaries, variant_info)),
            "failures": list(zip(failure_gidx, failures)),
        })
        rows: list = []
        fails: list = []
        for part in allgather_bytes(payload):
            d = pickle.loads(part)
            rows.extend(d["rows"])
            fails.extend(d["failures"])
        rows.sort(key=lambda t: t[0])
        summaries = [s for _, s, _ in rows]
        variant_info = [vi for _, _, vi in rows]
        failures = [f for _, f in sorted(fails)]

    if failures and not summaries:
        log.error("All samples failed")
        raise SystemExit(1)
    if failures:
        log.warning("%d of %d samples processed; failed: %s",
                    len(summaries), n_total_jobs, ", ".join(failures))

    from bronko_tpu.parallel.distributed import is_primary

    log.info("Printing overview")
    if is_primary():
        write_overview(cfg.output, summaries)
    if not failures:
        log.info("All samples processed successfully")

    if cfg.output_alignment:
        log.info("Building alignment(s)")
        if is_primary():
            write_alignments(cfg.output, summaries, variant_info, index.files, log)

    if sharded is not None and sharded.layouts_used:
        LAST_MESH_LAYOUTS = frozenset(sharded.layouts_used)
        log.info("mesh layouts used this run: %s",
                 "+".join(sorted(sharded.layouts_used)))

    log.info("bronko complete!")
    return summaries
