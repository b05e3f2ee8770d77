#!/usr/bin/env python3
"""Bring-up check of `bronko call` on an NVIDIA GPU, end to end.

Run from the repository root:

    python3 chip_smoke.py               # one GPU: every phase below
    python3 chip_smoke.py --four-gpus   # four GPUs: only the --mesh phase

One process owns the card. The CPU reference run is a child process pinned
to the CPU (JAX_PLATFORMS=cpu), so it never opens the card.

Deployment: the benchmark's deep-coverage SARS-CoV-2-scale sample, made
from a fixed seed by tests/make_synthetic.py — a panel of 4 genomes of
29,900 bp (k = 21) and 300,000 single-end 150 bp reads (~1,500x depth,
error rate 0.003, 8 planted major and 12 planted minor variants).

Phases (one GPU):
  1. device     JAX must report a GPU; prints the card from nvidia-smi
  2. native     rebuilds libbronko_io.so from the committed sources
  3. data       generates the deployment (timed apart)
  4. index      host build vs on-card build: every array bit-identical
  5. call       `call -d ... --pileup` through cli.main on the GPU; VCF,
                pileup and overview byte-identical to a CPU run of the same
                commit, planted majors PASS, one batch equal to the scalar
                oracle (tests/oracle/map_oracle.py)
  6. branches   classic / streamed / auto stream gate, device counter,
                paired end, multi-batch (saved-probe and fallback passes),
                3-sample cohort (prefetch + fused map), both _expand_lanes
                forms (timed), and a profiler trace of the probe front end
                and the window pack
  7. timings    per-phase wall time beside the card's name and power limit
  8. tests      the tests marked `chip` (tests/test_chip.py), in-process

Every comparison is exact: the device work is integer sorts, gathers and
int32 scatter-add/scatter-max, which give the same result in any order,
and the f64 caller runs on the host.

The last stdout line is one JSON object naming the device; any failed
phase exits non-zero before it is printed. Details go to
.bench_cache/smoke/smoke_detail.json.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import logging
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".bench_cache", "smoke")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory bandwidth (data sheet)
DEVICE_PLANE = "/device:GPU"  # profiler planes that hold the GPU's events
OUTPUT_FILES = ("{s}.vcf", "{s}.tsv", "bronko_overview.tsv")


@dataclass(frozen=True)
class Deployment:
    n_genomes: int = 4
    genome_len: int = 29_900
    k: int = 21
    n_reads: int = 300_000
    read_len: int = 150
    insert: int = 400            # paired-end fragment length
    error_rate: float = 0.003
    n_major: int = 8
    n_minor: int = 12
    seed: int = 2024
    cohort: int = 3
    multi_batch: int = 32_768    # --batch-size that splits a sample (nb > 1)
    oracle_kmers: int = 2_048    # k-mers in the oracle slice
    form_runs: int = 7           # timed runs of each _expand_lanes form
    trace_runs: int = 5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _load(name: str, path: str, package_dir: str | None = None):
    """Import a repo file under a private module name (a `tests` package
    installed elsewhere must not shadow the repo's own)."""
    spec = importlib.util.spec_from_file_location(
        name, path, submodule_search_locations=(
            [package_dir] if package_dir else None))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def synth_module():
    return _load("bronko_smoke_synth",
                 os.path.join(REPO, "tests", "make_synthetic.py"))


def oracle_module():
    pkg = os.path.join(REPO, "tests", "oracle")
    _load("bronko_smoke_oracle", os.path.join(pkg, "__init__.py"), pkg)
    return _load("bronko_smoke_oracle.map_oracle",
                 os.path.join(pkg, "map_oracle.py"))


# ---------------------------------------------------------------- phase 1


def card_lines() -> list[str]:
    """`nvidia-smi --query-gpu=name,power.limit` lines, from a child that
    stays off JAX."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    check(bool(lines), "nvidia-smi listed no card")
    return lines


def check_device(n_min: int = 1):
    """The GPUs JAX sees; exits non-zero when JAX finds none (never falls
    back to the CPU) or fewer than n_min."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < n_min:
        raise SystemExit(f"chip_smoke: needs {n_min} GPUs, JAX found "
                         f"{len(devs)}")
    return devs


# ------------------------------------------------------------ run context


class Smoke:
    """State shared by the phases: the deployment, its files, captured
    engine log records and the timings."""

    def __init__(self, dep: Deployment, work: str, card: str):
        self.dep = dep
        self.work = work
        self.card = card
        self.timings: list[tuple[str, float, str]] = []
        self.detail: dict = {"deployment": dep.__dict__, "card": card}
        self.records: list[logging.LogRecord] = []
        os.makedirs(work, exist_ok=True)
        log = logging.getLogger("bronko")
        log.setLevel(logging.INFO)
        log.propagate = False    # the CLI's own stderr handler stays quiet
        cap = logging.Handler()
        cap.emit = self.records.append
        log.addHandler(cap)
        fh = logging.FileHandler(os.path.join(work, "smoke.log"), mode="w")
        fh.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(message)s"))
        log.addHandler(fh)

    def time(self, name: str, seconds: float, kind: str = "run") -> None:
        self.timings.append((name, seconds, kind))
        print(f"  {kind:7s} {name}: {seconds:.3f} s  [{self.card}]",
              flush=True)

    def messages(self) -> list[str]:
        return [r.getMessage() for r in self.records]

    def path(self, *parts: str) -> str:
        return os.path.join(self.work, *parts)


@contextlib.contextmanager
def env(**values):
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli_call(sm: Smoke, out: str, args: list[str], **envs) -> float:
    """`bronko-tpu call ... -o out` through cli.main; returns wall seconds.
    A partial or total failure of the run is a smoke failure."""
    from bronko_tpu.cli import main

    sm.records.clear()
    argv = ["call", *args, "-o", out]
    with env(**envs), open(os.devnull, "w") as dn, \
            contextlib.redirect_stdout(dn):
        t0 = time.perf_counter()
        try:
            rc = main(argv)
        except SystemExit as e:
            raise SmokeFailure(f"`{' '.join(argv)}` exited {e.code}") from e
        dt = time.perf_counter() - t0
    check(rc == 0, f"`{' '.join(argv)}` returned {rc}")
    return dt


def cli_call_warm(sm: Smoke, name: str, out: str, args: list[str],
                  **envs) -> None:
    """cli_call twice: the first run (into out + '_warm') compiles and is
    reported as set-up, the second is the timed run; both outputs must
    be byte-identical."""
    sm.time(f"{name}, first run (compiles)",
            cli_call(sm, out + "_warm", args, **envs), "set-up")
    sm.time(name, cli_call(sm, out, args, **envs))


def sample_id(path: str) -> str:
    from bronko_tpu.io.naming import clean_sample_id

    return clean_sample_id(path)


def compare_outputs(dir_a: str, dir_b: str, sample: str,
                    files=OUTPUT_FILES) -> None:
    for f in files:
        name = f.format(s=sample)
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            check(fa.read() == fb.read(),
                  f"{name} differs: {dir_a} vs {dir_b}")


# ---------------------------------------------------------------- phase 2


def rebuild_native(sm: Smoke | None = None) -> None:
    """Rebuild libbronko_io.so from the committed sources (make -B): a
    library built on another host must never be loaded."""
    from bronko_tpu.io import native

    t0 = time.perf_counter()
    r = subprocess.run(["make", "-B", "-C", native._NATIVE_DIR],
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise SmokeFailure("native build failed:\n" + r.stdout[-2000:]
                           + r.stderr[-4000:])
    check(native.get_lib() is not None, "rebuilt native library won't load")
    if sm is not None:
        sm.time("native build (make -B)", time.perf_counter() - t0, "set-up")


# ---------------------------------------------------------------- phase 3


def make_data(sm: Smoke, samples: int) -> dict:
    """Panel FASTAs, `samples` single-end FASTQs (sample i drawn from
    genome i mod G), one paired sample, and the .bkdb built through the
    CLI's `build`."""
    import numpy as np

    from bronko_tpu.cli import main

    dep = sm.dep
    syn = synth_module()
    rng = np.random.default_rng(dep.seed)
    t0 = time.perf_counter()
    genomes, seqs = [], []
    for g in range(dep.n_genomes):
        seq = syn.make_genome(rng, dep.genome_len)
        p = sm.path(f"g{g}.fasta")
        syn.write_fasta(p, f"strain{g}", seq)
        genomes.append(p)
        seqs.append(seq)
    reads, planted = [], []
    for i in range(samples):
        ref = seqs[i % dep.n_genomes]
        pl = syn.plant_variants(ref, rng, dep.n_major, dep.n_minor)
        p = sm.path(f"s{i}.fastq.gz")
        syn.write_fastq_array(p, syn.make_reads(
            ref, rng, dep.n_reads, dep.read_len, pl, dep.error_rate))
        reads.append(p)
        planted.append({pos: (chr(ref[pos]), chr(a))
                        for pos, (a, f) in pl.items() if f >= 0.9})
    pl = syn.plant_variants(seqs[0], rng, dep.n_major, dep.n_minor)
    pairs = (sm.path("pair_1.fastq.gz"), sm.path("pair_2.fastq.gz"))
    syn.write_pairs(*pairs, seqs[0], rng, dep.n_reads // 2, dep.read_len,
                    dep.insert, pl, dep.error_rate)
    sm.time("data generation", time.perf_counter() - t0, "set-up")
    db = sm.path("panel")
    with open(os.devnull, "w") as dn, contextlib.redirect_stdout(dn):
        main(["build", "-k", str(dep.k), "-g", *genomes, "-o", db])
    return dict(genomes=genomes, seqs=seqs, reads=reads, planted=planted,
                pairs=pairs, db=db + ".bkdb")


# ---------------------------------------------------------------- phase 4


def _same(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def compare_indexes(host, card) -> None:
    """Every array of the two DeviceIndex builds bit-identical. The card
    build pads the key table to a size class; its pad rows must be empty
    (sentinel keys, zero-length CSR rows, zero histogram words)."""
    import numpy as np

    hk = np.asarray(host.keys)
    U = hk.shape[0]
    ck = np.asarray(card.keys)
    check(ck.dtype == hk.dtype and _same(ck[:U], hk), "index keys differ")
    check(bool(np.all(ck[U:] == np.uint64(0xFFFFFFFFFFFFFFFF))),
          "index pad keys are not sentinels")
    co = np.asarray(card.offsets)
    check(_same(co[:U + 1], host.offsets), "index offsets differ")
    check(bool(np.all(co[U:] == co[-1])), "index pad rows are not empty")
    check(_same(card.postings, host.postings), "index postings differ")
    for name in ("hist", "hist_words"):
        h, c = getattr(host, name), getattr(card, name)
        check((h is None) == (c is None), f"index {name} presence differs")
        if h is not None:
            c = np.asarray(c)
            check(_same(c[:U], h), f"index {name} differs")
            check(not c[U:].any(), f"index {name} pad rows are not zero")
    for name in ("postings_local32", "genome_lens", "file_bases"):
        h, c = getattr(host, name), getattr(card, name)
        check((h is None) == (c is None), f"index {name} presence differs")
        if h is not None:
            check(_same(c, h), f"index {name} differs")
    for name in ("k", "num_genomes", "total_len", "max_bucket",
                 "g_total_len", "g_max_bucket", "fid_grouped"):
        check(getattr(host, name) == getattr(card, name),
              f"index {name} differs")
    check([(s.file_id, s.seq_id, s.name, s.offset, s.length)
           for s in host.seq_slices]
          == [(s.file_id, s.seq_id, s.name, s.offset, s.length)
              for s in card.seq_slices], "index sequence slices differ")


def phase_index(sm: Smoke, data: dict):
    import jax

    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.device_build import build_device_index_on_device
    from bronko_tpu.index.layout import build_device_index

    t0 = time.perf_counter()
    index = build_index(sm.dep.k, data["genomes"])
    host = build_device_index(index)
    jax.block_until_ready((host.keys, host.offsets, host.postings))
    sm.time("index build, host", time.perf_counter() - t0)
    t0 = time.perf_counter()
    build_device_index_on_device(sm.dep.k, data["genomes"])
    sm.time("index build, on card (first call, compiles)",
            time.perf_counter() - t0, "set-up")
    t0 = time.perf_counter()
    _, card = build_device_index_on_device(sm.dep.k, data["genomes"])
    jax.block_until_ready((card.keys, card.offsets, card.postings))
    sm.time("index build, on card", time.perf_counter() - t0)
    compare_indexes(host, card)
    print("  index: host and on-card builds bit-identical", flush=True)
    return index, card


# ---------------------------------------------------------------- phase 5


CPU_CHILD = ("import json, sys\n"
             "from bronko_tpu.cli import main\n"
             "for argv in json.loads(sys.argv[1]):\n"
             "    main(argv)\n")


def cpu_reference(sm: Smoke, runs: list[list[str]]) -> None:
    """The same CLI runs on the CPU, in a child pinned to it."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", CPU_CHILD, json.dumps(runs)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True,
        text=True, timeout=900)
    if r.returncode != 0:
        raise SmokeFailure("CPU reference run failed:\n" + r.stderr[-4000:])
    sm.time("CPU reference runs (child on the host CPU)",
            time.perf_counter() - t0, "cpu")


def pass_positions(vcf: str) -> set[tuple[int, str, str]]:
    out = set()
    with open(vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if f[6] == "PASS":
                out.add((int(f[1]), f[3], f[4]))
    return out


def oracle_slice(sm: Smoke, data: dict, index, dev) -> None:
    """One batch of the sample's counted k-mers through map_batch_jit on
    the GPU against the scalar oracle of the reference's map_kmers."""
    import jax.numpy as jnp
    import numpy as np

    from bronko_tpu.call.engine import count_sample
    from bronko_tpu.config import CallConfig
    from bronko_tpu.io.fasta import read_fasta
    from bronko_tpu.ops.map import (
        PLANE_CNT_FWD, PLANE_CNT_REV, PLANE_DEPTH_FWD, PLANE_DEPTH_REV,
        map_batch_jit,
    )

    orc = oracle_module()
    t0 = time.perf_counter()
    kmers, counts, _ = count_sample(data["reads"][0], CallConfig(), sm.dep.k)
    step = max(1, kmers.shape[0] // sm.dep.oracle_kmers)
    kb = kmers[::step][:sm.dep.oracle_kmers]
    cb = counts[::step][:sm.dep.oracle_kmers].astype(np.int32)
    files = [(os.path.basename(p), [(r.name, r.seq.upper())
                                    for r in read_fasta(p)])
             for p in data["genomes"]]
    o_maps, o_tallies = orc.map_kmers_oracle(
        list(zip(kb.tolist(), cb.tolist())),
        orc.build_oracle_index(sm.dep.k, files))
    sm.time("oracle slice, scalar oracle (host)", time.perf_counter() - t0,
            "cpu")
    mcfg = dev.map_config(2, False)
    while True:
        pileup, tallies, ov = map_batch_jit(
            jnp.asarray(kb), jnp.asarray(cb), dev.keys, dev.offsets,
            dev.postings, jnp.zeros((4, dev.total_len + 1, 4), jnp.int32),
            jnp.zeros((dev.num_genomes, 3), jnp.int32), mcfg)
        if not int(ov):
            break
        from dataclasses import replace
        mcfg = replace(mcfg, lane_factor=mcfg.lane_factor * 2)
    pileup, tallies = np.asarray(pileup), np.asarray(tallies)
    for fid in range(dev.num_genomes):
        check(tallies[fid].tolist() == o_tallies.get(fid, [0, 0, 0]),
              f"oracle slice: tallies of genome {fid} differ")
    planes = ((PLANE_DEPTH_FWD, "fwd"), (PLANE_DEPTH_REV, "rev"),
              (PLANE_CNT_FWD, "fwd_cnt"), (PLANE_CNT_REV, "rev_cnt"))
    for sl in dev.seq_slices:
        om = o_maps[sl.file_id][files[sl.file_id][1][sl.seq_id][0]]
        rows = slice(sl.offset, sl.offset + sl.length)
        for plane, key in planes:
            check(np.array_equal(pileup[plane, rows], om[key]),
                  f"oracle slice: pileup {sl.name}/{key} differs")
    check(int(pileup[2:, :-1].sum()) > 0, "oracle slice mapped nothing")
    print(f"  oracle slice: {kb.shape[0]} k-mers, tallies and pileup equal "
          "the scalar oracle", flush=True)


def phase_call(sm: Smoke, data: dict, index, dev) -> str:
    s0 = data["reads"][0]
    sid = sample_id(s0)
    call = ["-d", data["db"], "-r", s0, "--pileup"]
    out = sm.path("out_call")
    cli_call_warm(sm, "call, GPU (single sample, auto stream gate)", out,
                  call)
    msgs = sm.messages()
    counter = [m for m in msgs if " counter" in m and "ounted" in m]
    gate = [m for m in msgs if m.startswith("stream gate")]
    check(any("host counter" in m for m in counter),
          f"main path did not use the host counter: {counter}")
    print(f"  counter: {counter[0]}", flush=True)
    print(f"  stream gate: {gate[0] if gate else 'not consulted'}",
          flush=True)
    sm.detail["stream_gate"] = gate
    compare_outputs(out + "_warm", out, sid)
    compare_outputs(sm.path("cpu", "call"), out, sid)
    print("  call: VCF, pileup and overview byte-identical to the CPU run",
          flush=True)
    passed = pass_positions(os.path.join(out, sid + ".vcf"))
    majors = {(p + 1, r, a) for p, (r, a) in data["planted"][0].items()}
    check(majors <= passed, f"planted majors missing from PASS rows: "
                            f"{sorted(majors - passed)}")
    print(f"  call: all {len(majors)} planted majors are PASS rows "
          f"({len(passed)} PASS rows)", flush=True)
    oracle_slice(sm, data, index, dev)
    return out


# ---------------------------------------------------------------- phase 6


def phase_branches(sm: Smoke, data: dict, ref_out: str) -> None:
    import bronko_tpu.call.engine as engine

    s0 = data["reads"][0]
    sid = sample_id(s0)
    call = ["-d", data["db"], "-r", s0, "--pileup"]
    runs = [
        ("classic path (BRONKO_NO_STREAM=1)", call, {"BRONKO_NO_STREAM": "1"}),
        ("streamed path (BRONKO_STREAM=1)", call, {"BRONKO_STREAM": "1"}),
        ("device counter (--counter device)",
         call + ["--counter", "device"], {}),
        (f"multi-batch (--batch-size {sm.dep.multi_batch})",
         call + ["--batch-size", str(sm.dep.multi_batch)],
         {"BRONKO_NO_STREAM": "1"}),
    ]
    for i, (name, args, envs) in enumerate(runs):
        out = sm.path(f"out_branch{i}")
        cli_call_warm(sm, name, out, args, **envs)
        compare_outputs(ref_out, out + "_warm", sid)
        msgs = sm.messages()
        if "device counter" in name:
            check(any("device counter" in m for m in msgs),
                  "--counter device did not use the device counter")
        if "streamed" in name:
            check(any("(streamed)" in m for m in msgs),
                  "BRONKO_STREAM=1 did not stream")
        if "multi-batch" in name:
            n = int(next(m for m in msgs if "unique kmers above" in m)
                    .split()[0])
            B = sm.dep.multi_batch
            nb = 1 << (-(-n // B) - 1).bit_length()
            check(nb > 1, f"multi-batch run has nb={nb}")
            print(f"  multi-batch: {n} unique k-mers -> nb={nb} batches",
                  flush=True)
        compare_outputs(ref_out, out, sid)
    # the fallback two-pass path (tally_all_jit + pileup_all_jit scans),
    # which the engine takes when the saved probe would exceed its cap
    cap = engine.PROBE_BYTES_CAP
    engine.PROBE_BYTES_CAP = 0
    try:
        out = sm.path("out_branch_fallback")
        cli_call_warm(sm, "multi-batch, fallback passes (no saved probe)",
                      out, runs[3][1], BRONKO_NO_STREAM="1")
    finally:
        engine.PROBE_BYTES_CAP = cap
    compare_outputs(ref_out, out + "_warm", sid)
    compare_outputs(ref_out, out, sid)
    print("  branches: classic, streamed, device counter, multi-batch and "
          "fallback outputs byte-identical to the call phase", flush=True)

    p1, p2 = data["pairs"]
    out = sm.path("out_pair")
    cli_call_warm(sm, "paired end (-1/-2)", out,
                  ["-d", data["db"], "-1", p1, "-2", p2, "--pileup"])
    compare_outputs(sm.path("cpu", "pair"), out + "_warm", sample_id(p1))
    compare_outputs(sm.path("cpu", "pair"), out, sample_id(p1))
    print("  paired end: byte-identical to the CPU run", flush=True)


def phase_cohort(sm: Smoke, data: dict, ref_out: str) -> None:
    """A 3-sample run_call (prefetch pipeline, stream-first cut, fused
    map) against single-sample runs of the same files."""
    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.device_build import device_build
    from bronko_tpu.index.store import load_index

    reads = data["reads"]
    singles = {reads[0]: ref_out}
    for p in reads[1:]:
        out = sm.path("out_single_" + sample_id(p))
        sm.time(f"call, GPU ({sample_id(p)})",
                cli_call(sm, out, ["-d", data["db"], "-r", p, "--pileup"]))
        singles[p] = out
    index = load_index(data["db"], expect_k=sm.dep.k)
    dev = device_build(index)
    # a first (classic-path) sample sets the rolling lane ratio that
    # enables the fused map
    with env(BRONKO_NO_STREAM="1"):
        run_call(CallConfig(db=data["db"], reads=[reads[0]],
                            output_pileup=True,
                            output=sm.path("out_cohort_seed")), index, dev)
    check(dev.fused_ratio > 0, "the seed run left no fused lane ratio")
    for out, kind in ((sm.path("out_cohort_warm"), "set-up"),
                      (sm.path("out_cohort"), "run")):
        sm.records.clear()
        t0 = time.perf_counter()
        summaries = run_call(CallConfig(db=data["db"], reads=reads,
                                        output_pileup=True, output=out),
                             index, dev)
        sm.time(f"cohort of {len(reads)} (run_call)"
                + (", first run (compiles)" if kind == "set-up" else ""),
                time.perf_counter() - t0, kind)
    check(len(summaries) == len(reads), "cohort lost a sample")
    check(any("(fused)" in m for m in sm.messages()),
          "cohort did not run the fused map")
    rows = {}
    for p, d in singles.items():
        sid = sample_id(p)
        compare_outputs(d, out, sid, files=("{s}.vcf", "{s}.tsv"))
        with open(os.path.join(d, "bronko_overview.tsv")) as fh:
            rows[p] = fh.read().splitlines()[1]
    with open(os.path.join(out, "bronko_overview.tsv")) as fh:
        got = fh.read().splitlines()[1:]
    check(got == [rows[p] for p in reads],
          "cohort overview rows differ from the single-sample runs")
    print("  cohort: per-sample VCF, pileup and overview rows equal the "
          "single-sample runs; fused map ran", flush=True)


def fused_inputs(sm: Smoke, data: dict, dev):
    """Counted batches of the main sample and the fused map's arguments at
    the engine's own budget."""
    from dataclasses import replace

    import jax.numpy as jnp
    import numpy as np

    from bronko_tpu.call.engine import (
        _pass2_budget, _prepare_batches, count_sample,
    )
    from bronko_tpu.config import CallConfig
    from bronko_tpu.ops.map import tally_save_jit

    cfg = CallConfig()
    kmers, counts, _ = count_sample(data["reads"][0], cfg, sm.dep.k)
    kj, cj = _prepare_batches(kmers, counts, cfg.batch_size)
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)
    tj, lane_tot, _, _ = tally_save_jit(
        kj, cj, dev.keys, dev.offsets, dev.hist,
        jnp.zeros((dev.num_genomes, 3), jnp.int32), mcfg)
    best = int(np.argmax(np.asarray(tj)[:, 0]))
    exact = int(np.asarray(lane_tot)[best])
    gcfg = replace(mcfg, total_len=dev.g_total_len,
                   max_bucket=dev.g_max_bucket,
                   lane_budget=_pass2_budget(kj, mcfg, None,
                                             exact * 5 // 4 + 1024))
    post = (dev.postings_local32 if dev.postings_local32 is not None
            else dev.postings)
    args = (kj, cj, dev.keys, dev.offsets, dev.hist, post)
    tail = (jnp.asarray(2 * dev.genome_lens.astype(np.int64)),
            jnp.asarray(dev.file_bases.astype(np.int32)))
    return args, tail, mcfg, gcfg, kmers.shape[0]


def phase_expand_forms(sm: Smoke, data: dict, dev) -> dict:
    """The fused map at the deployment's widths with each _expand_lanes
    form, in turns; outputs must be identical."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bronko_tpu.ops.map as m

    args, tail, mcfg, gcfg, n_kmers = fused_inputs(sm, data, dev)
    G = dev.num_genomes
    fns = {}
    outs = {}
    hlo = {}
    for form, flag in (("merge", "1"), ("scatter", "0")):
        def fused(*a, cfg, gcfg):   # a fresh function: its own trace cache
            return m.map_fused_jit.__wrapped__(*a, cfg=cfg, gcfg=gcfg)

        with env(BRONKO_EXPAND_MERGE=flag):
            m._expand_merge_enabled.cache_clear()
            fns[form] = jax.jit(fused, static_argnames=("cfg", "gcfg"))
            hlo[form] = fns[form].lower(
                *args, jnp.zeros((G, 3), jnp.int32), *tail, cfg=mcfg,
                gcfg=gcfg).as_text()
            t0 = time.perf_counter()
            o = fns[form](*args, jnp.zeros((G, 3), jnp.int32), *tail,
                          cfg=mcfg, gcfg=gcfg)
            jax.block_until_ready(o)
            sm.time(f"fused map, {form} form (first call, compiles)",
                    time.perf_counter() - t0, "set-up")
            outs[form] = [np.asarray(o[i]) for i in (0, 2, 5, 6)]
    m._expand_merge_enabled.cache_clear()
    check(hlo["merge"] != hlo["scatter"], "both forms traced the same program")
    check(not outs["merge"][3], "fused map budget overflowed")
    for a, b in zip(outs["merge"], outs["scatter"]):
        check(np.array_equal(a, b), "expand forms disagree")
    times = {"merge": [], "scatter": []}
    for i in range(sm.dep.form_runs):
        order = ("merge", "scatter") if i % 2 == 0 else ("scatter", "merge")
        for form in order:
            tj = jnp.zeros((G, 3), jnp.int32)
            jax.block_until_ready(tj)
            t0 = time.perf_counter()
            jax.block_until_ready(fns[form](*args, tj, *tail, cfg=mcfg,
                                            gcfg=gcfg))
            times[form].append(time.perf_counter() - t0)
    med = {f: statistics.median(t) for f, t in times.items()}
    for f in ("merge", "scatter"):
        sm.time(f"fused map, {f} form (median of {sm.dep.form_runs})",
                med[f])
    with env(BRONKO_EXPAND_MERGE=None):
        m._expand_merge_enabled.cache_clear()
        default = "merge" if m._expand_merge_enabled() else "scatter"
    print(f"  expand forms: identical pileups and tallies; merge "
          f"{med['merge'] * 1e3:.3f} ms vs scatter "
          f"{med['scatter'] * 1e3:.3f} ms ({n_kmers} unique k-mers); "
          f"faster: {min(med, key=med.get)}, default: {default}",
          flush=True)
    sm.detail["expand_forms_s"] = times
    return med


# ------------------------------------------------------- trace reduction


_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
                "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8,
                "u64": 8, "f64": 8}
_SHAPE = re.compile(r"\b(pred|[suf]\d+|bf16)\[([\d,]*)\]")
_COMP = re.compile(r"^(?:ENTRY\s+)?%([^\s(]+)\s*\(.*\{\s*$")
_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%([^\s=]+)\s*=\s*(.*)$")


def _shape_bytes(shape: str) -> int:
    n = 0
    for dt, dims in _SHAPE.findall(shape):
        size = 1
        for d in filter(None, dims.split(",")):
            size *= int(d)
        n += size * _DTYPE_BYTES[dt]
    return n


def _split_shape(rest: str) -> tuple[str, str]:
    """'(s32[2]{0}, u64[4]{0}) fusion(...)' -> (shape, remainder)."""
    if rest.startswith("("):
        depth = 0
        for i, ch in enumerate(rest):
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if depth == 0:
                return rest[:i + 1], rest[i + 1:].strip()
    shape, _, tail = rest.partition(" ")
    return shape, tail


def scope_fusions(hlo_text: str, scope: str) -> dict[str, int]:
    """Fusions of an optimized HLO module that hold an instruction from
    jax.named_scope(scope), with the bytes each reads and writes (its
    operands' and its result's shapes)."""
    comps: dict[str, list[str]] = {}
    cur = None
    for line in hlo_text.splitlines():
        m = _COMP.match(line)
        if m:
            cur = m.group(1)
            comps[cur] = []
        elif line.startswith("}"):
            cur = None
        elif cur is not None:
            comps[cur].append(line)
    sizes: dict[str, int] = {}
    fusions: list[tuple[str, str, list[str]]] = []
    for lines in comps.values():
        for line in lines:
            m = _INSTR.match(line)
            if not m:
                continue
            name, rest = m.groups()
            shape, tail = _split_shape(rest)
            sizes[name] = _shape_bytes(shape)
            if tail.startswith("fusion("):
                called = re.search(r"calls=%([\w.\-]+)", tail)
                operands = re.findall(r"%([\w.\-]+)",
                                      tail[:tail.find(")")])
                if called:
                    fusions.append((name, called.group(1), operands))

    def in_scope(comp: str, seen=()) -> bool:
        for line in comps.get(comp, []):
            op = re.search(r'op_name="([^"]*)"', line)
            if op and scope in op.group(1).split("/"):
                return True
            sub = re.search(r"calls=%([\w.\-]+)", line)
            if sub and sub.group(1) not in seen and in_scope(
                    sub.group(1), seen + (comp,)):
                return True
        return False

    return {name: sizes[name] + sum(sizes.get(o, 0) for o in ops)
            for name, comp, ops in fusions if in_scope(comp)}


def _kernel_key(name: str) -> str:
    # XLA names a fusion's GPU kernel after the fusion, with '.' and '-'
    # sanitized to '_'
    return re.sub(r"[.\-]", "_", name)


def device_events(trace_dir: str) -> list[tuple[str, str, float]]:
    """(kernel name, hlo_op stat, seconds) of every event on the GPU
    planes of a jax.profiler trace. Kernels replayed from a CUDA graph
    keep their own names but may carry the graph's hlo_op, so callers
    match on both."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True))
    check(bool(paths), f"no trace written under {trace_dir}")
    out = []
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith(DEVICE_PLANE):
            continue
        for line in plane.lines:
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op", "")
                out.append((ev.name, str(op), ev.duration_ns * 1e-9))
    check(bool(out), f"no device events in the trace under {trace_dir}")
    return out


def trace_share(sm: Smoke, label: str, fn, make_args, static: dict,
                scope: str, runs: int) -> dict:
    """Device time and achieved bandwidth of the fusions of the jitted
    `fn` that come from jax.named_scope(scope), read from a profiler
    trace of `runs` calls (make_args() gives fresh, undonated inputs)."""
    import jax

    args = make_args()
    fusions = scope_fusions(fn.lower(*args, **static).compile().as_text(),
                            scope)
    check(bool(fusions), f"{label}: no fusion carries scope {scope!r}")
    jax.block_until_ready(fn(*args, **static))
    calls = [make_args() for _ in range(runs)]
    jax.block_until_ready(calls)
    trace_dir = sm.path("trace_" + scope)
    with jax.profiler.trace(trace_dir):
        for a in calls:
            jax.block_until_ready(fn(*a, **static))
    # only fn runs inside the window: every device event is its own
    events = device_events(trace_dir)
    keys = {_kernel_key(f) for f in fusions}
    total = sum(t for _, _, t in events) / runs
    t = sum(dt for name, op, dt in events
            if _kernel_key(name) in keys or _kernel_key(op) in keys) / runs
    if t <= 0:
        sample = sorted({(n[:60], o) for n, o, _ in events})[:60]
        raise SmokeFailure(f"{label}: the trace holds none of "
                           f"{sorted(fusions)}; events: {sample}")
    moved = sum(fusions.values())
    roof = moved / HBM_BYTES_PER_S / t
    res = dict(device_s=t, module_device_s=total, share_of_module=t / total,
               bytes=moved, bandwidth_share=roof, fusions=sorted(fusions))
    sm.detail.setdefault("trace", {})[label] = res
    print(f"  {label}: {len(fusions)} fusions, {t * 1e6:.1f} us of "
          f"{total * 1e6:.1f} us device time ({100 * t / total:.1f}%), "
          f"{moved / 1e6:.2f} MB -> {100 * roof:.1f}% of 3.35 TB/s "
          f"[{sm.card}]", flush=True)
    return res


def phase_trace(sm: Smoke, data: dict, dev) -> None:
    """Probe front end (inside the fused map) and the device counter's
    window pack, read from short profiler traces."""
    import jax.numpy as jnp
    import numpy as np

    from bronko_tpu.config import CallConfig
    from bronko_tpu.io.native import native_read_fastq_chunks
    from bronko_tpu.ops.count import WINDOW_PACK_SCOPE, extract_and_count_chunk
    from bronko_tpu.ops.map import PROBE_FRONT_END_SCOPE, map_fused_jit

    args, tail, mcfg, gcfg, _ = fused_inputs(sm, data, dev)
    G = dev.num_genomes
    front = trace_share(
        sm, "probe front end", map_fused_jit,
        lambda: (*args, jnp.zeros((G, 3), jnp.int32), *tail),
        dict(cfg=mcfg, gcfg=gcfg), PROBE_FRONT_END_SCOPE, sm.dep.trace_runs)
    cfg = CallConfig()
    codes, lengths, n = next(native_read_fastq_chunks(
        data["reads"][0], cfg.chunk_reads, max_len=512))
    L = -(-int(lengths[:n].max()) // 32) * 32
    codes = jnp.asarray(np.ascontiguousarray(codes[:, :L]))
    lengths = jnp.asarray(lengths)
    pack = trace_share(
        sm, "window pack", extract_and_count_chunk, lambda: (codes, lengths),
        dict(k=sm.dep.k), WINDOW_PACK_SCOPE, sm.dep.trace_runs)
    rule = {label: r["bandwidth_share"] < 0.5 and r["share_of_module"] > 0.1
            for label, r in (("probe front end", front),
                             ("window pack", pack))}
    sm.detail["kernel_rule"] = rule
    print(f"  kernel candidates (bandwidth share < 50% and > 10% of the "
          f"module's device time): {rule}", flush=True)


# ---------------------------------------------------------------- phase 8


def phase_chip_tests(sm: Smoke) -> None:
    import pytest

    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "chip", "--noconftest", "-p",
                      "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(REPO, "tests", "test_chip.py")])
    sm.time("tests marked chip (pytest, in-process)",
            time.perf_counter() - t0)
    check(rc == 0, f"chip tests failed (pytest exit {rc})")


# ------------------------------------------------------------- four GPUs


def phase_mesh(sm: Smoke, data: dict) -> None:
    """--mesh 4x1, --mesh 2x2 and a batchwise 4x1 (small --batch-size)
    against the single-device run of the same sample, in one process."""
    import numpy as np

    import bronko_tpu.call.engine as engine
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.layout import build_device_index
    from bronko_tpu.index.store import load_index

    s0 = data["reads"][0]
    sid = sample_id(s0)
    call = ["-d", data["db"], "-r", s0, "--pileup"]
    single = sm.path("mesh_single")
    cli_call_warm(sm, "single device", single, call)
    runs = (("4x1", []), ("2x2", []),
            ("4x1", ["--batch-size", str(sm.dep.multi_batch)]))
    layouts = {}
    for i, (mesh, extra) in enumerate(runs):
        out = sm.path(f"mesh_{i}")
        name = f"--mesh {mesh} {' '.join(extra)}".strip()
        cli_call_warm(sm, name, out, call + ["--mesh", mesh] + extra)
        layouts[name] = sorted(engine.LAST_MESH_LAYOUTS)
        print(f"  {name}: layouts {'+'.join(layouts[name])}", flush=True)
        compare_outputs(single, out, sid)
    check("batchwise" in layouts[list(layouts)[-1]],
          "the small --batch-size run did not take the batchwise layout")
    sm.detail["mesh_layouts"] = layouts
    print("  mesh: VCF, pileup and overview byte-identical across "
          "single-device, 4x1, 2x2 and batchwise", flush=True)

    index = load_index(data["db"], expect_k=sm.dep.k)
    dev = build_device_index(index)
    kmers = np.arange(1, 4 * 4096 + 1, dtype=np.uint64)
    counts = np.full(kmers.shape, 3, np.int32)
    for mesh in ("4x1", "2x2"):
        mapper = engine.ShardedMapper(index, CallConfig(mesh=mesh), dev)
        kj, cj = engine._prepare_batches(kmers, counts, 4096, upload=False,
                                         multiple=4)
        placed = mapper.place_batches(kj, cj)
        for name, arr in (("keys", mapper.keys), ("offsets", mapper.offsets),
                          ("postings", mapper.postings),
                          ("hist", mapper.hist), ("batches", placed[0])):
            n = len({sh.device for sh in arr.addressable_shards})
            check(n == 4, f"--mesh {mesh}: {name} spans {n} devices, not 4")
        print(f"  --mesh {mesh}: index shards and placed batches span 4 "
              "devices", flush=True)


# ------------------------------------------------------------------- main


def finish(sm: Smoke, devs) -> None:
    import jax

    peak = [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in devs]
    sm.detail["peak_bytes_in_use"] = peak
    print("  peak device memory (peak_bytes_in_use): " + ", ".join(
        "not reported" if p is None else f"{p / 2**30:.3f} GiB"
        for p in peak) + f"  [{sm.card}]", flush=True)
    sm.detail["timings"] = sm.timings
    with open(sm.path("smoke_detail.json"), "w") as fh:
        json.dump(sm.detail, fh, indent=1, default=str)
    for line in card_lines():
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the --mesh phase, on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO)
    import jax

    import bronko_tpu  # noqa: F401  (x64, compilation cache)

    devs = check_device(4 if args.four_gpus else 1)
    if args.four_gpus:
        devs = devs[:4]
    cards = card_lines()
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind} "
          f"({devs[0].platform})", flush=True)
    for line in cards:
        print(line, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    sm = Smoke(Deployment(), WORK, cards[0])
    print("native:", flush=True)
    rebuild_native(sm)
    print("  native library rebuilt from source; counter: host (C++)",
          flush=True)
    print("data:", flush=True)
    if args.four_gpus:
        data = make_data(sm, samples=1)
        print("mesh:", flush=True)
        phase_mesh(sm, data)
        finish(sm, devs)
        return 0
    data = make_data(sm, samples=sm.dep.cohort)
    print("cpu reference:", flush=True)
    s0, (p1, p2) = data["reads"][0], data["pairs"]
    cpu_reference(sm, [
        ["call", "-d", data["db"], "-r", s0, "--pileup", "-o",
         sm.path("cpu", "call")],
        ["call", "-d", data["db"], "-1", p1, "-2", p2, "--pileup", "-o",
         sm.path("cpu", "pair")],
    ])
    print("index:", flush=True)
    index, dev = phase_index(sm, data)
    print("call:", flush=True)
    ref_out = phase_call(sm, data, index, dev)
    print("branches:", flush=True)
    phase_branches(sm, data, ref_out)
    phase_cohort(sm, data, ref_out)
    phase_expand_forms(sm, data, dev)
    print("trace:", flush=True)
    phase_trace(sm, data, dev)
    print("chip tests:", flush=True)
    phase_chip_tests(sm)
    print("timings:", flush=True)
    finish(sm, devs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
