"""Benchmark: end-to-end reads/s on a deep-coverage SARS-CoV-2-scale sample.

Builds a 4-genome synthetic panel (29,900 bp each, k = 21), generates three
deep-coverage FASTQs with planted variants (cached under .bench_cache/),
runs the full call pipeline (count -> map -> select -> call -> VCF), and
prints ONE JSON line:

  {"metric": "reads_per_sec", "value": N, "unit": "reads/s",
   "vs_baseline": r, "device": {...}, "detail": {...}}

`device` names the platform, device kind and count JAX reports, and the
card's name and power limit from nvidia-smi where there is one.
vs_baseline is MEASURED: the identical pipeline is first run in a separate
process on the host CPU (XLA CPU backend, same code, same input), and
vs_baseline = reads_per_sec / host_reads_per_sec. The reference publishes no
numeric baseline (BASELINE.md).

detail carries per-stage times of one instrumented single-sample pass
(count_s host C++, h2d_s upload, tally_s / pileup_s device passes, each
ended by block_until_ready, call_s host f64 caller), the fused single-
dispatch map, a 15-sample cohort, and an interleaved classic-vs-streamed
single-sample A/B. A CPU-mesh subprocess (8 virtual devices) times the
ShardedMapper at 1..8 devices. Full detail goes to
.bench_cache/BENCH_DETAIL.json.

Which metrics, cells, statistics and spans the benchmark keeps is ROADMAP
item 1.1.

Run modes (internal): `bench.py --host-baseline` and `bench.py
--scale-proxy` are the subprocess entry points; both print one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, ".bench_cache")
N_GENOMES = 4
GENOME_LEN = 29_900
N_READS = 300_000
READ_LEN = 150
SEED = 2024


def _synth():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bronko_bench_synth", os.path.join(REPO, "tests", "make_synthetic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ensure_data():
    os.makedirs(CACHE, exist_ok=True)
    syn = _synth()
    rng = np.random.default_rng(SEED)
    genome_paths, genomes = [], []
    for g in range(N_GENOMES):
        seq = syn.make_genome(rng, GENOME_LEN)
        p = os.path.join(CACHE, f"synth{g}.fasta")
        if not os.path.exists(p):
            syn.write_fasta(p, f"synth{g}", seq)
        genome_paths.append(p)
        genomes.append(seq)
    # three DISTINCT samples (different read draws + planted variants) so
    # batch mode measures a real cohort, not a page-cache-warm re-read of
    # one file; identical N_READS keeps batch shapes (and therefore
    # compiled executables) shared across samples
    fastqs = []
    for s in range(3):
        fastq = os.path.join(CACHE, f"deep_{N_READS}_s{s}.fastq.gz")
        fastqs.append(fastq)
        planted = syn.plant_variants(genomes[0], rng, 8, 12)
        reads = syn.make_reads(genomes[0], rng, N_READS, READ_LEN, planted,
                               error_rate=0.003)
        if not os.path.exists(fastq):
            syn.write_fastq_array(fastq, reads)
    return genome_paths, fastqs


def _device_info() -> dict:
    import jax

    devs = jax.devices()
    info = dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))
    if devs[0].platform == "gpu":
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        info["cards"] = r.stdout.strip().splitlines()
    return info


def _single_sample_run(index, dev, cfg, fastq):
    """One full single-sample pipeline pass with per-stage timings, each
    stage ended by block_until_ready."""
    import jax
    import jax.numpy as jnp

    from bronko_tpu.call.engine import (
        _prepare_batches, call_sample_variants, count_sample,
        pick_best_genome, run_pileup_saved,
    )
    from bronko_tpu.ops.map import tally_save_jit

    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)

    t_start = time.perf_counter()
    kmers, counts, cstats = count_sample(fastq, cfg, index.k)
    t_count = time.perf_counter()

    kj, cj = jax.block_until_ready(
        _prepare_batches(kmers, counts, cfg.batch_size))
    h2d_bytes = kj.size * 8 + cj.size * 4
    t_h2d = time.perf_counter()
    tj = jnp.zeros((dev.num_genomes, 3), jnp.int32)
    tj, lane_tot, ii_all, h_all = jax.block_until_ready(tally_save_jit(
        kj, cj, dev.keys, dev.offsets, dev.hist, tj, mcfg))
    t_tally = time.perf_counter()

    tallies = np.asarray(tj).astype(np.int64)
    best = pick_best_genome(tallies, dev)
    pileup = jax.block_until_ready(run_pileup_saved(
        kj, cj, (ii_all, h_all), dev, best, mcfg, n_kmers=kmers.shape[0],
        exact_lanes=int(np.asarray(lane_tot)[best])))
    t_pileup = time.perf_counter()

    records, stats, _ = call_sample_variants(index, dev, cfg, best, pileup)
    t_call = time.perf_counter()

    # the fused single dispatch (cohort samples 2+): both passes + device
    # genome selection with the rolling static budget; best-of-3
    from dataclasses import replace

    from bronko_tpu.call.engine import _pass2_budget
    from bronko_tpu.ops.map import map_fused_jit

    exact = int(np.asarray(lane_tot)[best])
    budget = _pass2_budget(kj, mcfg, None, exact * 5 // 4 + 1024)
    gcfg = replace(mcfg, total_len=dev.g_total_len,
                   max_bucket=dev.g_max_bucket, lane_budget=budget)
    glen2 = jnp.asarray(2 * np.asarray(dev.genome_lens, np.int64))
    fbases = jnp.asarray(np.asarray(dev.file_bases, np.int32))
    post = (dev.postings_local32 if dev.postings_local32 is not None
            else dev.postings)
    fused_map_s = float("inf")
    for rep in range(4):  # rep 0 compiles
        tj0 = jax.block_until_ready(jnp.zeros((dev.num_genomes, 3),
                                              jnp.int32))
        t0f = time.perf_counter()
        outf = jax.block_until_ready(map_fused_jit(
            kj, cj, dev.keys, dev.offsets, dev.hist, post, tj0, glen2,
            fbases, mcfg, gcfg))
        if rep:
            fused_map_s = min(fused_map_s, time.perf_counter() - t0f)
    assert not int(np.asarray(outf[6])), "fused bench budget overflow"

    return dict(
        reads=cstats.total_reads,
        unique=cstats.unique_counted_kmers,
        n_variants=len(records),
        count_s=t_count - t_start,
        h2d_s=t_h2d - t_count,
        fused_map_s=fused_map_s,
        tally_s=t_tally - t_h2d,
        pileup_s=t_pileup - t_tally,
        call_s=t_call - t_pileup,
        total_s=t_call - t_start,
        h2d_bytes=h2d_bytes,
    )


def _pipeline_main():
    """Shared body for the device run and the --host-baseline run."""
    genome_paths, fastqs = _ensure_data()
    fastq = fastqs[0]

    import bronko_tpu  # noqa: F401

    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    cfg = CallConfig(db="bench", reads=[fastq], output=os.path.join(CACHE, "out"))
    os.makedirs(cfg.output, exist_ok=True)

    t0 = time.perf_counter()
    index = build_index(cfg.kmer, genome_paths)
    dev = build_device_index(index)
    build_s = time.perf_counter() - t0

    assert dev.hist is not None and dev.fid_grouped, "bench expects a small panel"

    warm = _single_sample_run(index, dev, cfg, fastq)  # compile warmup
    r = min((_single_sample_run(index, dev, cfg, fastq) for _ in range(3)),
            key=lambda d: d["total_s"])

    # production batch mode: host counting of sample i+1 overlaps device
    # mapping of sample i (run_call's prefetch pipeline) over a FIFTEEN-
    # sample cohort — three distinct samples x five file copies each, so
    # the pipeline runs FILLED for nearly the whole cohort. Copies repeat
    # content but not work: counting/mapping recompute per file, and the
    # host baseline subprocess runs the identical 15-sample discipline, so
    # the ratio stays like-for-like.
    import shutil

    cohort = []
    for c in range(5):
        for s, fq_i in enumerate(fastqs):
            p = os.path.join(CACHE, f"bcohort_{c}_{s}.fastq.gz")
            if not os.path.exists(p):
                shutil.copy(fq_i, p)
            cohort.append(p)
    bcfg = CallConfig(genomes=None, db="bench", reads=cohort,
                      output=os.path.join(CACHE, "out_batch"))
    batch_s = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        summaries = run_call(bcfg, index, dev)
        batch_s = min(batch_s, time.perf_counter() - t0)

    # single-sample e2e: classic vs streamed run_call, INTERLEAVED so
    # drift hits both sides. The measured pair is SAVED as this host's
    # outcome calibration so the engine's auto gate picks by measured wall
    # time, and a final auto-gated run records what a user actually gets.
    from bronko_tpu.call.engine import _can_stream, save_stream_calibration

    scfg = CallConfig(db="bench", reads=[fastq],
                      output=os.path.join(CACHE, "out_stream"))

    def _timed_run(**env):
        saved = {k: os.environ.pop(k, None)
                 for k in ("BRONKO_STREAM", "BRONKO_NO_STREAM")}
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            run_call(scfg, index, dev)
            return time.perf_counter() - t0
        finally:
            for k in ("BRONKO_STREAM", "BRONKO_NO_STREAM"):
                os.environ.pop(k, None)
                if saved.get(k) is not None:
                    os.environ[k] = saved[k]

    _timed_run(BRONKO_NO_STREAM="1")   # warm classic-path compiles
    _timed_run(BRONKO_STREAM="1")      # warm streamed-path compiles
    classic_e2e_s = stream_s = float("inf")
    for _ in range(3):
        classic_e2e_s = min(classic_e2e_s, _timed_run(BRONKO_NO_STREAM="1"))
        stream_s = min(stream_s, _timed_run(BRONKO_STREAM="1"))
    save_stream_calibration(classic_e2e_s, stream_s)
    gate_streams = _can_stream(scfg, dev, None)
    gated_s = _timed_run()             # what the auto gate now delivers
    reads_per_sec = r["reads"] * len(summaries) / batch_s

    return dict(
        device=_device_info(),
        build_s=build_s,
        warm_total_s=warm["total_s"],
        reads=r["reads"],
        unique_kmers=r["unique"],
        n_variants=r["n_variants"],
        single=dict(
            count_s=r["count_s"],
            h2d_s=r["h2d_s"],
            tally_s=r["tally_s"],
            pileup_s=r["pileup_s"],
            fused_map_s=r["fused_map_s"],
            call_s=r["call_s"],
            total_s=r["total_s"],
            reads_per_sec=r["reads"] / r["total_s"],
            e2e_classic_s=classic_e2e_s,
            streamed_total_s=stream_s,
            gated_total_s=gated_s,
            gated_reads_per_sec=r["reads"] / gated_s,
            gate_decision="streamed" if gate_streams else "classic",
        ),
        batch=dict(n=len(cohort), best_s=batch_s,
                   reads_per_sec=reads_per_sec),
        h2d_bytes=r["h2d_bytes"],
    )


def host_baseline_mode() -> None:
    out = _pipeline_main()
    print(json.dumps({"host_reads_per_sec": out["batch"]["reads_per_sec"],
                      "host_single_reads_per_sec": out["single"]["reads_per_sec"],
                      "device": out["device"]}))


def scale_proxy_mode() -> None:
    """CPU-mesh scaling proxy: the product ShardedMapper (tally + pileup)
    at 1 vs 8 virtual devices on the same counted k-mer workload."""
    genome_paths, fastqs = _ensure_data()
    fastq = fastqs[0]

    import bronko_tpu  # noqa: F401
    import jax

    from bronko_tpu.call.engine import (
        ShardedMapper, _prepare_batches, count_sample, pick_best_genome,
    )
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    n_dev = len(jax.devices())
    index = build_index(21, genome_paths)
    dev = build_device_index(index)
    cfg = CallConfig(db="bench", reads=[fastq], output=os.path.join(CACHE, "out_scale"))
    kmers, counts, cstats = count_sample(fastq, cfg, index.k)
    kj, cj = _prepare_batches(kmers, counts, cfg.batch_size)
    mcfg = dev.map_config(cfg.n_fixed, cfg.use_full_kmer)

    def timed(mesh: str, force_bsplit: bool = False) -> float:
        scfg = CallConfig(db="bench", reads=[fastq], mesh=mesh,
                          output=cfg.output, batch_size=cfg.batch_size)
        mapper = ShardedMapper(index, scfg, dev)
        if force_bsplit:
            mapper._routed_wins = lambda kj: False
        t_best = float("inf")
        for _ in range(3):  # first run compiles
            t0 = time.perf_counter()
            tallies = mapper.run_tallies(kj, cj)
            best = pick_best_genome(tallies, dev)
            jax.block_until_ready(mapper.run_pileup(
                kj, cj, dev, best, mcfg, n_kmers=kmers.shape[0]))
            t_best = min(t_best, time.perf_counter() - t0)
        return t_best

    n_cores = os.cpu_count() or 1
    t1 = timed("1x1")
    curve = {1: t1}
    curve_bs = {1: t1}
    n = 2
    while n <= n_dev:
        # the engine's own layout choice AND forced B-split: routed's
        # grouping / routing / unroute machinery is absolute extra work
        # that pays only on parallel hardware
        curve[n] = timed(f"{n}x1")
        curve_bs[n] = timed(f"{n}x1", force_bsplit=True)
        n *= 2
    # virtual CPU devices share the host cores: points past n_cores are
    # core-bound, so the headline efficiency is read at min(n_dev, n_cores)
    # devices over the best layout at that point
    n_eff = max(n for n in curve if n <= max(1, n_cores))
    t_eff = min(curve[n_eff], curve_bs[n_eff])
    print(json.dumps({
        "device": _device_info(),
        "devices": n_dev,
        "cores": n_cores,
        "kmers": int(kmers.shape[0]),
        "map_s": {str(n): t for n, t in curve.items()},
        "map_s_bsplit": {str(n): t for n, t in curve_bs.items()},
        "efficiency_at_cores": t1 / (n_eff * t_eff),
        "efficiency_note": (
            f"virtual CPU devices share {n_cores} host cores; this says "
            "nothing about a GPU mesh"),
    }))


def _run_subprocess(args: list[str], env_extra: dict[str, str], timeout: int):
    env = dict(os.environ, **env_extra)
    r = subprocess.run([sys.executable, os.path.abspath(__file__), *args],
                       capture_output=True, text=True, timeout=timeout, env=env)
    if r.returncode != 0:
        print(f"# subprocess {args} failed:\n{r.stderr[-2000:]}", file=sys.stderr)
        return None
    try:
        return json.loads(r.stdout.strip().splitlines()[-1])
    except Exception:  # noqa: BLE001
        print(f"# subprocess {args} emitted no JSON:\n{r.stdout[-500:]}",
              file=sys.stderr)
        return None


def main() -> None:
    # the CPU subprocesses run FIRST and sequentially, pinned to the host
    # CPU, so they never contend with this process for the device
    _ensure_data()  # generate fixtures once, before any timing
    host = _run_subprocess(["--host-baseline"], {"JAX_PLATFORMS": "cpu"},
                           timeout=3600)
    scale = _run_subprocess(
        ["--scale-proxy"],
        {"JAX_PLATFORMS": "cpu",
         "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "") +
                       " --xla_force_host_platform_device_count=8").strip()},
        timeout=3600,
    )

    out = _pipeline_main()
    reads_per_sec = out["batch"]["reads_per_sec"]
    host_rps = host["host_reads_per_sec"] if host else None
    vs_baseline = reads_per_sec / host_rps if host_rps else None

    full_detail = {
        "kind": "bench_full_detail",
        "device": out["device"],
        "baseline": {
            "kind": "measured_host_cpu_same_pipeline",
            "host_reads_per_sec": host_rps,
            "host_single_reads_per_sec":
                host.get("host_single_reads_per_sec") if host else None,
        },
        "build_s": out["build_s"],
        "warm_total_s": out["warm_total_s"],
        "single_sample": out["single"],
        "batch": out["batch"],
        "h2d_bytes": out["h2d_bytes"],
        "scaling_proxy_cpu_mesh": scale,
        "reads": out["reads"],
        "unique_kmers": out["unique_kmers"],
        "n_variants": out["n_variants"],
    }
    print(json.dumps(full_detail), flush=True)
    with open(os.path.join(CACHE, "BENCH_DETAIL.json"), "w") as f:
        json.dump(full_detail, f, indent=1)

    print(json.dumps({
        "metric": "reads_per_sec",
        "value": reads_per_sec,
        "unit": "reads/s",
        "vs_baseline": vs_baseline,
        "device": out["device"],
        "detail": {
            "host_baseline_reads_per_sec": host_rps,
            "batch": out["batch"],
            "single_total_s": out["single"]["gated_total_s"],
            "single_gate": out["single"]["gate_decision"],
            "stages_s": {k: out["single"].get(f"{k}_s") for k in
                         ("count", "h2d", "tally", "pileup", "fused_map",
                          "call")},
            "full_detail": "previous stdout line + .bench_cache/BENCH_DETAIL.json",
        },
    }))


if __name__ == "__main__":
    if "--host-baseline" in sys.argv:
        host_baseline_mode()
    elif "--scale-proxy" in sys.argv:
        scale_proxy_mode()
    else:
        main()
