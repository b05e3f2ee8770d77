"""Multi-host execution test (SURVEY §4/§5 plans).

Simulates a 2-host cluster: two subprocesses, each with 4 virtual CPU
devices, joined via jax.distributed (Gloo collectives) into one 8-device
runtime. Both run the PRODUCT engine (`run_call --mesh 4x2`); process 0
writes outputs. The files must be byte-identical to a single-process
single-device run of the same sample.

The worker re-execs this file (`python test_distributed.py worker <rank>`)
so each process owns a fresh JAX runtime pinned to the CPU.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
PORT = 29817


def _make_inputs(tmp: str):
    sys.path.insert(0, REPO)
    from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq

    rng = np.random.default_rng(59)
    genome = make_genome(rng, 1200)
    reads, _ = make_sample(genome, rng, read_len=80, depth=150,
                           major_positions={350: 0.9}, minor_positions={},
                           error_rate=0.003)
    ref = os.path.join(tmp, "ref.fasta")
    fq = os.path.join(tmp, "samp.fastq.gz")
    write_fasta(ref, "dref", genome)
    write_fastq(fq, reads)
    return ref, fq


def _worker(rank: int) -> None:
    tmp = os.environ["BRONKO_TEST_TMP"]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT}",
        num_processes=2, process_id=rank)
    import bronko_tpu  # noqa: F401  (x64 on, AFTER distributed init)
    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    assert jax.device_count() == 8 and jax.local_device_count() == 4
    ref = os.path.join(tmp, "ref.fasta")
    fq = os.path.join(tmp, "samp.fastq.gz")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    cfg = CallConfig(genomes=[ref], reads=[fq],
                     output=os.path.join(tmp, "out_dist"),
                     mesh="4x2", batch_size=4096, chunk_reads=8192,
                     output_pileup=True)
    summaries = run_call(cfg, index, dev)
    assert summaries and summaries[0].n_perfect > 0
    print(f"worker {rank} ok: {summaries[0].n_perfect} perfect", flush=True)


def test_two_process_engine_byte_identical(tmp_path):
    tmp = str(tmp_path)
    ref, fq = _make_inputs(tmp)

    # single-process single-device baseline
    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(CallConfig(genomes=[ref], reads=[fq],
                        output=os.path.join(tmp, "out_single"),
                        batch_size=4096, chunk_reads=8192,
                        output_pileup=True), index, dev)

    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               BRONKO_TEST_TMP=tmp, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, HERE, "worker", str(rank)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {rank} failed:\n{out[-4000:]}"
        assert f"worker {rank} ok" in out

    for fname in ("samp.vcf", "bronko_overview.tsv", "samp.tsv"):
        a = open(os.path.join(tmp, "out_single", fname)).read()
        b = open(os.path.join(tmp, "out_dist", fname)).read()
        assert a == b, fname


def _make_cohort(tmp: str) -> list[str]:
    sys.path.insert(0, REPO)
    from tests.make_synthetic import make_genome, make_sample, write_fasta, write_fastq

    rng = np.random.default_rng(61)
    genome = make_genome(rng, 1200)
    ref = os.path.join(tmp, "cref.fasta")
    write_fasta(ref, "cref", genome)
    fqs = []
    for i in range(4):
        reads, _ = make_sample(genome, rng, read_len=80, depth=140,
                               major_positions={250 + 90 * i: 0.9},
                               error_rate=0.003)
        p = os.path.join(tmp, f"cs{i}.fastq.gz")
        write_fastq(p, reads)
        fqs.append(p)
    return fqs


def _worker_shard(rank: int) -> None:
    tmp = os.environ["BRONKO_TEST_TMP"]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{PORT + 1}",
        num_processes=2, process_id=rank)
    import bronko_tpu  # noqa: F401
    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    ref = os.path.join(tmp, "cref.fasta")
    fqs = [os.path.join(tmp, f"cs{i}.fastq.gz") for i in range(4)]
    cfg = CallConfig(genomes=[ref], reads=fqs,
                     output=os.path.join(tmp, "out_shard"),
                     shard_samples=True, batch_size=4096, chunk_reads=8192)
    index = build_index(21, [ref])
    summaries = run_call(cfg, index, build_device_index(index))
    # after the gather every process holds the GLOBAL summary list
    assert len(summaries) == 4, len(summaries)
    print(f"shard worker {rank} ok: {len(summaries)} summaries", flush=True)


def test_sample_sharded_cohort_byte_identical(tmp_path):
    """--shard-samples: two processes each own two of four samples (no
    mesh, zero per-sample collectives); the union of per-process VCFs and
    the rank-0 overview must be byte-identical to one process running the
    whole cohort."""
    tmp = str(tmp_path)
    fqs = _make_cohort(tmp)

    from bronko_tpu.call.engine import run_call
    from bronko_tpu.config import CallConfig
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index

    ref = os.path.join(tmp, "cref.fasta")
    index = build_index(21, [ref])
    dev = build_device_index(index)
    run_call(CallConfig(genomes=[ref], reads=fqs,
                        output=os.path.join(tmp, "out_cohort_single"),
                        batch_size=4096, chunk_reads=8192), index, dev)

    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               BRONKO_TEST_TMP=tmp, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, HERE, "shard_worker", str(rank)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"shard worker {rank} failed:\n{out[-4000:]}"
        assert f"shard worker {rank} ok" in out

    names = [f"cs{i}.vcf" for i in range(4)] + ["bronko_overview.tsv"]
    for fname in names:
        a = open(os.path.join(tmp, "out_cohort_single", fname)).read()
        b = open(os.path.join(tmp, "out_shard", fname)).read()
        assert a == b, fname


if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "worker":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[2]))
if __name__ == "__main__" and len(sys.argv) > 1 and sys.argv[1] == "shard_worker":
    sys.path.insert(0, REPO)
    _worker_shard(int(sys.argv[2]))
