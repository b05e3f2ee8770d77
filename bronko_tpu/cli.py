"""Command-line interface: `bronko-tpu build` / `bronko-tpu call`.

Flag names and defaults mirror the reference CLI (cli.rs:29-166) for drop-in
compatibility; device knobs (batch size, chunking, mesh) are additive.
"""

from __future__ import annotations

import argparse
import sys
import time

from bronko_tpu import consts
from bronko_tpu.config import BuildConfig, CallConfig, setup_logging


def _add_common(p: argparse.ArgumentParser) -> None:
    # clap propagates --version to subcommands (cli.rs:17 propagate_version)
    p.add_argument("-V", "--version", action="version",
                   version=f"bronko-tpu {consts.BRONKO_TPU_VERSION}")
    p.add_argument("-t", "--threads", type=int, default=4, help="Number of threads")
    p.add_argument("--debug", action="store_true", help="Debug output")
    p.add_argument("--verbose", action="store_true", help="Verbose output")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bronko-tpu",
        description="Ultra-rapid mapping-free viral variant calling on an accelerator",
    )
    # clap's #[command(version)] surface (cli.rs:16)
    ap.add_argument("-V", "--version", action="version",
                    version=f"bronko-tpu {consts.BRONKO_TPU_VERSION}")
    sub = ap.add_subparsers(dest="mode", required=True)

    b = sub.add_parser("build", help="Create a bronko index of viral references")
    b.add_argument("-g", "--genomes", nargs="+", action="extend", default=[],
                   help="Genome files to be built into index (fasta/gzip)")
    b.add_argument("-k", "--kmer-size", dest="kmer", type=int,
                   default=consts.DEFAULT_KMER_SIZE, help="Kmer size")
    b.add_argument("-o", "--output", default=consts.DEFAULT_INDEX_OUTPUT,
                   help="Name of index file (.bkdb will be added)")
    b.add_argument("--format", dest="bkdb_format", choices=("npz", "bincode"),
                   default="npz",
                   help="Database format: npz (bronko-tpu native, "
                        "device-ready) or bincode (readable by the "
                        "reference bronko binary; bronko-tpu reads both)")
    _add_common(b)

    c = sub.add_parser("call", help="Perform rapid viral variant calling")
    c.add_argument("-g", "--genomes", nargs="+", action="extend", default=None,
                   help="Genome fasta(.gz) files to use as references")
    c.add_argument("-d", "--db", default=None, help="Use a prebuilt bronko db (.bkdb)")
    c.add_argument("-r", "--reads", nargs="+", action="extend", default=[],
                   help="Input single-end reads (fastq/gzip)")
    c.add_argument("-1", "--first-pairs", dest="first_pairs", nargs="+", action="extend", default=[],
                   help="First pairs for raw paired-end reads (fastq/gzip)")
    c.add_argument("-2", "--second-pairs", dest="second_pairs", nargs="+", action="extend", default=[],
                   help="Second pairs for raw paired-end reads (fastq/gzip)")
    c.add_argument("-k", "--kmer-size", dest="kmer", type=int,
                   default=consts.DEFAULT_KMER_SIZE, help="Kmer size used for analysis")
    c.add_argument("--min-kmers", type=int, default=consts.MIN_KMER_COUNT,
                   help="Minimum times a kmer must occur in sequencing data to be used")
    c.add_argument("--use-full-kmer", action="store_true",
                   default=consts.DEFAULT_USE_FULL_KMER,
                   help="Use the entire kmer length for variant positions")
    c.add_argument("--n-fixed", type=int, default=consts.DEFAULT_N_FIXED,
                   help="Number of fixed positions at each end of the kmer")
    c.add_argument("--min-af", type=float, default=consts.DEFAULT_MIN_AF,
                   help="Minimum minor allele frequency to be reported")
    c.add_argument("--no-end-filter", action="store_true",
                   default=consts.DEFAULT_NO_FILTER_ENDS,
                   help="Do not filter variants from the ends of each segment")
    c.add_argument("--no-strand-filter", action="store_true",
                   default=consts.DEFAULT_NO_STRAND_FILTER,
                   help="Do not use the SOR strand filter")
    c.add_argument("--no-strand-balance-filter", action="store_true",
                   default=consts.DEFAULT_NO_STRAND_BALANCE_FILTER,
                   help="Allow extremely strand-unbalanced variants past the SOR check")
    c.add_argument("--balance-ratio", dest="strand_balance_ratio", type=float,
                   default=consts.DEFAULT_STRAND_BALANCE_RATIO,
                   help="Max fraction of depth on one strand to call it unbalanced")
    c.add_argument("--n-per-strand", type=int, default=consts.DEFAULT_N_KMERS_PER_STRAND,
                   help="Min unique kmers per strand to call a variant")
    c.add_argument("--strand_odds", dest="strand_odds_max", type=float,
                   default=consts.DEFAULT_MAX_STRAND_ODDS,
                   help="Maximum strand odds ratio to pass strand filtering")
    c.add_argument("--min-depth", type=int, default=consts.DEFAULT_MIN_DEPTH,
                   help="Minimum total depth to call a minor variant")
    c.add_argument("--min-variant-depth", type=int, default=consts.MIN_KMER_COUNT,
                   help="Minimum depth of a minor variant to be called")
    c.add_argument("--noise-multiplier", dest="variant_multiplier", type=float,
                   default=consts.DEFAULT_NOISE_MULTIPLIER,
                   help="Required multiple above estimated baseline noise")
    c.add_argument("-o", "--output", default=consts.DEFAULT_OUT_FOLDER,
                   help="Folder to output all resulting files")
    c.add_argument("--pileup", dest="output_pileup", action="store_true",
                   default=consts.DEFAULT_TSV_PILEUP,
                   help="Also output a tsv of the approximate pileup")
    c.add_argument("--alignment", dest="output_alignment", action="store_true",
                   default=consts.DEFAULT_ALIGNMENT,
                   help="Output a multifasta alignment of all samples")
    c.add_argument("--keep-kmer-info", dest="keep_kmer_counts", action="store_true",
                   default=consts.DEFAULT_KEEP_KMER_INFO,
                   help="Keep kmer count information")
    c.add_argument("--batch-size", type=int, default=1 << 18,
                   help="Device mapping batch size (unique k-mers per batch)")
    c.add_argument("--chunk-reads", type=int, default=1 << 18,
                   help="Reads per device-counter chunk")
    c.add_argument("--counter", choices=("auto", "host", "device"), default="auto",
                   help="K-mer counter: host C++ hash, device sort, or auto (host "
                        "when the native library loads)")
    c.add_argument("--mesh", default=None,
                   help="Device mesh 'DxG' (data-parallel x genome shards), e.g. 4x2")
    c.add_argument("--shard-samples", dest="shard_samples", action="store_true",
                   help="Multi-host cohorts: partition samples across "
                        "processes (each host runs its share end-to-end; "
                        "rank 0 writes overview/alignment). Exclusive "
                        "with --mesh; assumes a shared output filesystem")
    c.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="Write a jax.profiler trace of the run to this directory")
    c.add_argument("--device-build", dest="device_build", default="auto",
                   choices=("auto", "on", "off"),
                   help="Build the device index on the device from genome "
                        "codes (auto: on for every backend but the CPU; off "
                        "under --mesh)")
    c.add_argument("--coordinator", default=None,
                   help="jax.distributed coordinator address host:port "
                        "(multi-process; omit under SLURM or Open MPI for "
                        "auto-detection)")
    c.add_argument("--num-processes", dest="num_processes", type=int, default=None,
                   help="Total process count for multi-host execution")
    c.add_argument("--process-id", dest="process_id", type=int, default=None,
                   help="This process's rank for multi-host execution")
    _add_common(c)
    return ap


def run_build(cfg: BuildConfig) -> None:
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.store import save_index

    cfg.validate()
    index = build_index(cfg.kmer, cfg.genomes)
    out = cfg.output + ".bkdb"
    import logging

    logging.getLogger("bronko").info("Saving index to %s", out)
    if cfg.bkdb_format == "bincode":
        from bronko_tpu.index.bincode_compat import save_reference_bkdb

        save_reference_bkdb(index, out)
    else:
        save_index(out, index)


def run_call_cmd(cfg: CallConfig) -> None:
    import logging

    from bronko_tpu.call.engine import run_call
    from bronko_tpu.index.build import build_index
    from bronko_tpu.index.layout import build_device_index
    from bronko_tpu.index.store import load_index

    log = logging.getLogger("bronko")
    cfg.validate()

    def _on_device() -> bool:
        if cfg.mesh is not None or cfg.device_build == "off":
            return False  # the mesh splitter consumes the host arrays
        if cfg.device_build == "on":
            return True
        import jax

        return jax.default_backend() not in ("cpu",)

    try:
        if cfg.genomes:
            log.info("Creating bronko index from provided reference genomes")
            if _on_device():
                from bronko_tpu.index.device_build import build_device_index_on_device

                index, dev = build_device_index_on_device(cfg.kmer, cfg.genomes)
            else:
                index = build_index(cfg.kmer, cfg.genomes)
                dev = build_device_index(index)
        else:
            log.info("Reading in provided bronko index")
            index = load_index(cfg.db, expect_k=cfg.kmer)
            if _on_device():
                from bronko_tpu.index.device_build import device_build

                dev = device_build(index)
            else:
                dev = build_device_index(index)
    except Exception as e:  # noqa: BLE001 — corrupt/truncated .bkdb files
        # raise IndexError/struct.error/BadZipFile from the decoders; every
        # load failure gets the reference's clean error + exit 1, not a
        # traceback (call.rs:189-203)
        log.error("%s | Unable to build/read index, exiting", e)
        raise SystemExit(1) from None
    summaries = run_call(cfg, index, dev)
    n_jobs = len(cfg.reads) + len(cfg.first_pairs)
    if len(summaries) < n_jobs:
        raise SystemExit(2)  # partial failure: some samples were skipped


def main(argv: list[str] | None = None) -> int:
    print(f"bronko-tpu v{consts.BRONKO_TPU_VERSION}")
    print("Accelerator rebuild of the bronko viral variant caller\n")
    t0 = time.time()
    args = build_parser().parse_args(argv)
    setup_logging(args.debug, args.verbose)

    if args.mode == "build":
        cfg = BuildConfig(
            genomes=args.genomes, kmer=args.kmer, output=args.output,
            threads=args.threads, debug=args.debug, verbose=args.verbose,
            bkdb_format=args.bkdb_format,
        )
        run_build(cfg)
    else:
        dist_flags = (args.coordinator, args.num_processes, args.process_id)
        if any(f is not None for f in dist_flags):
            if any(f is None for f in dist_flags):
                # jax.distributed.initialize with a partial set raises a
                # raw traceback; fail like every other config mistake
                from bronko_tpu.config import _fatal

                _fatal("--coordinator, --num-processes and --process-id "
                       "must be given together")
            from bronko_tpu.parallel.distributed import init_distributed

            init_distributed(args.coordinator, args.num_processes, args.process_id)
        fields = {f: getattr(args, f) for f in CallConfig.__dataclass_fields__
                  if hasattr(args, f)}
        cfg = CallConfig(**fields)
        run_call_cmd(cfg)

    print(f"\nbronko-tpu v{consts.BRONKO_TPU_VERSION} finished in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
