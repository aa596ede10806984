"""Command-line interface.

The reference has no CLI at all in the binary (hard-coded path,
main.rs:44) and a single positional arg in test.py (test.py:15-18).
Subcommands:

  count     FASTA/FASTQ -> sorted "kmer\\tcount" TSV on stdout
  histo     k-mer multiplicity spectrum (streaming with --two-pass)
  card      estimate DISTINCT k-mers (HyperLogLog sketch)
  parity    FASTA -> the reference's exact sorted chunk dump on stdout
  dump      saved table (.npz) -> TSV / spectrum / top-N
  query     look up counts in a saved table (.npz)
  tools     set ops on saved tables (union/intersect/subtract/compare)
  generate  seeded random FASTA/FASTQ corpora
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p):
    p.add_argument("fasta", nargs="+",
                   help="input FASTA/FASTQ file(s), auto-detected")
    p.add_argument("--batch-reads", type=int, default=2048)
    p.add_argument("--max-read-len", type=int, default=256)
    p.add_argument("--threads", type=int, default=None,
                   help="host parser threads (MT whole-file parse + "
                        "BGZF block inflate; default: up to 8 cores)")
    p.add_argument("--stats", action="store_true",
                   help="JSONL per-batch stats on stderr")
    p.add_argument("--profile-dir", default=None,
                   help="capture a jax.profiler trace into this directory")


def _add_kmer_flags(p):
    """The counting-config surface, shared by `count` and `histo` so the
    spectrum of any countable config (quality-filtered FASTQ, spaced
    seeds, gapped chunks) can be produced (VERDICT r3 #6)."""
    p.add_argument("-k", type=int, default=21)
    p.add_argument("--canonical", action="store_true")
    p.add_argument("--skip-invalid", action="store_true",
                   help="accept N/IUPAC bases and drop windows containing "
                        "them (default: error, the reference's contract)")
    p.add_argument("--min-qual", type=int, default=0,
                   help="FASTQ only: mask bases below this Phred+33 "
                        "quality and drop windows containing them "
                        "(implies --skip-invalid)")
    p.add_argument("--compact", action="store_true",
                   help="on-device compaction: device->host transfer "
                        "scales with distinct k-mers (sort mode)")
    p.add_argument("--device-merge", choices=("auto", "on", "off"),
                   default="auto",
                   help="device-resident table accumulation: the table "
                        "stays on device and only distinct rows are "
                        "read back, wire-compressed (auto: on when the "
                        "probed device->host link is slow)")
    p.add_argument("--seed-mask", default=None,
                   help="spaced seed: 0/1 match mask (e.g. 1101011); "
                        "the key is the bases at the '1' offsets per "
                        "window (-k is then ignored; canonical needs "
                        "a palindromic mask)")
    p.add_argument("--gapped", action="store_true",
                   help="gapped L+R chunks (the reference's window "
                        "semantics, main.rs:63-79) instead of "
                        "contiguous k-mers; -k is then ignored")
    p.add_argument("--l-len", type=int, default=27,
                   help="gapped left window length")
    p.add_argument("--r-len", type=int, default=27,
                   help="gapped right window length")
    p.add_argument("--c-min", type=int, default=80,
                   help="gapped minimum chunk span")
    p.add_argument("--c-max", type=int, default=140,
                   help="gapped maximum chunk span")


def _build_cfg(args):
    """KmerConfig from the shared _add_kmer_flags surface (one builder
    for count and histo — the configs can never drift)."""
    from .config import KmerConfig
    if args.gapped and args.seed_mask:
        raise ValueError("--seed-mask and --gapped are exclusive")
    if args.gapped and args.canonical:
        raise ValueError("--canonical applies to contiguous "
                         "k-mers (gapped chunks have no "
                         "reverse-complement contract)")
    skip_invalid = args.skip_invalid or args.min_qual > 0
    mode = getattr(args, "mode", "auto")
    if args.gapped:
        return KmerConfig(gapped=True, l_len=args.l_len, r_len=args.r_len,
                          c_min=args.c_min, c_max=args.c_max,
                          batch_reads=args.batch_reads,
                          max_read_len=max(args.max_read_len, args.c_max),
                          partitions=args.partitions, stats=args.stats,
                          skip_invalid=skip_invalid,
                          min_qual=args.min_qual,
                          compact=args.compact,
                          device_merge=args.device_merge)
    span = len(args.seed_mask) if args.seed_mask else args.k
    return KmerConfig(k=args.k, canonical=args.canonical, mode=mode,
                      batch_reads=args.batch_reads,
                      max_read_len=max(args.max_read_len, span),
                      partitions=args.partitions, stats=args.stats,
                      skip_invalid=skip_invalid,
                      min_qual=args.min_qual,
                      seed_mask=args.seed_mask,
                      compact=args.compact,
                      device_merge=args.device_merge)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kmer_tpu", description=__doc__)
    from . import __version__
    ap.add_argument("--version", action="version",
                    version=f"kmer-tpu {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("count", help="count k-mers")
    _add_common(pc)
    _add_kmer_flags(pc)
    pc.add_argument("--mode", choices=["auto", "dense", "sort"], default="auto")
    pc.add_argument("--min-count", type=int, default=1,
                    help="suppress k-mers with count below this")
    pc.add_argument("--max-count", type=int, default=None,
                    help="suppress k-mers with count above this "
                         "(repeat cutoff, KMC's -cx)")
    pc.add_argument("--out-npz", default=None,
                    help="also save the table as a .npz (KmerTable.load)")
    pc.add_argument("--two-pass", action="store_true",
                    help="streaming two-pass spill mode (checkpointable)")
    pc.add_argument("--multihost", action="store_true",
                    help="SPMD multi-host counting: run this same command "
                         "on every process with COORDINATOR_ADDRESS / "
                         "JAX process env set (parallel.multihost); "
                         "process 0 writes the table")
    pc.add_argument("--coordinator", default=None,
                    help="jax.distributed coordinator address "
                         "(host:port) for --multihost")
    pc.add_argument("--num-processes", type=int, default=None)
    pc.add_argument("--process-id", type=int, default=None)
    pc.add_argument("--spill-dir", default=None,
                    help="spill/checkpoint directory for --two-pass; "
                         "rerun with the same dir to resume")
    pc.add_argument("--partitions", type=int, default=16,
                    help="hash-prefix spill partitions for --two-pass")

    pp = sub.add_parser("parity", help="reference-parity sorted chunk dump")
    pp.add_argument("fasta")
    pp.add_argument("--batch-reads", type=int, default=256)
    pp.add_argument("--max-read-len", type=int, default=512)
    pp.add_argument("--bounded", action="store_true",
                    help="bounded-memory streaming dump (corpora beyond "
                         "RAM): spill per-partition line runs, sort one "
                         "partition at a time; byte-identical output")
    pp.add_argument("--spill-dir", default=None,
                    help="spill directory for --bounded (default: a "
                         "temp dir, removed afterwards)")
    pp.add_argument("--partitions", type=int, default=64,
                    help="spill partitions for --bounded")

    ph = sub.add_parser("histo", help="k-mer multiplicity spectrum "
                                      "(count\\tnum_distinct per line)")
    _add_common(ph)
    _add_kmer_flags(ph)
    ph.add_argument("--two-pass", action="store_true",
                    help="streaming spectrum for corpora whose table "
                         "exceeds host memory (requires --spill-dir)")
    ph.add_argument("--spill-dir", default=None)
    ph.add_argument("--partitions", type=int, default=16)

    pe = sub.add_parser("card", help="estimate DISTINCT k-mers (F0 "
                                     "cardinality, ntCard-style "
                                     "HyperLogLog) without "
                                     "building a table")
    _add_common(pe)
    pe.add_argument("-k", type=int, action="append", default=None,
                    help="k value; repeatable (-k 17 -k 21 -k 31): all "
                         "ks are sketched in ONE ingest pass, ntCard-"
                         "style (default: 21)")
    pe.add_argument("--canonical", action="store_true")
    pe.add_argument("--skip-invalid", action="store_true")
    pe.add_argument("--min-qual", type=int, default=0)
    pe.add_argument("--seed-mask", default=None,
                    help="estimate distinct SPACED keys (0/1 mask; "
                         "exclusive with -k)")
    pe.add_argument("--buckets-log2", type=int, default=10,
                    help="HLL precision b: 2^b buckets, relative error "
                         "~1.04/sqrt(2^b) (default 10: ~3.3%%)")

    pd = sub.add_parser("dump", help="dump a saved table (.npz) as "
                                     "sorted kmer\\tcount TSV "
                                     "(kmc_dump-style)")
    pd.add_argument("table", help="KmerTable .npz path")
    pd.add_argument("--min-count", type=int, default=1)
    pd.add_argument("--max-count", type=int, default=None)
    pd.add_argument("--histo", action="store_true",
                    help="print the multiplicity spectrum instead")
    pd.add_argument("--top", type=int, default=None,
                    help="print only the N most frequent k-mers")

    pq = sub.add_parser("query", help="look up k-mer counts in a saved "
                                      "table (.npz from count --out-npz)")
    pq.add_argument("table", help="KmerTable .npz path")
    pq.add_argument("kmers", nargs="*",
                    help="k-mers to look up (default: read one per line "
                         "from stdin)")
    pq.add_argument("--canonical", action="store_true",
                    help="map queries to min(kmer, revcomp) first (use "
                         "when the table was built with --canonical)")

    pt = sub.add_parser("tools", help="set operations on saved tables "
                                      "(KMC-tools style)")
    pt.add_argument("op", choices=["union", "intersect", "subtract",
                                   "kmers-subtract", "compare"],
                    help="union: sum counts; intersect: keys in both, "
                         "min counts; subtract: count difference, <=0 "
                         "dropped; kmers-subtract: drop keys present "
                         "in B; compare: Jaccard/containment summary "
                         "(JSON, no table output)")
    pt.add_argument("table_a", help="KmerTable .npz (operand A)")
    pt.add_argument("table_b", nargs="+",
                    help="KmerTable .npz operand(s); union folds ALL "
                         "of them (merge per-shard outputs in one go), "
                         "the other ops take exactly one B")
    pt.add_argument("-o", "--out-npz", default=None,
                    help="save the result as .npz (default: TSV on "
                         "stdout only)")
    pt.add_argument("--min-count", type=int, default=1)
    pt.add_argument("--max-count", type=int, default=None)

    pg = sub.add_parser("generate", help="seeded random FASTA/FASTQ to stdout")
    pg.add_argument("--style", choices=["reference", "reads", "genome"],
                    default="reference",
                    help="genome: reads sampled from one random genome "
                         "(realistic k-mer multiplicity structure)")
    pg.add_argument("--format", choices=["fasta", "fastq"], default="fasta",
                    help="fastq implies --style reads")
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--n-records", type=int, default=200)
    pg.add_argument("--read-len", type=int, default=150)
    pg.add_argument("--genome-len", type=int, default=100_000)
    pg.add_argument("--error-rate", type=float, default=0.0)

    args = ap.parse_args(argv)
    from .utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    if getattr(args, "threads", None):
        import os
        os.environ["KMER_TPU_PARSE_THREADS"] = str(args.threads)
    try:
        return _dispatch(args)
    except (ValueError, OSError, EOFError) as e:
        # EOFError: truncated gzip via the Python-fallback decompressor
        print(f"kmer_tpu: error: {e}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if args.cmd == "count":
        cfg = _build_cfg(args)
        from .utils.profiling import trace
        if args.compact and (args.two_pass or args.multihost):
            raise ValueError("--compact applies to the single-host "
                             "in-memory pipeline (not --two-pass or "
                             "--multihost)")
        if args.multihost:
            if args.two_pass:
                raise ValueError("--two-pass and --multihost are not "
                                 "combined (yet); the multihost driver "
                                 "is already memory-bounded via chunked "
                                 "ingest + owner-sharded aggregation")
            if len(args.fasta) != 1:
                raise ValueError("--multihost takes exactly one input file")
            import jax
            from .parallel.multihost import count_fasta_multihost, initialize
            initialize(coordinator_address=args.coordinator,
                       num_processes=args.num_processes,
                       process_id=args.process_id)
            with trace(args.profile_dir):
                table = count_fasta_multihost(args.fasta[0], cfg)
            if args.min_count > 1 or args.max_count is not None:
                table = table.filter_count_range(args.min_count,
                                                 args.max_count)
            if jax.process_index() == 0:
                if args.out_npz:
                    table.save(args.out_npz)
                table.write_tsv(sys.stdout)
            return 0
        if args.two_pass:
            if not args.spill_dir:
                raise ValueError("--two-pass requires --spill-dir")
            if len(args.fasta) != 1:
                raise ValueError("--two-pass takes exactly one input file")
            from .pipeline.streaming import StreamingCounter
            sc = StreamingCounter(args.fasta[0], cfg.replace(mode="sort"),
                                  args.spill_dir)
            with trace(args.profile_dir):
                sc.run()
            if args.min_count > 1 or args.max_count is not None \
                    or args.out_npz:
                table = sc.final_table()
                if args.min_count > 1 or args.max_count is not None:
                    table = table.filter_count_range(args.min_count,
                                                     args.max_count)
                if args.out_npz:
                    table.save(args.out_npz)
                table.write_tsv(sys.stdout)
            else:
                sc.write_tsv(sys.stdout)
            return 0
        from .pipeline.count import count_files
        with trace(args.profile_dir):
            table = count_files(args.fasta, cfg)
        if args.min_count > 1 or args.max_count is not None:
            table = table.filter_count_range(args.min_count,
                                             args.max_count)
        if args.out_npz:
            table.save(args.out_npz)
        table.write_tsv(sys.stdout)
        return 0

    if args.cmd == "histo":
        cfg = _build_cfg(args)
        if args.two_pass:
            if args.compact:
                raise ValueError("--compact applies to the single-host "
                                 "in-memory pipeline (not --two-pass)")
            if not args.spill_dir:
                raise ValueError("--two-pass requires --spill-dir")
            if len(args.fasta) != 1:
                raise ValueError("--two-pass takes exactly one input file")
            from .pipeline.streaming import StreamingCounter
            sc = StreamingCounter(args.fasta[0], cfg.replace(mode="sort"),
                                  args.spill_dir)
            sc.run()
            histo = sc.multiplicity_histogram()
        else:
            from .pipeline.count import count_files
            histo = count_files(args.fasta, cfg).multiplicity_histogram()
        for mult, ndis in sorted(histo.items()):
            sys.stdout.write(f"{mult}\t{ndis}\n")
        return 0

    if args.cmd == "card":
        from .config import KmerConfig
        from .pipeline.sketch import estimate_distinct_multi_k
        if args.seed_mask and args.k:
            # the estimator returns ONE spaced result; zipping it
            # against user ks would mislabel it as k=<first> and drop
            # the rest
            raise ValueError("--seed-mask selects its own key width "
                             "(the mask popcount); -k cannot be "
                             "combined with it")
        ks = list(dict.fromkeys(args.k or [21]))
        span = len(args.seed_mask) if args.seed_mask else max(ks)
        cfg = KmerConfig(k=max(ks), canonical=args.canonical,
                         batch_reads=args.batch_reads,
                         max_read_len=max(args.max_read_len, span),
                         skip_invalid=(args.skip_invalid
                                       or args.min_qual > 0),
                         seed_mask=args.seed_mask,
                         min_qual=args.min_qual, stats=args.stats)
        res = estimate_distinct_multi_k(args.fasta, ks, cfg,
                                        b=args.buckets_log2)
        for kk, (est, total) in zip(ks, res):
            prefix = f"k={kk}\t" if len(ks) > 1 else ""
            sys.stdout.write(f"{prefix}distinct_estimate\t{round(est)}\n"
                             f"{prefix}total_kmers\t{total}\n")
        return 0

    if args.cmd == "parity":
        from .config import KmerConfig
        from .pipeline.parity import parity_dump, parity_dump_stream
        cfg = KmerConfig(gapped=True, batch_reads=args.batch_reads,
                         max_read_len=args.max_read_len)
        if args.bounded:
            parity_dump_stream(args.fasta, sys.stdout.buffer, cfg,
                               spill_dir=args.spill_dir,
                               partitions=args.partitions)
        else:
            sys.stdout.buffer.write(parity_dump(args.fasta, cfg))
        return 0

    if args.cmd == "query":
        from .pipeline.table import KmerTable
        table = KmerTable.load(args.table)
        kmers = args.kmers or [ln.strip() for ln in sys.stdin
                               if ln.strip()]
        counts = table.get_many(kmers, canonical=args.canonical)
        for km, c in zip(kmers, counts.tolist()):
            sys.stdout.write(f"{km}\t{c}\n")
        return 0

    if args.cmd == "dump":
        from .pipeline.table import KmerTable
        t = KmerTable.load(args.table)
        if args.min_count > 1 or args.max_count is not None:
            t = t.filter_count_range(args.min_count, args.max_count)
        if args.histo:
            for mult, ndis in sorted(t.multiplicity_histogram().items()):
                sys.stdout.write(f"{mult}\t{ndis}\n")
        elif args.top is not None:
            for km, cnt in t.top(args.top):
                sys.stdout.write(f"{km}\t{cnt}\n")
        else:
            t.write_tsv(sys.stdout)
        return 0

    if args.cmd == "tools":
        from .pipeline.table import KmerTable
        a = KmerTable.load(args.table_a)
        bs = [KmerTable.load(p) for p in args.table_b]
        for p, t in zip(args.table_b, bs):
            if a.k != t.k:
                raise ValueError(f"table k mismatch: {a.k} vs {t.k} "
                                 f"({p})")
        if args.op != "union" and len(bs) != 1:
            raise ValueError(f"{args.op} takes exactly one B table")
        b = bs[0]
        if args.op == "compare":
            import json
            sys.stdout.write(json.dumps(a.compare(b)) + "\n")
            return 0
        if args.op == "union":
            import numpy as np
            allt = [a] + bs
            t = KmerTable.from_pairs(
                a.k, np.concatenate([x.keys for x in allt], axis=0),
                np.concatenate([x.counts for x in allt]))
        elif args.op == "intersect":
            t = a.intersect(b)
        elif args.op == "subtract":
            t = a.subtract(b, counters=True)
        else:
            t = a.subtract(b, counters=False)
        if args.min_count > 1 or args.max_count is not None:
            t = t.filter_count_range(args.min_count, args.max_count)
        if args.out_npz:
            t.save(args.out_npz)
        t.write_tsv(sys.stdout)
        return 0

    if args.cmd == "generate":
        from .io.generator import (random_reads_fasta, random_reads_fastq,
                                   reference_style_fasta)
        from .io.generator import genome_reads_fasta
        if args.format == "fastq":
            sys.stdout.write(random_reads_fastq(args.n_records, args.read_len,
                                                seed=args.seed))
        elif args.style == "genome":
            sys.stdout.write(genome_reads_fasta(
                args.n_records, args.read_len, genome_len=args.genome_len,
                seed=args.seed, error_rate=args.error_rate))
        elif args.style == "reference":
            sys.stdout.write(reference_style_fasta(n_records=args.n_records,
                                                   seed=args.seed))
        else:
            sys.stdout.write(random_reads_fasta(args.n_records, args.read_len,
                                                seed=args.seed))
        return 0
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
