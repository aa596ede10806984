#!/usr/bin/env python3
"""Run the BASELINE.json benchmark configs end-to-end and print one JSON
line per config (development record; bench.py stays the driver's single
headline metric).

  1 k=21 exact count on sample.fasta (parity vs oracle)
  2 k=31 canonical on synthetic 150bp reads (end-to-end reads/s)
  3 dense small-k: k=8 and k=12
  4 streaming two-pass over a large synthetic corpus
  (config 5, multi-host, is exercised by dryrun_multichip + tests)

Usage: python scripts/bench_configs.py [--reads N]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")
from kmer_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

SAMPLE = os.path.join(os.path.dirname(__file__), "..", "tests", "data",
                      "sample.fasta")


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100_000)
    args = ap.parse_args()

    import jax
    from kmer_tpu import KmerConfig, count_fasta
    from kmer_tpu.io.generator import random_reads_fasta
    from kmer_tpu.pipeline.streaming import stream_count_fasta
    from kmer_tpu.utils import oracle

    dev = str(jax.devices()[0])
    print(f"# device={dev}", file=sys.stderr, flush=True)

    # -- config 1: exact parity on sample.fasta ---------------------------
    if os.path.exists(SAMPLE):
        t0 = time.perf_counter()
        table = count_fasta(SAMPLE, KmerConfig(k=21, batch_reads=256,
                                               max_read_len=512))
        dt = time.perf_counter() - t0
        want = oracle.oracle_count(oracle.read_fasta_py(SAMPLE), 21)
        emit(config=1, metric="k=21 sample.fasta exact", ok=(
            table.to_dict() == dict(want)), secs=round(dt, 3),
            total_kmers=table.total, distinct=table.num_distinct)

    # synthetic corpus shared by configs 2 and 4
    tmp = tempfile.mkdtemp(prefix="kmer_bench_")
    try:
        corpus = os.path.join(tmp, "reads.fasta")
        with open(corpus, "w") as f:
            f.write(random_reads_fasta(args.reads, 150, seed=7))

        # -- config 2: k=31 canonical end-to-end --------------------------
        # every timed config runs twice and reports the WARM pass —
        # first-pass numbers are dominated by remote compiles (up to
        # ~15 min/HLO on this attachment; the cross-process persistent
        # cache is unreliable, in-process caching works)
        cfg = KmerConfig(k=31, canonical=True, batch_reads=8192,
                         max_read_len=150)
        count_fasta(corpus, cfg)
        t0 = time.perf_counter()
        table = count_fasta(corpus, cfg)
        dt = time.perf_counter() - t0
        kmers = table.total
        emit(config=2, metric="k=31 canonical end-to-end", reads=args.reads,
             secs=round(dt, 3), kmers=kmers,
             kmers_per_s=round(kmers / dt), reads_per_s=round(args.reads / dt))

        # -- config 3: dense k=8 and k=12 ---------------------------------
        for k in (8, 12):
            cfg = KmerConfig(k=k, mode="dense", batch_reads=8192,
                             max_read_len=150)
            count_fasta(corpus, cfg)
            t0 = time.perf_counter()
            table = count_fasta(corpus, cfg)
            dt = time.perf_counter() - t0
            emit(config=3, metric=f"dense k={k} end-to-end",
                 reads=args.reads, secs=round(dt, 3),
                 kmers_per_s=round(table.total / dt))

        # -- genome-coverage corpus: on-device compaction win -------------
        # (duplicate-heavy reads are THE realistic k-mer workload; D2H
        # then scales with distinct k-mers instead of total)
        from kmer_tpu.io.generator import genome_reads_fasta
        gcorpus = os.path.join(tmp, "genome_reads.fasta")
        n_g = max(args.reads // 4, 2000)
        with open(gcorpus, "w") as f:
            f.write(genome_reads_fasta(n_g, 150, genome_len=200_000, seed=11))
        for compact in (False, True):
            cfg = KmerConfig(k=21, canonical=True, batch_reads=8192,
                             max_read_len=150, compact=compact)
            count_fasta(gcorpus, cfg)
            t0 = time.perf_counter()
            tg = count_fasta(gcorpus, cfg)
            dt = time.perf_counter() - t0
            emit(config="2g", metric="k=21 canonical genome-coverage "
                 f"end-to-end compact={compact}", reads=n_g,
                 secs=round(dt, 3), total=tg.total, distinct=tg.num_distinct,
                 kmers_per_s=round(tg.total / dt))

        # -- config 4: streaming two-pass ---------------------------------
        spill = os.path.join(tmp, "spill")
        cfg = KmerConfig(k=31, canonical=True, batch_reads=8192,
                         max_read_len=150, partitions=32)
        t0 = time.perf_counter()
        table2 = stream_count_fasta(corpus, cfg, spill_dir=spill)
        dt = time.perf_counter() - t0
        emit(config=4, metric="streaming two-pass k=31", reads=args.reads,
             secs=round(dt, 3), kmers_per_s=round(table2.total / dt),
             matches_in_memory=bool(table2.total == kmers))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
