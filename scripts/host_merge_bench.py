#!/usr/bin/env python3
"""Host merge A/B: numpy from_pairs core vs the native bucket-parallel
aggregator (pipeline/nativeagg.py) across key widths and duplicate
ratios.  Pure host benchmark — no accelerator; run on an idle machine.

Usage: python scripts/host_merge_bench.py [--n 8388608] [--reps 5]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from kmer_tpu.ops.encode import words_per_key          # noqa: E402
from kmer_tpu.pipeline.table import KmerTable          # noqa: E402


def bench_one(k, n, pool_frac, reps):
    rng = np.random.default_rng(0)
    W = words_per_key(k)
    pool = rng.integers(0, 2 ** 32, (max(int(n * pool_frac), 1), W),
                        dtype=np.uint32)
    used = 2 * k - 32 * (W - 1)
    if used < 32:
        pool[:, 0] &= (1 << used) - 1
    keys = pool[rng.integers(0, len(pool), n)]
    counts = rng.integers(1, 100, n).astype(np.int64)

    out = {}
    for mode, env in (("numpy", "0"), ("native", "1")):
        os.environ["KMER_TPU_NATIVE_AGG"] = env
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            t = KmerTable.from_pairs(k, keys, counts)
            best = min(best, time.perf_counter() - t0)
        out[mode] = best
        distinct = t.num_distinct
    os.environ.pop("KMER_TPU_NATIVE_AGG", None)
    rate = n / out["native"] / 1e6
    print(f"k={k:2d} W={W} n={n} dup_pool={pool_frac:4.2f} "
          f"distinct={distinct:8d}  numpy {out['numpy'] * 1e3:7.1f} ms  "
          f"native {out['native'] * 1e3:7.1f} ms  "
          f"speedup {out['numpy'] / out['native']:.2f}x  "
          f"({rate:.1f} M pairs/s)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8 << 20)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    print(f"cpus={os.cpu_count()} threads="
          f"{os.environ.get('KMER_TPU_AGG_THREADS', 'auto')}")
    for k in (15, 21, 45, 63):
        for pool_frac in (0.05, 0.9):
            bench_one(k, args.n, pool_frac, args.reps)


if __name__ == "__main__":
    main()
