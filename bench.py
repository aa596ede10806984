#!/usr/bin/env python3
"""Benchmark: canonical k=21 counting throughput per chip (north-star
metric, BASELINE.json).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "kmers/s", "vs_baseline": R, ...}

vs_baseline compares against the only measurable reference number
(BASELINE.md): the semantics-exact oracle of the reference pipeline runs
at ~0.40 M chunks/s on this host's CPU (the committed Rust binary is a
macOS Mach-O and cannot run here; the reference publishes no numbers).

Measurement methodology: every step chains a data dependency from its
counts into the next step's codes (XLA cannot fold it or reuse a
result), warms the step first, and forces completion with a host
readback that depends on the whole chain.  The device metrics are
measured ROUND-ROBIN — each of NROUNDS rounds times one block per
metric, after a re-warm — so all metrics sample the same interference
phases, and the JSON carries every window plus the median, not just the
best.

The end-to-end legs report cold AND warm runs with per-stage seconds
(utils/stagetime) and the measured D2H link rate.  A failure in any leg
fails the run.

Extra diagnostics go to stderr; stdout carries exactly the JSON line.
"""

import json
import sys
import time

import numpy as np

BASELINE_KMERS_PER_SEC = 0.40e6   # BASELINE.md: oracle extract+sort rate

K = 21
B = 32768         # reads per batch (BASELINE.json config 2 shape)
L = 150
BG = 2048         # gapped batch
WARMUP = 150      # untimed warmup steps
NROUNDS = int(__import__("os").environ.get("KMER_TPU_BENCH_ROUNDS",
                                           "12"))  # round-robin rounds
REWARM = 150      # untimed steps before every timed block
BIG_ITERS = 1600  # steps per timed block


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from kmer_tpu.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()

    import os

    import jax
    import jax.numpy as jnp

    from kmer_tpu.config import KmerConfig
    from kmer_tpu.pipeline.count import count_step_sort, gapped_step_sort

    dev = jax.devices()[0]
    log(f"device: {dev} backend={jax.default_backend()}")

    gk = int(os.environ.get("KMER_TPU_BENCH_GROUP_KEYS", "0")) or None
    cfg = KmerConfig(k=K, **({"sort_group_keys": gk} if gk else {}))
    log(f"sort group keys: {cfg.sort_group_keys}")

    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lengths = jnp.full((B,), L, jnp.int32)
    limits = jnp.full((B,), L, jnp.int32)
    codes_g = jnp.asarray(rng.integers(0, 4, (BG, L), dtype=np.uint8))
    lengths_g = jnp.full((BG,), L, jnp.int32)
    limits_g = jnp.full((BG,), L, jnp.int32)

    def chained(K_, group_keys):
        @jax.jit
        def step(c):
            s, is_start, counts = count_step_sort(
                c, lengths, limits, k=K_, canonical=True,
                group_keys=group_keys)
            inj = (counts[:L] % 4).astype(jnp.uint8)
            return c.at[0, :].set(inj)
        return step

    @jax.jit
    def step_gapped(c):
        s, is_start, counts = gapped_step_sort(
            c, lengths_g, limits_g, c_min=80, c_max=140,
            l_len=27, r_len=27, group_keys=cfg.sort_group_keys)
        inj = (counts[:L] % 4).astype(jnp.uint8)
        return c.at[0, :].set(inj)

    metrics = [
        # name, step fn, initial state, lanes per step
        ("k21", chained(21, cfg.sort_group_keys), codes, B * (L - 21 + 1)),
        ("k31", chained(31, cfg.sort_group_keys), codes, B * (L - 31 + 1)),
        ("k45", chained(45, cfg.sort_group_keys), codes, B * (L - 45 + 1)),
        ("gapped", step_gapped, codes_g,
         BG * sum(L - c + 1 for c in range(80, 141))),
    ]

    def block(step, s, n):
        if n <= 0:
            return 0.0, s
        t0 = time.perf_counter()
        for _ in range(n):
            s = step(s)
        _ = np.asarray(s[0, :8])   # depends on the whole chain
        return time.perf_counter() - t0, s

    # compile + promote every metric once, then round-robin the timed
    # windows so all metrics sample the same interference phases
    states = {}
    for name, step, s0, _lanes in metrics:
        t0 = time.perf_counter()
        _, s = block(step, s0, 1)
        log(f"{name}: first step (incl. compile) "
            f"{time.perf_counter() - t0:.2f}s")
        _, s = block(step, s, WARMUP)
        states[name] = s

    windows = {name: [] for name, *_ in metrics}
    for r in range(NROUNDS):
        for name, step, _s0, _lanes in metrics:
            _, states[name] = block(step, states[name], REWARM)
            dt, states[name] = block(step, states[name], BIG_ITERS)
            windows[name].append(dt / BIG_ITERS)
            log(f"round{r} {name:7s} {dt / BIG_ITERS * 1e3:7.3f} ms/step")

    stats = {}
    for name, _step, _s0, lanes in metrics:
        w = sorted(windows[name])
        best, med = w[0], w[len(w) // 2]
        stats[name] = {
            "windows_ms": [round(x * 1e3, 4) for x in windows[name]],
            "best_ms": round(best * 1e3, 4),
            "median_ms": round(med * 1e3, 4),
            "best_rate": round(lanes / best),
            "median_rate": round(lanes / med),
        }
        log(f"{name}: best {best * 1e3:.3f} ms ({lanes / best / 1e9:.2f} B"
            f"/s), median {med * 1e3:.3f} ms ({lanes / med / 1e9:.2f} B/s)")

    kmers_per_sec = stats["k21"]["best_rate"]

    # host-merge metric: the from_pairs choke point at the flush-merge
    # shape (native bucket-parallel aggregator; scales with cores)
    from kmer_tpu.pipeline.table import KmerTable
    hm_n = 8 << 20
    hm_keys = np.asarray(rng.integers(0, 2 ** 32, (hm_n, 2)),
                         dtype=np.uint32)
    hm_keys[:, 0] &= (1 << 10) - 1
    hm_keys = hm_keys[rng.integers(0, hm_n // 2, hm_n)]
    hm_counts = np.ones(hm_n, np.int64)
    hm_best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        KmerTable.from_pairs(K, hm_keys, hm_counts)
        hm_best = min(hm_best, time.perf_counter() - t0)
    hm_rate = hm_n / hm_best
    log(f"host merge: {hm_best * 1e3:.0f} ms = {hm_rate / 1e6:.1f} M"
        " pairs/s")

    # end-to-end corpus run, instrumented: cold then warm, each with
    # per-stage wall seconds — the warm run is the pipeline's number;
    # cold - warm is compile.  The measured D2H link rate
    # contextualizes the readback stage.
    import tempfile

    from kmer_tpu.io.generator import genome_reads_fasta
    from kmer_tpu.pipeline.count import count_fasta
    from kmer_tpu.utils import stagetime
    from kmer_tpu.utils.linkspeed import d2h_gbps
    n_reads = int(os.environ.get("KMER_TPU_BENCH_E2E_READS", "10000"))
    e2e = None
    if n_reads > 0:
        link = d2h_gbps()
        runs = {}
        with tempfile.TemporaryDirectory() as d:
            fa = os.path.join(d, "bench.fasta")
            with open(fa, "w") as f:
                f.write(genome_reads_fasta(n_reads, L,
                                           genome_len=1_000_000,
                                           seed=1))
            for label in ("cold", "warm"):
                st = {}
                t0 = time.perf_counter()
                with stagetime.collect(st):
                    table = count_fasta(fa, cfg.replace(canonical=True))
                wall = time.perf_counter() - t0
                runs[label] = {
                    "seconds": round(wall, 3),
                    "stages": {k2: round(v, 3)
                               for k2, v in sorted(st.items())},
                }
                log(f"e2e {label}: {wall:.2f}s "
                    f"{runs[label]['stages']}")
        warm_s = runs["warm"]["seconds"]
        e2e = {
            "reads": n_reads,
            "distinct": table.num_distinct,
            "cold": runs["cold"],
            "warm": runs["warm"],
            "reads_per_sec_warm": round(n_reads / warm_s),
            "kmers_per_sec_warm": round(n_reads * (L - K + 1) / warm_s),
            "d2h_link_gbps": round(link, 4),
            "note": "warm stage seconds attribute the wall; "
                    "readback rides the measured link rate",
        }

    # production-scale end-to-end (the SCALE_r05 shape): 1 M genome-
    # coverage reads, 165 MB FASTA, ~15.3 M distinct.
    from kmer_tpu.io.generator import genome_reads_fasta
    n_scale = int(os.environ.get("KMER_TPU_BENCH_SCALE_READS",
                                 "1000000"))
    e2e_scale = None
    if n_scale > 0:
        with tempfile.TemporaryDirectory() as d:
            fa = os.path.join(d, "scale.fasta")
            with open(fa, "w") as f:
                f.write(genome_reads_fasta(
                    n_scale, L, genome_len=10_000_000, seed=5,
                    error_rate=0.002))
            runs = {}
            for label in ("cold", "warm"):
                st = {}
                t0 = time.perf_counter()
                with stagetime.collect(st):
                    stab = count_fasta(fa, cfg.replace(canonical=True))
                wall = time.perf_counter() - t0
                runs[label] = {
                    "seconds": round(wall, 2),
                    "stages": {k2: round(v, 2)
                               for k2, v in sorted(st.items())},
                }
                log(f"e2e-scale {label}: {wall:.2f}s "
                    f"{runs[label]['stages']}")
        warm_s = runs["warm"]["seconds"]
        e2e_scale = {
            "reads": n_scale,
            "total_kmers": int(stab.counts.sum()),
            "distinct": stab.num_distinct,
            "cold": runs["cold"],
            "warm": runs["warm"],
            "reads_per_sec_warm": round(n_scale / warm_s),
            "kmers_per_sec_warm": round(
                int(stab.counts.sum()) / warm_s),
        }

    print(json.dumps({
        "metric": f"canonical k={K} count throughput (1 chip, sort mode)",
        "value": kmers_per_sec,
        "unit": "kmers/s",
        "vs_baseline": round(kmers_per_sec / BASELINE_KMERS_PER_SEC, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        # every timed window for every metric — noise vs regression is
        # adjudicable from the artifact alone
        "device_metrics": {
            name: stats[name] for name, *_ in metrics
        },
        "kmers_per_sec_k31": stats["k31"]["best_rate"],
        "kmers_per_sec_k45": stats["k45"]["best_rate"],
        "gapped_chunks_per_sec": stats["gapped"]["best_rate"],
        "host_merge_pairs_per_sec": round(hm_rate),
        "end_to_end": e2e,
        "end_to_end_scale": e2e_scale,
    }))


if __name__ == "__main__":
    main()
