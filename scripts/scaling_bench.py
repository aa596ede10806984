#!/usr/bin/env python3
"""Multi-chip scaling bench (BASELINE.json config 5): throughput of the
production distributed count step (local-count pair routing) across
mesh sizes 1, 2, 4, ..., N, and the scaling efficiency
eff(N) = rate(N) / (N * rate(1)).

On a host with several accelerators this is the scaling number
(target >= 0.9).  On the virtual CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
it validates the harness and the sharding/collective structure, NOT
device scaling (CPU "devices" share cores; expect eff << 1).

Methodology: chained non-foldable feedback + readback forcing, best
window of NBLOCKS (docs/DESIGN.md).

Usage: python scripts/scaling_bench.py [--k 21] [--b-per-dev 4096]
"""

import argparse
import hashlib
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from kmer_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kmer_tpu.parallel import distributed, mesh as mesh_lib  # noqa: E402


def bench_mesh(n_dev: int, k: int, b_per_dev: int, L: int,
               iters: int, nblocks: int) -> float:
    m = mesh_lib.make_mesh(n_dev, 1)
    B = b_per_dev * n_dev
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lengths = jnp.full((B,), L, jnp.int32)
    limits = jnp.full((B,), L, jnp.int32)
    fn = distributed.make_distributed_count_pairs(m, k=k, canonical=True)

    def step(codes):
        words, counts, overflow = fn(codes, lengths, limits)
        inj = (counts.reshape(-1)[:B].astype(jnp.uint32)
               % 4).astype(jnp.uint8)
        return codes.at[:, 0].set(inj)

    s = step(codes)
    _ = np.asarray(s[:4, 0])
    for _ in range(max(iters // 2, 10)):
        s = step(s)
    _ = np.asarray(s[:4, 0])
    best = float("inf")
    for _ in range(nblocks):
        t0 = time.perf_counter()
        for _ in range(iters):
            s = step(s)
        _ = np.asarray(s[:4, 0])
        best = min(best, (time.perf_counter() - t0) / iters)
    return B * (L - k + 1) / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--b-per-dev", type=int, default=4096)
    ap.add_argument("--read-len", type=int, default=150)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--nblocks", type=int, default=4)
    ap.add_argument("--json", help="write a JSON artifact here")
    args = ap.parse_args()

    n_avail = len(jax.devices())
    print(f"devices: {n_avail} x {jax.devices()[0].device_kind} "
          f"(backend={jax.default_backend()})", flush=True)
    if jax.default_backend() == "cpu":
        print("NOTE: CPU backend — this validates the harness, "
              "not device scaling", flush=True)
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]
    rates = {}
    for n in sizes:
        r = bench_mesh(n, args.k, args.b_per_dev, args.read_len,
                       args.iters, args.nblocks)
        rates[n] = r
        eff = r / (n * rates[1])
        unit, div = ("B", 1e9) if rates[1] >= 1e8 else ("M", 1e6)
        print(f"n={n:3d}  {r/div:10.2f} {unit} kmers/s  "
              f"per-dev {r/n/div:8.2f} {unit}  eff={eff:.3f}", flush=True)

    # bit-identity across mesh sizes: one fixed corpus through the
    # production pair-routed step per size; the md5 over the final
    # (keys, counts) bytes must be identical for every mesh
    from kmer_tpu.ops.encode import BASE_ORDER, encode_seq
    from kmer_tpu.pipeline.table import KmerTable
    rng = np.random.default_rng(5)
    Bc, Lc = 64, 96
    seqs = ["".join(BASE_ORDER[c] for c in rng.integers(0, 4, Lc))
            for _ in range(Bc)]
    codes = np.stack([encode_seq(x) for x in seqs])
    lens = np.full((Bc,), Lc, np.int32)
    checks = {}
    for n in sizes:
        m = mesh_lib.make_mesh(n, 1)
        fn = distributed.make_distributed_count_pairs(m, k=args.k,
                                                      canonical=True)
        words, counts, over = fn(jnp.asarray(codes), jnp.asarray(lens),
                                 jnp.asarray(lens))
        assert not bool(over)
        t = KmerTable.from_routed_pairs(args.k, words, counts)
        checks[n] = hashlib.md5(
            t.keys.tobytes() + t.counts.tobytes()).hexdigest()
    assert len(set(checks.values())) == 1, checks
    print(f"bit-identity md5 across meshes {sizes}: "
          f"{checks[sizes[0]]}", flush=True)

    if args.json:
        out = {
            "backend": jax.default_backend(),
            "device_kind": jax.devices()[0].device_kind,
            "k": args.k, "b_per_dev": args.b_per_dev,
            "read_len": args.read_len,
            "mesh_sizes": sizes,
            "kmers_per_sec": {str(n): round(rates[n]) for n in sizes},
            "efficiency_vs_1": {str(n): round(rates[n] / (n * rates[1]), 4)
                                for n in sizes},
            "table_md5_across_meshes": checks[sizes[0]],
            "validity": ("virtual CPU mesh: validates the sharding/"
                         "collective structure and bit-identity, NOT "
                         "silicon scaling (devices share host cores)"
                         if jax.default_backend() == "cpu" else
                         "device mesh"),
        }
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}", flush=True)


if __name__ == "__main__":
    main()
