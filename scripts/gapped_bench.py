#!/usr/bin/env python3
"""Gapped (reference-parity) device-step timing: chained + forced
methodology of bench.py, at the reference geometry L=27/R=27,
c in [80, 140], on 150 bp reads.

Reports ms/step and chunk throughput (valid chunks/s), plus the padded
lane count the sort actually processes (validity fraction).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from kmer_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402
enable_compilation_cache()

B = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
M = int(os.environ.get("GAPPED_M", "256"))     # sort group size
L = 150
L_LEN = R_LEN = 27
C_MIN, C_MAX = 80, 140
WARMUP = 150
ITERS = 300


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    import jax
    import jax.numpy as jnp

    from kmer_tpu.pipeline.count import gapped_step_sort

    log(f"device: {jax.devices()[0]} B={B} m={M}")
    rng = np.random.default_rng(0)
    codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lengths = jnp.full((B,), L, jnp.int32)
    limits = jnp.full((B,), L, jnp.int32)

    # valid chunks per 150 bp read: sum_{c=80..140} (151 - c)
    per_read = sum(L - c + 1 for c in range(C_MIN, C_MAX + 1))
    chunks_per_step = B * per_read

    @jax.jit
    def step(codes):
        s, is_start, counts = gapped_step_sort(
            codes, lengths, limits, c_min=C_MIN, c_max=C_MAX,
            l_len=L_LEN, r_len=R_LEN, group_keys=M)
        inj = (counts[:L] % 4).astype(jnp.uint8)
        return codes.at[0, :].set(inj)

    t0 = time.perf_counter()
    c = step(codes)
    _ = np.asarray(c[0, :8])
    log(f"first step (incl. compile): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    for _ in range(WARMUP):
        c = step(c)
    _ = np.asarray(c[0, :8])
    log(f"warmup {WARMUP}: {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    for _ in range(ITERS):
        c = step(c)
    _ = np.asarray(c[0, :8])
    dt = time.perf_counter() - t0

    ms = dt / ITERS * 1e3
    # lanes the device sorts: exact per-c widths (ops/extract.
    # gapped_lanes c-major layout) — all valid at full-length reads
    lanes = B * per_read
    log(f"{ms:.3f} ms/step; {chunks_per_step} valid chunks "
        f"({chunks_per_step / (lanes):.2f} of {lanes} lanes)")
    print(f"{ms:.3f} ms/step  {chunks_per_step * ITERS / dt / 1e9:.2f} B "
          f"chunks/s  ({lanes * ITERS / dt / 1e9:.2f} B lanes/s)")


if __name__ == "__main__":
    main()
