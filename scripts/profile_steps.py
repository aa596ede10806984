#!/usr/bin/env python3
"""Per-step device profile of the XLA count steps on the attached
accelerator: steady time, device kernels per step, the compiler's
bytes-accessed estimate, and each step's byte bound at the measured
copy rate.  Also times the gapped step's cold compile per row width and
A/Bs the single-operand sort against the same sort with a dummy payload
operand.

Usage: python scripts/profile_steps.py [--out DIR] [--iters N]
           [--batch B] [--copy-mib M]

--batch scales every shape (default 32768 reads: the bench shape; the
gapped steps use B/16 rows at 150 bp and B/128 rows at 512 bp).

Writes one JSON object per step to stdout (and DIR/profile_steps.jsonl
when --out is given); the jax.profiler traces stay under DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def _bytes_accessed(compiled) -> float | None:
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    return (ca or {}).get("bytes accessed")


def reduce_trace(trace_dir: str, n_steps: int) -> dict:
    """Kernels per step, device busy seconds per step and the top
    kernels by device time, from the newest .xplane.pb under trace_dir.
    Device planes are those named /device:<accelerator>; their lines
    carry one event per kernel execution."""
    import jax
    paths = []
    for root, _dirs, files in os.walk(trace_dir):
        paths += [os.path.join(root, f) for f in files
                  if f.endswith(".xplane.pb")]
    if not paths:
        return {"error": "no trace written"}
    pd = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    n_events, spans, per_name = 0, [], {}
    lines_seen = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:") or "CPU" in plane.name:
            continue
        for line in plane.lines:
            lines_seen.append(f"{plane.name}|{line.name}")
            # kernel activity lives on the stream lines; the others
            # (e.g. XLA op / module summaries) would double count
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                n_events += 1
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_name[ev.name] = per_name.get(ev.name, 0.0) \
                    + ev.duration_ns
    busy = 0
    end = -1
    for s, e in sorted(spans):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    return {
        "kernels_per_step": n_events / n_steps,
        "device_busy_s_per_step": busy / 1e9 / n_steps,
        "top_kernels_ms_per_step": [[name[:80], round(ns / 1e6 / n_steps, 4)]
                                    for name, ns in top],
        "device_lines": sorted(set(lines_seen))[:12],
    }


def measure(name, fn, args, *, iters, out_dir, bound_bytes, copy_bps,
            carry=None, extra=None):
    """Compile (cold, timed), warm, time `iters` steps over 5 windows,
    then trace a few steps.  carry: index of an argument that the step
    returns and the next step consumes (a donated accumulator)."""
    import jax
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    args = list(args)

    def step():
        out = compiled(*args)
        if carry is not None:
            args[carry] = out
        return out
    jax.block_until_ready(step())
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        jax.block_until_ready(out)
        windows.append((time.perf_counter() - t0) / iters)
    steady = float(np.median(windows))
    tdir = os.path.join(out_dir, "traces", name)
    n_trace = 5
    with jax.profiler.trace(tdir):
        for _ in range(n_trace):
            out = step()
        jax.block_until_ready(out)
    rec = {
        "step": name,
        "compile_s": round(compile_s, 3),
        "steady_ms": round(steady * 1e3, 4),
        "windows_ms": [round(w * 1e3, 4) for w in windows],
        "xla_bytes_accessed": _bytes_accessed(compiled),
        "bound_bytes": bound_bytes,
        "bound_ms_at_copy_rate": round(bound_bytes / copy_bps * 1e3, 4),
        "times_bound": round(steady / (bound_bytes / copy_bps), 2),
    }
    rec.update(reduce_trace(tdir, n_trace))
    rec.update(extra or {})
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--copy-mib", type=int, default=1024)
    args = ap.parse_args()
    from kmer_tpu.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    import jax
    import jax.numpy as jnp
    from jax import lax

    from kmer_tpu.ops import count as count_ops
    from kmer_tpu.ops.canonical import canonical_kmer_lanes
    from kmer_tpu.ops.encode import words_per_key
    from kmer_tpu.ops.sketch import hll_step
    from kmer_tpu.pipeline.count import (count_step_compact,
                                         count_step_dense, count_step_sort,
                                         gapped_step_sort)
    from kmer_tpu.utils.profiling import Roofline

    dev = jax.devices()[0]
    print(f"# device {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr, flush=True)
    out_dir = args.out or tempfile.mkdtemp(prefix="profile_steps_")
    os.makedirs(out_dir, exist_ok=True)
    sink = open(os.path.join(out_dir, "profile_steps.jsonl"), "w")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    # measured copy rate: x + 1 over 1 GiB reads 1 GiB and writes 1 GiB
    big = jnp.zeros((args.copy_mib << 18,), jnp.uint32)
    inc = jax.jit(lambda x: x + jnp.uint32(1))
    jax.block_until_ready(inc(big))
    t0 = time.perf_counter()
    for _ in range(20):
        big = inc(big)
    jax.block_until_ready(big)
    copy_bps = 2 * big.nbytes * 20 / (time.perf_counter() - t0)
    del big
    emit({"step": "copy", "bytes_per_s": copy_bps,
          "device_kind": dev.device_kind})

    rng = np.random.default_rng(0)
    it = args.iters
    B, L = args.batch, 150
    codes = jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.uint8))
    lens = jnp.full((B,), L, jnp.int32)

    for k in (21, 31, 45):
        W = words_per_key(k)
        rl = Roofline.for_fused_step(B, L, k, W)
        emit(measure(
            f"count_step_sort_k{k}",
            jax.jit(lambda c, n, m, k=k: count_step_sort(
                c, n, m, k=k, canonical=True, group_keys=256)),
            (codes, lens, lens), iters=it, out_dir=out_dir,
            bound_bytes=rl.total_bytes, copy_bps=copy_bps,
            extra={"shape": [B, L], "k": k, "group_keys": 256}))

    k = 21
    N = B * (L - k + 1)
    emit(measure(
        "count_step_compact_k21",
        jax.jit(lambda c, n, m: count_step_compact(
            c, n, m, k=21, canonical=True, group_keys=256)),
        (codes, lens, lens), iters=it, out_dir=out_dir,
        bound_bytes=Roofline.for_fused_step(B, L, k, 2).total_bytes,
        copy_bps=copy_bps, extra={"shape": [B, L], "k": 21}))

    # stages of the k=21 step on their own: extraction (+ canonical +
    # repack), the grouped sort + run-length, and one flat sort
    @jax.jit
    def extract(c, n):
        words, valid = canonical_kmer_lanes(c, n, 21, limits=n)
        rw, _ = count_ops.repack_words([w.reshape(-1) for w in words],
                                       valid.reshape(-1), 21)
        return rw
    emit(measure("extract_canonical_repack_k21", extract, (codes, lens),
                 iters=it, out_dir=out_dir,
                 bound_bytes=B * L + N * 2 * 4, copy_bps=copy_bps))
    rw = extract(codes, lens)
    grouped = jax.jit(lambda a, b: count_ops._sorted_grouped_runs([a, b],
                                                                  256))
    emit(measure("grouped_sort_runlength_k21", grouped, tuple(rw),
                 iters=it, out_dir=out_dir,
                 bound_bytes=N * 8 + N * 12, copy_bps=copy_bps))
    flat = jax.jit(lambda a, b: count_ops.sort_words([a, b]))
    emit(measure("flat_sort_2word_k21", flat, tuple(rw), iters=it,
                 out_dir=out_dir, bound_bytes=2 * N * 8, copy_bps=copy_bps))

    # single-operand sort vs the same sort with a dummy payload operand
    # (1-word keys, k=15, in 256-key groups and flat)
    n15 = B * (L - 15 + 1)
    keys = jnp.asarray(rng.integers(0, 1 << 30, (n15,), dtype=np.uint32))
    g = keys.reshape(-1, 256)
    for label, fn, x in (
            ("sort1_grouped_plain",
             jax.jit(lambda x: lax.sort((x,), num_keys=1, dimension=1)[0]),
             g),
            ("sort1_grouped_dummy",
             jax.jit(lambda x: lax.sort((x, jnp.zeros_like(x)), num_keys=1,
                                        dimension=1)[0]), g),
            ("sort1_flat_plain",
             jax.jit(lambda x: lax.sort((x,), num_keys=1)[0]), keys),
            ("sort1_flat_dummy",
             jax.jit(lambda x: lax.sort((x, jnp.zeros_like(x)),
                                        num_keys=1)[0]), keys)):
        emit(measure(label, fn, (x,), iters=it, out_dir=out_dir,
                     bound_bytes=2 * n15 * 4, copy_bps=copy_bps))

    # gapped reference step: bench shape and the parity width
    for Bg, Lg in ((B // 16, 150), (B // 128, 512)):
        cg = jnp.asarray(rng.integers(0, 4, (Bg, Lg), dtype=np.uint8))
        lg = jnp.full((Bg,), Lg, jnp.int32)
        T = sum(Lg - c + 1 for c in range(80, 141))
        emit(measure(
            f"gapped_step_sort_{Bg}x{Lg}",
            jax.jit(lambda c, n, m: gapped_step_sort(
                c, n, m, c_min=80, c_max=140, group_keys=256)),
            (cg, lg, lg), iters=max(it // 5, 3), out_dir=out_dir,
            bound_bytes=Bg * Lg + Bg * T * (4 * 4 + 4), copy_bps=copy_bps,
            extra={"shape": [Bg, Lg], "lanes": Bg * T}))

    # dense k=8 (scatter-add into a donated 4^8 table) and the HLL step
    hist8 = jnp.zeros((4 ** 8,), jnp.int32)
    emit(measure(
        "count_step_dense_k8",
        jax.jit(lambda c, n, m, h: count_step_dense(
            c, n, m, h, k=8, canonical=True), donate_argnums=3),
        (codes, lens, lens, hist8), iters=it, out_dir=out_dir,
        bound_bytes=B * L + 2 * 4 ** 8 * 4, copy_bps=copy_bps, carry=3,
        extra={"shape": [B, L], "k": 8}))
    hh = jnp.zeros((1 << 15,), jnp.int32)
    emit(measure(
        "hll_step_k21",
        jax.jit(lambda c, n, m, h: hll_step(c, n, m, h, k=21,
                                            canonical=True, b=10)),
        (codes, lens, lens, hh), iters=it, out_dir=out_dir,
        bound_bytes=B * L + 2 * (1 << 15) * 4, copy_bps=copy_bps, carry=3,
        extra={"shape": [B, L], "k": 21, "b": 10}))
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
