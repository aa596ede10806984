#!/usr/bin/env python3
"""Smoke run of kmer_tpu on an NVIDIA GPU: the main paths, end to end,
each compared exactly with a plain reference.

    python chip_smoke.py               # one card: every default phase
    python chip_smoke.py --four-cards  # four cards: the mesh path only

Default phases (one process, one card):
  1. main path — `kmer_tpu count -k 21 --canonical` through the CLI
     entry on a 1 M-read genome-coverage corpus (150 bp reads over a
     10 Mb genome at 0.2 % error), cold then warm; the table must equal
     a NumPy reference computed from the FASTA (utils.oracle).
  2. multi-word keys — k=31 and k=45 canonical on a 20 k-read slice.
  3. parity — the reference's sorted gapped dump of sample.fasta must
     have md5 1a4ca1e7d4f2e70253aadca10d8351b4.
  4. other paths on a 100 k-read slice — --compact, device merge,
     --two-pass, histo, dense k=8, a spaced seed, and the `card` sketch
     histogram — each equal to its reference.

--four-cards runs count_fasta_multihost on a data=4 mesh and on a
data=2 x seq=2 mesh (1 M reads), the gapped mesh step (sample.fasta)
and the dense psum (k=8), each bit-identical to the one-card table
computed in the same process.

Every phase prints its cold and warm wall seconds.  Any mismatch or
error exits nonzero; so does a run that finds no GPU.  The last stdout
line is one JSON object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SAMPLE = os.path.join(HERE, "tests", "data", "sample.fasta")
SAMPLE_MD5 = "1a4ca1e7d4f2e70253aadca10d8351b4"
N_READS, READ_LEN = 1_000_000, 150
GENOME_LEN, ERROR_RATE, SEED = 10_000_000, 0.002, 5


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    log(f"  OK {what}")


def twice(label: str, fn):
    """Run fn cold, then warm; print both walls; the two results must
    be equal.  Returns the warm result."""
    t0 = time.perf_counter()
    cold = fn()
    t1 = time.perf_counter()
    warm = fn()
    t2 = time.perf_counter()
    log(f"  {label}: cold {t1 - t0:.3f} s, warm {t2 - t1:.3f} s")
    check(_same(cold, warm), f"{label}: warm result equals cold")
    return warm


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return bool(a == b)


@contextlib.contextmanager
def stdout_to(path: str):
    """Point sys.stdout (text and .buffer) at a file for an in-process
    CLI call."""
    with open(path, "wb") as f:
        wrapper = io.TextIOWrapper(f, encoding="utf-8", write_through=True)
        old = sys.stdout
        sys.stdout = wrapper
        try:
            yield
        finally:
            wrapper.flush()
            sys.stdout = old
            wrapper.detach()


def cli(argv: list[str], out_path: str) -> None:
    from kmer_tpu.cli import main
    with stdout_to(out_path):
        rc = main(argv)
    if rc != 0:
        raise SmokeFailure(f"kmer_tpu {' '.join(argv)} exited {rc}")


def table_equals_np(table, keys: np.ndarray, counts: np.ndarray) -> bool:
    return (table.keys.shape == keys.shape
            and np.array_equal(table.keys, keys)
            and np.array_equal(table.counts, counts))


def write_slice(src: str, dst: str, n_reads: int) -> None:
    """First n_reads records of a two-lines-per-record FASTA."""
    with open(src, "rb") as f, open(dst, "wb") as g:
        for i, line in enumerate(f):
            if i >= 2 * n_reads:
                break
            g.write(line)


def make_corpus(d: str) -> str:
    from kmer_tpu.io.generator import genome_reads_fasta
    path = os.path.join(d, "genome_1m.fasta")
    t0 = time.perf_counter()
    with open(path, "w") as f:
        f.write(genome_reads_fasta(N_READS, READ_LEN, genome_len=GENOME_LEN,
                                   seed=SEED, error_rate=ERROR_RATE))
    log(f"corpus: {N_READS} x {READ_LEN} bp reads, genome {GENOME_LEN} bp, "
        f"error {ERROR_RATE}, {os.path.getsize(path)} bytes, "
        f"{time.perf_counter() - t0:.1f} s to generate")
    return path


def print_environment(jax) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    # the card's name and power limit, exactly as nvidia-smi gives them
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    log(f"jax {jax.__version__}, python {sys.version.split()[0]}, "
        f"devices {[d.device_kind for d in jax.devices()]}")
    log(f"JAX_COMPILATION_CACHE_DIR="
        f"{os.environ.get('JAX_COMPILATION_CACHE_DIR', '')!r} "
        f"(empty: <checkout>/.jax_cache)")
    from kmer_tpu.io.fasta import _load_native
    from kmer_tpu.pipeline.nativeagg import _load
    parser, agg = _load_native() is not None, _load() is not None
    log(f"native libraries: parser {'loaded' if parser else 'MISSING'}, "
        f"aggregator {'loaded' if agg else 'MISSING'}")
    if not (parser and agg):
        raise SmokeFailure("a native library failed to build or load")


def print_policies() -> None:
    from kmer_tpu.config import KmerConfig
    from kmer_tpu.pipeline.count import _devmerge_ok
    from kmer_tpu.utils import linkspeed
    gbps = linkspeed.d2h_gbps()
    log(f"D2H probe: {gbps:.3f} GB/s")
    log(f"policy: dense auto for k<=8 "
        f"{'ON' if linkspeed.dense_auto_ok() else 'off'} "
        f"(link < {linkspeed.DENSE_BREAKEVEN_GBPS} GB/s); dense k=9..12 "
        f"{'device scatter' if linkspeed.dense_scatter_ok() else 'hybrid'}"
        f" (link < {linkspeed.SCATTER_BREAKEVEN_GBPS} GB/s); device merge "
        f"auto {'ON' if _devmerge_ok(KmerConfig()) else 'off'}")


def print_step_memory(jax, jnp) -> None:
    """compiled.memory_analysis() of the CLI's count step (k=21
    canonical, default --batch-reads 2048, 150 bp rows tightened to
    160, 2-bit packed transfer)."""
    from kmer_tpu.pipeline.count import count_step_sort
    B, L = 2048, 160
    codes = jax.ShapeDtypeStruct((B, -(-L // 16)), jnp.uint32)
    vec = jax.ShapeDtypeStruct((B,), jnp.int32)
    t0 = time.perf_counter()
    compiled = count_step_sort.lower(
        codes, vec, vec, k=21, canonical=True, group_keys=256,
        packed_width=L).compile()
    ma = compiled.memory_analysis()
    log(f"count step B={B} L={L} k=21: compile {time.perf_counter() - t0:.3f}"
        f" s; memory_analysis: argument {ma.argument_size_in_bytes} B, "
        f"output {ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} "
        f"B, generated code {ma.generated_code_size_in_bytes} B")


def phase_main(d: str, corpus: str) -> None:
    from kmer_tpu.pipeline.table import KmerTable
    from kmer_tpu.utils import oracle, stagetime
    log("phase 1: count -k 21 --canonical on the 1 M-read corpus (CLI)")
    npz = os.path.join(d, "main.npz")
    tsv = os.path.join(d, "main.tsv")
    walls = {}
    for label in ("cold", "warm"):
        st: dict = {}
        t0 = time.perf_counter()
        with stagetime.collect(st):
            cli(["count", corpus, "-k", "21", "--canonical",
                 "--out-npz", npz], tsv)
        walls[label] = time.perf_counter() - t0
        log(f"  {label}: {walls[label]:.3f} s wall; stages "
            + ", ".join(f"{k}={v:.3f}" for k, v in sorted(st.items())))
    table = KmerTable.load(npz)
    total = int(table.counts.sum())
    log(f"  warm: {N_READS / walls['warm']:.0f} reads/s, "
        f"{total / walls['warm']:.0f} k-mers/s, {table.num_distinct} "
        f"distinct of {total} k-mers; cold - warm "
        f"{walls['cold'] - walls['warm']:.3f} s")
    t0 = time.perf_counter()
    codes, lengths = oracle.read_fasta_codes_np(corpus)
    keys, counts = oracle.oracle_count_np(codes, lengths, 21, canonical=True)
    log(f"  NumPy reference: {len(keys)} distinct, "
        f"{time.perf_counter() - t0:.1f} s")
    check(total == N_READS * (READ_LEN - 21 + 1), "every k-mer counted")
    check(table_equals_np(table, keys, counts),
          "table bit-identical to the NumPy reference")
    check(os.path.getsize(tsv) > 0, "TSV written")


def phase_multiword(d: str, corpus: str) -> None:
    from kmer_tpu import KmerConfig, count_fasta
    from kmer_tpu.utils import oracle
    log("phase 2: multi-word keys on a 20 k-read slice")
    sl = os.path.join(d, "slice_20k.fasta")
    write_slice(corpus, sl, 20_000)
    codes, lengths = oracle.read_fasta_codes_np(sl)
    for k in (31, 45):
        t = twice(f"k={k}", lambda: count_fasta(
            sl, KmerConfig(k=k, canonical=True)))
        check(table_equals_np(t, *oracle.oracle_count_np(
            codes, lengths, k, canonical=True)),
            f"k={k} table equals the oracle")


def phase_parity(d: str) -> None:
    import jax
    from kmer_tpu.config import KmerConfig
    from kmer_tpu.io.fasta import iter_batches, parse_seqs
    from kmer_tpu.pipeline.count import gapped_device_len, gapped_step_sort
    log("phase 3: parity on sample.fasta")
    cfg = KmerConfig(gapped=True, batch_reads=256, max_read_len=512)
    codes, offsets = parse_seqs(SAMPLE)
    longest = int(np.max(np.diff(offsets)))
    width = min(gapped_device_len(cfg),
                -(-max(longest, cfg.window_span) // 32) * 32)
    batch = next(iter_batches(codes, offsets, batch_reads=256,
                              max_len=width, overlap=cfg.overlap,
                              packed=True))
    t0 = time.perf_counter()
    gapped_step_sort.lower(
        *(jax.ShapeDtypeStruct(x.shape, x.dtype) for x in
          (batch.codes, batch.lengths, batch.start_limits)),
        c_min=cfg.c_min, c_max=cfg.c_max, l_len=cfg.l_len, r_len=cfg.r_len,
        group_keys=cfg.sort_group_keys,
        packed_width=batch.packed_width).compile()
    log(f"  gapped step at width {width} (batch 256): compile "
        f"{time.perf_counter() - t0:.3f} s")
    out = os.path.join(d, "parity.txt")

    def run():
        cli(["parity", SAMPLE], out)
        with open(out, "rb") as f:
            return hashlib.md5(f.read()).hexdigest()
    md5 = twice("parity", run)
    log(f"  md5 {md5}")
    check(md5 == SAMPLE_MD5, "parity md5 matches the reference dump")


def phase_other_paths(d: str, corpus: str) -> None:
    from kmer_tpu import KmerConfig, count_fasta
    from kmer_tpu.ops.sketch import hll_classes
    from kmer_tpu.pipeline.sketch import sketch_histograms
    from kmer_tpu.pipeline.table import KmerTable
    from kmer_tpu.utils import oracle
    log("phase 4: other paths on a 100 k-read slice")
    sl = os.path.join(d, "slice_100k.fasta")
    write_slice(corpus, sl, 100_000)
    codes, lengths = oracle.read_fasta_codes_np(sl)
    cfg = KmerConfig(k=21, canonical=True)
    base = twice("default path", lambda: count_fasta(sl, cfg))
    check(table_equals_np(base, *oracle.oracle_count_np(
        codes, lengths, 21, canonical=True)), "default path equals the oracle")
    t = twice("--compact", lambda: count_fasta(sl, cfg.replace(compact=True)))
    check(t == base, "--compact equals the default path")
    t = twice("device merge on", lambda: count_fasta(
        sl, cfg.replace(device_merge="on")))
    check(t == base, "device merge equals the default path")
    npz = os.path.join(d, "two_pass.npz")
    counter = [0]

    def two_pass():
        counter[0] += 1
        spill = os.path.join(d, f"spill{counter[0]}")
        cli(["count", sl, "-k", "21", "--canonical", "--two-pass",
             "--spill-dir", spill, "--out-npz", npz],
            os.path.join(d, "two_pass.tsv"))
        return KmerTable.load(npz)
    t = twice("--two-pass", two_pass)
    check(t == base, "--two-pass equals the default path")
    histo_out = os.path.join(d, "histo.txt")

    def histo():
        cli(["histo", sl, "-k", "21", "--canonical"], histo_out)
        with open(histo_out) as f:
            return f.read()
    got = twice("histo", histo)
    want = "".join(f"{m}\t{n}\n" for m, n in
                   sorted(base.multiplicity_histogram().items()))
    check(got == want, "histo equals the table's spectrum")
    dense = twice("dense k=8", lambda: count_fasta(
        sl, KmerConfig(k=8, canonical=True, mode="dense")))
    check(table_equals_np(dense, *oracle.oracle_count_np(
        codes, lengths, 8, canonical=True)), "dense k=8 equals the oracle")
    mask = "110101011"
    sp = twice(f"--seed-mask {mask}", lambda: count_fasta(
        sl, KmerConfig(seed_mask=mask, canonical=True)))
    check(table_equals_np(sp, *oracle.oracle_count_np(
        codes, lengths, 0, canonical=True, mask=mask)),
        "spaced seed equals the oracle")
    card_out = os.path.join(d, "card.txt")

    def card():
        cli(["card", sl, "-k", "21", "--canonical"], card_out)
        with open(card_out) as f:
            return f.read()
    printed = twice("card -k 21", card)
    log("  " + printed.strip().replace("\n", "; "))
    b = 10
    _, hists, totals = sketch_histograms([sl], [21], cfg, b=b)
    keys = oracle.oracle_keys_np(codes, lengths, 21, canonical=True)
    cls, _ = hll_classes([keys[:, j] for j in range(keys.shape[1])],
                         None, b)
    want_h = np.bincount(cls, minlength=1 << (b + 5))
    check(np.array_equal(hists[21], want_h),
          "card histogram equals the NumPy histogram of the same classes")
    check(f"total_kmers\t{len(keys)}\n" in printed and totals[21] == len(keys),
          "card total equals the k-mer count")


def run_one_card(jax, jnp, d: str) -> None:
    print_policies()
    corpus = make_corpus(d)
    print_step_memory(jax, jnp)
    phase_main(d, corpus)
    phase_multiword(d, corpus)
    phase_parity(d)
    phase_other_paths(d, corpus)


def run_four_cards(jax, d: str) -> None:
    from kmer_tpu import KmerConfig, count_fasta
    from kmer_tpu.parallel.multihost import count_fasta_multihost
    if len(jax.devices()) != 4 or jax.process_count() != 1:
        raise SmokeFailure(f"--four-cards needs one process with 4 "
                           f"devices, got {len(jax.devices())} devices in "
                           f"{jax.process_count()} processes")
    corpus = make_corpus(d)
    cfg = KmerConfig(k=21, canonical=True)
    one = twice("one card, count_fasta", lambda: count_fasta(corpus, cfg))
    for n_seq in (1, 2):
        shape = f"data={4 // n_seq} x seq={n_seq}"
        t = twice(f"count_fasta_multihost {shape}", lambda: (
            count_fasta_multihost(corpus, cfg, n_seq=n_seq)))
        check(t == one, f"mesh {shape} table bit-identical to one card")
    gcfg = KmerConfig(gapped=True, batch_reads=256, max_read_len=512)
    g_one = count_fasta(SAMPLE, gcfg)
    for n_seq in (1, 2):
        t = twice(f"gapped mesh seq={n_seq}", lambda: (
            count_fasta_multihost(SAMPLE, gcfg, n_seq=n_seq)))
        check(t == g_one, f"gapped mesh seq={n_seq} equals one card")
    sl = os.path.join(d, "slice_100k.fasta")
    write_slice(corpus, sl, 100_000)
    dcfg = KmerConfig(k=8, canonical=True, mode="dense", batch_reads=8192)
    d_one = count_fasta(sl, dcfg)
    t = twice("dense psum k=8", lambda: count_fasta_multihost(sl, dcfg))
    check(t == d_one, "dense psum table equals one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh path, on four cards")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        import kmer_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the kmer_tpu package is not beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    if args.four_cards:
        # one process drives all four cards; with no cluster environment
        # initialize() joins nothing
        from kmer_tpu.parallel.multihost import initialize
        initialize()
    import jax
    import jax.numpy as jnp
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 1
    from kmer_tpu.utils.jaxcache import enable_compilation_cache
    enable_compilation_cache()
    print_environment(jax)
    t0 = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            if args.four_cards:
                run_four_cards(jax, d)
            else:
                run_one_card(jax, jnp, d)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
