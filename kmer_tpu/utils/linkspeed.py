"""D2H link-speed probe for the link-aware counting policies.

Dense mode's value is its O(4^k)-bytes once-per-corpus D2H (the count
table stays device-resident between batches), bought with a per-key
scatter-add that costs more device time than the sort step's.  The
device-resident sparse table (ops/devmerge) makes the same trade for
sort mode.  Both trades flip with the host link: on a slow attachment
the device-resident table wins, while on a fast PCIe/NVLink host the
sort path's per-batch readback is cheap.  config.effective_mode and
pipeline.count._devmerge_ok consult this probe to route "auto" —
lazily, so constructing a KmerConfig never touches the backend
(multihost must initialize jax.distributed first).

The breakeven constants below are derived from per-lane byte counts and
per-lane device costs; the device costs are not yet measured on the
current card (ROADMAP 3.3).
"""

from __future__ import annotations

import os

_cache: dict = {}

# breakeven: the non-compact sort path reads back ~12 B/lane (key +
# run-start + count); dense spends extra device time per lane instead.
# Links slower than 12 B / (extra seconds per lane) favor the dense
# device-resident table.
DENSE_BREAKEVEN_GBPS = 5.0


def d2h_gbps(probe_mb: int = 4) -> float:
    """Device->host bandwidth in GB/s, measured once per process.

    Env override KMER_TPU_D2H_GBPS skips the probe entirely (useful in
    tests and on rigs whose bandwidth is known).  On the CPU backend
    "D2H" is a host memcpy — returns inf (never the bottleneck).
    """
    env = os.environ.get("KMER_TPU_D2H_GBPS")
    if env:
        return float(env)
    if "gbps" not in _cache:
        import time

        import numpy as np

        import jax
        if jax.default_backend() == "cpu":
            _cache["gbps"] = float("inf")
        else:
            import jax.numpy as jnp

            # a FRESH device buffer per rep: a buffer the host has
            # already fetched may be served from a host-side copy, which
            # would time a memcpy instead of the link
            n = probe_mb << 20
            make = jax.jit(lambda s: jnp.zeros((n // 4,), jnp.int32) + s)
            np.asarray(make(0))      # warm: executable + link setup
            best = float("inf")
            for rep in (1, 2):
                x = make(rep)
                t0 = time.perf_counter()
                np.asarray(x)
                best = min(best, time.perf_counter() - t0)
            _cache["gbps"] = (n / best) / 1e9
    return _cache["gbps"]


def dense_auto_ok() -> bool:
    """auto-mode policy: dense (device-resident 4^k table) only when
    the D2H link is slower than the breakeven.  Threshold overridable
    via KMER_TPU_DENSE_LINK_GBPS."""
    thr = float(os.environ.get("KMER_TPU_DENSE_LINK_GBPS",
                               DENSE_BREAKEVEN_GBPS))
    return d2h_gbps() < thr


# dense k=9..12: the hybrid's per-batch readback costs 5 B/lane (u32
# key + i8 count) against a device scatter-add's per-lane cost; links
# slower than 5 B / (scatter seconds per lane) favor the scatter.
SCATTER_BREAKEVEN_GBPS = 0.49


def dense_scatter_ok() -> bool:
    """dense k=9..12 policy: accumulate the 4^k table ON DEVICE via
    scatter-add (zero per-batch D2H) only when the link is slower than
    the scatter/readback crossover; otherwise the hybrid
    (device sort-count + host np.add.at) wins.  KMER_TPU_DENSE_SCATTER
    forces (1) or disables (0)."""
    env = os.environ.get("KMER_TPU_DENSE_SCATTER")
    if env in ("0", "1"):
        return env == "1"
    thr = float(os.environ.get("KMER_TPU_SCATTER_LINK_GBPS",
                               SCATTER_BREAKEVEN_GBPS))
    return d2h_gbps() < thr
