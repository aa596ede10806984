"""Profiling hooks + roofline accounting (SURVEY.md §5.1).

The reference has zero observability (no timers, no tracing crates —
Cargo.toml:8-10).  Here:

  * `trace(dir)` wraps jax.profiler.trace — open the dump with
    tensorboard/xprof to see per-op device timelines;
  * `Roofline` converts a measured step time into the achieved fraction
    of the device-memory roofline.

The roofline model for sort-mode counting charges the minimum
device-memory traffic the algorithm must move: the code batch in, plus
one round trip of the packed keys between extraction and sort (read
once, write once), plus the run-length outputs.  Dense mode charges the
histogram update instead.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

# Peak device-memory bandwidth, bytes/s, keyed by jax device_kind
# (NVIDIA H100 data sheet: SXM 3.35 TB/s, PCIe 80 GB 2.0 TB/s).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def detect_hbm_bw() -> float:
    """Published peak device-memory bandwidth of the attached device.
    A device missing from HBM_BYTES_PER_S is an error, not a default."""
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in HBM_BYTES_PER_S:
        raise ValueError(f"no peak bandwidth known for device {kind!r}; "
                         f"add it to utils.profiling.HBM_BYTES_PER_S")
    return HBM_BYTES_PER_S[kind]


@contextlib.contextmanager
def trace(log_dir: str | None):
    """jax.profiler trace context; no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import jax
    with jax.profiler.trace(log_dir):
        yield


@dataclass
class Roofline:
    """Minimum-traffic model for one count step."""
    batch_bytes: int      # code batch in
    key_bytes: int        # N * W * 4, one read + one write for the sort
    out_bytes: int        # run-length outputs

    @property
    def total_bytes(self) -> int:
        return self.batch_bytes + 2 * self.key_bytes + self.out_bytes

    def seconds_at_roofline(self, hbm_bytes_per_s: float | None = None) -> float:
        return self.total_bytes / (hbm_bytes_per_s or detect_hbm_bw())

    def fraction(self, measured_seconds: float,
                 hbm_bytes_per_s: float | None = None) -> float:
        """Achieved fraction of the roofline (1.0 = speed of light)."""
        return self.seconds_at_roofline(hbm_bytes_per_s) / measured_seconds

    @staticmethod
    def for_sort_step(B: int, L: int, k: int, W: int) -> "Roofline":
        N = B * (L - k + 1)
        return Roofline(batch_bytes=B * L,
                        key_bytes=N * W * 4,
                        out_bytes=N * (W * 4 + 4 + 1))

    @staticmethod
    def for_fused_step(B: int, L: int, k: int, W: int,
                       cnt_bytes: int = 4) -> "Roofline":
        """Minimum traffic of a step that never writes its keys between
        extraction and counting: codes in once, keys + counts out once
        (key_bytes=0).  The bound a fused extract + count step would
        approach."""
        N = B * (L - k + 1)
        return Roofline(batch_bytes=B * L, key_bytes=0,
                        out_bytes=N * (W * 4 + cnt_bytes))

    @staticmethod
    def for_dense_step(B: int, L: int, k: int) -> "Roofline":
        N = B * (L - k + 1)
        hist = 4 ** k * 4
        return Roofline(batch_bytes=B * L, key_bytes=N * 2,
                        out_bytes=2 * hist)
