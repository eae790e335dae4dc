"""Observability: phase timers, throughput counters, structured reports.

Capability parity: the reference prints sizes/ratios to stdout (SURVEY.md
§5 'metrics/logging'). The unit of account is GB/s per phase per
device (BASELINE.json:2), so timers block on device results and
report bytes moved per phase.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax


@dataclass
class PhaseStats:
    seconds: float = 0.0
    bytes: int = 0
    calls: int = 0

    @property
    def gbps(self) -> float | None:
        return self.bytes / self.seconds / 1e9 if self.seconds else None


@dataclass
class Trace:
    """Collects per-phase wall-clock + throughput for one codec run."""
    phases: dict[str, PhaseStats] = field(default_factory=dict)

    @contextmanager
    def phase(self, name: str, nbytes: int = 0, sync=None):
        """Time a phase. `sync`: a jax array (or pytree) to block on so
        device work is attributed to the phase that launched it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                jax.block_until_ready(sync)
            st = self.phases.setdefault(name, PhaseStats())
            st.seconds += time.perf_counter() - t0
            st.bytes += nbytes
            st.calls += 1

    def report(self) -> dict:
        return {
            name: {
                "seconds": round(st.seconds, 6),
                "bytes": st.bytes,
                "GBps": round(st.gbps, 4) if st.gbps else None,
                "calls": st.calls,
            }
            for name, st in self.phases.items()
        }

    def dumps(self) -> str:
        return json.dumps(self.report())


@contextmanager
def jax_profile(outdir: str):
    """Wrap a region in a jax.profiler trace (view with tensorboard /
    xprof). Usage: `with metrics.jax_profile('/tmp/trace'): ...`"""
    jax.profiler.start_trace(outdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def scaling_report(per_device_bytes: int, n_devices: int,
                   seconds_1: float, seconds_n: float) -> dict:
    """Scaling efficiency vs ideal linear (BASELINE.json:5 '>=80%')."""
    ideal = seconds_1 / n_devices
    eff = ideal / seconds_n if seconds_n else None
    return {
        "n_devices": n_devices,
        "seconds_1dev": seconds_1,
        "seconds_ndev": seconds_n,
        "scaling_efficiency": round(eff, 4) if eff else None,
        "aggregate_GBps": round(
            per_device_bytes * n_devices / seconds_n / 1e9, 4)
        if seconds_n else None,
    }
