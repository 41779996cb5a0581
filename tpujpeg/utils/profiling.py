"""Profiling/observability helpers (SURVEY §6 tracing parity).

The reference instruments with NVTX ranges + nsys/ncu scripts
(cuda-decoder/benchmark/benchmark.cu:41,70, bench_profile.sh).  The JAX
equivalents: `jax.profiler` device traces viewable in Perfetto/XProf, and
`jax.named_scope` annotations that label our pipeline stages inside the
trace.  JSONL timing records come from the benchmark harnesses.
"""

from __future__ import annotations

import contextlib
import json
import time

import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a device profiler trace (open with Perfetto / XProf).

        with device_trace("/tmp/tpujpeg-trace"):
            decoder.decode(batch)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


scope = jax.named_scope  # stage annotation inside jit programs


class StageTimer:
    """Wall-clock stage timing emitted as JSONL (append-only, the
    two-tier scheme of the reference's benchmark_results.txt + JSON)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = {"stage": name, "s": round(time.perf_counter() - t0, 6), **meta}
            self.records.append(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
