"""Tracing / profiling utilities.

The reference's observability is per-epoch wall-clock history and tqdm
postfixes (SURVEY.md §5).  This rebuild adds ``jax.profiler`` traces and a
structured per-stage timer that the pipeline and benchmarks share.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

__all__ = ["StageTimer", "trace", "device_memory_stats",
           "enable_compilation_cache"]


class StageTimer:
    """Accumulates named wall-clock spans; ``.summary()`` is JSON-friendly."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.spans[name] = self.spans.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"total_s": round(self.spans[name], 4),
                       "calls": self.counts[name],
                       "mean_s": round(self.spans[name]
                                       / max(1, self.counts[name]), 4)}
                for name in self.spans}

    def dump(self) -> str:
        return json.dumps(self.summary(), indent=2)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/fgk_jax_trace"):
    """jax.profiler trace context; view with TensorBoard/XProf."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def device_memory_stats() -> Optional[Dict]:
    """Per-device memory stats when the backend exposes them."""
    import jax
    out = {}
    for d in jax.devices():
        s = d.memory_stats()
        if s:
            out[str(d)] = {
                "bytes_in_use": s.get("bytes_in_use"),
                "peak_bytes_in_use": s.get("peak_bytes_in_use"),
                "bytes_limit": s.get("bytes_limit"),
            }
    return out or None


CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compilation_cache() -> None:
    """Turn on JAX's persistent compilation cache.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
    nothing is changed here.  Otherwise the cache lives at ``CACHE_DIR``, a
    fixed directory inside the checkout: the path is part of each entry's
    key, so a path that moved between runs would never hit."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
