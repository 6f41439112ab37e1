"""Stage timing, device tracing, the compile cache and compile counting.

The reference hand-rolls wall-clock pairs around every phase
(local_faldoi.cpp:1074-1282, global_faldoi.cpp:621-845) and prints a
percentage breakdown.  Here: a ``StageTimer`` collecting named spans with
the same style of report, plus an optional ``jax.profiler`` trace context
for device-level inspection (replaces the reference's per-substep chrono
instrumentation, which XLA fusion makes meaningless per-op).
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional

# <checkout>/.jax_cache: a fixed path, because the cache key includes it
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads it
    itself) and no other path is set; otherwise the cache lives in the
    checkout's ``.jax_cache``.  Call before the first compilation."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        import jax

        path = _DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path


class CompileCounter:
    """Counts XLA programs compiled or loaded from the persistent cache
    (JAX's monitoring events) from construction on."""

    def __init__(self):
        import jax

        self.programs = 0
        self.cache_hits = 0
        self.compile_s = 0.0

        def on_duration(event, secs, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                self.programs += 1
                self.compile_s += secs

        def on_event(event, **_):
            if event == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)


class StageTimer:
    """Collects named wall-clock spans and prints a breakdown."""

    def __init__(self, enabled: bool = True, out=sys.stderr):
        self.enabled = enabled
        self.out = out
        self.spans: Dict[str, float] = {}
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.time() - t
            if self.enabled:
                print(f"({name}) took {self.spans[name]:.3f}s", file=self.out)

    def report(self):
        """Total + percentage breakdown (tvl2OF profiling style,
        global_faldoi.cpp:824-843)."""
        total = time.time() - self._t0
        if not self.enabled:
            return
        print(f"all stages took {total:.3f}s", file=self.out)
        for name, s in sorted(self.spans.items(), key=lambda kv: -kv[1]):
            print(f"\t({name}) total: {s:.3f}, perc.: {100 * s / total:.1f}%",
                  file=self.out)


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None):
    """jax.profiler trace context; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import jax

    with jax.profiler.trace(logdir):
        yield
