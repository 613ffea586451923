"""Runtime telemetry: FPS / success-rate / stage-timing reporting.

Replaces the reference's printf telemetry — the 1 Hz FPS + tracking mode +
success counters + mean registration time line
(reference GoodColorReconstruction.py:580-586,671-681) and the frame counters
(bundlefusion_reconstructionWorks.py:192-193) — with a small structured
reporter the pipelines share. Also provides log-level prefixes matching the
reference's [INFO]/[WARNING]/[ERROR] convention
(GoodColorReconstruction.py:18-24).
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, Optional


def log_info(msg: str) -> None:
    print(f"[INFO] {msg}")


def log_warning(msg: str) -> None:
    print(f"[WARNING] {msg}")


def log_error(msg: str) -> None:
    print(f"[ERROR] {msg}")


class Telemetry:
    """Windowed FPS + counters + timers, reported at most once per second."""

    def __init__(self, report_interval: float = 1.0,
                 sink: Optional[Callable[[str], None]] = None,
                 window: int = 120):
        self.report_interval = report_interval
        self.sink = sink or print
        self._frame_times = collections.deque(maxlen=window)
        self._counters: Dict[str, int] = collections.defaultdict(int)
        self._timers: Dict[str, collections.deque] = collections.defaultdict(
            lambda: collections.deque(maxlen=window)
        )
        self._gauges: Dict[str, float] = {}
        self._last_report = time.perf_counter()
        self.frame_count = 0

    def tick_frame(self) -> None:
        self._frame_times.append(time.perf_counter())
        self.frame_count += 1
        # process-health guard, piggybacked on the one per-frame host hook
        # every pipeline already calls: long CPU-backend sessions keep
        # compiling new shapes (bucket ladders, streaming growth) and march
        # toward the kernel's vm.max_map_count — fatal SIGSEGV at ~65k
        # mappings (see process_map_count). One /proc read per 512 frames;
        # a no-op on the GPU, where compiled kernels live on the card.
        if self.frame_count % 512 == 0 and release_jit_maps_if_crowded():
            self.count("jit_maps_released")

    def count(self, name: str, inc: int = 1) -> None:
        self._counters[name] += inc

    def gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def time_block(self, name: str):
        """with telemetry.time_block("registration"): ..."""
        return _Timer(self, name)

    def record_time(self, name: str, seconds: float) -> None:
        self._timers[name].append(seconds)

    @property
    def fps(self) -> float:
        if len(self._frame_times) < 2:
            return 0.0
        dt = self._frame_times[-1] - self._frame_times[0]
        return (len(self._frame_times) - 1) / dt if dt > 0 else 0.0

    def mean_time_ms(self, name: str) -> float:
        t = self._timers.get(name)
        return 1000.0 * sum(t) / len(t) if t else 0.0

    def maybe_report(self, extra: str = "") -> Optional[str]:
        now = time.perf_counter()
        if now - self._last_report < self.report_interval:
            return None
        self._last_report = now
        parts = [f"fps {self.fps:5.1f}", f"frames {self.frame_count}"]
        for k, v in sorted(self._counters.items()):
            parts.append(f"{k} {v}")
        for k in sorted(self._timers):
            parts.append(f"{k} {self.mean_time_ms(k):.1f}ms")
        for k, v in sorted(self._gauges.items()):
            parts.append(f"{k} {v:.3g}")
        if extra:
            parts.append(extra)
        line = "[INFO] " + " | ".join(parts)
        self.sink(line)
        return line


def process_map_count() -> int:
    """Number of memory mappings of this process (0 where /proc is absent).

    Why it matters: every LARGE executable XLA:CPU JIT-compiles leaves
    hundreds-to-thousands of code/rodata/data mappings alive for as long as
    the compiled executable is cached (measured on this image: ONE
    auto-grow mesh-extraction ladder = +5.5k mappings; jax.clear_caches()
    returns the process to baseline). A long-lived CPU-backend process that
    keeps compiling new shapes therefore marches toward the kernel's
    ``vm.max_map_count`` (65530 by default) and DIES WITH SIGSEGV inside
    the next mmap-backed compile or cache load — that is how the full test
    suite crashed at ~94% before `release_jit_maps_if_crowded` existed.
    The GPU path is not affected the same way (kernels live on the card),
    so live pipelines only need this guard on CPU."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def release_jit_maps_if_crowded(soft_limit: int = 35_000) -> bool:
    """Call ``jax.clear_caches()`` when the process nears the kernel map
    limit (see `process_map_count`). Returns True when a clear happened.
    Safe to call at any cadence: a clear only costs recompiles of whatever
    jitted shapes are used again (softened by the persistent compilation
    cache), and the headroom between `soft_limit` and the kernel's 65530
    default covers the largest single-compile burst observed (~10k)."""
    if process_map_count() <= soft_limit:
        return False
    import jax

    jax.clear_caches()
    return True


class _Timer:
    def __init__(self, telemetry: Telemetry, name: str):
        self.telemetry = telemetry
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.telemetry.record_time(self.name, time.perf_counter() - self.t0)
        return False
