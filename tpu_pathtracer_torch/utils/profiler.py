"""Stage profiler with rolling frame history.

Counterpart: `tpu_pathtracer/utils/profiler.py` (copied): named stages,
per-frame timings with a 120-frame ring history, avg/min/max statistics,
scoped timing, and an end-of-run summary as a table or JSON. Where the
JAX package waits for its device with `jax.effects_barrier()` at a
stage's exit, a `Profiler(device)` on a CUDA device synchronizes that
device, so device time is attributed to the stage that launched it; on
the CPU there is nothing to wait for.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from dataclasses import dataclass, field

import torch

HISTORY = 120  # frames of rolling history (profiler.h:100-160)


@dataclass
class Stage:
    name: str
    history: deque = field(default_factory=lambda: deque(maxlen=HISTORY))
    total: float = 0.0
    count: int = 0

    def record(self, seconds: float) -> None:
        self.history.append(seconds)
        self.total += seconds
        self.count += 1

    @property
    def avg_ms(self) -> float:
        return (self.total / self.count) * 1e3 if self.count else 0.0

    @property
    def min_ms(self) -> float:
        return min(self.history) * 1e3 if self.history else 0.0

    @property
    def max_ms(self) -> float:
        return max(self.history) * 1e3 if self.history else 0.0

    @property
    def last_ms(self) -> float:
        return self.history[-1] * 1e3 if self.history else 0.0


class Profiler:
    """Named-stage wall profiler. Use `with profiler.stage("Render"):`."""

    def __init__(self, device: str | torch.device | None = None):
        self.device = None if device is None else torch.device(device)
        self.stages: dict[str, Stage] = {}
        self.frame_history: deque = deque(maxlen=HISTORY)
        self._frame_start: float | None = None
        # Profiler-window toggles (ui_windows.h:372-380: "Enable
        # Profiling" checkbox + "Reset Stats" button).
        self.enabled = True

    def reset(self) -> None:
        """Profiler::reset — drop all stage + frame history."""
        self.stages.clear()
        self.frame_history.clear()
        self._frame_start = None

    def add_stage(self, name: str) -> Stage:
        if name not in self.stages:
            self.stages[name] = Stage(name)
        return self.stages[name]

    @contextlib.contextmanager
    def stage(self, name: str):
        """Scoped stage timing (ScopedProfiler RAII, profiler.h:287-305).
        Synchronizes the profiler's CUDA device at exit so device time is
        attributed to the stage that launched it."""
        if not self.enabled:
            yield None
            return
        st = self.add_stage(name)
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            if self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            st.record(time.perf_counter() - t0)

    # --- frame accounting (Profiler::endFrame, profiler.h:212-253) ---

    def begin_frame(self) -> None:
        self._frame_start = time.perf_counter()

    def end_frame(self) -> float:
        if self._frame_start is None:
            return 0.0
        dt = time.perf_counter() - self._frame_start
        self.frame_history.append(dt)
        self._frame_start = None
        return dt

    @property
    def fps(self) -> float:
        if not self.frame_history:
            return 0.0
        return len(self.frame_history) / sum(self.frame_history)

    # --- reporting ---

    def summary(self) -> str:
        lines = [
            f"{'stage':<20} {'last ms':>9} {'avg ms':>9} "
            f"{'min ms':>9} {'max ms':>9} {'count':>6}"
        ]
        for s in self.stages.values():
            lines.append(
                f"{s.name:<20} {s.last_ms:>9.2f} {s.avg_ms:>9.2f} "
                f"{s.min_ms:>9.2f} {s.max_ms:>9.2f} {s.count:>6d}"
            )
        if self.frame_history:
            lines.append(f"fps: {self.fps:.1f}")
        return "\n".join(lines)

    def to_json(self) -> str:
        return json.dumps(
            {
                name: {
                    "last_ms": s.last_ms,
                    "avg_ms": s.avg_ms,
                    "min_ms": s.min_ms,
                    "max_ms": s.max_ms,
                    "count": s.count,
                }
                for name, s in self.stages.items()
            },
            indent=2,
        )
