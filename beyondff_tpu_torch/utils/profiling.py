"""Tracing and throughput instrumentation.

Every stage driver records named spans and derived rates (scenes/min,
frames/sec — the north-star metrics). The port's copy of
beyondff_tpu/utils/profiling.py's ``StageProfiler``; a span measures host
time, so a caller timing device work synchronizes inside the span.

Usage:
    prof = StageProfiler("segmentation_2d")
    with prof.span("scene", frames=len(frame_ids)):
        ...
    print(prof.report())
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


class StageProfiler:
    def __init__(self, stage: str):
        self.stage = stage
        self.durations: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)
        self._t0 = time.time()

    @contextlib.contextmanager
    def span(self, name: str, **items: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.durations[name] += time.perf_counter() - t0
            self.counts[name] += 1
            for key, n in items.items():
                self.items[f"{name}.{key}"] += int(n)

    def report(self) -> str:
        total = time.time() - self._t0
        lines = [f"[{self.stage}] wall={total:.2f}s"]
        for name in self.durations:
            line = f"  {name}: {self.durations[name]:.2f}s x{self.counts[name]}"
            for key, n in self.items.items():
                span, _, item = key.partition(".")
                if span == name:
                    line += f" | {n} {item} ({n / max(self.durations[name], 1e-9):.1f}/s)"
            lines.append(line)
        return "\n".join(lines)
