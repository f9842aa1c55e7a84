"""Tracing and throughput instrumentation.

Every stage driver records named spans and derived rates (scenes/min,
frames/sec — the north-star metrics). The port's copy of
beyondff_tpu/utils/profiling.py's ``StageProfiler``; a span measures host
time, so a caller timing device work synchronizes inside the span.

Usage:
    prof = StageProfiler("segmentation_2d")
    with prof.span("scene", frames=len(frame_ids)):
        ...
    print(prof.report(), prof.rate("scene", "frames"))

    with trace("/tmp/tb"):          # torch.profiler capture, a Chrome trace
        with annotate("lift"):      # a named range in it (and NVTX on the card)
            run_heavy_thing()

On the card, ``device_spans`` and ``device_ms`` read the device's own events
from ``torch.profiler``; the peak rates below give the bounds a kernel's
time is held against.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

# H100 SXM peaks (data sheet): the memory rate, dense bf16 and f32 (non-tensor)
# FLOP/s, dense int8 tensor OP/s and dense TF32 tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_INT8_OPS = 1979e12
PEAK_TF32_FLOPS = 495e12


def f32_attention_bounds(flops: float, nbytes: float) -> Tuple[float, float, str]:
    """The least milliseconds an H100 takes for f32-grade attention of
    ``flops`` operations moving ``nbytes``: (bound_ms, bound_fma_ms,
    bound_by). ``bound_ms`` is 3xTF32 on the tensor cores (three TF32
    products per f32 product, 495 TFLOP/s), the fastest way to f32
    accuracy; ``bound_fma_ms`` the same operations as f32 FMAs (67 TFLOP/s).
    Each is the larger of its operation time and the byte time."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    fma_ms = flops / PEAK_FLOPS["float32"] * 1e3
    return (max(tf32_ms, bytes_ms), max(fma_ms, bytes_ms),
            "operations" if tf32_ms >= bytes_ms else "bytes")


class StageProfiler:
    def __init__(self, stage: str):
        self.stage = stage
        self.durations: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.items: Dict[str, int] = defaultdict(int)
        self._t0 = time.time()
        self._lock = threading.Lock()  # spans may close on loader threads

    @contextlib.contextmanager
    def span(self, name: str, **items: int) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.durations[name] += dt
                self.counts[name] += 1
                for key, n in items.items():
                    self.items[f"{name}.{key}"] += int(n)

    def rate(self, name: str, item: str) -> Optional[float]:
        """items/sec for a span, e.g. rate("lift", "frames")."""
        dur = self.durations.get(name)
        n = self.items.get(f"{name}.{item}")
        if not dur or n is None:
            return None
        return n / dur

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

    def to_json(self) -> str:
        return json.dumps(
            {
                "stage": self.stage,
                "durations_s": dict(self.durations),
                "counts": dict(self.counts),
                "items": dict(self.items),
            }
        )


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """``torch.profiler`` capture around a region (host ops, and the card's
    kernels and copies when there is one), written to ``log_dir`` as a
    Chrome trace (``*.pt.trace.json``; chrome://tracing, Perfetto or
    TensorBoard's profiler plugin). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as p:
        yield p
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range inside a profiler trace, and an NVTX range on the
    card."""
    import torch

    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


def device_spans(fn: Callable[[], object]) -> List[Tuple[float, float, str]]:
    """Run ``fn`` under ``torch.profiler`` (device activity only), then
    synchronize; returns the sorted (start us, end us, name) of its device
    events (kernels, copies, sets)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in p.events()
                  if e.device_type == DeviceType.CUDA)


def device_ms(fn: Callable[[], object], iters: int = 5, windows: int = 3) -> float:
    """Device time per call of ``fn``: the summed durations of the device
    events of ``iters`` calls under ``torch.profiler``, over ``iters``, after
    one call outside it. Unlike CUDA events around a loop it leaves out the
    host work around each launch, which a kernel of a few microseconds would
    hide. CUPTI now and then drops events from a window, all of them or a
    share (one window read 0.214 ms of a 0.280 ms kernel), and never adds
    any, so the largest of ``windows`` non-empty windows is taken, from at
    most four times as many tries; raises if every try is empty."""
    import torch

    fn()
    torch.cuda.synchronize()
    readings = []
    for _ in range(4 * windows):
        spans = device_spans(lambda: [fn() for _ in range(iters)])
        if spans:
            readings.append(sum(e - s for s, e, _name in spans) / iters / 1e3)
            if len(readings) == windows:
                break
    if not readings:
        raise RuntimeError(f"torch.profiler recorded no device activity in {4 * windows} tries")
    return max(readings)
