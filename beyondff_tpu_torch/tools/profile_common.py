"""What the port's profiling CLIs share: their options, timing and output.

Each CLI (``profile_models``, ``profile_sam``, ``profile_gdino_blocks``,
``profile_enhancer``) times model variants at ``--scale full`` (the
published widths: Swin-B Grounding-DINO, SAM ViT-H) or ``--scale test``
(the ``"test"`` presets, for CPU runs), in ``--dtype`` (default bfloat16, as
the JAX tools), and prints one JSON line per variant. On the card a variant's
``ms`` comes from CUDA events around ``--iters`` calls (best of two rounds)
and ``device_ms`` from ``utils.profiling.device_ms`` (the device's own
events); on the CPU ``ms`` is the host clock and ``device_ms`` is null.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Callable, Optional

import torch

from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels.dispatch import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def parser(description: str, iters: int = 8) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", choices=("test", "full"), default="full")
    ap.add_argument("--dtype", choices=tuple(DTYPES), default="bfloat16")
    ap.add_argument("--iters", type=int, default=iters)
    return ap


def setup(args) -> tuple:
    """(device, dtype) of the parsed options; seeds the global RNG."""
    torch.manual_seed(0)
    return resolve_device(args.device), DTYPES[args.dtype]


@contextlib.contextmanager
def env_set(name: str, value: Optional[str]):
    """The environment variable ``name`` set to ``value`` (unset for None)
    inside the block, restored after."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def time_ms(fn: Callable[[], object], iters: int, dev: torch.device) -> float:
    """Milliseconds a call of ``fn``: CUDA events around ``iters`` calls on
    the card (after a warm-up call), the host clock on the CPU; the best of
    two rounds."""
    fn()
    best = None
    for _ in range(2):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / iters
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / iters
        best = ms if best is None else min(best, ms)
    return best


def timing(fn: Callable[[], object], iters: int, dev: torch.device) -> dict:
    """``ms`` (:func:`time_ms`), ``device_ms`` (the card only, else None;
    ``device_ms_not_measured`` says why when the profiler recorded nothing)
    and the kernel launches of one call (a wrapper counts where it
    launches)."""
    from beyondff_tpu_torch.utils.profiling import device_ms

    out = {}
    with torch.inference_mode():
        out["ms"] = time_ms(fn, iters, dev)
        out["device_ms"] = None
        if dev.type == "cuda":
            try:
                out["device_ms"] = device_ms(fn, iters=max(1, iters // 2))
            except RuntimeError as err:
                # CUPTI now and then records no event in any window: the
                # device time is then not measured, and the line says why
                out["device_ms_not_measured"] = str(err)
        dispatch.reset_launch_counts()
        fn()
    out["launches"] = {k: v for k, v in dispatch.launch_counts.items() if v}
    return out


def randn(shape, dev: torch.device, dtype: torch.dtype, seed: int = 0) -> torch.Tensor:
    """Seeded standard normals of ``shape``, made on the host and moved."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev, dtype)


def emit(tool: str, **fields) -> dict:
    """Print one JSON line ``{"tool": tool, **fields}`` and return it."""
    row = {"tool": tool, **fields}
    print(json.dumps(row), flush=True)
    return row


def differences(rows: dict, base: str, key: str = "ms") -> dict:
    """``rows[base][key] - rows[v][key]`` for every other variant ``v``
    whose value was measured."""
    ref = rows[base][key]
    return {v: (ref - r[key]) if ref is not None and r[key] is not None else None
            for v, r in rows.items() if v != base}
