"""MFU / roofline accounting for measured programs.

Port of beyondff_tpu/utils/mfu.py. Every headline timing carries a
model-FLOPs utilization: the program's FLOPs and bytes divided by the
measured time and the device's peak. The JAX package reads both from XLA's
cost analysis of the lowered program; here the program runs once under two
dispatch modes: ``torch.utils.flop_counter.FlopCounterMode`` counts the
FLOPs of matmuls, convolutions and attention (forward and backward), and a
byte counter sums each operator's input and output bytes, views excluded:
the same pre-fusion upper bound on memory traffic that XLA's estimate is.

Peaks are the published dense rates (bf16 tensor-core TFLOP/s, HBM GB/s):

- NVIDIA H100 SXM: 989 TFLOP/s, 3 350 GB/s

The CPU row is a nominal 1 TFLOP/s / 100 GB/s, so the code paths stay
testable without a card; its utilizations mean nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from beyondff_tpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS

# substring of the lowercased device name -> (TFLOP/s bf16, HBM GB/s)
_PEAKS = (
    ("h100", PEAK_FLOPS["bfloat16"] / 1e12, HBM_BYTES_PER_S / 1e9),
    ("cpu", 1.0, 100.0),
)


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device (the first one when
    ``device`` is None and a card is present), else ``"cpu"``."""
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def chip_peaks(device=None):
    """(peak_flops_per_s, peak_bytes_per_s) of a torch device."""
    kind = device_kind(device).lower()
    for sub, tf, gb in _PEAKS:
        if sub in kind:
            return tf * 1e12, gb * 1e9
    return 1e12, 100e9  # unknown device: nominal, flagged by name in the report


@dataclass
class ProgramCost:
    """FLOPs and pre-fusion bytes of one run of a program."""

    flops: float
    bytes_accessed: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.bytes_accessed, 1.0)


def _nbytes(obj) -> int:
    leaves, _ = tree_flatten(obj)
    return sum(t.numel() * t.element_size() for t in leaves if isinstance(t, torch.Tensor))


class _ByteCounter(TorchDispatchMode):
    """Sums every operator's input and output tensor bytes; view operators
    move nothing and are skipped."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out


def program_cost(fn, *args, **kwargs) -> Optional[ProgramCost]:
    """Run ``fn(*args, **kwargs)`` once and count its FLOPs and bytes
    (autograd's backward included when ``fn`` calls it). None when it
    counts no FLOPs (callers must tolerate missing cost data, as with the
    JAX package's)."""
    bytes_mode = _ByteCounter()
    with FlopCounterMode(display=False) as flops_mode, bytes_mode:
        fn(*args, **kwargs)
    flops = float(flops_mode.get_total_flops())
    if flops <= 0.0:
        return None
    return ProgramCost(flops, float(bytes_mode.bytes))


def describe(name: str, cost: Optional[ProgramCost], seconds: float,
             device=None) -> str:
    """One MFU/roofline line for a measured component.

    The bound verdict compares the program's arithmetic intensity against the
    machine balance (peak FLOPs / peak bytes): programs below balance are
    memory-bound at best, so the honest ceiling is bandwidth utilization,
    not MFU.
    """
    if cost is None or seconds <= 0:
        return f"{name}: mfu n/a (no cost analysis available)"
    peak_f, peak_b = chip_peaks(device)
    mfu = cost.flops / seconds / peak_f
    bwu = cost.bytes_accessed / seconds / peak_b
    balance = peak_f / peak_b
    bound = "compute-bound" if cost.arithmetic_intensity >= balance else "HBM-bound"
    return (f"{name}: {cost.flops / 1e9:.1f} GFLOP, "
            f"{cost.bytes_accessed / 1e9:.2f} GB accessed, "
            f"intensity {cost.arithmetic_intensity:.0f} flop/B "
            f"({bound}; balance {balance:.0f}) -> "
            f"MFU {mfu * 100:.1f}%, HBM {bwu * 100:.1f}% of peak")


def summarize(name: str, cost: Optional[ProgramCost], seconds: float,
              device=None) -> dict:
    """Machine-readable MFU record; ``device`` names the peaks used."""
    if cost is None or seconds <= 0:
        return {"component": name, "mfu": None}
    peak_f, peak_b = chip_peaks(device)
    return {
        "component": name,
        "gflop": round(cost.flops / 1e9, 2),
        "gb_accessed": round(cost.bytes_accessed / 1e9, 3),
        "ms": round(seconds * 1e3, 2),
        "mfu": round(cost.flops / seconds / peak_f, 4),
        "hbm_util": round(cost.bytes_accessed / seconds / peak_b, 4),
        "device": device_kind(device),
    }
