"""Device selection and kernel dispatch for the port.

The JAX package asks ``on_tpu()`` whether to take a Pallas kernel. The port
decides by the tensor instead: a CUDA tensor goes to the hand-written kernel
(or the wrapper raises), a CPU tensor goes to the plain PyTorch version.
Entry points resolve their device here and never fall back to the CPU on
their own.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

# Launches of each hand-written kernel since the last reset: a wrapper adds
# one where it launches its kernel and nowhere else.
launch_counts: Dict[str, int] = {"flash_attention": 0, "flash_attention_f32": 0,
                                 "flash_attention_relpos": 0,
                                 "flash_attention_relpos_streamed": 0,
                                 "flash_attention_relpos_tf32": 0,
                                 "flash_attention_relpos_tf32_streamed": 0,
                                 "flash_attention_relpos_wgmma": 0,
                                 "flash_attention_relpos_wide_tf32": 0,
                                 "flash_attention_relpos_wide_wgmma": 0,
                                 "flash_attention_tf32": 0,
                                 "flash_attention_wide_tf32": 0,
                                 "flash_attention_wgmma": 0,
                                 "flash_attention_wide_wgmma": 0, "flash_masked_wgmma": 0,
                                 "mask_iou": 0,
                                 "mask_iou_wgmma": 0, "ms_deform_sample": 0, "nms_fixed": 0,
                                 "nms_fixed_large": 0,
                                 "window_attention_relpos": 0,
                                 "window_attention_relpos_tf32": 0,
                                 "window_attention_relpos_wgmma": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller names another device; raises when CUDA is
    asked for (or defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` before a kernel launch that autograd would
    have to record: the kernels have no backward, so their output would
    silently cut the graph, leave the parameters upstream without a
    gradient, and ``AdamW`` would skip them. The JAX package raises in the
    same place, when it differentiates a ``pallas_call`` that has no VJP."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; run it under "
                           "torch.no_grad() or on inputs that do not require grad")


def kernel_device(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (launch the kernel), False
    when they lie on the CPU (plain version); raises for anything else."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on one CUDA device or on the CPU, got {types}")
