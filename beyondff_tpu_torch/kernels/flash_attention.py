"""Flash attention: the hand-written Hopper kernel and its plain version.

Port of beyondff_tpu/kernels/flash_attention.py (``attend``,
``flash_attention`` and ``_flash_masked``). One CUDA kernel
(``csrc/flash_attention.cu``) computes softmax(Q K^T * scale) V over
(BH, S, D) with keys >= ``valid_len`` masked, so the TPU's padded-and-masked
``_flash_masked`` and its unpadded ``flash_attention`` are the same call
here. The wrapper launches it for CUDA tensors and raises on what it does
not take; CPU tensors take :func:`flash_attention_plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from beyondff_tpu_torch.kernels import dispatch

# below this many tokens ``attend`` takes plain dense attention (the JAX
# package's BLOCK_Q cutoff, where its dense XLA path was the fast one)
BLOCK_Q = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid_len: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Explicit-softmax attention with keys >= ``valid_len`` masked, in f32;
    the same function as the kernel. q, k, v: (BH, S, D)."""
    d = q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if valid_len is not None and valid_len < k.shape[1]:
        logits[..., valid_len:] = float("-inf")
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(BH, S, D) -> (BH, S, D); scale defaults to D ** -0.5."""
    if not dispatch.kernel_device(q, k, v):
        return flash_attention_plain(q, k, v, valid_len, scale)
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous tensors")
    bh, s, d = q.shape
    if d > 128:
        raise ValueError(f"head dim {d} > 128")
    valid = s if valid_len is None else int(valid_len)
    if not 1 <= valid <= s:
        raise ValueError(f"valid_len {valid} outside [1, {s}]")
    scale = d ** -0.5 if scale is None else float(scale)
    from beyondff_tpu_torch.kernels import _build

    out = torch.empty_like(q)
    rc = _build.library().bff_flash_attention(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        bh, s, d, valid, ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (code {rc})")
    dispatch.launch_counts["flash_attention"] += 1
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention over (BH, S, D): plain dense for S < ``BLOCK_Q``, else the
    flash kernel with every key valid. The scale is d ** -0.5 of the true
    head dim, as in the JAX ``attend``."""
    bh, s, d = q.shape
    scale = d ** -0.5
    if s < BLOCK_Q:
        logits = torch.einsum("bqd,bkd->bqk", q * scale, k)
        w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return torch.einsum("bqk,bkd->bqd", w, v)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           valid_len=s, scale=scale)
