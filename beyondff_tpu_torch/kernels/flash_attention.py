"""Flash attention: the hand-written Hopper kernels and their plain versions.

Port of beyondff_tpu/kernels/flash_attention.py. One CUDA kernel
(``csrc/flash_attention.cu``) computes softmax(Q K^T * scale) V over
(BH, S, D) with keys >= ``valid_len`` masked, so the TPU's padded-and-masked
``_flash_masked`` and its unpadded ``flash_attention`` are the same call
here. A second one (``csrc/relpos_attention.cu``) adds SAM's decomposed
relative-position bias from its thin factors (``flash_attention_relpos``,
reached through ``attend_relpos``). The wrappers launch them for CUDA
tensors and raise on what they do not take; CPU tensors take the plain
versions.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from beyondff_tpu_torch.kernels import dispatch

# below this many tokens ``attend`` takes plain dense attention (the JAX
# package's BLOCK_Q cutoff, where its dense XLA path was the fast one)
BLOCK_Q = 256
# the JAX package's kv block, kept for ``relpos_shapes_ok``'s routing decision
BLOCK_KV = 512
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


def relpos_bias(bias_h: torch.Tensor, bias_w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The dense (B, S, kh * kw) bias of the thin factors, rounded to
    ``dtype`` and added in f32: bias[q, ky * kw + kx] = bias_h[q, ky] +
    bias_w[q, kx]."""
    bh = bias_h.to(dtype).float()
    bw = bias_w.to(dtype).float()
    return (bh[..., :, None] + bw[..., None, :]).reshape(*bh.shape[:-1], -1)


def attend_relpos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(Q K^T * scale + bias) V with the dense bias and an f32
    softmax; the same function as the rel-pos kernel. q, k, v: (BH, S, D)
    with S = kh * kw raster-ordered; bias_h (BH, S, kh), bias_w (BH, S, kw)."""
    if bias_w.shape[-1] != kw:
        raise ValueError(f"bias_w has {bias_w.shape[-1]} columns for kw={kw}")
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    w = torch.softmax(logits + relpos_bias(bias_h, bias_w, q.dtype), dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def _check_relpos(name, q, k, v, bias_h, bias_w, rows, cols):
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"{name}: q, k, v must share one (BH, S, D) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    bh, s, d = q.shape
    if rows * cols != s:
        raise ValueError(f"{name}: a {rows} x {cols} grid for {s} tokens")
    if tuple(bias_h.shape) != (bh, s, rows) or tuple(bias_w.shape) != (bh, s, cols):
        raise ValueError(f"{name}: factors {tuple(bias_h.shape)}, {tuple(bias_w.shape)} for "
                         f"({bh}, {s}, {rows}) and ({bh}, {s}, {cols})")
    if d > 128:
        raise ValueError(f"{name}: head dim {d} > 128")


def _launch_relpos(fn_name, q, k, v, bias_h, bias_w, rows, cols, scale):
    from beyondff_tpu_torch.kernels import _build

    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    # the factors round to the inputs' dtype, as the JAX wrapper casts them
    bias_h = bias_h.to(q.dtype).contiguous()
    bias_w = bias_w.to(q.dtype).contiguous()
    bh, s, d = q.shape
    out = torch.empty_like(q)
    rc = getattr(_build.library(), fn_name)(
        _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(),
        bias_w.data_ptr(), out.data_ptr(), bh, s, d, rows, cols, ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed (code {rc})")
    return out


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over a raster-ordered (kh, kw) token grid with SAM's
    decomposed rel-pos bias from its thin factors: (BH, S, D) -> (BH, S, D),
    S = kh * kw, kh + kw <= 256, D <= 128; scale defaults to D ** -0.5."""
    if not dispatch.kernel_device(q, k, v, bias_h, bias_w):
        return attend_relpos_plain(q, k, v, bias_h, bias_w, kw, scale)
    kh = bias_h.shape[-1]
    _check_relpos("flash_attention_relpos", q, k, v, bias_h, bias_w, kh, kw)
    if kh + kw > 256:
        raise ValueError(f"flash_attention_relpos: kh + kw = {kh + kw} > 256")
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    out = _launch_relpos("bff_flash_attention_relpos", q, k, v, bias_h, bias_w, kh, kw, scale)
    dispatch.launch_counts["flash_attention_relpos"] += 1
    return out


def relpos_shapes_ok(kh: int, kw: int) -> bool:
    """The JAX package's routing predicate for its rel-pos kernel (whole grid
    rows per kv block, S divisible by both blocks), kept as it is so that the
    port takes its kernel exactly where the JAX package takes its Pallas
    kernel. The CUDA kernel itself has no block constraint."""
    s = kh * kw
    if s < BLOCK_Q:
        return False
    bq = min(BLOCK_Q, s)
    bkv = min(BLOCK_KV, s)
    bkv = max(kw, (bkv // kw) * kw)
    return s % bq == 0 and s % bkv == 0 and kw <= bkv


def attend_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  bias_h: torch.Tensor, bias_w: torch.Tensor, kw: int) -> torch.Tensor:
    """Rel-pos attention with the scale d ** -0.5 of the true head dim, as the
    JAX ``attend_relpos`` (which pads the head dim to 128 lanes; the kernel
    here needs no padding)."""
    return flash_attention_relpos(q, k, v, bias_h, bias_w, kw, scale=q.shape[-1] ** -0.5)
