"""Windowed attention with SAM's decomposed rel-pos bias: the hand-written
Hopper kernel and its plain version.

Port of beyondff_tpu/kernels/window_attention.py ``window_attention_relpos``.
The CUDA kernel (``csrc/relpos_attention.cu``, beside the global-block
kernel) computes softmax(Q K^T * d ** -0.5 + bias) V for each of G
independent windows of S = win_h * win_w tokens, bias[q, (ky, kx)] =
bias_h[q, ky] + bias_w[q, kx], with a plain softmax over the window's keys.
A window's zero-padded tokens (``window_partition``) are real keys; only the
TPU's lane padding beyond S was masked there. Like the JAX kernel it is not
wired into the SAM encoder.
"""

from __future__ import annotations

import torch

from beyondff_tpu_torch.kernels import dispatch
from beyondff_tpu_torch.kernels import flash_attention as fa


def window_attention_relpos_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  bias_h: torch.Tensor, bias_w: torch.Tensor,
                                  win_h: int, win_w: int) -> torch.Tensor:
    """The dense bias and an f32 softmax; the same function as the kernel.
    q, k, v: (G, S, D); bias_h (G, S, win_h), bias_w (G, S, win_w)."""
    if q.shape[1] != win_h * win_w:
        raise ValueError(f"{q.shape[1]} tokens for a {win_h} x {win_w} window")
    return fa.attend_relpos_plain(q, k, v, bias_h, bias_w, win_w)


def window_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            bias_h: torch.Tensor, bias_w: torch.Tensor,
                            win_h: int, win_w: int) -> torch.Tensor:
    """(G, S, D) -> (G, S, D) with S = win_h * win_w <= 256 and D <= 128."""
    if not dispatch.kernel_device(q, k, v, bias_h, bias_w):
        return window_attention_relpos_plain(q, k, v, bias_h, bias_w, win_h, win_w)
    fa._check_relpos("window_attention_relpos", q, k, v, bias_h, bias_w, win_h, win_w)
    if q.shape[1] > 256:
        raise ValueError(f"window_attention_relpos: {q.shape[1]} tokens > 256")
    out = fa._launch_relpos("bff_window_attention_relpos", q, k, v, bias_h, bias_w,
                            win_h, win_w, q.shape[-1] ** -0.5)
    dispatch.launch_counts["window_attention_relpos"] += 1
    return out
