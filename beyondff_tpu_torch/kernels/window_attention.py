"""Windowed attention with SAM's decomposed rel-pos bias: the hand-written
Hopper kernel and its plain version.

Port of beyondff_tpu/kernels/window_attention.py ``window_attention_relpos``.
The CUDA kernels (``csrc/relpos_attention.cu``, beside the global-block
kernel) compute softmax(Q K^T * d ** -0.5 + bias) V for each of G
independent windows of S = win_h * win_w tokens, bias[q, (ky, kx)] =
bias_h[q, ky] + bias_w[q, kx]: bf16 inputs on the tensor-core tile of
``csrc/attention_tc.cuh`` (an online softmax over the window's few key
tiles, P rounded to bf16 before P V as the TPU kernel rounds it; within
``flash_attention.bf16_error_bound``), other f32 inputs with a plain
softmax on f32 FMAs. SAM ViT-H's bf16 14 x 14 windows at head dim 80
(``flash_attention.relpos_wgmma_route``) take the wgmma/TMA kernel of
``csrc/relpos_attention_wgmma.cu`` instead, counted as
``window_attention_relpos_wgmma``: the window's whole softmax at once, the
output divided by its f32 denominator after P V, within the same bound.
Their f32 counterparts (``flash_attention.relpos_tf32_route``) take the
3xTF32 wgmma kernel of ``csrc/relpos_attention_tf32.cu``, counted as
``window_attention_relpos_tf32``: an online softmax over five 40-key tiles,
the window's K and V split into TF32 halves on the chip, within 1e-4.
A window's zero-padded tokens (``window_partition``) are real keys; only the
TPU's lane padding beyond S was masked there. Windows of more than 256
tokens or head dims past 128 run K4's kernels (the same function with G
windows as BH: the plain versions are one), counted as
``flash_attention_relpos`` (``flash_attention.window_on_flash``), or as the
route that takes them: ``flash_attention_relpos_streamed`` past the factor
table, and at head dims 144 to 256 ``flash_attention_relpos_wide_wgmma``
(bf16) and ``flash_attention_relpos_wide_tf32`` (f32)
(``flash_attention.relpos_counter``). Like the JAX kernel it is not wired
into the SAM encoder.
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
    """(G, S, D) -> (G, S, D) with S = win_h * win_w: windows past 256 tokens
    or head dim 128 on K4's kernels (``fa.window_on_flash``)."""
    if not dispatch.kernel_device(q, k, v, bias_h, bias_w):
        return window_attention_relpos_plain(q, k, v, bias_h, bias_w, win_h, win_w)
    dispatch.refuse_autograd("window_attention_relpos", q, k, v, bias_h, bias_w)
    fa._check_relpos("window_attention_relpos", q, k, v, bias_h, bias_w, win_h, win_w)
    return fa._launch_relpos("bff_window_attention_relpos", 1, q, k, v, bias_h, bias_w, win_h,
                             win_w, q.shape[-1] ** -0.5)
