"""Swin Transformer backbone (PyTorch) for Grounding-DINO.

Port of beyondff_tpu/models/gdino/swin.py: shifted-window attention with
relative position bias tables, patch merging, multi-scale outputs. Module
names are the official checkpoint's (``backbone.0.layers.{s}.blocks.{b}``,
``downsample``, ``norm{s}``); the index tables the official model keeps as
buffers are recomputed from the window size here.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from beyondff_tpu_torch.models.layers import MLP, gelu_exact
from beyondff_tpu_torch.utils.host_copy import to_device


@dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    patch_size: int = 4
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, ...] = (1, 2, 3)


PRESETS = {
    "swin_b": SwinConfig(),
    "swin_t": SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24), window_size=7),
    "test": SwinConfig(embed_dim=16, depths=(1, 1), num_heads=(2, 2), window_size=4,
                       out_indices=(0, 1)),
}


@functools.lru_cache(maxsize=8)
def _rel_pos_index(window: int) -> np.ndarray:
    """(win^2 * win^2,) index into the (2w-1)^2 relative position bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[..., 0] * (2 * window - 1) + rel[..., 1]).reshape(-1).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _shift_mask(hp: int, wp: int, win: int, shift: int) -> np.ndarray:
    """(nW, win^2, win^2) additive mask for shifted windows."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    m = img.reshape(hp // win, win, wp // win, win).transpose(0, 2, 1, 3).reshape(-1, win * win)
    return np.where(m[:, :, None] != m[:, None, :], -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, num_heads))

    def forward(self, x, mask=None):  # x: (nW*B, win*win, C)
        n, l, c = x.shape
        hd = c // self.num_heads
        qkv = self.qkv(x).reshape(n, l, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (n, heads, l, hd)
        logits = (q * hd ** -0.5) @ k.transpose(-1, -2)
        idx = to_device(_rel_pos_index(self.window), x.device)
        bias = self.relative_position_bias_table[idx].reshape(l, l, -1).permute(2, 0, 1)
        logits = logits + bias.to(x.dtype)[None]
        if mask is not None:  # (nW, l, l)
            nw = mask.shape[0]
            logits = (logits.reshape(n // nw, nw, self.num_heads, l, l)
                      + mask[None, :, None].to(x.dtype)).reshape(n, self.num_heads, l, l)
        attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
        return self.proj((attn @ v).transpose(1, 2).reshape(n, l, c))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, shift: int, mlp_ratio: float):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = MLP(dim, int(dim * mlp_ratio), activation=gelu_exact)

    def forward(self, x, hw):  # x: (B, H*W, C)
        h, w = hw
        b, l, c = x.shape
        win = min(self.window, h, w)
        if win != self.window:
            raise ValueError(f"feature map {hw} smaller than the Swin window {self.window}")
        shift = self.shift if win < min(h, w) else 0
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        pad_r, pad_b = (-w) % win, (-h) % win
        if pad_r or pad_b:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = to_device(_shift_mask(hp, wp, win, shift), x.device)
        x = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
        x = self.attn(x.reshape(-1, win * win, c), mask)
        x = x.reshape(b, hp // win, wp // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, hp, wp, c)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        x = shortcut + x[:, :h, :w].reshape(b, l, c)
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x, hw):
        h, w = hw
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, num_heads: int, cfg: SwinConfig, downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, cfg.window_size,
                                 0 if i % 2 == 0 else cfg.window_size // 2, cfg.mlp_ratio)
            for i in range(depth))
        self.downsample = PatchMerging(dim) if downsample else None


class SwinPatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.proj = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size)
        self.norm = nn.LayerNorm(cfg.embed_dim, eps=1e-5)


class SwinBackbone(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = SwinPatchEmbed(cfg)
        n = len(cfg.depths)
        self.layers = nn.ModuleList(
            BasicLayer(cfg.embed_dim * 2 ** i, d, cfg.num_heads[i], cfg, i < n - 1)
            for i, d in enumerate(cfg.depths))
        for si in cfg.out_indices:
            self.add_module(f"norm{si}", nn.LayerNorm(cfg.embed_dim * 2 ** si, eps=1e-5))

    def out_channels(self):
        return [self.cfg.embed_dim * 2 ** si for si in self.cfg.out_indices]

    def forward(self, images):  # (B, H, W, 3) normalized
        x = self.patch_embed.proj(images.permute(0, 3, 1, 2))
        b, _, h, w = x.shape
        x = self.patch_embed.norm(x.flatten(2).transpose(1, 2))
        outs = []
        dim = self.cfg.embed_dim
        for si, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, (h, w))
            if si in self.cfg.out_indices:
                y = getattr(self, f"norm{si}")(x)
                outs.append(y.reshape(b, h, w, dim))
            if layer.downsample is not None:
                x = layer.downsample(x, (h, w))
                h, w = (h + 1) // 2, (w + 1) // 2
                dim *= 2
        return outs  # list of (B, H_i, W_i, C_i)
