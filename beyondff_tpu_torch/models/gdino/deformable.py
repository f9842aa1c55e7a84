"""Multi-scale deformable attention (PyTorch) over the hand-written sampler.

Port of beyondff_tpu/models/gdino/deformable.py. Sampling of every level
and point goes through one ``ms_deform_sample`` call
(kernels/deform_window.py): the Hopper kernel for CUDA tensors, its plain
gather version on the CPU. Per level the call runs exact sampling or the
TPU kernel's windowed clamp, chosen exactly as the JAX package chooses
(``level_modes``), so the encoder on the card computes what the encoder on
a TPU computes.

Shapes follow the Deformable-DETR convention:
  value:             (B, sum_l H_l*W_l, heads, head_dim)
  sampling_locs:     (B, Q, heads, levels, points, 2) in [0, 1] per level
  attention_weights: (B, Q, heads, levels, points)    softmaxed over l*p
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
from torch import nn

from beyondff_tpu_torch.kernels import deform_window as dw
from beyondff_tpu_torch.utils.host_copy import to_device

# levels with H*W at or below this are the "small" levels of the JAX package
_MATMUL_LEVEL_MAX = 1024


def _use_windowed(windowed: bool, value: torch.Tensor) -> bool:
    """Config-requested windowed sampling, on CUDA tensors by default, with
    the JAX package's env override: BFF_DEFORM_WINDOWED=0 forces exact, =1
    forces windowing off the card too. The variable only gates callers that
    requested windowing (never decoder layers)."""
    env = os.environ.get("BFF_DEFORM_WINDOWED")
    if env is not None:
        return windowed and env != "0"
    return windowed and value.is_cuda


def level_modes(spatial_shapes: Sequence[Tuple[int, int]]) -> Tuple[dw.Mode, ...]:
    """Per-level (tile, radius) of the windowed encoder, the JAX package's
    rule and defaults: the largest level tile 16 radius 8
    (BFF_DEFORM_TILE1 / BFF_DEFORM_R1; an explicit TILE1 makes the radius
    default to the tile), other large levels tile 8 radius = tile
    (BFF_DEFORM_TILE2 / BFF_DEFORM_R2), small levels (H*W <= 1024) tile 8
    radius = tile (BFF_DEFORM_TILE_SMALL / BFF_DEFORM_R_SMALL) unless
    BFF_DEFORM_SMALL_KERNEL=0 sends them exact."""
    env = os.environ.get
    sizes = [h * w for h, w in spatial_shapes]
    modes = []
    for h, w in spatial_shapes:
        if h * w <= _MATMUL_LEVEL_MAX:
            if env("BFF_DEFORM_SMALL_KERNEL", "1") == "0":
                modes.append(None)
                continue
            tile = int(env("BFF_DEFORM_TILE_SMALL", "8"))
            radius = int(env("BFF_DEFORM_R_SMALL", str(tile)))
        elif h * w == max(sizes):
            tile1 = env("BFF_DEFORM_TILE1")
            tile = int(tile1) if tile1 is not None else 16
            radius = int(env("BFF_DEFORM_R1", str(tile) if tile1 is not None else "8"))
        else:
            tile = int(env("BFF_DEFORM_TILE2", "8"))
            radius = int(env("BFF_DEFORM_R2", str(tile)))
        modes.append((tile, radius))
    return tuple(modes)


def ms_deform_attn(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locs: torch.Tensor, attention_weights: torch.Tensor,
                   windowed: bool = False) -> torch.Tensor:
    """Core sampling. Returns (B, Q, heads*head_dim) in value's dtype.

    ``windowed=True`` is valid only when the queries are the all-level
    raster (the encoder token order); other query sets sample exactly."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    q = sampling_locs.shape[1]
    use_win = _use_windowed(windowed, value) and q == sum(h * w for h, w in shapes)
    modes = level_modes(shapes) if use_win else (None,) * len(shapes)
    return dw.ms_deform_sample(value.contiguous(), shapes,
                               sampling_locs.float().contiguous(),
                               attention_weights.to(value.dtype).contiguous(), modes)


class MSDeformAttn(nn.Module):
    """Deformable attention layer: projections + predicted offsets/weights."""

    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 4, points: int = 4,
                 windowed: bool = False):
        super().__init__()
        self.dim, self.heads, self.levels, self.points = dim, heads, levels, points
        self.windowed = windowed
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.value_proj = nn.Linear(dim, dim)
        self.output_proj = nn.Linear(dim, dim)

    def sampling_locations(self, query, reference_points, spatial_shapes):
        """(B, Q, heads, levels, points, 2) f32 sampling locations in [0, 1]:
        the reference points plus the predicted offsets."""
        b, q, _ = query.shape
        offsets = self.sampling_offsets(query).reshape(
            b, q, self.heads, self.levels, self.points, 2)
        shapes = to_device(spatial_shapes, query.device, torch.float32)
        wh = shapes.flip(-1)[None, None, None, :, None, :]  # (w, h) per level
        ref = reference_points.float()
        if ref.shape[-1] == 2:
            return ref[:, :, None, :, None, :] + offsets.float() / wh
        # (cx, cy, w, h) refs: offsets scaled by box size
        return (ref[..., :2][:, :, None, :, None, :]
                + offsets.float() / self.points * ref[..., 2:][:, :, None, :, None, :] * 0.5)

    def forward(self, query, reference_points, value, spatial_shapes):
        """query (B, Q, dim); reference_points (B, Q, levels, 2 or 4) in
        [0, 1]; value (B, sum HW, dim)."""
        b, q, _ = query.shape
        v = self.value_proj(value).reshape(b, -1, self.heads, self.dim // self.heads)
        weights = torch.softmax(
            self.attention_weights(query).reshape(b, q, self.heads, -1).float(), dim=-1)
        weights = weights.to(query.dtype).reshape(b, q, self.heads, self.levels, self.points)
        locs = self.sampling_locations(query, reference_points, spatial_shapes)
        out = ms_deform_attn(v, spatial_shapes, locs, weights, windowed=self.windowed)
        return self.output_proj(out)
