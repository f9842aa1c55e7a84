"""Segment Anything (SAM) in PyTorch: ViT image encoder + box-prompted decoder.

Port of beyondff_tpu/models/sam.py. Module and parameter names are the
official ``sam_vit_h_4b8939.pth`` layout (``image_encoder.blocks.{i}``,
``prompt_encoder``, ``mask_decoder.transformer.layers.{i}``); the mask-prompt
downscaling stack is left out, as the stage prompts with boxes only. The
encoder runs windowed and global blocks with the decomposed relative-position
bias. On the card its attention takes the JAX package's kernel branches
(``ViTAttention.forward``): a grid of 512 tokens or more without rel-pos goes
through the flash kernel, and with rel-pos through the rel-pos flash kernel
when ``BFF_SAM_RELPOS_FLASH`` is set; everything else stays plain, as in the
JAX default. ``BFF_SAM_ABLATE`` (read on every call; timing attribution
only, ``tools/profile_sam``) holds any of ``norelpos`` (the plain path drops
the rel-pos bias; a global block on the rel-pos flash kernel keeps it, since
that branch returns first, as in the JAX package), ``noattn`` (windowed
blocks skip attention) and ``nomlp`` (every block skips its MLP).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from beyondff_tpu_torch.core import resize as _resize
from beyondff_tpu_torch.kernels import flash_attention as fa
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models.convert_util import load_module, require_file
from beyondff_tpu_torch.models.layers import (MLP, MLPHead, PatchEmbed, build, conv_nhwc,
                                              gelu_exact, window_partition, window_unpartition)
from beyondff_tpu_torch.parallel.frames import data_parallel_slice, gather_frames
from beyondff_tpu_torch.utils.host_copy import to_device

PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


@dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    encoder_dim: int = 1280
    encoder_depth: int = 32
    encoder_heads: int = 16
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    prompt_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    use_rel_pos: bool = True
    softmax_f32: bool = True


PRESETS = {
    "vit_h": SAMConfig(),
    "vit_l": SAMConfig(encoder_dim=1024, encoder_depth=24, encoder_heads=16,
                       global_attn_indexes=(5, 11, 17, 23)),
    "vit_b": SAMConfig(encoder_dim=768, encoder_depth=12, encoder_heads=12,
                       global_attn_indexes=(2, 5, 8, 11)),
    "test": SAMConfig(img_size=64, patch_size=8, encoder_dim=32, encoder_depth=2,
                      encoder_heads=2, window_size=4, global_attn_indexes=(1,),
                      prompt_dim=32, decoder_mlp_dim=64),
}


# ------------------------------------------------------------ image encoder
def _rel_pos_factors(q_hw, k_hw, rel_h, rel_w, q):
    """Thin factors of SAM's decomposed bias: bias[q, (ky, kx)] =
    bias_h[q, ky] + bias_w[q, kx]. q: (B, S, dim). Returns ((B, S, kh), (B, S, kw))."""
    qh, qw = q_hw
    kh, kw = k_hw

    def get(rel, q_size, k_size):
        needed = 2 * max(q_size, k_size) - 1
        if rel.shape[0] > needed:
            start = (rel.shape[0] - needed) // 2
            rel = rel[start:start + needed]
        coords = (np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
                  - np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
                  + (k_size - 1) * max(q_size / k_size, 1.0))
        return rel[to_device(coords.astype(np.int64), rel.device)]

    rh = get(rel_h, qh, kh)
    rw = get(rel_w, qw, kw)
    b, _, dim = q.shape
    rq = q.reshape(b, qh, qw, dim)
    bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh).reshape(b, qh * qw, kh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw).reshape(b, qh * qw, kw)
    return bias_h, bias_w


def _rel_pos_bias(q_hw, k_hw, rel_h, rel_w, q):
    bias_h, bias_w = _rel_pos_factors(q_hw, k_hw, rel_h, rel_w, q)
    kh, kw = k_hw
    bias = bias_h[..., :, None] + bias_w[..., None, :]
    return bias.reshape(q.shape[0], q_hw[0] * q_hw[1], kh * kw)


def _kernel_path(t: torch.Tensor) -> bool:
    """Whether attention over ``t`` takes the JAX package's kernel branches:
    on the card, where the JAX package asks ``on_tpu()``."""
    return t.is_cuda


class ViTAttention(nn.Module):
    """SAM ViT attention: fused qkv, per-head decomposed rel-pos bias."""

    def __init__(self, dim: int, num_heads: int, use_rel_pos: bool, table_hw, softmax_f32: bool):
        super().__init__()
        self.num_heads = num_heads
        self.use_rel_pos = use_rel_pos
        self.softmax_f32 = softmax_f32
        head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.empty(2 * table_hw[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.empty(2 * table_hw[1] - 1, head_dim))

    def forward(self, x):  # (B, H, W, C)
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(b, h * w, 3, nh, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(b * nh, h * w, hd) for i in range(3))
        out = None
        if h * w >= 512 and _kernel_path(q):
            if not self.use_rel_pos:
                out = fa.attend(q, k, v)
            elif os.environ.get("BFF_SAM_RELPOS_FLASH") and fa.relpos_shapes_ok(h, w):
                bias_h, bias_w = _rel_pos_factors((h, w), (h, w), self.rel_pos_h.to(x.dtype),
                                                  self.rel_pos_w.to(x.dtype), q)
                out = fa.attend_relpos(q, k, v, bias_h, bias_w, w)
        if out is None:
            logits = (q * hd ** -0.5) @ k.transpose(1, 2)
            # BFF_SAM_ABLATE: the timing-attribution knob of tools/profile_sam,
            # read past the kernel branches as in the JAX package
            if self.use_rel_pos and "norelpos" not in os.environ.get("BFF_SAM_ABLATE", ""):
                logits = logits + _rel_pos_bias((h, w), (h, w), self.rel_pos_h.to(x.dtype),
                                                self.rel_pos_w.to(x.dtype), q)
            if self.softmax_f32:
                attn = torch.softmax(logits.float(), dim=-1).to(x.dtype)
            else:
                attn = torch.softmax(logits, dim=-1)
            out = attn @ v
        return self.proj(out.reshape(b, nh, h * w, hd).transpose(1, 2).reshape(b, h, w, c))


class Block(nn.Module):
    def __init__(self, cfg: SAMConfig, window_size: int, grid: int):
        super().__init__()
        d = cfg.encoder_dim
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        table = (window_size, window_size) if window_size > 0 else (grid, grid)
        self.attn = ViTAttention(d, cfg.encoder_heads, cfg.use_rel_pos, table, cfg.softmax_f32)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = MLP(d, 4 * d, activation=gelu_exact, names=("lin1", "lin2"))

    def forward(self, x):
        ablate = os.environ.get("BFF_SAM_ABLATE", "")  # profiling only
        h0, w0 = x.shape[1], x.shape[2]
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            x, padded = window_partition(x, self.window_size)
        if not ("noattn" in ablate and self.window_size > 0):
            x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, padded, (h0, w0))
        x = shortcut + x
        if "nomlp" in ablate:
            return x
        return x + self.mlp(self.norm2(x))


class ImageEncoderViT(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        g = cfg.img_size // cfg.patch_size
        d = cfg.encoder_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, d)
        self.pos_embed = nn.Parameter(torch.empty(1, g, g, d))
        self.blocks = nn.ModuleList(
            Block(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size, g)
            for i in range(cfg.encoder_depth))
        pd = cfg.prompt_dim
        self.neck = nn.Sequential(nn.Conv2d(d, pd, 1, bias=False), nn.LayerNorm(pd, eps=1e-6),
                                  nn.Conv2d(pd, pd, 3, padding=1, bias=False),
                                  nn.LayerNorm(pd, eps=1e-6))

    def forward(self, x):  # (B, H, W, 3) normalized
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2]].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.neck[1](conv_nhwc(self.neck[0], x))
        return self.neck[3](conv_nhwc(self.neck[2], x))  # (B, g, g, prompt_dim)


# ----------------------------------------------------------- prompt encoder
class PositionEmbeddingRandom(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.empty(2, dim // 2))

    def forward(self, coords):  # coords in [0, 1], f32
        proj = (2.0 * coords - 1.0) @ self.positional_encoding_gaussian_matrix.float()
        proj = 2 * np.pi * proj
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(d)
        # 0: neg point, 1: pos point, 2: box top-left, 3: box bottom-right
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)

    def encode_boxes(self, boxes):  # (N, 4) xyxy in pixels of the padded square
        corners = boxes.float().reshape(-1, 2, 2) + 0.5
        emb = self.pe_layer(corners / self.cfg.img_size)
        tl = self.point_embeddings[2].weight[0].float()
        br = self.point_embeddings[3].weight[0].float()
        return torch.stack([emb[:, 0] + tl, emb[:, 1] + br], dim=1)  # (N, 2, d)

    def dense_pe(self, gh: int, gw: int, device):
        g = self.cfg.img_size // self.cfg.patch_size
        ys = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) / g
        xs = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) / g
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self.pe_layer(torch.stack([gx, gy], dim=-1))  # (gh, gw, d)


# ------------------------------------------------------------- mask decoder
class DecoderAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        qh, kh, vh = (t.unflatten(-1, (self.num_heads, -1)).transpose(-3, -2)
                      for t in (self.q_proj(q), self.k_proj(k), self.v_proj(v)))
        logits = (qh * qh.shape[-1] ** -0.5) @ kh.transpose(-1, -2)
        attn = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        return self.out_proj((attn @ vh).transpose(-3, -2).flatten(-2))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, d: int, heads: int, mlp_dim: int, skip_first_layer_pe: bool):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DecoderAttention(d, heads)
        self.norm1 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn_token_to_image = DecoderAttention(d, heads, 2)
        self.norm2 = nn.LayerNorm(d, eps=1e-6)
        self.mlp = MLP(d, mlp_dim, activation=torch.relu, names=("lin1", "lin2"))
        self.norm3 = nn.LayerNorm(d, eps=1e-6)
        self.norm4 = nn.LayerNorm(d, eps=1e-6)
        self.cross_attn_image_to_token = DecoderAttention(d, heads, 2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(d, cfg.decoder_heads, cfg.decoder_mlp_dim, i == 0)
            for i in range(cfg.decoder_depth))
        self.final_attn_token_to_image = DecoderAttention(d, cfg.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(d, eps=1e-6)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        d = cfg.prompt_dim
        self.n_masks = cfg.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.n_masks, d)
        self.transformer = TwoWayTransformer(cfg)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), nn.LayerNorm(d // 4, eps=1e-6), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLPHead([d, d, d, d // 8]) for _ in range(self.n_masks))
        self.iou_prediction_head = MLPHead([d, d, d, self.n_masks])

    def forward(self, image_emb, image_pe, sparse):
        """image_emb (N, gh, gw, d) per prompt; image_pe (gh, gw, d); sparse
        (N, P, d). Returns masks (N, n_masks, 4gh, 4gw) logits, iou (N, n_masks)."""
        n, gh, gw, d = image_emb.shape
        tok = torch.cat([self.iou_token.weight, self.mask_tokens.weight], 0)
        tokens = torch.cat([tok.expand(n, -1, -1), sparse.to(tok.dtype)], dim=1)
        src = image_emb.reshape(n, gh * gw, d)
        pos = image_pe.reshape(1, gh * gw, d).to(src.dtype).expand(n, -1, -1)
        q, k = tokens, src
        for layer in self.transformer.layers:
            q, k = layer(q, k, tokens, pos)
        attn = self.transformer.final_attn_token_to_image(q + tokens, k + pos, k)
        q = self.transformer.norm_final_attn(q + attn)
        iou_out, mask_out = q[:, 0], q[:, 1:1 + self.n_masks]

        up = self.output_upscaling
        img = k.reshape(n, gh, gw, d)
        img = gelu_exact(up[1](conv_nhwc(up[0], img)))
        img = gelu_exact(conv_nhwc(up[3], img))  # (N, 4gh, 4gw, d/8)
        hyper = torch.stack([mlp(mask_out[:, m])
                             for m, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1)
        masks = torch.einsum("nmc,nhwc->nmhw", hyper, img)
        return masks, self.iou_prediction_head(iou_out)


class SAMModule(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder(cfg)
        self.mask_decoder = MaskDecoder(cfg)
        self.init_overrides = {
            "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": (0.0, 1.0),
            "image_encoder.pos_embed": (0.0, 0.02)}

    def encode(self, images):
        return self.image_encoder(images)

    def decode_boxes(self, embs, boxes):
        """embs (N, g, g, d), one embedding per prompt; boxes (N, 4)
        padded-square pixels. Single-mask output (multimask_output=False):
        low-res logits (N, 4g, 4g), iou (N,)."""
        sparse = self.prompt_encoder.encode_boxes(boxes)
        dense_pe = self.prompt_encoder.dense_pe(embs.shape[1], embs.shape[2], embs.device)
        no_mask = self.prompt_encoder.no_mask_embed.weight[0].to(embs.dtype)
        masks, iou = self.mask_decoder(embs + no_mask, dense_pe, sparse)
        return masks[:, 0], iou[:, 0]


class SAM:
    """Inference wrapper: batched frame encode + batched box-prompted decode."""

    def __init__(self, cfg: SAMConfig, module: SAMModule):
        self.cfg = cfg
        self.module = module
        p = next(module.parameters())
        self.device, self.dtype = p.device, p.dtype
        self._mean = torch.as_tensor(PIXEL_MEAN, device=self.device)
        self._std = torch.as_tensor(PIXEL_STD, device=self.device)

    @classmethod
    def create(cls, name_or_cfg="vit_h", seed: int = 0, dtype=torch.float32,
               device=None) -> "SAM":
        cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
        dev = resolve_device(device)
        return cls(cfg, build(lambda: SAMModule(cfg), dev, dtype, seed))

    def scale_frames(self, frames: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """uint8 RGB (B, H, W, 3) -> long-side-scaled unpadded uint8
        (B, nh, nw, 3) on the frames' device (OpenCV-exact INTER_LINEAR,
        core/resize.py); padding happens in :meth:`encode_frames`."""
        hw = self.scaled_hw(frames.shape[1:3])
        return _resize.resize_linear(frames, hw), hw

    def scaled_hw(self, hw) -> Tuple[int, int]:
        """The long-side-scaled size of an (h, w) frame."""
        h, w = hw
        scale = self.cfg.img_size / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    def padded_hw(self, hw) -> Tuple[int, int]:
        """The encoder's input size for an (nh, nw) scaled frame: the full
        square, or under ``BFF_SAM_RECT=1`` only the patch multiple, capped
        at ``img_size`` (ScanNet's 765 x 1024 frames then encode 48 x 64
        patches instead of 64 x 64). The variable is read on every call; the
        JAX package reads it when it traces ``encode_frames_u8``."""
        s = self.cfg.img_size
        if os.environ.get("BFF_SAM_RECT") != "1":
            return s, s
        patch = self.cfg.patch_size
        return tuple(min(-(-n // patch) * patch, s) for n in hw)

    @torch.inference_mode()
    def encode_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, nh, nw, 3) uint8 device frames -> (B, gh, gw, d) embeddings;
        pad to :meth:`padded_hw` and normalize on the device (the pad is
        exactly 0 after normalization). Inside ``parallel.frames.shard_frames``
        over a group of more than one rank whose size divides B, each rank
        encodes its slice of the frames and the slices are gathered, so every
        rank returns the whole batch (the JAX package's data-parallel encode)."""
        b, nh, nw, _ = frames.shape
        ph, pw = self.padded_hw((nh, nw))
        sliced = data_parallel_slice(b)
        if sliced is not None:
            frames = frames[sliced]
        x = F.pad(frames, (0, 0, 0, pw - nw, 0, ph - nh)).float()
        x = (x - self._mean) / self._std
        valid = torch.zeros(ph, pw, 1, dtype=x.dtype, device=x.device)
        valid[:nh, :nw] = 1.0
        out = self.module.encode((x * valid).to(self.dtype))
        return out if sliced is None else gather_frames(out)

    def transform_boxes(self, boxes_xyxy: np.ndarray, orig_hw: Tuple[int, int]) -> np.ndarray:
        """Boxes in original pixels -> padded-square pixels."""
        h, w = orig_hw
        return np.asarray(boxes_xyxy, np.float32) * (self.cfg.img_size / max(h, w))

    @torch.inference_mode()
    def decode_boxes(self, embedding: torch.Tensor, boxes) -> Tuple[torch.Tensor, torch.Tensor]:
        """embedding (g, g, d); boxes (B, 4) padded-square pixels -> low-res
        mask logits (B, 4g, 4g), iou (B,)."""
        bx = torch.as_tensor(np.asarray(boxes, np.float32), device=self.device)
        return self.module.decode_boxes(embedding[None].expand(bx.shape[0], -1, -1, -1), bx)

    def _box_decode(self, embs: torch.Tensor, boxes: torch.Tensor):
        """The packed decode's per-prompt decode: SAM's single-mask output
        (EfficientSAM overrides it with its best-of-multimask selection, as
        the JAX package's ``_box_decode_method``)."""
        return self.module.decode_boxes(embs, boxes)

    @torch.inference_mode()
    def decode_boxes_packed(self, embs: torch.Tensor, frame_idx, boxes,
                            input_hw: Tuple[int, int], orig_hw: Tuple[int, int]):
        """Decode every box of a frame batch in one call, postprocessed and
        bit-packed on the device.

        embs (B, g, g, d); frame_idx (M,) frame of each box; boxes (M, 4)
        padded-square pixels. Returns (packed uint8 (M, ceil(H*W/8)), iou
        (M,)); unpack with ``np.unpackbits(..., bitorder="little")``. The two
        resizes are bilinear with half-pixel centres, as the JAX package's
        ``jax.image.resize(..., "bilinear")``, which antialiases. Antialias
        changes nothing where a resize grows an axis (the first one always,
        the second for frames at or above the SAM input size), but where the
        second shrinks one (a frame's long side below ``img_size``) it widens
        the triangle filter to the shrink factor, so it is on there."""
        idx = to_device(np.asarray(frame_idx, np.int64), self.device)
        bx = to_device(np.asarray(boxes, np.float32), self.device)
        low, iou = self._box_decode(embs.index_select(0, idx), bx)
        hh, ww = orig_hw
        # the upsample target follows the embedding grid: g * patch rows
        sq = (embs.shape[1] * self.cfg.patch_size, embs.shape[2] * self.cfg.patch_size)
        x = F.interpolate(low[:, None].float(), size=sq, mode="bilinear", align_corners=False)
        x = x[:, :, :input_hw[0], :input_hw[1]]
        shrinks = hh < x.shape[2] or ww < x.shape[3]
        x = F.interpolate(x, size=(hh, ww), mode="bilinear", align_corners=False,
                          antialias=shrinks)
        return pack_bits((x[:, 0] > 0).reshape(-1, hh * ww)), iou


# checkpoint keys the box-prompted stage has no module for: the mask-prompt
# downscaling stack (the reference prompts with boxes only,
# segmentation_2d.py:183-188) and batch-norm counters
IGNORED_CHECKPOINT_KEYS = (r"^prompt_encoder\.mask_downscaling\.", r"num_batches_tracked$")


def load_torch_checkpoint(path: str, cfg: SAMConfig, dtype=torch.float32,
                          device=None) -> SAMModule:
    """An official SAM checkpoint (``sam_vit_{b,l,h}_*.pth``, plain or
    wrapped in ``{"model": ...}`` as EfficientSAM's are) -> :class:`SAMModule`
    on ``device`` (``cuda`` unless named) in ``dtype``; every key loaded or
    ignored (:data:`IGNORED_CHECKPOINT_KEYS`), the port's counterpart of
    the JAX package's ``sam.convert_torch_checkpoint``."""
    sd = torch.load(require_file(path, "SAM"), map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "items"):
        sd = sd["model"]
    return load_module(lambda: SAMModule(cfg), sd, IGNORED_CHECKPOINT_KEYS,
                       resolve_device(device), dtype, context="SAM checkpoint")


def pack_bits(flat: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/8)) uint8, little bit order."""
    n = flat.shape[-1]
    pad = (-n) % 8
    if pad:
        flat = F.pad(flat, (0, pad))
    bits = flat.reshape(*flat.shape[:-1], -1, 8).to(torch.uint8)
    w8 = to_device(np.array([1, 2, 4, 8, 16, 32, 64, 128], np.uint8), flat.device)
    return (bits * w8).sum(-1, dtype=torch.uint8)
