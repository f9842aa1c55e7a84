"""YOLO-World open-vocabulary detector in PyTorch.

Port of beyondff_tpu/models/yolo_world.py, the fast variant's detector.
Module and parameter names are the released ultralytics ``yolov8*-world(v2)``
layout (``model.{N}.cv1.conv.weight``, ``model.22.cv4.{i}.logit_scale``), so
an official state dict loads with ``load_state_dict``: a YOLOv8 CSP backbone
(layers 0-9), a PAN neck whose CSP layers carry max-sigmoid text attention
(layers 12/15/18/21) and the ``WorldDetect`` head (DFL box regression, a
contrastive head scoring pixel embeddings against the guide embeddings:
batch-normed in the v2 checkpoints, L2-normalized in the v1 ones,
``bn_head=False``). Convolutions run channels-first; the public functions
keep the JAX package's layout (images (B, H, W, 3), anchors
raster-ordered per stride). BatchNorm runs in eval mode with flax's eps 1e-5, as the JAX
package does (ultralytics trains with 1e-3).

Post-processing (sigmoid score, class-agnostic NMS with a fixed output
size) runs on the device through :func:`kernels.nms.nms_fixed`, the
hand-written kernel for the JAX package's ``lax.fori_loop`` NMS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from beyondff_tpu_torch.core import resize as _resize
from beyondff_tpu_torch.kernels import nms as _nms
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.models.convert_util import ConversionError, load_module, require_file
from beyondff_tpu_torch.models.layers import build
from beyondff_tpu_torch.utils.host_copy import HostCopy, to_device


@dataclass(frozen=True)
class YOLOWorldConfig:
    width: float = 1.0  # channel multiplier (L = 1.0)
    depth: float = 1.0  # block multiplier
    max_channels: int = 512
    text_dim: int = 512  # guide channels (gc)
    embed_dim: int = 512
    img_size: Tuple[int, int] = (640, 640)
    max_dets: int = 100
    reg_max: int = 16  # DFL bins
    nc: int = 80  # training class count (sets the cls-branch width only)
    bn_head: bool = True  # v2 checkpoints use BNContrastiveHead
    attn_heads: Tuple[int, int, int, int] = (8, 4, 8, 16)  # layers 12/15/18/21


PRESETS = {
    "l": YOLOWorldConfig(),
    "m": YOLOWorldConfig(width=0.75, depth=0.67, max_channels=768),
    "s": YOLOWorldConfig(width=0.5, depth=0.33, max_channels=1024),
    "test": YOLOWorldConfig(width=0.25, depth=0.34, max_channels=512, text_dim=32,
                            embed_dim=32, img_size=(64, 64), max_dets=20, reg_max=4,
                            nc=4, attn_heads=(2, 2, 2, 2)),
}


def _make_div(x: float, div: int = 8) -> int:
    return max(div, int(x + div / 2) // div * div)


class BatchNorm(nn.Module):
    """Eval-mode batch norm over channels (dim 1) with the checkpoint's
    ``weight``/``bias``/``running_mean``/``running_var`` and no
    ``num_batches_tracked`` (the head's norms carry none)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(ch))
        self.bias = nn.Parameter(torch.empty(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=self.eps)


class ConvBN(nn.Module):
    """ultralytics ``Conv``: conv (no bias, padding k // 2), batch norm, SiLU."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, k // 2, bias=False)
        self.bn = BatchNorm(c_out)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class Bottleneck(nn.Module):
    def __init__(self, ch: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBN(ch, ch, 3)
        self.cv2 = ConvBN(ch, ch, 3)
        self.shortcut = shortcut

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """YOLOv8 cross-stage partial block with n bottlenecks."""

    def __init__(self, c_in: int, ch: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        half = ch // 2
        self.half = half
        self.cv1 = ConvBN(c_in, ch, 1)
        self.m = nn.ModuleList(Bottleneck(half, shortcut) for _ in range(n))
        self.cv2 = ConvBN((2 + n) * half, ch, 1)

    def _parts(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.half], y[:, self.half:]]
        for blk in self.m:
            parts.append(blk(parts[-1]))
        return parts

    def forward(self, x):
        return self.cv2(torch.cat(self._parts(x), 1))


class MaxSigmoidAttn(nn.Module):
    """ultralytics MaxSigmoidAttnBlock with c1 == ec (the released widths):
    per head, the max over classes of <pixel embedding, projected guide>,
    sigmoid-gated onto a 3x3-projected feature map."""

    def __init__(self, ch: int, nh: int, gc: int):
        super().__init__()
        self.nh = nh
        self.gl = nn.Linear(gc, ch, bias=False)
        self.bias = nn.Parameter(torch.empty(nh))
        self.proj_conv = ConvBN(ch, ch, 3, act=False)

    def forward(self, x, guide):  # x (B, C, H, W); guide (K, gc)
        b, c, h, w = x.shape
        hc = c // self.nh
        g = self.gl(guide.to(x.dtype)).reshape(-1, self.nh, hc)  # (K, nh, hc)
        e = x.reshape(b, self.nh, hc, h, w)
        aw = torch.einsum("bmchw,nmc->bmnhw", e, g).amax(2)
        aw = aw / np.float32(np.sqrt(hc))
        aw = torch.sigmoid(aw + self.bias.to(x.dtype)[None, :, None, None])
        xp = self.proj_conv(x).reshape(b, self.nh, hc, h, w) * aw[:, :, None]
        return xp.reshape(b, c, h, w)


class C2fAttn(C2f):
    """C2f with the max-sigmoid text-attention branch appended before the
    output projection (ultralytics C2fAttn: cv2 sees (3 + n) * c/2 channels)."""

    def __init__(self, c_in: int, ch: int, n: int, nh: int, gc: int):
        super().__init__(c_in, ch, n, shortcut=False)
        self.attn = MaxSigmoidAttn(ch // 2, nh, gc)
        self.cv2 = ConvBN((3 + n) * (ch // 2), ch, 1)

    def forward(self, x, guide):
        parts = self._parts(x)
        parts.append(self.attn(parts[-1], guide))
        return self.cv2(torch.cat(parts, 1))


class SPPF(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.cv1 = ConvBN(ch, ch // 2, 1)
        self.cv2 = ConvBN(4 * (ch // 2), ch, 1)

    def forward(self, x):
        pools = [self.cv1(x)]
        for _ in range(3):  # "SAME" 5x5 max pool: the padding is -inf
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, 1))


class BNContrastiveHead(nn.Module):
    """``WorldDetect.cv4[i]`` of the v2 checkpoints: logits = <BN(x), txt> *
    exp(logit_scale) + bias."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.norm = BatchNorm(embed_dim)
        self.bias = nn.Parameter(torch.empty(1))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def forward(self, x, txt):  # x (B, E, H, W); txt (K, E) f32, L2-normed
        logits = torch.einsum("bchw,kc->bhwk", self.norm(x).float(), txt)
        return logits * torch.exp(self.logit_scale.float()) + self.bias.float()


class ContrastiveHead(nn.Module):
    """``WorldDetect.cv4[i]`` of the v1 checkpoints: logits = <x / |x|, txt>
    * exp(logit_scale) + bias, the pixel embedding L2-normalized over its
    channels (no batch norm)."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.empty(1))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def forward(self, x, txt):  # x (B, E, H, W); txt (K, E) f32, L2-normed
        norm = torch.linalg.vector_norm(x.float(), dim=1, keepdim=True) + 1e-12
        logits = torch.einsum("bchw,kc->bhwk", (x / norm.to(x.dtype)).float(), txt)
        return logits * torch.exp(self.logit_scale.float()) + self.bias.float()


class WorldDetect(nn.Module):
    """Layer 22: box branches (``cv2``), class-embedding branches (``cv3``)
    and contrastive heads (``cv4``) for strides 8/16/32."""

    def __init__(self, c: YOLOWorldConfig, chans: Sequence[int]):
        super().__init__()
        c2h = max(16, chans[0] // 4, 4 * c.reg_max)
        c3 = max(chans[0], min(c.nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(ConvBN(ch, c2h, 3), ConvBN(c2h, c2h, 3),
                                               nn.Conv2d(c2h, 4 * c.reg_max, 1))
                                 for ch in chans)
        self.cv3 = nn.ModuleList(nn.Sequential(ConvBN(ch, c3, 3), ConvBN(c3, c3, 3),
                                               nn.Conv2d(c3, c.embed_dim, 1))
                                 for ch in chans)
        self.cv4 = nn.ModuleList((BNContrastiveHead(c.embed_dim) if c.bn_head
                                  else ContrastiveHead()) for _ in chans)


def _nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` over (B, C, H, W): output index i
    reads input floor((i + 0.5) * in / out), computed in float32."""
    idx = []
    for n_in, n_out in zip(x.shape[2:], hw):
        src = np.floor((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                       * np.float32(n_in) / np.float32(n_out)).astype(np.int64)
        idx.append(to_device(src, x.device))
    return x.index_select(2, idx[0]).index_select(3, idx[1])


class YOLOWorldModule(nn.Module):
    """The ultralytics layer list (``model.0`` ... ``model.22``; the upsample
    and concat layers hold no weights) with the JAX package's split into a
    text-independent :meth:`backbone` and the text-guided :meth:`detect`, so
    the class sweep banks each frame's pyramid and re-runs only the guided
    half per class."""

    def __init__(self, cfg: YOLOWorldConfig):
        super().__init__()
        self.cfg = c = cfg

        def w(ch):
            return _make_div(min(ch, c.max_channels) * c.width)

        def d(n):
            return max(1, round(n * c.depth))

        nh, gc = c.attn_heads, c.text_dim
        layers = [
            ConvBN(3, w(64), 3, 2), ConvBN(w(64), w(128), 3, 2), C2f(w(128), w(128), d(3)),
            ConvBN(w(128), w(256), 3, 2), C2f(w(256), w(256), d(6)),
            ConvBN(w(256), w(512), 3, 2), C2f(w(512), w(512), d(6)),
            ConvBN(w(512), w(1024), 3, 2), C2f(w(1024), w(1024), d(3)), SPPF(w(1024)),
            nn.Identity(), nn.Identity(),
            C2fAttn(w(1024) + w(512), w(512), d(3), nh[0], gc),
            nn.Identity(), nn.Identity(),
            C2fAttn(w(512) + w(256), w(256), d(3), nh[1], gc),
            ConvBN(w(256), w(256), 3, 2), nn.Identity(),
            C2fAttn(w(256) + w(512), w(512), d(3), nh[2], gc),
            ConvBN(w(512), w(512), 3, 2), nn.Identity(),
            C2fAttn(w(512) + w(1024), w(1024), d(3), nh[3], gc),
            WorldDetect(c, (w(256), w(512), w(1024))),
        ]
        self.model = nn.ModuleList(layers)
        # random init: batch-norm scales 1
        self.init_overrides = {f"{name}.weight": (1.0, 0.0) for name, m in self.named_modules()
                               if isinstance(m, BatchNorm)}

    def backbone(self, images):
        """images (B, H, W, 3) in [0, 1] -> the text-independent pyramid
        (p3 /8, p4 /16, p5 /32), channels-first."""
        m = self.model
        x = images.permute(0, 3, 1, 2).to(m[0].conv.weight.dtype)
        for i in range(4):
            x = m[i](x)
        p3 = m[4](x)
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        return p3, p4, p5

    def detect(self, p3, p4, p5, text_embeds):
        """Text-guided PAN + WorldDetect head over a backbone pyramid.

        Returns (boxes (B, A, 4) xyxy in input pixels, cls_logits (B, A, K))
        over all anchors A of strides 8/16/32, f32."""
        c, m = self.cfg, self.model
        f12 = m[12](torch.cat([_nearest(p5, p4.shape[2:]), p4], 1), text_embeds)
        f15 = m[15](torch.cat([_nearest(f12, p3.shape[2:]), p3], 1), text_embeds)
        f18 = m[18](torch.cat([m[16](f15), f12], 1), text_embeds)
        f21 = m[21](torch.cat([m[19](f18), p5], 1), text_embeds)
        head = m[22]
        txt = text_embeds.float()
        txt = txt / (torch.linalg.vector_norm(txt, dim=-1, keepdim=True) + 1e-12)
        bins = torch.arange(c.reg_max, dtype=torch.float32, device=txt.device)
        boxes_all, cls_all = [], []
        for li, (feat, stride) in enumerate(((f15, 8), (f18, 16), (f21, 32))):
            b, _, hh, ww = feat.shape
            # DFL: expectation over the softmaxed bins, in f32
            rb = head.cv2[li](feat).float().reshape(b, 4, c.reg_max, hh * ww)
            ltrb = (torch.softmax(rb.permute(0, 3, 1, 2), -1) * bins).sum(-1)  # (B, A, 4)
            ys = torch.arange(hh, dtype=torch.float32, device=txt.device) + 0.5
            xs = torch.arange(ww, dtype=torch.float32, device=txt.device) + 0.5
            cy, cx = torch.meshgrid(ys, xs, indexing="ij")
            centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)  # (A, 2)
            x1y1 = (centers - ltrb[..., :2]) * stride
            x2y2 = (centers + ltrb[..., 2:]) * stride
            boxes_all.append(torch.cat([x1y1, x2y2], -1))
            logits = head.cv4[li](head.cv3[li](feat), txt)  # (B, hh, ww, K)
            cls_all.append(logits.reshape(b, hh * ww, -1))
        return torch.cat(boxes_all, 1), torch.cat(cls_all, 1)

    def forward(self, images, text_embeds):
        return self.detect(*self.backbone(images), text_embeds)


class YOLOWorld:
    """Inference wrapper with the Grounding-DINO-compatible detector interface."""

    def __init__(self, cfg: YOLOWorldConfig, module: YOLOWorldModule, clip_model=None,
                 clip_tokenizer=None):
        self.cfg = cfg
        self.module = module
        self.clip = clip_model
        self.clip_tokenizer = clip_tokenizer
        p = next(module.parameters())
        self.device, self.dtype = p.device, p.dtype
        self._text_cache = {}

    @classmethod
    def create(cls, name_or_cfg="l", seed: int = 0, dtype=torch.float32,
               device=None) -> "YOLOWorld":
        cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
        return cls(cfg, build(lambda: YOLOWorldModule(cfg), resolve_device(device), dtype, seed))

    def class_embeddings(self, classes: Sequence[str]) -> np.ndarray:
        """L2-normalized guide embeddings (K, text_dim), from the attached
        CLIP text tower or, without one, from ``hash(class)``-seeded normals
        (the JAX package's expression: the numbers change with
        ``PYTHONHASHSEED``)."""
        key = tuple(classes)
        if key in self._text_cache:
            return self._text_cache[key]
        if self.clip is None:
            feats = np.stack([np.random.default_rng(abs(hash(cname)) % (2 ** 31)).normal(
                size=self.cfg.text_dim) for cname in classes]).astype(np.float32)
        else:
            toks = self.clip_tokenizer(list(classes))
            feats = self.clip.encode_text(toks).float().cpu().numpy()
            if feats.shape[-1] != self.cfg.text_dim:
                raise ValueError(
                    f"YOLO-World guide embeddings must be {self.cfg.text_dim}-d "
                    f"(cfg.text_dim), got {feats.shape[-1]} from the attached CLIP "
                    "tower — official YOLO-World guides on the CLIP-base (512-d) "
                    "text encoder, not ViT-L/14")
        feats = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
        self._text_cache[key] = feats
        return feats

    def _detector_input(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, h, w, 3) -> (B, H, W, 3) in [0, 1] at the detector size:
        the JAX ``jax.image.resize(..., "bilinear", antialias=False)`` of the
        float frames, skipped when they are at that size already."""
        x = frames_u8.float()
        if tuple(x.shape[1:3]) != tuple(self.cfg.img_size):
            x = F.interpolate(x.permute(0, 3, 1, 2), size=self.cfg.img_size, mode="bilinear",
                              align_corners=False, antialias=False).permute(0, 2, 3, 1)
        return x / 255.0

    @torch.inference_mode()
    def _head_topk(self, feats, txt, nms_iou: float) -> torch.Tensor:
        """Guided half + NMS -> packed (B, K, 6) rows [score | xyxy | class]
        (padding rows: score -1), one download for the batch."""
        boxes, logits = self.module.detect(*feats, txt)
        probs = torch.sigmoid(logits.float())
        scores, cls_id = probs.max(-1)
        keep, valid = _nms.nms_fixed(boxes, scores, nms_iou, self.cfg.max_dets)
        k = keep.long()
        sc = torch.gather(scores, 1, k)
        bx = torch.gather(boxes, 1, k[..., None].expand(-1, -1, 4))
        ci = torch.gather(cls_id, 1, k).float()
        return torch.cat([torch.where(valid, sc, -1.0)[..., None], bx, ci[..., None]], -1)

    # ------------------------------------------------------ frame batches
    supports_feats_cache = True

    def predict_batch_frames_async(self, frames_dev: torch.Tensor, caption: str,
                                   nms_iou: float = 0.5, feats_cache=None):
        """Detection on an uploaded uint8 frame buffer (B, h, w, 3) of any
        size, resized to the detector input on the device; the work is
        queued on the current stream, and the packed result's download
        (a :class:`utils.host_copy.HostCopy`) starts behind it. Finish with
        :meth:`predict_finalize`.

        ``feats_cache``: optional ``(bank, key)``, the class sweep's
        per-scene bank: the backbone pyramid of this frame batch is computed
        once and stored under ``key``; later captions run only the
        text-guided half."""
        classes = [c.strip() for c in caption.rstrip(".").split(".") if c.strip()]
        txt = to_device(self.class_embeddings(classes), self.device)
        feats = None
        if feats_cache is not None:
            bank, key = feats_cache
            feats = bank.get(key)
        if feats is None:
            with torch.inference_mode():
                feats = self.module.backbone(self._detector_input(frames_dev))
            if feats_cache is not None:
                bank[key] = feats
        return HostCopy(self._head_topk(feats, txt, nms_iou).float()), classes

    def _row_dets(self, row, sel, classes):
        """Packed (K, 6) row + keep mask -> (normalized cxcywh, scores,
        phrases)."""
        hh, ww = self.cfg.img_size
        scores = row[sel, 0]
        boxes = row[sel, 1:5].copy()
        cls_id = row[sel, 5].astype(np.int64)
        boxes[:, [0, 2]] /= ww
        boxes[:, [1, 3]] /= hh
        cx = (boxes[:, 0] + boxes[:, 2]) / 2
        cy = (boxes[:, 1] + boxes[:, 3]) / 2
        bw = boxes[:, 2] - boxes[:, 0]
        bh = boxes[:, 3] - boxes[:, 1]
        cxcywh = np.clip(np.stack([cx, cy, bw, bh], 1), 0, 1)
        return cxcywh, scores, [classes[i] for i in cls_id]

    def predict_finalize(self, handle, box_threshold: float = 0.02,
                         text_threshold: float = 0.0):
        """Host half: waits for the packed download + threshold. Per frame (boxes
        normalized cxcywh, scores, phrases); padding rows carry score -1."""
        packed_d, classes = handle
        packed = packed_d.numpy()
        return [self._row_dets(row, row[:, 0] > box_threshold, classes) for row in packed]

    def predict_batch(self, images, caption: str, box_threshold: float = 0.02,
                      text_threshold: float = 0.0, nms_iou: float = 0.5):
        """Same-size uint8 RGB host frames, each resized straight to the
        detector input (OpenCV-exact INTER_LINEAR on the device, the JAX
        ``predict``'s host ``cv2.resize``), one batched forward. Returns,
        per frame, :meth:`predict`'s result."""
        frames = torch.as_tensor(np.stack(images), device=self.device)
        img = _resize.resize_linear(frames, self.cfg.img_size)
        packed_d, classes = self.predict_batch_frames_async(img, caption, nms_iou)
        packed = packed_d.numpy()
        # NMS padding first, then the threshold, as the JAX ``predict``
        return [self._row_dets(row, (row[:, 0] >= 0) & (row[:, 0] > box_threshold), classes)
                for row in packed]

    def predict(self, image: np.ndarray, caption: str, box_threshold: float = 0.02,
                text_threshold: float = 0.0, nms_iou: float = 0.5):
        """Single-image detection: (boxes (K, 4) normalized cxcywh, scores
        (K,), phrases). The default confidence 0.02 is the reference's."""
        return self.predict_batch([image], caption, box_threshold, text_threshold, nms_iou)[0]

    # -------------------------------------------------- fused-caption hooks
    def caption_spans(self, classes):
        """Fused multi-class caption: YOLO-World scores every box against the
        whole guide set in one forward, so class i's "span" is its logit
        index, ``(i, i + 1)``. Never overflows."""
        caption = " . ".join(c.strip().rstrip(".").strip() for c in classes)
        return caption, [(i, i + 1) for i in range(len(classes))]

    def predict_finalize_demux(self, handle, spans, box_threshold=0.02, text_threshold=0.0):
        """A fused detection split by argmax class: class i keeps the NMS
        survivors whose best class is i and that clear its threshold
        (``box_threshold`` a scalar or one per span)."""
        packed_d, classes = handle
        packed = packed_d.numpy()
        thresholds = (list(box_threshold) if np.ndim(box_threshold)
                      else [box_threshold] * len(spans))
        if len(thresholds) != len(spans):
            raise ValueError(f"{len(thresholds)} box thresholds for {len(spans)} spans")
        out = []
        for row in packed:
            cls_id = row[:, 5].astype(np.int64)
            out.append([self._row_dets(row, (cls_id == s) & (row[:, 0] > thr), classes)
                        for (s, _e), thr in zip(spans, thresholds)])
        return out


# --------------------------------------------------------------- checkpoints
def _normalize_state(obj) -> dict:
    """A loaded ultralytics file -> a ``model.N.*`` state dict: a ``{"model":
    ...}`` wrapper, a module or a plain dict; the ``model.model.N`` prefix of a
    full YOLO wrapper's export dropped, as the JAX converter does."""
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = dict(sd)
    if any(k.startswith("model.model.") for k in sd):
        sd = {k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    return sd


# batch-norm counters, and the DFL expectation conv (a constant arange,
# checked on load)
IGNORED_CHECKPOINT_KEYS = (r"num_batches_tracked$", r"^model\.22\.dfl\.conv\.weight$")


def load_torch_checkpoint(path_or_sd, cfg: YOLOWorldConfig, dtype=torch.float32,
                          device=None) -> YOLOWorldModule:
    """An ultralytics ``yolov8*-world(v2)`` checkpoint (path or state dict;
    a v1 file with ``cfg.bn_head`` False) -> :class:`YOLOWorldModule` on
    ``device`` (``cuda`` unless named); every
    key loaded or ignored, the DFL conv checked to be ``arange(reg_max)``.
    The port's counterpart of the JAX ``convert_torch_checkpoint``."""
    if isinstance(path_or_sd, dict):
        obj = path_or_sd
    else:
        obj = torch.load(require_file(path_or_sd, "YOLO-World"), map_location="cpu",
                         weights_only=False)
    sd = _normalize_state(obj)
    dfl = sd.get("model.22.dfl.conv.weight")
    if dfl is not None and not np.allclose(dfl.float().reshape(-1).numpy(),
                                           np.arange(cfg.reg_max, dtype=np.float32)):
        raise ConversionError("YOLO-World checkpoint: unexpected DFL conv weights")
    return load_module(lambda: YOLOWorldModule(cfg), sd, IGNORED_CHECKPOINT_KEYS,
                       resolve_device(device), dtype, context="YOLO-World checkpoint")


def load(checkpoint_path: str, preset: str = "l", clip_model=None, clip_tokenizer=None,
         dtype=torch.float32, device=None) -> YOLOWorld:
    """Public YOLO-World checkpoint -> ready model."""
    cfg = PRESETS[preset] if isinstance(preset, str) else preset
    return YOLOWorld(cfg, load_torch_checkpoint(checkpoint_path, cfg, dtype, device),
                     clip_model=clip_model, clip_tokenizer=clip_tokenizer)
