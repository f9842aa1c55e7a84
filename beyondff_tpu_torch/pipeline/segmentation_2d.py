"""Stage 1 driver: open-vocabulary 2D detection + promptable segmentation.

Port of beyondff_tpu/pipeline/segmentation_2d.py: the classic variant
(``detector.kind: grounding_dino``: Grounding-DINO, SAM ViT-H) and the fast
one (``yolo_world``: YOLO-World, EfficientSAM). Per scene, frames go in
batches of ``detector.frame_batch`` through

  1. open-vocabulary detection with phrase filtering against the query,
  2. CLIP supervision: box crops scored against the ensembled descriptor
     embedding of the query, low-similarity boxes dropped,
  3. box-prompted SAM mask decoding,

and the per-frame results are RLE-encoded into the 2D-mask stage contract.
:func:`run` takes one class; :func:`run_classes` takes a class list scene by
scene with a per-scene frame bank (frames, detector backbone pyramids, SAM
embeddings) and, with ``detector.fused_captions``, one fused multi-phrase
detection pass per group of classes.

With ``detector.device_frames`` (the default) frames reach the device
through the JAX package's transports, under its switches and defaults:

* ``BFF_SEG2D_YUV`` (default on): frames are scaled on the host (OpenCV's
  INTER_LINEAR) and cross as YCrCb 4:2:0 (core/color.py), 1.5 bytes a
  pixel; ``0`` uploads dense RGB at the frame's own size and scales on the
  device (core/resize.py, bit-exact to OpenCV: the same pixels);
* ``BFF_SEG2D_TWO_TIER`` (auto: the detector's input has fewer pixels than
  the SAM-scaled frame, YOLO-World's 640x640): detector-scale buffers for
  every frame, SAM-scale buffers only for frames with boxes;
* ``BFF_SEG2D_BATCH_UPLOAD`` (auto: where two-tier is on): one host-to-device
  copy per detection batch instead of one per frame;
* ``BFF_CLIP_DEVICE_CROPS`` (auto: YOLO-World, fused replays and
  ``detections_override``): CLIP crops are cut and resized on the device
  from the SAM-scale buffers (core/crop_resize.py); otherwise they are cut
  from the host frames through the bit-exact lookup-table chain, and with
  ``BFF_CLIP_YUV`` (auto: YOLO-World with ``BFF_SEG2D_YUV`` on) cross as
  YCrCb;
* ``BFF_SEG2D_JXT`` (auto: YOLO-World; needs device crops): a frame whose
  file is a baseline JPEG at the configured size crosses as its quantized
  DCT coefficients (core/jxt.py, the native entropy decoder) and decodes on
  the device; its detector- and SAM-scale buffers both derive from that one
  upload. A frame the spill guard or the runtime rejects takes YCrCb (with
  batched uploads, its whole batch does), and ``upload_stats`` counts it.

Frame loading runs ahead of the batches through :func:`utils.prefetch.
prefetch_map`, as in the JAX package: ``BFF_SEG2D_PREFETCH`` frames (default
three detection batches) in flight on ``BFF_SEG2D_WORKERS`` loader threads
(default 1). A loader thread decodes the JPEGs, packs the YCrCb or JXT wire and starts the upload
and device decode on the caller's current stream, so the batch's kernels
queue behind its copies on that one stream and need no cross-stream event.
The records are the same with any depth and any number of workers.

Batches go through the JAX package's three-stage deferred completion
(:meth:`Segmentor2D._staged`): a batch's detection, CLIP features and packed
masks each start their download at dispatch (:class:`utils.host_copy.
HostCopy`: a pinned buffer and a CUDA event) and are read a flush cycle
later, with ``BFF_SEG2D_INFLIGHT`` (default 2) detection batches in flight,
``BFF_SEG2D_DEFER`` (default 1, ``0``: same cycle) and ``BFF_SEG2D_EAGER_SAM``
(default on), read on every call; the records are the same for every
setting. Small host arrays on the loop's path (boxes, indices, tables)
upload pinned and non-blocking (``host_copy.to_device``), since a blocking
upload waits for the whole stream. ``device_frames: false`` stays serial.
Profiler spans inside the loop hold host time only; the scene ends with one
synchronize. ``BFF_SEG2D_TRACE=1`` prints each scene's host-blocking seconds
per phase under the JAX package's phase names.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import color, jxt, rle
from beyondff_tpu_torch.core import resize as _resize
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.pipeline import descriptors, llm_client
from beyondff_tpu_torch.utils import io as bio
from beyondff_tpu_torch.utils.checkpoint import SceneCheckpoint
from beyondff_tpu_torch.utils.host_copy import HostCopy, to_device
from beyondff_tpu_torch.utils.prefetch import prefetch_map
from beyondff_tpu_torch.utils.profiling import StageProfiler


def box_cxcywh_to_xyxy(boxes: np.ndarray, w: int, h: int) -> np.ndarray:
    """Normalized cxcywh -> absolute xyxy (reference: box_ops + scaling)."""
    cx, cy, bw, bh = boxes.T
    return np.stack(
        [(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], axis=1)


def _take(t: torch.Tensor, indices) -> torch.Tensor:
    """``t[indices]`` along the first axis; the index list uploads
    non-blocking (a list index would upload blocking, waiting for the
    stream), and all rows in order return ``t`` itself."""
    indices = list(indices)
    if indices == list(range(t.shape[0])):
        return t
    return t.index_select(0, to_device(np.asarray(indices, np.int64), t.device))


def _record(dets, masks) -> Dict:
    """One frame's stage record: (M, 1, H, W) bool masks, CLIP confidences,
    phrases."""
    return {"segmented_frame_masks": masks[:, None].astype(bool),
            "confidences": [float(s) for s in dets[1]],
            "labels": list(dets[2])}


@dataclass
class _Transport:
    """One ``process_scene`` call's frame transport: the JAX package's
    switches resolved, and the state its batches share."""

    scene_id: str
    size: Tuple[int, int]  # (width, height) for the frame loader
    frame_hw: Tuple[int, int]
    sam_hw: Tuple[int, int]
    det_hw: Optional[Tuple[int, int]]
    bank: Optional[Dict]
    two_tier: bool
    yuv: bool
    batch_upload: bool
    device_crops: bool
    jxt: bool
    # fid -> the native-resolution JXT frame, kept until its batch's SAM-scale
    # buffers are derived from it (each loaded batch has its own copy of the
    # transport, so a batch loaded ahead keeps its frames apart)
    native: Dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        """The bank key of the frames the detector reads."""
        if not (self.yuv or self.jxt):
            return "raw" if self.two_tier else "sam"
        return "det" if self.two_tier else "sam"

    @property
    def target_hw(self) -> Tuple[int, int]:
        return self.det_hw if self.two_tier else self.sam_hw


class Segmentor2D:
    """Holds the model stack; processes scenes batch by batch.

    Models not injected are loaded from the configured checkpoints, as in
    the JAX package: ``detector.{gdino,sam,clip}_checkpoint`` (Grounding-DINO
    Swin-B, SAM ViT-H) or, with ``detector.kind: yolo_world``,
    ``detector.{yolo_world,efficientsam}_checkpoint`` (YOLO-World-L, which
    runs in float32 as the JAX package loads it, and EfficientSAM-S), with
    CLIP at ``detector.clip_model_size``, in ``detector.dtype``. With no
    checkpoint configured the ``"test"`` presets are created randomly. A
    configured file that does not exist raises ``FileNotFoundError`` (the
    JAX package builds a random SAM instead). YOLO-World takes its class
    embeddings from CLIP's text tower when that tower's width is its
    ``text_dim``, else from ``hash()``-seeded normals, as the JAX package.
    ``load_seconds`` holds each loaded model's time from file to device.
    ``frame_loader(path, size)`` returns a uint8 RGB frame; it defaults to
    :func:`utils.io.load_image` (OpenCV). The JXT transport reads the frame
    files themselves. ``upload_stats`` counts the frames of each transport
    (``jxt``, ``ycrcb``, ``rgb``), the frames JXT did not take
    (``jxt_spill``) and the bytes of every host-to-device frame copy
    (``bytes``); with several loader threads a frame shared by two batches
    of a replay may load, and count, twice."""

    _jxt_forced_warned = False  # the forced-JXT warning prints once a process

    def __init__(self, cfg: Config, detector=None, sam=None, clip_model=None,
                 clip_tokenizer=None, device=None,
                 frame_loader: Optional[Callable] = None):
        self.cfg = cfg
        d = cfg.detector
        if d.kind not in ("grounding_dino", "yolo_world"):
            raise NotImplementedError(f"detector kind {d.kind!r} is not ported")
        self.yolo = d.kind == "yolo_world"
        injected = next((m for m in (detector, sam, clip_model) if m is not None), None)
        self.device = injected.device if injected is not None and device is None \
            else resolve_device(device)
        self.dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(
            d.dtype, torch.float32)
        self.load_seconds: Dict[str, float] = {}
        self.clip = self.clip_tokenizer = None
        if d.filter_with_clip or self.yolo:
            if clip_model is not None:
                self.clip, self.clip_tokenizer = clip_model, clip_tokenizer
            else:
                self.clip, self.clip_tokenizer = self._load_clip()
            if self.clip_tokenizer is None:
                from beyondff_tpu_torch.models.tokenizers import HashTokenizer

                self.clip_tokenizer = HashTokenizer(self.clip.cfg.vocab_size,
                                                    self.clip.cfg.context_length)
        self.detector = detector if detector is not None else self._load_detector()
        if self.yolo and getattr(self.detector, "clip", None) is None:
            # only a CLIP tower of YOLO-World's guide width is attached (the
            # official guides are CLIP-base, 512-d; the crop filter's
            # ViT-L/14 is 768-d): the detector falls back to hash embeddings
            det_dim = getattr(getattr(self.detector, "cfg", None), "text_dim", None)
            clip_dim = getattr(getattr(self.clip, "cfg", None), "embed_dim", None)
            if det_dim is None or clip_dim == det_dim:
                self.detector.clip = self.clip
                self.detector.clip_tokenizer = self.clip_tokenizer
        self.sam = sam if sam is not None else self._load_sam()
        self.frame_loader = frame_loader or bio.load_image
        self.profiler: Optional[StageProfiler] = None
        self.upload_stats: Counter = Counter()
        self._stats_lock = threading.Lock()
        self._trace: Optional[StageProfiler] = None  # BFF_SEG2D_TRACE phases
        self._query_embedding_cache: Dict[str, np.ndarray] = {}

    # ------------------------------------------------------------- loading
    def _timed(self, name: str, load: Callable):
        t0 = time.perf_counter()
        out = load()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.load_seconds[name] = time.perf_counter() - t0
        return out

    def _load_detector(self):
        d = self.cfg.detector
        if self.yolo:
            from beyondff_tpu_torch.models import yolo_world

            if not d.yolo_world_checkpoint:
                return yolo_world.YOLOWorld.create("test", dtype=self.dtype, device=self.device)
            cfg = yolo_world.PRESETS["l"]
            # float32 whatever detector.dtype says: the JAX package loads it so
            return yolo_world.YOLOWorld(cfg, self._timed(
                "yolo_world", lambda: yolo_world.load_torch_checkpoint(
                    d.yolo_world_checkpoint, cfg, torch.float32, self.device)))
        from beyondff_tpu_torch.models.gdino import GroundingDINO
        from beyondff_tpu_torch.models.gdino import model as gdino_model

        if not d.gdino_checkpoint:
            return GroundingDINO.create("test", dtype=self.dtype, device=self.device)
        from beyondff_tpu_torch.models.gdino import convert
        from beyondff_tpu_torch.models.tokenizers import BertTokenizer

        cfg = gdino_model.PRESETS["swinb"]
        module = self._timed("gdino", lambda: convert.load_torch_checkpoint(
            d.gdino_checkpoint, cfg, self.dtype, self.device))
        tok = BertTokenizer(d.bert_vocab_path) if d.bert_vocab_path else None
        return GroundingDINO(cfg, module, tok)

    def _load_sam(self):
        d = self.cfg.detector
        if self.yolo:
            from beyondff_tpu_torch.models import efficientsam as esam

            if not d.efficientsam_checkpoint:
                return esam.EfficientSAM.create("test", dtype=self.dtype, device=self.device)
            cfg = esam.PRESETS["vits"]
            return esam.EfficientSAM(cfg, self._timed("efficientsam", lambda: (
                esam.load_torch_checkpoint(d.efficientsam_checkpoint, cfg, self.dtype,
                                           self.device))))
        from beyondff_tpu_torch.models import sam as sam_mod

        if not d.sam_checkpoint:
            return sam_mod.SAM.create("test", dtype=self.dtype, device=self.device)
        cfg = sam_mod.PRESETS["vit_h"]
        return sam_mod.SAM(cfg, self._timed("sam", lambda: sam_mod.load_torch_checkpoint(
            d.sam_checkpoint, cfg, self.dtype, self.device)))

    def _load_clip(self):
        from beyondff_tpu_torch.models import clip as clip_mod

        d = self.cfg.detector
        if not d.clip_checkpoint:
            return clip_mod.CLIP.create("test", dtype=self.dtype, device=self.device), None
        return self._timed("clip", lambda: clip_mod.load(
            d.clip_model_size, d.clip_checkpoint, bpe_path=d.clip_bpe_path or None,
            dtype=self.dtype, device=self.device))

    def _span(self, name: str, **items):
        """A profiler span when a profiler is attached. It holds host time
        only, as the JAX package's spans: the stage's device work runs
        behind the host, and a fence here would put back the serial order.
        :meth:`process_scene` synchronizes once at its end, so a span
        around a whole scene holds its device work."""
        if self.profiler is None:
            return contextlib.nullcontext()
        return self.profiler.span(name, **items)

    def _phase(self, name: str):
        """A ``BFF_SEG2D_TRACE`` phase: a span of the scene's own trace
        profiler, whose durations are the host seconds the scene's loop
        spends in each phase (the JAX package's phase names)."""
        return contextlib.nullcontext() if self._trace is None else self._trace.span(name)

    def _count(self, **items):
        """Add to ``upload_stats`` (loader threads count too)."""
        with self._stats_lock:
            self.upload_stats.update(items)

    # ------------------------------------------------------- CLIP filtering
    def query_embedding(self, query: str) -> np.ndarray:
        """Mean of the CLIP text embeddings of the descriptor-extended query,
        L2-normalized twice like the reference (segmentation_2d.py:324-337)."""
        if query in self._query_embedding_cache:
            return self._query_embedding_cache[query]
        method = self.cfg.detector.descriptor_generator
        llm = llm_client.from_config(self.cfg.detector) if "gpt" in method else None
        variants = descriptors.generate(query, method, seed=self.cfg.seed, llm=llm)[query]
        feats = self.clip.encode_text(self.clip_tokenizer(variants)).float().cpu().numpy()
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        mean = feats.mean(axis=0)
        mean /= np.linalg.norm(mean)
        self._query_embedding_cache[query] = mean
        return mean

    def _clip_crops(self, image, boxes_xyxy: np.ndarray, frame_hw=None) -> List[torch.Tensor]:
        """Box crops for CLIP scoring, cut as the reference cuts them and cast
        back to uint8 with ``* 255``, wraparound included, through a
        256-entry lookup table built with the identical expression. The
        Grounding-DINO variant crops the ImageNet-normalized detector-size
        frame (bbox_filter, segmentation_2d.py:345-380; one table per
        channel), the YOLO-World variant the uint8 frame itself, where
        ``x * 255`` wraps to ``-x mod 256`` (segmentation_2d_yolo_world.py:
        505-515). ``image``: uint8 (H, W, 3), host array or device tensor, the
        frame or a scaled copy of it (``frame_hw``: the boxes' frame). A host
        frame is copied to the device dense and cut there, with the same
        bytes as the JAX package's OpenCV chain on the host; crops stay on
        the device."""
        image = to_device(image, self.device)
        h, w = frame_hw if frame_hw is not None else image.shape[:2]
        if self.yolo:
            src = image
            lut = to_device((np.arange(256, dtype=np.uint8) * 255).astype(np.uint8),
                            self.device)
            chans = None
        else:
            from beyondff_tpu_torch.models.gdino.model import IMAGE_MEAN, IMAGE_STD

            src = _resize.resize_linear(image, tuple(self.detector.cfg.image_size))
            lut = to_device(
                (((np.arange(256, dtype=np.float32)[:, None] / 255.0 - IMAGE_MEAN) / IMAGE_STD)
                 * 255).astype(np.uint8), self.device)
            chans = torch.arange(3, device=self.device)
        sh, sw = src.shape[:2]
        sx, sy = sw / w, sh / h
        crops = []
        for bx0, by0, bx1, by1 in boxes_xyxy:
            x0, y0 = max(0, int(bx0 * sx)), max(0, int(by0 * sy))
            x1, y1 = min(sw, int(bx1 * sx)), min(sh, int(by1 * sy))
            if x1 <= x0 or y1 <= y0:
                crops.append(torch.zeros((2, 2, 3), dtype=torch.uint8, device=self.device))
                continue
            crop = src[y0:y1, x0:x1].long()
            crops.append(lut[crop] if chans is None else lut[crop, chans])
        return crops

    def _crop_yuv(self) -> bool:
        """The JAX package's ``BFF_CLIP_YUV`` rule (auto/1/0): host crops
        cross as YCrCb in YOLO-World mode with ``BFF_SEG2D_YUV`` on (raw
        image content; Grounding-DINO's crops are normalize-wrapped
        sawtooths that chroma subsampling would smear)."""
        mode = os.environ.get("BFF_CLIP_YUV", "auto")
        if mode != "auto":
            return mode == "1"
        return self.yolo and os.environ.get("BFF_SEG2D_YUV", "1") != "0"

    def _clip_feats_dispatch(self, crops: List[torch.Tensor]) -> Tuple[HostCopy, int]:
        """Device half of crop scoring (the JAX package's
        ``_clip_sims_dispatch``): preprocess, encode and start the features'
        download; returns the download and the crop count for
        :meth:`_clip_feats_fetch`. Under :meth:`_crop_yuv` the preprocessed
        crops go through the YCrCb round trip of the JAX package's crop
        upload (packed on the host, unpacked on the device), so the encoder
        sees its pixels."""
        with self._span("clip", crops=len(crops)), self._phase("clip_dispatch"):
            batch = self.clip.preprocess(crops)
            if self._crop_yuv():
                packed = np.stack([color.pack_ycrcb420(c) for c in batch.cpu().numpy()])
                feats = self.clip.encode_image_packed_yuv(packed)
            else:
                feats = self.clip.encode_image(batch)
            return HostCopy(feats.float()), len(crops)

    def _clip_feats_fetch(self, feats: HostCopy, n: int) -> np.ndarray:
        """Host half: wait for the download, L2-normalize on the host."""
        with self._phase("clip_wait"):
            out = feats.numpy()[:n].copy()
        out /= np.linalg.norm(out, axis=-1, keepdims=True)
        return out

    def _device_crop_feats_dispatch(self, frames: torch.Tensor, boxes: List[np.ndarray],
                                    frame_hw) -> Tuple[HostCopy, int]:
        """:meth:`_clip_feats_dispatch` for device crops (``BFF_CLIP_DEVICE_
        CROPS``): ``boxes[i]`` cut from ``frames[i]``, the SAM-scale
        buffers."""
        with self._phase("crop_build"):
            counts = [len(bx) for bx in boxes]
            fpos = np.repeat(np.arange(len(boxes)), counts)
            boxes_cat = np.concatenate(boxes).astype(np.float32)
        with self._span("clip", crops=len(boxes_cat)), self._phase("clip_dispatch"):
            if self.yolo:
                feats, n = self.clip.encode_image_boxes(frames, fpos, boxes_cat, "yolo",
                                                        frame_hw)
            else:
                from beyondff_tpu_torch.models.gdino.model import IMAGE_MEAN, IMAGE_STD

                feats, n = self.clip.encode_image_boxes(
                    frames, fpos, boxes_cat, "gdino", frame_hw,
                    det_hw=tuple(self.detector.cfg.image_size), det_mean=IMAGE_MEAN,
                    det_std=IMAGE_STD)
            return HostCopy(feats[:n].float()), n

    def filter_boxes_with_clip(self, image: np.ndarray, boxes_xyxy: np.ndarray, query: str):
        """Keep boxes whose crop's CLIP similarity >= threshold. Returns
        (keep_mask, similarities)."""
        feats = self._clip_feats_fetch(*self._clip_feats_dispatch(
            self._clip_crops(image, boxes_xyxy)))
        sims = feats @ self.query_embedding(query)
        return sims >= self.cfg.detector.similarity_threshold, sims

    # --------------------------------------------------------- detection
    def _phrase_filter(self, image: np.ndarray, query: str, detection, frame_hw=None):
        """Phrase filter for one frame; (boxes_xyxy, scores, phrases) or None
        (reference: segmentation_2d.py:133-141)."""
        d = self.cfg.detector
        h, w = frame_hw if frame_hw is not None else image.shape[:2]
        boxes, scores, phrases = detection
        if d.must_match_query and len(phrases):
            needle = d.must_match_class or query
            keep = np.array([needle in p for p in phrases], bool)
            boxes, scores = boxes[keep], scores[keep]
            phrases = [p for p, k in zip(phrases, keep) if k]
        if boxes.shape[0] == 0:
            return None
        return box_cxcywh_to_xyxy(boxes, w, h), scores, phrases

    def _cap_detections(self, filtered):
        d = self.cfg.detector
        boxes_xyxy, scores, phrases = filtered
        if boxes_xyxy.shape[0] > d.max_detections:
            order = np.argsort(-np.asarray(scores))[:d.max_detections]
            boxes_xyxy = boxes_xyxy[order]
            scores = np.asarray(scores)[order]
            phrases = [phrases[i] for i in order]
        return boxes_xyxy, np.asarray(scores), phrases

    def _filter_apply(self, pre, idx, feats, counts, queries) -> Dict[int, tuple]:
        """The CLIP filter on one batch: ``feats`` holds the crops of the
        frames ``idx`` (``counts`` each) in order; one product per distinct
        query over the whole batch, then per frame the kept boxes with the
        similarities as their scores, capped. Returns {frame: detections}
        for the frames that keep a box."""
        sims_by_query = {q: feats @ self.query_embedding(q)
                         for q in dict.fromkeys(queries[i] for i in idx)}
        out, off = {}, 0
        for i, n in zip(idx, counts):
            boxes_xyxy, _scores, phrases = pre[i]
            sims = sims_by_query[queries[i]][off:off + n]
            off += n
            keep = sims >= self.cfg.detector.similarity_threshold
            if keep.any():
                out[i] = self._cap_detections(
                    (boxes_xyxy[keep], sims[keep], [ph for ph, k in zip(phrases, keep) if k]))
        return out

    def _detect_and_filter_batch(self, images, raw_dets, query):
        """Host path: per-frame phrase filter + one batched CLIP crop scoring
        for the frame batch + per-frame top-K. Returns (boxes_xyxy, scores,
        phrases) or None per frame; CLIP similarities replace the detector
        scores."""
        d = self.cfg.detector
        queries = [query] * len(images)
        with self._phase("phrase_filter"):
            pre = [self._phrase_filter(im, query, det) for im, det in zip(images, raw_dets)]
        if self.clip is None or not d.filter_with_clip:
            return [None if p is None else self._cap_detections(p) for p in pre]
        idx = [i for i, p in enumerate(pre) if p is not None]
        if not idx:
            return [None] * len(images)
        crops = []
        with self._span("clip_crops", frames=len(idx)), self._phase("crop_build"):
            for i in idx:
                crops.extend(self._clip_crops(images[i], pre[i][0]))
        feats = self._clip_feats_fetch(*self._clip_feats_dispatch(crops))
        with self._phase("filter_apply"):
            kept = self._filter_apply(pre, idx, feats, [len(pre[i][0]) for i in idx], queries)
        return [kept.get(i) for i in range(len(images))]

    def _decode_masks_dispatch(self, embs, dets: List, input_hw,
                               orig_hw) -> Tuple[HostCopy, List[int]]:
        """Device half of the batched box decode: every box of the batch in
        one SAM decode, bit-packed on the device, and the one download of
        the batch started. Returns (the download, boxes per frame)."""
        sizes = [bx.shape[0] for bx, _s, _p in dets]
        frame_idx = np.repeat(np.arange(len(dets)), sizes)
        boxes = np.concatenate([self.sam.transform_boxes(bx, orig_hw) for bx, _s, _p in dets])
        with self._span("sam_decode", boxes=len(boxes)), self._phase("decode_dispatch"):
            packed, _iou = self.sam.decode_boxes_packed(embs, frame_idx, boxes, input_hw,
                                                        orig_hw)
            return HostCopy(packed), sizes

    def _decode_masks_fetch(self, packed: HostCopy, sizes: List[int],
                            orig_hw) -> List[np.ndarray]:
        """Host half: wait for the packed download, unpack to dense (M, H, W)
        bool per frame."""
        h, w = orig_hw
        with self._phase("decode_wait"):
            masks = np.unpackbits(packed.numpy(), axis=-1, bitorder="little")[:, :h * w]
            out, off = [], 0
            for m in sizes:
                out.append(masks[off:off + m].reshape(m, h, w).astype(bool))
                off += m
        return out

    # ------------------------------------------------------------ per frame
    def process_frame(self, image: np.ndarray, query: str) -> Optional[Dict]:
        """One RGB frame -> detection record or None (no boxes)."""
        dets, masks = self._host_batch([image], query, self.cfg.detector.box_threshold)[0]
        return None if dets is None else _record(dets, masks)

    # ------------------------------------------------------------ per scene
    def process_scene(self, scene_id: str, query: str, frame_bank: Optional[Dict] = None,
                      demux: Optional[tuple] = None,
                      detections_override: Optional[Dict] = None,
                      override_groups: Optional[Dict] = None,
                      box_threshold: Optional[float] = None):
        """All frames of a scene, ``detector.frame_batch`` at a time.

        ``frame_bank``: a dict shared by the classes of one scene
        (:func:`run_classes`). It holds each frame's device buffers: the
        SAM-scaled one (``("sam", fid)``, with ``("sam_host", fid)``: the
        host-scaled frame, or ``None`` after JXT, and its size), on the
        two-tier path the detector-scale one (``("det", fid)``; under
        ``BFF_SEG2D_YUV=0`` the frame-size upload, ``("raw", fid)``) and
        SAM-scaled ones of frames with boxes only; the host frame
        (``("img", fid)``) where the host decoded it; the detector's text-independent
        backbone pyramid per frame chunk (``("det_feats", fids)``, up to
        ``BFF_SEG2D_BANK_FEATS_CAP`` frames, default 256;
        ``BFF_SEG2D_BANK_FEATS=0`` opts out) and SAM's embedding of each hit
        frame (``("sam_emb", fid)``, up to ``BFF_SEG2D_BANK_EMB_CAP``, default
        256; ``BFF_SEG2D_BANK_EMB=0`` opts out), so a multi-class sweep loads,
        uploads and encodes each frame once per scene.

        Fused-caption hooks (:func:`run_classes`):
        ``demux=(classes, spans, out[, thresholds])`` runs a detection-only
        pass with ``query`` the fused caption: per-class detections split by
        token span into ``out[(class, frame_id)]``, hit frames' SAM
        embeddings go to the bank, and no records are made.
        ``detections_override={frame_id: (boxes, scores, phrases)}`` skips
        the detector and sends the recorded detections through the CLIP
        filter and SAM decode; frames absent from the table are skipped.
        ``override_groups={class: {frame_id: dets}}`` replays a whole class
        group in one pass over (frame, class) entries, frame-major: each
        frame loads and encodes once (``frame_bank`` required), each entry's
        crops score against its own class. Returns ``{class: [records]}``.

        ``box_threshold`` overrides ``detector.box_threshold`` for this pass.

        On the device path the batches go through the JAX package's
        three-stage deferred completion (see :meth:`_staged`); the records
        are the same for every setting of its variables."""
        p = self.cfg.paths
        d = self.cfg.detector
        box_thr = d.box_threshold if box_threshold is None else box_threshold
        size = (self.cfg.frames.width_2d, self.cfg.frames.height_2d)
        frame_hw = (self.cfg.frames.height_2d, self.cfg.frames.width_2d)
        frame_ids = bio.list_scene_frames(p.scene_2d_dir, scene_id,
                                          self.cfg.frames.downsample_ratio)
        group = override_groups is not None
        replay = group or detections_override is not None
        if (demux is not None or replay) and not d.device_frames:
            raise ValueError("fused-caption passes require the device-frames detector path")
        if group:
            if frame_bank is None:
                raise ValueError("override_groups requires a frame_bank "
                                 "(frames are shared across entries)")
            entries = [(f, c) for f in frame_ids for c in override_groups
                       if f in override_groups[c]]
        elif detections_override is not None:
            entries = [f for f in frame_ids if f in detections_override]
        else:
            entries = frame_ids
        by_class: Dict[str, List[Dict]] = {c: [] for c in override_groups} if group else {}
        records: List[Dict] = []

        def emit(chunk, fids, batch):
            with self._phase("emit"):
                for e, f, (dets, masks) in zip(chunk, fids, batch):
                    if dets is not None:
                        (by_class[e[1]] if group else records).append(
                            {"frame_id": f"{f}.jpg", **_record(dets, masks)})

        tp = self._transport(scene_id, size, frame_hw, frame_bank, replay) \
            if d.device_frames else None
        bsz = max(1, d.frame_batch)
        chunks = [entries[i:i + bsz] for i in range(0, len(entries), bsz)]
        self._trace = StageProfiler("seg2d_trace") if os.environ.get("BFF_SEG2D_TRACE") \
            else None
        with contextlib.closing(self._prefetched(chunks, group, tp, scene_id, size,
                                                 frame_bank)) as batches:
            if d.device_frames:
                self._staged(batches, query, frame_hw, frame_bank, box_thr, demux,
                             detections_override, override_groups, emit)
            else:
                for chunk, loaded, _ctp in batches:  # the JAX package's flush_host
                    emit(chunk, chunk, self._host_batch(loaded, query, box_thr))
        if self.device.type == "cuda":
            # the scene's time holds its device work: the scene span ends here
            torch.cuda.synchronize(self.device)
        if self._trace is not None:
            phases = self._trace.durations
            total = sum(phases.values())
            parts = " ".join(f"{k}={v * 1000:.0f}ms" for k, v in
                             sorted(phases.items(), key=lambda kv: -kv[1]))
            print(f"# seg2d host trace [{scene_id}] total={total * 1000:.0f}ms "
                  f"({len(frame_ids)} frames): {parts}", flush=True)
        self._trace = None
        return by_class if group else records

    def _staged(self, batches, query, frame_hw, frame_bank, box_thr, demux,
                detections_override, override_groups, emit):
        """The JAX package's three-stage deferred completion over the loaded
        batches (``segmentation_2d.py``'s ``flush_device``).

        ``dispatch_detection`` queues a batch's detection and the start of
        its download (:class:`utils.host_copy.HostCopy`) into ``pending``;
        ``stage_a`` finalizes the oldest one (phrase filter, the eager SAM
        encode, crop build and CLIP dispatch with its download started; or
        the demux) into ``bq``; ``stage_b`` waits for the CLIP features,
        applies the filter and the cap and dispatches the mask decode with
        its download into ``cq``; ``stage_c`` waits for the masks and emits.
        Every wait is on the download's own event. After each loaded batch
        the stages run while more than ``BFF_SEG2D_INFLIGHT`` (default 2)
        detections are pending and more than ``BFF_SEG2D_DEFER`` (default
        1; ``0``: same cycle) results wait in ``bq`` and ``cq``; the tail
        drains in order. ``BFF_SEG2D_EAGER_SAM`` (default on) encodes every
        frame with phrase-filtered boxes before the CLIP filter, so the card
        runs the encoder while the host builds crops; ``0`` filters first
        and encodes only frames that keep a box. Stages run in batch order,
        so the records are those of the serial order, for every setting."""
        d = self.cfg.detector
        group = override_groups is not None
        bank_emb = (frame_bank is not None
                    and os.environ.get("BFF_SEG2D_BANK_EMB", "1") != "0")
        filter_clip = self.clip is not None and d.filter_with_clip
        eager_sam = os.environ.get("BFF_SEG2D_EAGER_SAM", "1") != "0"
        inflight = int(os.environ.get("BFF_SEG2D_INFLIGHT", "2"))
        defer = int(os.environ.get("BFF_SEG2D_DEFER", "1") or 1)
        pending: List = []  # detection dispatched, awaiting finalize
        bq: List = []  # awaiting CLIP features -> decode dispatch
        cq: List = []  # awaiting packed-mask download -> emit

        def dispatch_detection(chunk, loaded, ctp):
            fids = [e[0] for e in chunk] if group else chunk
            frames, hosts = loaded
            if ctp.two_tier:
                input_hw = ctp.sam_hw
                sam_bufs: Dict[str, torch.Tensor] = {}

                def sam_upload(indices):
                    todo = [i for i in indices if fids[i] not in sam_bufs]
                    if todo:
                        with self._phase("sam_upload"):
                            sam_bufs.update(self._sam_frames(fids, todo, frames, hosts, ctp))

                def sam_input(indices):
                    sam_upload(indices)
                    return torch.stack([sam_bufs[fids[i]] for i in indices])
            else:
                input_hw = tuple(frames.shape[1:3])

                def sam_upload(indices):
                    pass

                def sam_input(indices):
                    return _take(frames, indices)

            def encode(indices):
                with self._span("sam_encode", frames=len(indices)), \
                        self._phase("sam_encode_dispatch"):
                    return self._encode(fids, indices, sam_input, frame_bank, bank_emb, group)

            handle = None
            if not (group or detections_override is not None):
                with self._span("detect", frames=len(fids)), self._phase("det_dispatch"):
                    det_in = self._detector_input(frames) if ctp.key == "raw" else frames
                    handle = self._detect(det_in, query, fids, frame_bank)
            pending.append((chunk, fids, hosts, ctp, input_hw, sam_upload, sam_input, encode,
                            handle))

        def stage_a():
            batch = pending.pop(0)
            try:
                _stage_a(*batch)
            finally:
                # native JXT frames only serve this batch's SAM-scale buffers
                batch[3].native.clear()

        def _stage_a(chunk, fids, hosts, ctp, input_hw, sam_upload, sam_input, encode, handle):
            if demux is not None:
                with self._phase("det_finalize"):
                    hits = self._demux(handle, fids, demux, box_thr)
                if hits and bank_emb:
                    encode(hits)
                return
            with self._phase("det_finalize"):
                if group:
                    raw = [override_groups[c][f] for f, c in chunk]
                elif handle is None:
                    raw = [detections_override[f] for f in fids]
                else:
                    raw = self.detector.predict_finalize(handle, box_threshold=box_thr,
                                                         text_threshold=d.text_threshold)
            queries = [e[1] for e in chunk] if group else [query] * len(chunk)
            with self._phase("phrase_filter"):
                pre = [self._phrase_filter(None, q, det, frame_hw)
                       for q, det in zip(queries, raw)]
            idx = [i for i, pr in enumerate(pre) if pr is not None]
            if not idx:
                return
            # two-tier: frames with boxes get their SAM-scale buffers now,
            # while the batch's native JXT frames are still held
            sam_upload(idx)
            embs = encode(idx) if eager_sam else None
            feats = n_crops = counts = None
            if filter_clip:
                counts = [len(pre[i][0]) for i in idx]
                if ctp.device_crops:
                    feats, n_crops = self._device_crop_feats_dispatch(
                        sam_input(idx), [pre[i][0] for i in idx], frame_hw)
                else:
                    crops = []
                    with self._span("clip_crops", frames=len(idx)), self._phase("crop_build"):
                        for i in idx:
                            crops.extend(self._clip_crops(hosts[i], pre[i][0], frame_hw))
                    feats, n_crops = self._clip_feats_dispatch(crops)
            bq.append((chunk, fids, input_hw, encode, idx, pre, queries, embs, feats, n_crops,
                       counts))

        def stage_b():
            (chunk, fids, input_hw, encode, idx, pre, queries, embs, feats, n_crops,
             counts) = bq.pop(0)
            if feats is not None:
                feats = self._clip_feats_fetch(feats, n_crops)
                with self._phase("filter_apply"):
                    dets_by_i = self._filter_apply(pre, idx, feats, counts, queries)
            else:
                dets_by_i = {i: self._cap_detections(pre[i]) for i in idx}
            kept = [i for i in idx if i in dets_by_i]
            if not kept:
                return
            if embs is None:
                embs = encode(kept)
            elif len(kept) < len(idx):
                # a frame the CLIP filter emptied has paid its eager encode
                # but leaves the decode batch
                embs = _take(embs, [j for j, i in enumerate(idx) if i in dets_by_i])
            packed, sizes = self._decode_masks_dispatch(embs, [dets_by_i[i] for i in kept],
                                                        input_hw, frame_hw)
            cq.append((chunk, fids, kept, dets_by_i, packed, sizes))

        def stage_c():
            chunk, fids, kept, dets_by_i, packed, sizes = cq.pop(0)
            masks = dict(zip(kept, self._decode_masks_fetch(packed, sizes, frame_hw)))
            emit(chunk, fids, [(dets_by_i[i], masks[i]) if i in masks else (None, None)
                               for i in range(len(chunk))])

        for chunk, loaded, ctp in batches:  # flush_device
            dispatch_detection(chunk, loaded, ctp)
            if len(pending) > inflight:
                stage_a()
            while len(bq) > defer:
                stage_b()
            while len(cq) > defer:
                stage_c()
        while pending:
            stage_a()
        while bq:
            stage_b()
        while cq:
            stage_c()

    def _prefetched(self, chunks, group: bool, tp: Optional[_Transport], scene_id, size,
                    frame_bank):
        """``(chunk, loaded, transport)`` per detection batch, loaded ahead
        by :func:`utils.prefetch.prefetch_map` (the JAX package's
        ``BFF_SEG2D_PREFETCH`` frames in flight, default three batches, on
        ``BFF_SEG2D_WORKERS`` threads, default 1).
        ``loaded`` is the host frames (``device_frames: false``) or the
        device buffers and host crop sources; each batch gets its own copy
        of the transport (its native JXT frames). Loader threads queue their
        copies and decodes on the caller's current stream."""
        bsz = max(1, self.cfg.detector.frame_batch)
        depth = int(os.environ.get("BFF_SEG2D_PREFETCH", "0")) or 3 * bsz
        workers = int(os.environ.get("BFF_SEG2D_WORKERS", "1"))
        stream = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None

        def load(chunk):
            fids = [e[0] for e in chunk] if group else chunk
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                if tp is None:
                    return chunk, self._host_frames(scene_id, fids, size, frame_bank), None
                ctp = replace(tp, native={})
                return chunk, self._device_frames(fids, ctp), ctp

        it = prefetch_map(load, chunks, depth=max(1, depth // bsz), workers=workers)
        try:
            while True:
                with self._phase("prefetch_wait"):
                    item = next(it, None)
                if item is None:
                    return
                yield item
        finally:
            it.close()  # stops the loader threads when the scene loop ends early

    def _frame_path(self, scene_id: str, fid: str) -> str:
        return os.path.join(self.cfg.paths.scene_2d_dir, scene_id, "color", f"{fid}.jpg")

    def _host_frames(self, scene_id, fids, size, bank) -> List[np.ndarray]:
        """Host frames for the ``device_frames: false`` path, banked by frame."""
        out = []
        with self._span("load", frames=len(fids)):
            for f in fids:
                img = None if bank is None else bank.get(("img", f))
                if img is None:
                    img = self.frame_loader(self._frame_path(scene_id, f), size)
                    if bank is not None:
                        bank[("img", f)] = img
                out.append(img)
        return out

    def _two_tier(self, frame_hw) -> bool:
        """The JAX package's two-tier rule: detector-scale uploads when the
        detector's input has fewer pixels than the SAM-scaled frame
        (``BFF_SEG2D_TWO_TIER=1``/``0`` forces it either way)."""
        mode = os.environ.get("BFF_SEG2D_TWO_TIER", "auto")
        if mode != "auto":
            return mode == "1"
        det_hw = self._det_hw()
        if det_hw is None:
            return False
        scale = self.sam.cfg.img_size / max(frame_hw)
        sam_px = round(frame_hw[0] * scale) * round(frame_hw[1] * scale)
        return det_hw[0] * det_hw[1] < sam_px

    def _det_hw(self):
        """The detector's input size (YOLO-World's ``img_size``,
        Grounding-DINO's ``image_size``)."""
        dcfg = getattr(self.detector, "cfg", None)
        return getattr(dcfg, "img_size", None) or getattr(dcfg, "image_size", None)

    def _transport(self, scene_id, size, frame_hw, bank, replay: bool) -> _Transport:
        """The JAX package's transport switches for one ``process_scene``
        call (see the module docstring), with their auto rules."""
        env = os.environ.get
        two_tier = self._two_tier(frame_hw)
        bu = env("BFF_SEG2D_BATCH_UPLOAD", "auto")
        dc = env("BFF_CLIP_DEVICE_CROPS", "auto")
        device_crops = self.clip is not None and (
            (self.yolo or replay) if dc == "auto" else dc == "1")
        jm = env("BFF_SEG2D_JXT", "auto")
        use_jxt = device_crops and (jm == "1" or (jm == "auto" and self.yolo))
        if jm == "1" and not use_jxt and not Segmentor2D._jxt_forced_warned:
            # a forced A/B that silently measured YCrCb would compare one
            # configuration with itself
            Segmentor2D._jxt_forced_warned = True
            print("[seg2d] warning: BFF_SEG2D_JXT=1 has no effect without device crops "
                  f"(device_crops={device_crops}); set BFF_CLIP_DEVICE_CROPS=1 to engage the "
                  "coefficient transport")
        det_hw = self._det_hw()
        return _Transport(scene_id=scene_id, size=size, frame_hw=frame_hw,
                          sam_hw=self.sam.scaled_hw(frame_hw),
                          det_hw=tuple(det_hw) if det_hw is not None else None, bank=bank,
                          two_tier=two_tier, yuv=env("BFF_SEG2D_YUV", "1") != "0",
                          batch_upload=two_tier if bu == "auto" else bu == "1",
                          device_crops=device_crops, jxt=use_jxt)

    def _detector_input(self, frames: torch.Tensor) -> torch.Tensor:
        """Frame-size uploads -> the detector input: one OpenCV-exact
        INTER_LINEAR resize, the JAX package's host ``cv2.resize``."""
        return _resize.resize_linear(frames, tuple(self._det_hw()))

    def _device_frames(self, fids, tp: _Transport):
        """The batch's device buffers the detector reads, (B, h, w, 3) uint8,
        one per fid (repeats allowed), and each frame's host crop source
        (``None`` where the frame never reached the host as pixels). With a
        bank each frame loads and uploads once per scene."""
        uniq = list(dict.fromkeys(fids))
        if tp.yuv or tp.jxt:
            frames, hosts = self._transport_frames(uniq, tp)
        else:
            frames = self._dense_frames(uniq, tp)
            hosts = dict(zip(uniq, frames))
        if uniq != list(fids):
            pos = {f: i for i, f in enumerate(uniq)}
            frames = _take(frames, [pos[f] for f in fids])
        return frames, [hosts[f] for f in fids]

    def _load_imgs(self, fids, tp: _Transport, bank_img: bool = True) -> List[np.ndarray]:
        """Host frames from their files, banked as ``("img", fid)``."""
        bank = tp.bank if bank_img else None
        out = []
        with self._span("load", frames=len(fids)):
            for f in fids:
                img = bank.get(("img", f)) if bank is not None else None
                if img is None:
                    img = self.frame_loader(self._frame_path(tp.scene_id, f), tp.size)
                    if bank is not None:
                        bank[("img", f)] = img
                out.append(img)
        return out

    def _dense_frames(self, fids, tp: _Transport) -> torch.Tensor:
        """``BFF_SEG2D_YUV=0`` (and no JXT): each frame uploads dense at its
        own size (one copy per batch under batched uploads, else one per
        frame); SAM-scaled on the device, or kept at frame size (``"raw"``)
        for two-tier. The same pixels as scaling on the host first."""
        bank = tp.bank
        have = {} if bank is None else {f: bank[(tp.key, f)] for f in fids if (tp.key, f) in bank}
        todo = [f for f in fids if f not in have]
        if todo:
            images = self._load_imgs(todo, tp, bank_img=False)
            with self._span("upload", frames=len(todo)):
                if tp.batch_upload:
                    fresh = torch.from_numpy(np.stack(images)).to(self.device)
                else:
                    fresh = torch.stack([torch.from_numpy(im).to(self.device) for im in images])
                if not tp.two_tier:
                    fresh, _hw = self.sam.scale_frames(fresh)
            self._count(rgb=len(todo), bytes=sum(im.nbytes for im in images))
            if bank is not None:
                for f, t in zip(todo, fresh):
                    bank[(tp.key, f)] = t
            if todo == list(fids):
                return fresh
            have.update(zip(todo, fresh))
        return torch.stack([have[f] for f in fids])

    def _transport_frames(self, fids, tp: _Transport):
        """The JAX package's loaders under YCrCb and JXT: per batch with
        batched uploads (one spilled frame sends the whole batch to YCrCb),
        else per frame. Returns the stacked buffers and {fid: host source}."""
        bank = tp.bank
        if tp.batch_upload:
            if bank is not None and all((tp.key, f) in bank for f in fids):
                return (torch.stack([bank[(tp.key, f)] for f in fids]),
                        {f: self._banked_host(f, tp) for f in fids})
            if tp.jxt:
                packs = self._jxt_packs(fids, tp)
                if all(pk is not None for pk in packs):
                    return self._jxt_frames(fids, packs, tp), dict.fromkeys(fids)
                self._count(jxt_spill=len(fids))
            return self._host_frames_up(fids, self._load_imgs(fids, tp), tp)
        devs, hosts = [], {}
        for f in fids:
            if bank is not None and (tp.key, f) in bank:
                devs.append(bank[(tp.key, f)])
                hosts[f] = self._banked_host(f, tp)
                continue
            pk = self._jxt_packs([f], tp)[0] if tp.jxt else None
            if pk is not None:
                devs.append(self._jxt_frames([f], [pk], tp)[0])
                hosts[f] = None
                continue
            if tp.jxt:
                self._count(jxt_spill=1)
            dev, host = self._host_frames_up([f], self._load_imgs([f], tp), tp)
            devs.append(dev[0])
            hosts.update(host)
        return torch.stack(devs), hosts

    def _banked_host(self, f, tp: _Transport):
        """The host crop source of a frame whose device buffer is banked."""
        if not tp.two_tier:
            return tp.bank[("sam_host", f)][0]
        return None if tp.jxt else self._load_imgs([f], tp)[0]

    def _host_frames_up(self, fids, imgs, tp: _Transport):
        """Host frames -> the detector's buffers through YCrCb (dense under
        ``BFF_SEG2D_YUV=0``), banked; returns them and {fid: host source}."""
        dev, scaled = self._scale_upload(imgs, tp.target_hw, tp)
        if tp.bank is not None:
            for i, f in enumerate(fids):
                tp.bank[(tp.key, f)] = dev[i]
                if not tp.two_tier:
                    tp.bank[("sam_host", f)] = (scaled[i], tp.sam_hw)
        return dev, dict(zip(fids, imgs if tp.two_tier else scaled))

    def _scale_upload(self, imgs, hw, tp: _Transport):
        """Host frames scaled to ``hw`` on the host (OpenCV's INTER_LINEAR,
        as the JAX package) and uploaded as YCrCb, one copy per batch under
        batched uploads; under ``BFF_SEG2D_YUV=0`` uploaded dense at their
        own size and scaled on the device (``core/resize.py``, the same
        pixels). Returns the device batch and the host-scaled frames
        (``None`` for dense)."""
        import cv2

        with self._span("upload", frames=len(imgs)):
            if tp.yuv:
                scaled = [img if img.shape[:2] == tuple(hw) else
                          cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
                          for img in imgs]
                groups = [scaled] if tp.batch_upload else [[im] for im in scaled]
                dev = torch.cat([color.upload_frames(g, self.device) for g in groups])
                self._count(ycrcb=len(imgs),
                                         bytes=len(imgs) * color.wire_bytes(*hw))
            else:
                scaled = [None] * len(imgs)
                dev = _resize.resize_linear(torch.from_numpy(np.stack(imgs)).to(self.device),
                                            tuple(hw))
                self._count(rgb=len(imgs), bytes=sum(im.nbytes for im in imgs))
        return dev, scaled

    def _jxt_packs(self, fids, tp: _Transport) -> List[Optional[jxt.JxtPacked]]:
        """Each frame's file sparse-packed for the JXT transport, or ``None``
        (the spill guard, a file the native runtime does not take, or pixel
        dims other than the configured frame size)."""
        out = []
        with self._span("load", frames=len(fids)):
            for f in fids:
                try:
                    with open(self._frame_path(tp.scene_id, f), "rb") as fh:
                        pk = jxt.pack_file(fh.read())
                except (OSError, ValueError):
                    pk = None
                if pk is not None and (pk.geometry.h, pk.geometry.w) != tuple(tp.frame_hw):
                    pk = None
                out.append(pk)
        return out

    def _jxt_upload(self, packs) -> torch.Tensor:
        """Packed frames -> native-resolution device frames, one copy."""
        with self._span("upload", frames=len(packs)):
            natives = jxt.upload_frames(packs, self.device)
        self._count(jxt=len(packs), bytes=jxt.wire_bytes(packs))
        return natives

    def _jxt_frames(self, fids, packs, tp: _Transport) -> torch.Tensor:
        """JXT frames decoded on the device and resized there to the
        detector's buffers (banked); two-tier keeps each native frame for its
        batch's SAM-scale buffers."""
        natives = self._jxt_upload(packs)
        with self._span("upload", frames=len(fids)):
            dev = jxt.resize_frames(natives, tp.target_hw)
        for i, f in enumerate(fids):
            if tp.two_tier:
                tp.native[f] = natives[i]
            if tp.bank is not None:
                tp.bank[(tp.key, f)] = dev[i]
                if not tp.two_tier:
                    tp.bank[("sam_host", f)] = (None, tp.sam_hw)
        return dev

    def _sam_frames(self, fids, indices, frames, hosts, tp: _Transport) -> Dict:
        """SAM-scaled buffers of the batch positions ``indices`` of a
        two-tier batch, made when first needed (frames with boxes only),
        banked per frame: {fid: (nh, nw, 3) uint8}. Dense uploads scale on
        the device from the frame-size buffers; JXT derives them from the
        batch's native frames (no second upload), re-packs a frame whose
        native is gone, and sends spilled frames the YCrCb way, as YCrCb
        frames go: scaled on the host, packed, uploaded."""
        bank = tp.bank
        out, todo = {}, {}  # todo: fid -> its first batch position
        for i in indices:
            f = fids[i]
            if bank is not None and ("sam", f) in bank:
                out[f] = bank[("sam", f)]
            else:
                todo.setdefault(f, i)
        todo = list(todo.values())
        if not todo:
            return out
        if tp.key == "raw":
            fresh, _hw = self.sam.scale_frames(frames[todo])
            fresh = dict(zip((fids[i] for i in todo), fresh))
        else:
            fresh, jx, host_missing = {}, [], []
            for i in todo:
                f = fids[i]
                if f in tp.native:
                    jx.append(f)
                    continue
                pk = self._jxt_packs([f], tp)[0] if tp.jxt else None
                if pk is not None:
                    tp.native[f] = self._jxt_upload([pk])[0]
                    jx.append(f)
                else:
                    self._count(jxt_spill=int(tp.jxt))
                    host_missing.append(i)
            if jx:
                with self._span("upload", frames=len(jx)):
                    res = jxt.resize_frames(torch.stack([tp.native[f] for f in jx]), tp.sam_hw)
                fresh.update(zip(jx, res))
            if host_missing:
                imgs = [hosts[i] if hosts[i] is not None
                        else self._load_imgs([fids[i]], tp)[0] for i in host_missing]
                dev, scaled = self._scale_upload(imgs, tp.sam_hw, tp)
                for j, i in enumerate(host_missing):
                    fresh[fids[i]] = dev[j]
                    if bank is not None:
                        bank[("sam_host", fids[i])] = (scaled[j], tp.sam_hw)
        for f, t in fresh.items():
            out[f] = t
            if bank is not None:
                bank[("sam", f)] = t
        return out

    def _detect(self, frames, caption: str, fids, bank):
        """Dispatch detection on the frame batch; with a bank, the detector's
        text-independent pyramid is banked per frame chunk (the chunks are
        the same for every class of a scene)."""
        kw = {}
        if (bank is not None and getattr(self.detector, "supports_feats_cache", False)
                and os.environ.get("BFF_SEG2D_BANK_FEATS", "1") != "0"):
            cap = int(os.environ.get("BFF_SEG2D_BANK_FEATS_CAP", "256"))
            key = ("det_feats", tuple(fids))
            # list(): loader threads may add frames to the bank meanwhile
            n_banked = sum(len(k[1]) for k in list(bank) if k[0] == "det_feats")
            if key in bank or n_banked + len(fids) <= cap:
                kw["feats_cache"] = (bank, key)
        return self.detector.predict_batch_frames_async(frames, caption, **kw)

    def _demux(self, handle, fids, demux, box_thr) -> List[int]:
        """A fused detection batch split per class into the demux table;
        returns the batch positions of frames any class hit."""
        classes, spans, out = demux[:3]
        # optional 4th element: per-class box thresholds
        thr = demux[3] if len(demux) > 3 else box_thr
        per_frame = self.detector.predict_finalize_demux(
            handle, spans, box_threshold=thr, text_threshold=self.cfg.detector.text_threshold)
        hits = []
        for i, per_class in enumerate(per_frame):
            for c, det in zip(classes, per_class):
                if det[0].shape[0]:
                    out[(c, fids[i])] = det
            if any(det[0].shape[0] for det in per_class):
                hits.append(i)
        return hits

    def _encode(self, fids, indices, sam_input, bank, bank_emb: bool,
                dedupe: bool) -> torch.Tensor:
        """SAM embeddings of the batch positions ``indices``; ``sam_input``
        gives their SAM-scaled frames. With ``bank_emb`` banked frames are
        not encoded again and fresh ones are banked (up to the cap);
        ``dedupe`` encodes a frame that appears under several classes of a
        replay batch once."""
        if not bank_emb and not dedupe:
            return self.sam.encode_frames(sam_input(indices))
        cached = {i: bank.get(("sam_emb", fids[i])) if bank_emb else None for i in indices}
        missing, seen = [], set()
        for i in indices:
            if cached[i] is None and fids[i] not in seen:
                seen.add(fids[i])
                missing.append(i)
        if missing:
            fresh = self.sam.encode_frames(sam_input(missing))
            by_fid = {fids[i]: fresh[j] for j, i in enumerate(missing)}
            if bank_emb:
                cap = int(os.environ.get("BFF_SEG2D_BANK_EMB_CAP", "256"))
                n_banked = sum(1 for k in list(bank) if k[0] == "sam_emb")
                for i in missing:
                    if n_banked < cap:
                        bank[("sam_emb", fids[i])] = by_fid[fids[i]]
                        n_banked += 1
            for i in indices:
                if cached[i] is None:
                    cached[i] = by_fid[fids[i]]
            if len(missing) == len(indices):
                return fresh
        return torch.stack([cached[i] for i in indices])

    def _host_batch(self, images, query, box_threshold):
        """``detector.device_frames: false``: the reference's per-model host
        resize chain (detector input from the full-resolution frame), one
        batch start to finish. Returns (detections, masks) per frame."""
        d = self.cfg.detector
        with self._span("detect", frames=len(images)):
            raw = self.detector.predict_batch(images, query, box_threshold=box_threshold,
                                              text_threshold=d.text_threshold)
        dets = self._detect_and_filter_batch(images, raw, query)
        kept = [i for i, f in enumerate(dets) if f is not None]
        out = [(None, None)] * len(images)
        if not kept:
            return out
        with self._span("sam_encode", frames=len(kept)):
            frames, input_hw = self.sam.scale_frames(
                torch.as_tensor(np.stack([images[i] for i in kept]), device=self.device))
            embs = self.sam.encode_frames(frames)
        masks = self._decode_masks_fetch(*self._decode_masks_dispatch(
            embs, [dets[i] for i in kept], input_hw, images[0].shape[:2]), images[0].shape[:2])
        for i, m in zip(kept, masks):
            out[i] = (dets[i], m)
        return out


def run(cfg: Config, class_name: str, scenes: Optional[Sequence[str]] = None,
        resume: bool = True, segmentor: Optional[Segmentor2D] = None,
        profiler: Optional[StageProfiler] = None) -> List[Dict]:
    """Per-class driver. Scene list defaults to the stage-1 results dir
    (reference scene discovery: segmentation_2d.py:453-454). ``profiler``
    receives the per-stage spans; one is made when none is given."""
    p = cfg.paths
    scenes = _scene_list(cfg, scenes)
    prof = profiler or StageProfiler("segmentation_2d")
    seg = segmentor or Segmentor2D(cfg)
    seg.profiler = prof
    ckpt = SceneCheckpoint(p.checkpoint_dir, "segmentation_2d", class_name)
    results = []
    try:
        for scene_id in scenes:
            if resume and ckpt.done(scene_id):
                continue
            frame_ids = bio.list_scene_frames(p.scene_2d_dir, scene_id,
                                              cfg.frames.downsample_ratio)
            with prof.span("scene", frames=len(frame_ids)):
                records = seg.process_scene(scene_id, class_name)
            n_frames = len(records)
            with prof.span("encode_write"):
                rle.encode_frame_masks(records)
                out = os.path.join(p.mask_2d_dir, class_name,
                                   f"{scene_id}.{cfg.output_format}")
                bio.save_frame_records(out, records)
            ckpt.mark(scene_id)
            results.append({"scene_id": scene_id, "frames_with_boxes": n_frames})
    finally:
        seg.profiler = None
    if results:
        print(prof.report())
    return results


def _scene_list(cfg: Config, scenes: Optional[Sequence[str]]) -> List[str]:
    if scenes is not None:
        return list(scenes)
    return sorted(f.rsplit(".", 1)[0] for f in os.listdir(cfg.paths.stage_1_results_dir)
                  if f.endswith((".pth", ".npz")))


def bank_sizes(bank: Dict) -> Dict[str, int]:
    """Entries of each kind in a frame bank and the device bytes they hold."""
    out = {"frames": len({key for kind, key in bank if kind in ("sam", "det", "img", "raw")}),
           "det_feats_frames": 0, "sam_emb": 0, "bytes": 0}
    for (kind, key), val in bank.items():
        if kind == "det_feats":
            out["det_feats_frames"] += len(key)
        elif kind == "sam_emb":
            out["sam_emb"] += 1
        for t in val if isinstance(val, (list, tuple)) else (val,):
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                out["bytes"] += t.numel() * t.element_size()
    return out


def _fused_groups(detector, classes: Sequence[str], group_size: int):
    """Split ``classes`` into fused-caption groups: greedy ``group_size``
    chunks, bisected while a chunk overflows the detector's text budget
    (``caption_spans`` raises). Returns ``[(group_classes, caption, spans),
    ...]`` in class order."""
    out = []

    def fit(group):
        try:
            caption, spans = detector.caption_spans(group)
        except ValueError:
            if len(group) == 1:
                raise
            mid = len(group) // 2
            fit(group[:mid])
            fit(group[mid:])
            return
        out.append((group, caption, spans))

    for i in range(0, len(classes), max(1, group_size)):
        fit(list(classes[i:i + group_size]))
    return out


def run_classes(cfg: Config, class_names: Sequence[str],
                scenes: Optional[Sequence[str]] = None, resume: bool = True,
                segmentor: Optional[Segmentor2D] = None,
                class_thresholds: Optional[Dict[str, float]] = None,
                profiler: Optional[StageProfiler] = None) -> Dict[str, List[Dict]]:
    """Multi-class 2D stage, scene-outer: each scene's frames load and
    upload once into a per-scene frame bank that every class reuses, with
    the detector's backbone pyramids and SAM's embeddings of hit frames
    (:meth:`Segmentor2D.process_scene`). Checkpoints stay per (class, scene),
    interchangeable with :func:`run`.

    ``detector.fused_captions`` (``BFF_SEG2D_FUSED=1``/``0`` overrides):
    each scene runs one detection pass per ``fused_group`` classes on a
    " . "-joined caption, split per class by token span, and one combined
    replay of the CLIP filter and SAM decode for the group. Fused detections
    are close to, not byte-identical with, per-class captions (shared image
    pathway and top-K), so the mode is opt-in.

    ``class_thresholds``: per-class ``box_threshold`` overrides, kept on both
    paths (absent classes use ``detector.box_threshold``). ``profiler``
    receives the spans and, per scene, a ``bank`` span whose items are the
    bank's sizes."""
    p = cfg.paths
    scenes = _scene_list(cfg, scenes)
    prof = profiler or StageProfiler("segmentation_2d")
    seg = segmentor or Segmentor2D(cfg)
    env = os.environ.get("BFF_SEG2D_FUSED")
    fused = ((cfg.detector.fused_captions if env is None else env == "1")
             and len(class_names) > 1 and cfg.detector.device_frames
             and all(hasattr(seg.detector, a) for a in
                     ("caption_spans", "predict_finalize_demux", "predict_batch_frames_async"))
             and hasattr(seg.sam, "encode_frames"))
    ckpts = {c: SceneCheckpoint(p.checkpoint_dir, "segmentation_2d", c) for c in class_names}
    results: Dict[str, List[Dict]] = {c: [] for c in class_names}
    seg.profiler = prof
    try:
        for scene_id in scenes:
            todo = [c for c in class_names if not (resume and ckpts[c].done(scene_id))]
            if not todo:
                continue
            frame_bank: Dict = {}  # lives for this scene only
            n_frames = len(bio.list_scene_frames(p.scene_2d_dir, scene_id,
                                                 cfg.frames.downsample_ratio))

            def finish(c, records):
                with prof.span("encode_write"):
                    rle.encode_frame_masks(records)
                    bio.save_frame_records(
                        os.path.join(p.mask_2d_dir, c, f"{scene_id}.{cfg.output_format}"),
                        records)
                ckpts[c].mark(scene_id)
                results[c].append({"scene_id": scene_id, "frames_with_boxes": len(records)})

            if fused and len(todo) > 1:
                for group, caption, spans in _fused_groups(seg.detector, todo,
                                                           cfg.detector.fused_group):
                    dets: Dict = {}
                    dmx = (group, spans, dets)
                    if class_thresholds:
                        dmx += ([class_thresholds.get(c, cfg.detector.box_threshold)
                                 for c in group],)
                    with prof.span("fused_detect", frames=n_frames):
                        seg.process_scene(scene_id, caption, frame_bank=frame_bank, demux=dmx)
                    tables = {c: {fid: det for (cc, fid), det in dets.items() if cc == c}
                              for c in group}
                    with prof.span("scene", frames=n_frames * len(group)):
                        by_class = seg.process_scene(scene_id, caption, frame_bank=frame_bank,
                                                     override_groups=tables)
                    for c in group:
                        finish(c, by_class[c])
            else:
                for c in todo:
                    with prof.span("scene", frames=n_frames):
                        records = seg.process_scene(
                            scene_id, c, frame_bank=frame_bank,
                            box_threshold=(class_thresholds or {}).get(c))
                    finish(c, records)
            with prof.span("bank", **bank_sizes(frame_bank)):
                pass
    finally:
        seg.profiler = None
    if any(results.values()):
        print(prof.report())
    return results
