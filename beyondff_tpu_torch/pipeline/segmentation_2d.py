"""Stage 1 driver: open-vocabulary 2D detection + promptable segmentation.

Port of beyondff_tpu/pipeline/segmentation_2d.py on its Grounding-DINO
classic path. Per scene, frames go in batches of ``detector.frame_batch``
through

  1. Grounding-DINO detection with phrase filtering against the query,
  2. CLIP supervision: box crops scored against the ensembled descriptor
     embedding of the query, low-similarity boxes dropped,
  3. box-prompted SAM mask decoding,

and the per-frame results are RLE-encoded into the 2D-mask stage contract.

With ``detector.device_frames`` (the default) each frame uploads once as a
SAM-scaled dense uint8 RGB buffer; the detector input derives from it on the
device and SAM encodes it directly (the JAX package with
``BFF_SEG2D_YUV=0``). Batches run one after another: the JAX package's
three-stage deferred flush gives identical records, and the port's device
calls queue asynchronously on the CUDA stream anyway.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import resize as _resize
from beyondff_tpu_torch.core import rle
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.pipeline import descriptors
from beyondff_tpu_torch.utils import io as bio
from beyondff_tpu_torch.utils.checkpoint import SceneCheckpoint
from beyondff_tpu_torch.utils.profiling import StageProfiler


def box_cxcywh_to_xyxy(boxes: np.ndarray, w: int, h: int) -> np.ndarray:
    """Normalized cxcywh -> absolute xyxy (reference: box_ops + scaling)."""
    cx, cy, bw, bh = boxes.T
    return np.stack(
        [(cx - bw / 2) * w, (cy - bh / 2) * h, (cx + bw / 2) * w, (cy + bh / 2) * h], axis=1)


def _record(dets, masks) -> Dict:
    """One frame's stage record: (M, 1, H, W) bool masks, CLIP confidences,
    phrases."""
    return {"segmented_frame_masks": masks[:, None].astype(bool),
            "confidences": [float(s) for s in dets[1]],
            "labels": list(dets[2])}


class Segmentor2D:
    """Holds the model stack; processes scenes batch by batch.

    Models may be injected (full-width random models in a smoke run);
    otherwise the ``"test"`` presets are created randomly, as in the JAX
    package. ``frame_loader(path, size)`` returns a uint8 RGB frame; it
    defaults to :func:`utils.io.load_image` (OpenCV)."""

    def __init__(self, cfg: Config, detector=None, sam=None, clip_model=None,
                 clip_tokenizer=None, device=None,
                 frame_loader: Optional[Callable] = None):
        self.cfg = cfg
        d = cfg.detector
        if d.kind != "grounding_dino":
            raise NotImplementedError(f"detector kind {d.kind!r} is not ported yet")
        if d.gdino_checkpoint or d.sam_checkpoint or d.clip_checkpoint:
            raise NotImplementedError("checkpoint loading is not ported yet; inject models "
                                      "built from state dicts instead")
        injected = next((m for m in (detector, sam, clip_model) if m is not None), None)
        self.device = injected.device if injected is not None and device is None \
            else resolve_device(device)
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}.get(d.dtype, torch.float32)
        self.clip = self.clip_tokenizer = None
        if d.filter_with_clip:
            if clip_model is not None:
                self.clip, self.clip_tokenizer = clip_model, clip_tokenizer
            else:
                from beyondff_tpu_torch.models import clip as clip_mod

                self.clip = clip_mod.CLIP.create("test", dtype=dtype, device=self.device)
            if self.clip_tokenizer is None:
                from beyondff_tpu_torch.models.tokenizers import HashTokenizer

                self.clip_tokenizer = HashTokenizer(self.clip.cfg.vocab_size,
                                                    self.clip.cfg.context_length)
        if detector is None:
            from beyondff_tpu_torch.models.gdino import GroundingDINO

            detector = GroundingDINO.create("test", dtype=dtype, device=self.device)
        self.detector = detector
        if sam is None:
            from beyondff_tpu_torch.models import sam as sam_mod

            sam = sam_mod.SAM.create("test", dtype=dtype, device=self.device)
        self.sam = sam
        self.frame_loader = frame_loader or bio.load_image
        self.profiler: Optional[StageProfiler] = None
        self._query_embedding_cache: Dict[str, np.ndarray] = {}

    def _span(self, name: str, **items):
        """A profiler span when a profiler is attached; device work queued
        inside it is synchronized at its end so the span holds it."""
        if self.profiler is None:
            return contextlib.nullcontext()
        prof, dev = self.profiler, self.device

        @contextlib.contextmanager
        def cm():
            with prof.span(name, **items):
                yield
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)

        return cm()

    # ------------------------------------------------------- CLIP filtering
    def query_embedding(self, query: str) -> np.ndarray:
        """Mean of the CLIP text embeddings of the descriptor-extended query,
        L2-normalized twice like the reference (segmentation_2d.py:324-337)."""
        if query in self._query_embedding_cache:
            return self._query_embedding_cache[query]
        method = self.cfg.detector.descriptor_generator
        if "gpt" in method:
            raise NotImplementedError("the gpt descriptor backend is not ported yet")
        variants = descriptors.generate(query, method, seed=self.cfg.seed)[query]
        feats = self.clip.encode_text(self.clip_tokenizer(variants)).float().cpu().numpy()
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        mean = feats.mean(axis=0)
        mean /= np.linalg.norm(mean)
        self._query_embedding_cache[query] = mean
        return mean

    def _clip_crops(self, image, boxes_xyxy: np.ndarray, frame_hw=None) -> List[torch.Tensor]:
        """Box crops for CLIP scoring from the detector-transformed frame, as
        the reference crops: the ImageNet-normalized resized tensor cast back
        with ``* 255`` into uint8, wraparound included (bbox_filter,
        segmentation_2d.py:345-380), applied per channel through a 256-entry
        lookup table built with the identical float expression. ``image``:
        uint8 (H, W, 3), host array or device tensor; crops stay on the
        device."""
        from beyondff_tpu_torch.models.gdino.model import IMAGE_MEAN, IMAGE_STD

        image = torch.as_tensor(image, device=self.device)
        h, w = frame_hw if frame_hw is not None else image.shape[:2]
        gh, gw = self.detector.cfg.image_size
        src = _resize.resize_linear(image, (gh, gw))
        sx, sy = gw / w, gh / h
        lut = (((np.arange(256, dtype=np.float32)[:, None] / 255.0 - IMAGE_MEAN) / IMAGE_STD)
               * 255).astype(np.uint8)
        lut = torch.as_tensor(lut, device=self.device)
        chans = torch.arange(3, device=self.device)
        crops = []
        for bx0, by0, bx1, by1 in boxes_xyxy:
            x0, y0 = max(0, int(bx0 * sx)), max(0, int(by0 * sy))
            x1, y1 = min(gw, int(bx1 * sx)), min(gh, int(by1 * sy))
            if x1 <= x0 or y1 <= y0:
                crops.append(torch.zeros((2, 2, 3), dtype=torch.uint8, device=self.device))
                continue
            crops.append(lut[src[y0:y1, x0:x1].long(), chans])
        return crops

    def _clip_sims(self, crops: List[np.ndarray], query: str) -> np.ndarray:
        with self._span("clip", crops=len(crops)):
            feats = self.clip.encode_image(self.clip.preprocess(crops)).float().cpu().numpy()
        feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
        return feats @ self.query_embedding(query)

    def filter_boxes_with_clip(self, image: np.ndarray, boxes_xyxy: np.ndarray, query: str):
        """Keep boxes whose crop's CLIP similarity >= threshold. Returns
        (keep_mask, similarities)."""
        sims = self._clip_sims(self._clip_crops(image, boxes_xyxy), query)
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

    def _detect_and_filter_batch(self, images, raw_dets, query: str, frame_hw=None,
                                 pre=None):
        """Per-frame phrase filter + one batched CLIP crop scoring for the
        frame batch + per-frame top-K. Returns (boxes_xyxy, scores, phrases)
        or None per frame; CLIP similarities replace the detector scores.
        ``pre``: phrase-filter results already computed by the caller."""
        d = self.cfg.detector
        if pre is None:
            pre = [self._phrase_filter(im, query, det, frame_hw)
                   for im, det in zip(images, raw_dets)]
        if self.clip is None or not d.filter_with_clip:
            return [None if p is None else self._cap_detections(p) for p in pre]
        crops, counts = [], []
        with self._span("clip_crops", frames=sum(p is not None for p in pre)):
            for im, p in zip(images, pre):
                c = [] if p is None else self._clip_crops(im, p[0], frame_hw)
                crops.extend(c)
                counts.append(len(c))
        if not crops:
            return [None] * len(images)
        sims_all = self._clip_sims(crops, query)
        out, off = [], 0
        for p, n in zip(pre, counts):
            if p is None:
                out.append(None)
                continue
            boxes_xyxy, _scores, phrases = p
            sims = sims_all[off:off + n]
            off += n
            keep = sims >= d.similarity_threshold
            out.append(None if not keep.any() else self._cap_detections(
                (boxes_xyxy[keep], sims[keep], [ph for ph, k in zip(phrases, keep) if k])))
        return out

    def _decode_masks(self, embs, dets: List, input_hw, orig_hw) -> List[np.ndarray]:
        """Every box of the batch in one SAM decode, bit-packed on the device,
        one download, unpacked to dense (M, H, W) bool per frame."""
        h, w = orig_hw
        sizes = [bx.shape[0] for bx, _s, _p in dets]
        frame_idx = np.repeat(np.arange(len(dets)), sizes)
        boxes = np.concatenate([self.sam.transform_boxes(bx, orig_hw) for bx, _s, _p in dets])
        with self._span("sam_decode", boxes=len(boxes)):
            packed, _iou = self.sam.decode_boxes_packed(embs, frame_idx, boxes, input_hw, orig_hw)
            flat = packed.cpu().numpy()
        masks = np.unpackbits(flat, axis=-1, bitorder="little")[:, :h * w]
        out, off = [], 0
        for m in sizes:
            out.append(masks[off:off + m].reshape(m, h, w).astype(bool))
            off += m
        return out

    # ------------------------------------------------------------ per frame
    def process_frame(self, image: np.ndarray, query: str) -> Optional[Dict]:
        """One RGB frame -> detection record or None (no boxes)."""
        dets, masks = self._host_batch([image], query)[0]
        return None if dets is None else _record(dets, masks)

    # ------------------------------------------------------------ per scene
    def process_scene(self, scene_id: str, query: str) -> List[Dict]:
        """All frames of a scene, ``detector.frame_batch`` at a time."""
        p = self.cfg.paths
        d = self.cfg.detector
        size = (self.cfg.frames.width_2d, self.cfg.frames.height_2d)
        frame_hw = (self.cfg.frames.height_2d, self.cfg.frames.width_2d)
        frame_ids = bio.list_scene_frames(p.scene_2d_dir, scene_id,
                                          self.cfg.frames.downsample_ratio)
        records: List[Dict] = []
        bsz = max(1, d.frame_batch)
        for i in range(0, len(frame_ids), bsz):
            fids = frame_ids[i:i + bsz]
            with self._span("load", frames=len(fids)):
                images = [self.frame_loader(
                    os.path.join(p.scene_2d_dir, scene_id, "color", f"{fid}.jpg"), size)
                    for fid in fids]
            batch = (self._device_batch(images, query, frame_hw) if d.device_frames
                     else self._host_batch(images, query))
            records.extend({"frame_id": f"{fid}.jpg", **_record(dets, masks)}
                           for fid, (dets, masks) in zip(fids, batch) if dets is not None)
        return records

    def _device_batch(self, images, query, frame_hw):
        """Single-upload path: frames upload once and scale to the SAM input
        on the device; detection resizes that buffer, SAM encodes it (before
        the CLIP filter, as the JAX package's eager encode) and the CLIP crops
        come from it. Returns (detections, masks) per frame."""
        d = self.cfg.detector
        with self._span("upload", frames=len(images)):
            frames, input_hw = self.sam.scale_frames(
                torch.as_tensor(np.stack(images)).to(self.device))
            smalls = list(frames)
        with self._span("detect", frames=len(images)):
            handle = self.detector.predict_batch_frames_async(frames, query)
            raw = self.detector.predict_finalize(handle, box_threshold=d.box_threshold,
                                                 text_threshold=d.text_threshold)
        pre = [self._phrase_filter(im, query, det, frame_hw) for im, det in zip(smalls, raw)]
        idx = [i for i, pr in enumerate(pre) if pr is not None]
        if not idx:
            return [(None, None)] * len(images)
        with self._span("sam_encode", frames=len(idx)):
            embs = self.sam.encode_frames(frames[idx])
        dets = self._detect_and_filter_batch(smalls, raw, query, frame_hw, pre=pre)
        pos = [j for j, i in enumerate(idx) if dets[i] is not None]
        return self._with_masks(dets, embs[pos], input_hw, frame_hw)

    def _host_batch(self, images, query):
        """``detector.device_frames: false``: the reference's per-model host
        resize chain (detector input from the full-resolution frame)."""
        d = self.cfg.detector
        with self._span("detect", frames=len(images)):
            raw = self.detector.predict_batch(images, query, box_threshold=d.box_threshold,
                                              text_threshold=d.text_threshold)
        dets = self._detect_and_filter_batch(images, raw, query)
        kept = [i for i, f in enumerate(dets) if f is not None]
        if not kept:
            return [(None, None)] * len(images)
        with self._span("sam_encode", frames=len(kept)):
            frames, input_hw = self.sam.scale_frames(
                torch.as_tensor(np.stack([images[i] for i in kept]), device=self.device))
            embs = self.sam.encode_frames(frames)
        return self._with_masks(dets, embs, input_hw, images[0].shape[:2])

    def _with_masks(self, dets, embs, input_hw, frame_hw):
        """Decode the kept frames' boxes (``embs`` holds their embeddings in
        frame order) and pair each frame's detections with its masks."""
        kept = [i for i, f in enumerate(dets) if f is not None]
        out = [(None, None)] * len(dets)
        if kept:
            masks = self._decode_masks(embs, [dets[i] for i in kept], input_hw, frame_hw)
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
    if scenes is None:
        scenes = sorted(f.rsplit(".", 1)[0] for f in os.listdir(p.stage_1_results_dir)
                        if f.endswith((".pth", ".npz")))
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
