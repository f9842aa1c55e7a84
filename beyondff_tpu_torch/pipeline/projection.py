"""Stage 2 (projection): lift per-frame 2D masks onto the scene point cloud,
aggregate multi-view votes, filter, and write the 3D-mask stage contract.

The port's copy of beyondff_tpu/pipeline/projection.py (reference:
tools/projection_2d_to_3d.py:336-634). As in the JAX package:

  * frames are lifted in device chunks (``FRAME_CHUNK`` frames with
    detections, ``VIEW_CHUNK`` frames without) instead of a per-frame loop;
  * ``masked_counts`` and ``viewed_counts`` come out of ONE pass over the
    frames — the reference re-runs projection+visibility over every frame a
    second time for the detected-ratio filter (projection_2d_to_3d.py:524-578);
  * per-view membership stays on the device from the lift through
    aggregation; only the (I, I) IoU and the merged (C, N) masks come down;
  * the resume checkpoint is written after the scene's output lands on disk.

  * depth frames cross to the device through the depth-pack transport
    (``BFF_DEPTH_PACK``, default on; core/depth_pack.py): packed in the
    prefetch thread, decoded on the device to the exact uint16 frame; a
    frame the spill guard rejects uploads raw.

  * inside ``parallel.frames.shard_frames`` over a process group of more
    than one rank whose size divides ``FRAME_CHUNK`` and ``VIEW_CHUNK``,
    the view counts, the packed lift and the RLE lift shard each chunk's
    frames over the ranks (``parallel/lift.py``; counts summed with
    ``all_reduce``, membership gathered), as the JAX package shards them
    over its devices. Every rank makes the same calls and gets the same
    outputs.

Left out, each specific to JAX or the TPU and without effect on the
outputs: the ``BFF_MEMBERSHIP_HBM_MB`` host
spill (a full scene's membership, hundreds of MB, fits an 80 GB card many
times over) and the padding of frames, masks, runs and points to bucket
sizes (it served XLA's compile cache).

On-disk contracts are unchanged: input 2D RLE ``.pth`` records per scene,
output ``{"ins", "conf", "final_class"}`` per scene.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import aggregation, depth_pack, filtering, geometry, rle
from beyondff_tpu_torch.data.readers import build_dataset
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.utils import io as bio
from beyondff_tpu_torch.utils.checkpoint import SceneCheckpoint
from beyondff_tpu_torch.utils.profiling import StageProfiler

FRAME_CHUNK = 8  # detection frames lifted per device call
VIEW_CHUNK = 32  # detection-free frames per visibility call
# run-count cap for the RLE device path: noisier masks than this go through
# dense bitmaps instead (a run table this size is already ~1 MB)
_RLE_RUN_CAP = 16384


def upload_depth_raw(raw: np.ndarray, device: torch.device) -> torch.Tensor:
    """Raw uint16 depth to the device as its int16 bit pattern (2 bytes a
    pixel; :func:`geometry.prepare_depth` reads it back as uint16)."""
    return torch.from_numpy(np.ascontiguousarray(raw).view(np.int16)).to(device)


def sharded_lifts(dev: torch.device, depth_thresh: float) -> Optional[Dict]:
    """The frame-sharded view counts, packed lift and RLE lift
    (``parallel/lift.py``) inside ``parallel.frames.shard_frames`` over a
    group of more than one rank whose size divides ``FRAME_CHUNK`` and
    ``VIEW_CHUNK`` (the JAX package's rule for its devices), else ``None``."""
    from beyondff_tpu_torch.parallel.frames import frame_group

    group = frame_group()
    if group is None:
        return None
    n = dist.get_world_size(group)
    if FRAME_CHUNK % n or VIEW_CHUNK % n:
        return None
    from beyondff_tpu_torch.parallel import lift as plift
    from beyondff_tpu_torch.parallel.mesh import data_mesh

    mesh = data_mesh(dev.type)
    return {"ranks": n, "view": plift.make_sharded_view_counts(mesh, depth_thresh),
            "packed": lambda m: plift.make_sharded_lift_packed(mesh, m, depth_thresh),
            "rle": plift.make_sharded_lift_rle(mesh, depth_thresh)}


def _pad_frames(n_ranks: int, projs: torch.Tensor, depths: torch.Tensor, *per_frame):
    """Pad a chunk to a multiple of ``n_ranks`` frames with frames that see
    nothing (zero depth, no mask, empty runs: ``per_frame`` tensors padded
    with their ``fill``), for the sharded lifts. Returns the padded tensors."""
    pad = -projs.shape[0] % n_ranks
    if not pad:
        return (projs, depths, *(t for t, _fill in per_frame))

    def grow(t, fill):
        return torch.cat([t, torch.full((pad, *t.shape[1:]), fill, dtype=t.dtype,
                                        device=t.device)])

    return (torch.cat([projs, projs[-1:].expand(pad, -1, -1)]), grow(depths, 0),
            *(grow(t, fill) for t, fill in per_frame))


def _lift_sharded(lift, n_ranks: int, pcd_h, projs, depths, *per_frame):
    """A sharded lift over a chunk padded to split over the ranks; the
    ranks' membership slices gathered and the padding cut: the outputs of
    the one-rank lift."""
    from beyondff_tpu_torch.parallel.frames import gather_frames

    member, masked, viewed = lift(pcd_h, *_pad_frames(n_ranks, projs, depths, *per_frame))
    return gather_frames(member)[:projs.shape[0]], masked, viewed


def lift_scene(
    pcd: np.ndarray,  # (N, 3)
    cam_intr: np.ndarray,  # (3, 3)
    frames: Sequence[Dict],  # per-frame: {frame_id, pose, depth, masks?, confidences?, labels?}
    depth_thresh: float = 0.08,
    device=None,
) -> Tuple[np.ndarray, np.ndarray, List[str], np.ndarray, np.ndarray]:
    """Lift all frames of one scene (pre-materialized frame list).

    ``frames`` entries with a "masks" key ((M, H, W) bool) contribute lifted
    instance masks; all entries contribute to ``viewed_counts``.

    Returns (membership (I, N) bool, confidences, labels, masked_counts,
    viewed_counts) where I = total detections across frames.
    """
    det_ids = {f["frame_id"] for f in frames if f.get("masks") is not None and len(f["masks"])}
    return lift_scene_streamed(pcd, cam_intr, iter(frames), det_ids, depth_thresh, device=device)


def lift_scene_streamed(
    pcd: np.ndarray,
    cam_intr: np.ndarray,
    frames_iter,
    det_frame_ids,
    depth_thresh: float = 0.08,
    target_hw=None,
    depth_scale: float = 1000.0,
    need_viewed: bool = True,
    device_membership: bool = False,
    device=None,
) -> Tuple[object, np.ndarray, List[str], np.ndarray, np.ndarray]:
    """Streaming lift: consumes frames from an iterator (typically wrapped in
    a background prefetcher) and lifts device chunks as they fill, so host IO
    overlaps device compute.

    ``device_membership=True`` returns membership as a list of
    ``(device chunk (F, m, N) bool, row_sizes)`` pairs instead of one host
    array: per-view masks then never leave the device."""
    dev = resolve_device(device)
    n = pcd.shape[0]
    pcd_dev = torch.from_numpy(geometry.homogenize(pcd)).to(dev)
    sharded = sharded_lifts(dev, depth_thresh)
    chunks: List[tuple] = []  # (device (F, m, N) bool, [m_i per frame])
    confs: List[float] = []
    labels: List[str] = []
    # counts accumulate on the device across chunks (one download per scene)
    acc = {"m": torch.zeros(n, dtype=torch.int64, device=dev),
           "v": torch.zeros(n, dtype=torch.int64, device=dev)}

    def projections(chunk: List[Dict]) -> torch.Tensor:
        projs = np.stack([geometry.fuse_projection(cam_intr, f["pose"]).astype(np.float32)
                          for f in chunk])
        return torch.from_numpy(projs).to(dev)

    def chunk_depths(chunk: List[Dict]) -> torch.Tensor:
        """(F, H, W) float32 device depths; raw uint16 frames upload at native
        resolution and scale/resize on the device (geometry.prepare_depth).
        Frames carrying buffers already on the device (``depth_dev``,
        uploaded from the prefetch thread) stack there."""
        if "depth_dev" in chunk[0]:
            raw = torch.stack([f["depth_dev"] for f in chunk])
            return geometry.prepare_depth(raw, tuple(target_hw), depth_scale)
        if "depth_raw" in chunk[0]:
            raw = upload_depth_raw(np.stack([f["depth_raw"] for f in chunk]), dev)
            return geometry.prepare_depth(raw, tuple(target_hw), depth_scale)
        return torch.from_numpy(np.stack([np.asarray(f["depth"], np.float32)
                                          for f in chunk])).to(dev)

    def dense_masks(f: Dict) -> np.ndarray:
        if f.get("masks") is None:
            flat = rle.rle_decode_batch(f["rles"]).astype(bool)
            f["masks"] = flat.reshape(flat.shape[0], *target_hw)
        return f["masks"]

    def keep(membership, mc, vc, sizes, chunk) -> None:
        acc["m"] += mc
        acc["v"] += vc
        chunks.append((membership, sizes))
        for f in chunk:
            confs.extend(float(c) for c in f["confidences"])
            labels.extend(f["labels"])

    def flush_det(chunk: List[Dict]) -> None:
        projs = projections(chunk)
        depths = chunk_depths(chunk)
        # RLE device path: upload run bounds (KBs) instead of per-pixel bitmaps
        use_rle = (
            all(f.get("rles") is not None for f in chunk)
            # string-form counts (the reference's space-separated variant)
            # take the dense path, which decodes them on the host
            and not any(isinstance(r["counts"], str) for f in chunk for r in f["rles"])
            and max(np.asarray(r["counts"]).size for f in chunk for r in f["rles"])
            <= 2 * _RLE_RUN_CAP
        )
        if use_rle:
            m = max(len(f["rles"]) for f in chunk)
            r = max(1, max(len(np.asarray(x["counts"])) // 2 for f in chunk for x in f["rles"]))
            hw = target_hw[0] * target_hw[1]
            st = np.full((len(chunk), m, r), hw + 1, np.int64)
            en = np.zeros((len(chunk), m, r), np.int64)
            for i, f in enumerate(chunk):
                for j, x in enumerate(f["rles"]):
                    s0, e0 = rle.rle_bounds(x)
                    st[i, j, :len(s0)] = s0
                    en[i, j, :len(e0)] = e0
            st, en = torch.from_numpy(st).to(dev), torch.from_numpy(en).to(dev)
            if sharded is None:
                out = geometry.lift_frames_rle(pcd_dev, projs, depths, st, en, depth_thresh)
            else:
                out = _lift_sharded(sharded["rle"], sharded["ranks"], pcd_dev, projs, depths,
                                    (st, hw + 1), (en, 0))
            keep(*out, [len(f["rles"]) for f in chunk], chunk)
            return
        m = max(dense_masks(f).shape[0] for f in chunk)
        h, w = dense_masks(chunk[0]).shape[-2:]
        if m <= 32:
            # bit-packed path: one word gather per point
            packed = np.stack([geometry.pack_masks(
                f["masks"].reshape(f["masks"].shape[0], -1).astype(bool)) for f in chunk])
            packed = torch.from_numpy(packed.astype(np.int64)).to(dev)
            if sharded is None:
                out = geometry.lift_frames_packed(pcd_dev, projs, depths, packed, depth_thresh,
                                                  n_masks=m)
            else:
                out = _lift_sharded(sharded["packed"](m), sharded["ranks"], pcd_dev, projs,
                                    depths, (packed, 0))
        else:
            masks = np.zeros((len(chunk), m, h * w), bool)
            valid = np.zeros((len(chunk), m), bool)
            for i, f in enumerate(chunk):
                mi = f["masks"].reshape(f["masks"].shape[0], -1).astype(bool)
                masks[i, :mi.shape[0]] = mi
                valid[i, :mi.shape[0]] = True
            out = geometry.lift_frames(pcd_dev, projs, depths, torch.from_numpy(masks).to(dev),
                                       torch.from_numpy(valid).to(dev), depth_thresh)
        keep(*out, [f["masks"].shape[0] for f in chunk], chunk)

    def flush_view(chunk: List[Dict]) -> None:
        if sharded is None:
            acc["v"] += geometry.view_counts(pcd_dev, projections(chunk), chunk_depths(chunk),
                                             depth_thresh)
        else:
            acc["v"] += sharded["view"](pcd_dev, *_pad_frames(
                sharded["ranks"], projections(chunk), chunk_depths(chunk)))

    det_buf: List[Dict] = []
    view_buf: List[Dict] = []
    for f in frames_iter:
        det = f.get("rles") if f.get("rles") is not None else f.get("masks")
        if det is not None and len(det) and f["frame_id"] in det_frame_ids:
            det_buf.append(f)
            if len(det_buf) == FRAME_CHUNK:
                flush_det(det_buf)
                det_buf = []
        elif need_viewed:
            # occurrence-mode filtering never reads viewed_counts, so frames
            # without detections skip the device entirely
            view_buf.append(f)
            if len(view_buf) == VIEW_CHUNK:
                flush_view(view_buf)
                view_buf = []
    if det_buf:
        flush_det(det_buf)
    if view_buf:
        flush_view(view_buf)

    masked_counts = acc["m"].cpu().numpy()
    viewed_counts = acc["v"].cpu().numpy()
    if device_membership:
        membership = chunks
    elif chunks:
        membership = np.concatenate([c[i, :m_i].cpu().numpy() for c, sizes in chunks
                                     for i, m_i in enumerate(sizes)])
    else:
        membership = np.zeros((0, n), bool)
    return membership, np.asarray(confs, np.float32), labels, masked_counts, viewed_counts


def project_scene(cfg: Config, class_name: str, scene_id: str, ext: Optional[str] = None,
                  prof: Optional[StageProfiler] = None, depth_bank: Optional[Dict] = None,
                  view_bank: Optional[Dict] = None, device=None) -> Dict:
    """Run the full projection stage for one (class, scene); writes the output.

    ``depth_bank``: optional {frame_id: raw depth DEVICE buffer} shared across
    classes of the same scene (see :func:`run_classes`): the scene's depth
    then uploads once per scene instead of once per (class, scene).

    ``view_bank``: optional {frozenset(frame_ids): viewed_counts} shared across
    classes of the same scene. ``viewed_counts`` depends on scene geometry
    (pcd, poses, depths) over the frame listing, not on the query, so every
    class after the first lifts only the frames that carry detections."""
    dev = resolve_device(device)
    prof = prof or StageProfiler("projection")
    ext = ext or cfg.output_format
    p = cfg.paths
    reader = build_dataset(p.dataset, os.path.join(p.scene_2d_dir, scene_id))
    cam_intr = reader.intrinsic()

    pcd = bio.load_point_cloud(p.scene_npy_dir, scene_id)
    size = (cfg.frames.width_2d, cfg.frames.height_2d)

    # 2D stage output: records only for frames with detections
    rec_path = os.path.join(p.mask_2d_dir, class_name, f"{scene_id}.{'pth' if ext == 'pth' else 'npz'}")
    if not os.path.exists(rec_path):  # tolerate the other format on disk
        alt = rec_path[:-3] + ("npz" if ext == "pth" else "pth")
        rec_path = alt if os.path.exists(alt) else rec_path
    records = bio.load_frame_records(rec_path)
    by_frame = {str(r["frame_id"]).rsplit(".", 1)[0]: r for r in records}

    frame_ids = bio.list_scene_frames(p.scene_2d_dir, scene_id, cfg.frames.downsample_ratio)
    # the reference lifts every record stored in the 2D stage file
    # (projection_2d_to_3d.py:413); detection frames outside this config's
    # listing are unioned in (numeric order, like the listing) and, in this
    # mismatch case only, also counted as viewed
    missing = set(by_frame) - set(frame_ids)
    if missing:
        print(f"[projection] warning: {len(missing)} detection frames not in the "
              f"downsample-{cfg.frames.downsample_ratio} listing for {scene_id}; lifting them too")
        frame_ids = frame_ids + sorted(missing, key=lambda s: (len(s), s))

    device_resize = cfg.frames.device_depth_resize
    # viewed_counts feed only the detected-ratio point filter; in occurrence
    # mode the non-detection frames (and their depth decode/upload) are skipped
    need_viewed = (cfg.filtering.use_detected_ratio_threshold
                   and not cfg.filtering.use_occurrence_threshold)
    view_key = frozenset(frame_ids)
    banked_viewed = None
    if need_viewed and view_bank is not None:
        banked_viewed = view_bank.get(view_key)
    lift_need_viewed = need_viewed and banked_viewed is None
    lift_ids = (frame_ids if lift_need_viewed
                else [fid for fid in frame_ids if fid in by_frame])

    dec = max(1, int(cfg.frames.depth_decimation))
    cache_dir = None
    if cfg.frames.depth_cache and cfg.paths.checkpoint_dir:
        cache_dir = os.path.join(cfg.paths.checkpoint_dir, "depth_cache", scene_id)
        os.makedirs(cache_dir, exist_ok=True)

    def _depth_raw(fid: str) -> np.ndarray:
        if cache_dir is not None:
            # the source PNG's (size, mtime) is part of the cache filename: a
            # replaced depth frame invalidates its entry
            try:
                st = os.stat(reader.depth_path(fid))
                tag = f"{st.st_size}_{st.st_mtime_ns}"
            except OSError:
                tag = "nosrc"
            path = os.path.join(cache_dir, f"{fid}.d{dec}.{tag}.npy")
            if os.path.exists(path):
                try:
                    return np.load(path)
                except (OSError, ValueError):
                    pass  # truncated write; fall through to re-decode
            # drop superseded entries for this frame
            prefix = f"{fid}.d{dec}."
            for old in os.listdir(cache_dir):
                if old.startswith(prefix) and old != os.path.basename(path):
                    try:
                        os.remove(os.path.join(cache_dir, old))
                    except OSError:
                        pass
        raw = reader.depth_raw(fid)
        # decimate before upload: the visibility test samples depth at
        # projected points under an 0.08 m tolerance (see FramesConfig)
        if dec > 1:
            raw = raw[::dec, ::dec]
        if cache_dir is not None:
            tmp = f"{path}.tmp{os.getpid()}.npy"
            np.save(tmp, raw)
            os.replace(tmp, path)  # atomic: concurrent readers see old or new
        return raw

    use_dpack = os.environ.get("BFF_DEPTH_PACK", "1") == "1"

    def load_frame(fid: str) -> Dict:
        f: Dict = {"frame_id": fid, "pose": reader.pose(fid)}
        rec = by_frame.get(fid)
        if lift_need_viewed or rec is not None:
            if device_resize:
                buf = depth_bank.get(fid) if depth_bank is not None else None
                if buf is None:
                    # the upload starts here, in the prefetch thread: packed
                    # (bit-lossless) unless the frame spills, then raw
                    raw = _depth_raw(fid)
                    pk = depth_pack.pack_cached(raw) if use_dpack else None
                    buf = upload_depth_raw(raw, dev) if pk is None else \
                        depth_pack.upload_frame(pk, dev)
                    if depth_bank is not None:
                        depth_bank[fid] = buf
                f["depth_dev"] = buf
            else:
                f["depth"] = reader.depth(fid, size=size)
        if rec is not None:
            raw = rec["segmented_frame_masks"]
            if isinstance(raw, (list, tuple)) and (not raw or isinstance(raw[0], dict)):
                f["rles"] = list(raw)  # stays compressed; the device decodes
            else:
                masks = np.asarray(raw)  # dense (reference YOLO-World files)
                f["masks"] = masks[:, 0].astype(bool)  # (M, H, W)
            f["confidences"] = np.asarray(rec["confidences"], np.float32)
            f["labels"] = list(rec["labels"])
        return f

    with prof.span("lift", frames=len(lift_ids)):
        # frames stream through a background loader thread while the device
        # lifts the previous chunk; membership stays on the device
        from beyondff_tpu_torch.utils.prefetch import prefetch_map

        frames_iter = prefetch_map(load_frame, lift_ids,
                                   depth=max(1, cfg.parallel.prefetch_depth) * FRAME_CHUNK)
        chunks, confs, labels, masked_counts, viewed_counts = lift_scene_streamed(
            pcd, cam_intr, frames_iter, set(by_frame), cfg.frames.depth_thresh,
            target_hw=(cfg.frames.height_2d, cfg.frames.width_2d),
            depth_scale=cfg.frames.depth_scale, need_viewed=lift_need_viewed,
            device_membership=True, device=dev,
        )
        if banked_viewed is not None:
            viewed_counts = banked_viewed
        elif lift_need_viewed and view_bank is not None:
            view_bank[view_key] = viewed_counts

    out_path = os.path.join(p.mask_3d_dir, class_name, f"{scene_id}.{ext}")
    n_lifted = len(labels)
    if n_lifted == 0:
        bio.save_stage_dict(out_path, np.zeros((0, pcd.shape[0]), bool), np.zeros(0, np.float32), [])
        return {"scene_id": scene_id, "instances": 0}

    with prof.span("aggregate", instances=n_lifted):
        agg = aggregation.aggregate_chunks(
            chunks, pcd.shape[0], confs, labels,
            iou_thres=cfg.aggregation.iou_thres,
            min_aggregated_masks=cfg.aggregation.min_aggregated_masks,
        )
    if agg.empty:
        bio.save_stage_dict(out_path, np.zeros((0, pcd.shape[0]), bool), np.zeros(0, np.float32), [])
        return {"scene_id": scene_id, "instances": 0}

    with prof.span("filter"):
        out = filtering.filter_masks(agg, masked_counts, viewed_counts, cfg.filtering)
    bio.save_stage_dict(out_path, out.ins, out.conf, out.labels)
    return {"scene_id": scene_id, "instances": int(out.ins.shape[0])}


def run(cfg: Config, class_name: str, scenes: Optional[Sequence[str]] = None, resume: bool = True,
        device=None, profiler: Optional[StageProfiler] = None) -> List[Dict]:
    """Projection of one class over all scenes with 2D-stage outputs
    (reference scene discovery: projection_2d_to_3d.py:363-365), on
    ``device`` (``cuda`` unless the caller names another). ``profiler``
    receives the ``lift``/``aggregate``/``filter`` spans; one is made when
    none is given."""
    dev = resolve_device(device)
    seg_dir = os.path.join(cfg.paths.mask_2d_dir, class_name)
    if scenes is None:
        scenes = sorted(
            f.rsplit(".", 1)[0] for f in os.listdir(seg_dir) if f.endswith((".pth", ".npz"))
        )
    prof = profiler or StageProfiler("projection")
    ckpt = SceneCheckpoint(cfg.paths.checkpoint_dir, "projection_2d_to_3d", class_name)
    results = []
    for scene_id in scenes:
        if resume and ckpt.done(scene_id):
            continue
        results.append(project_scene(cfg, class_name, scene_id, prof=prof, device=dev))
        ckpt.mark(scene_id)
    if results:
        print(prof.report())
    return results


def run_classes(cfg: Config, class_names: Sequence[str],
                scenes: Optional[Sequence[str]] = None,
                resume: bool = True, device=None) -> Dict[str, List[Dict]]:
    """Multi-class projection with SCENE-OUTER ordering: each scene's depth
    uploads to the device once and is shared by every class's lift via a
    per-scene ``depth_bank``; the query-independent per-point visibility
    totals are likewise computed once per scene and shared via a
    ``view_bank`` (``BFF_PROJ_BANK_VIEWED=0`` disables it, as in the JAX
    package), so classes after the first lift only their detection
    frames. Per-(class, scene) checkpoints
    are identical to :func:`run`, so the two entry points resume each other's
    partial sweeps."""
    dev = resolve_device(device)
    bank_viewed = os.environ.get("BFF_PROJ_BANK_VIEWED", "1") == "1"
    per_class_scenes: Dict[str, set] = {}
    for c in class_names:
        seg_dir = os.path.join(cfg.paths.mask_2d_dir, c)
        if scenes is not None:
            per_class_scenes[c] = set(scenes)
        elif os.path.isdir(seg_dir):
            per_class_scenes[c] = {
                f.rsplit(".", 1)[0] for f in os.listdir(seg_dir)
                if f.endswith((".pth", ".npz"))
            }
        else:
            per_class_scenes[c] = set()
    all_scenes = sorted(set().union(*per_class_scenes.values()))

    prof = StageProfiler("projection")
    ckpts = {c: SceneCheckpoint(cfg.paths.checkpoint_dir, "projection_2d_to_3d", c)
             for c in class_names}
    results: Dict[str, List[Dict]] = {c: [] for c in class_names}
    for scene_id in all_scenes:
        todo = [c for c in class_names
                if scene_id in per_class_scenes[c]
                and not (resume and ckpts[c].done(scene_id))]
        if not todo:
            continue
        depth_bank: Dict = {}  # lives for this scene only
        view_bank: Optional[Dict] = {} if bank_viewed else None
        for c in todo:
            results[c].append(project_scene(cfg, c, scene_id, prof=prof, depth_bank=depth_bank,
                                            view_bank=view_bank, device=dev))
            ckpts[c].mark(scene_id)
    if any(results.values()):
        print(prof.report())
    return results
