"""Stage 3 (refinement): fuse stage-1 and stage-2 3D masks into final instances.

Two passes over all scenes of a class, exactly like the reference
(reference: tools/refinement.py:135-428): pass 1 matches/merges per scene and
collects query<->label similarities; the similarity threshold is a global
percentile over all scenes (the cross-scene barrier); pass 2 assembles and
writes the final per-scene outputs.

Stage-1 inputs are Open3DIS-style: ``ins`` is a list of RLE dicts and
``final_class`` holds integer indices into the 198 ScanNet200 instance
categories (refinement.py:26-39,58-62). The port's copy of
beyondff_tpu/pipeline/refinement.py: the cross-stage IoUs run on ``device``
(``cuda`` unless the caller names another).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from beyondff_tpu_torch.config import Config
from beyondff_tpu_torch.core import refine, rle
from beyondff_tpu_torch.data import scannet200
from beyondff_tpu_torch.kernels.dispatch import resolve_device
from beyondff_tpu_torch.pipeline.text_sim import TextSimilarity, build_text_similarity
from beyondff_tpu_torch.utils import io as bio
from beyondff_tpu_torch.utils.checkpoint import SceneCheckpoint


def decode_stage1(stage1_raw: Dict, labels_table=None) -> Dict:
    """RLE-decode stage-1 masks and map integer labels to class names."""
    table = labels_table or scannet200.INSTANCE_CAT_SCANNET_200
    masks = np.stack([rle.rle_decode(r) for r in stage1_raw["ins"]]).astype(bool)
    labels = [table[int(i)] for i in stage1_raw["final_class"]]
    return {"ins": masks, "conf": np.asarray(stage1_raw["conf"], np.float32), "final_class": labels}


def run(
    cfg: Config,
    class_name: str,
    scenes: Optional[Sequence[str]] = None,
    sim: Optional[TextSimilarity] = None,
    resume: bool = False,
    device=None,
) -> List[Dict]:
    """Per-class refinement over all scenes with stage-2 outputs."""
    dev = resolve_device(device)
    p = cfg.paths
    ext = cfg.output_format
    query = class_name
    query_underscore = query.replace(" ", "_")
    sim = sim or build_text_similarity(cfg, device=dev)
    from beyondff_tpu_torch.pipeline.evaluate import class_table

    labels_table, _ = class_table(p.dataset)

    stage2_dir = os.path.join(p.mask_3d_dir, class_name)
    if scenes is None:
        scenes = sorted(
            f.rsplit(".", 1)[0] for f in os.listdir(stage2_dir) if f.endswith((".pth", ".npz"))
        )

    # ---------------------------------------------------------------- pass 1
    matches: List[Optional[refine.SceneMatch]] = []
    kept_scenes: List[str] = []
    for scene_id in scenes:
        stage1_path = _find(os.path.join(p.stage_1_results_dir, scene_id))
        stage2_path = _find(os.path.join(stage2_dir, scene_id))
        if stage1_path is None or stage2_path is None:
            continue  # reference skips scenes missing either input (refinement.py:175-178)
        kept_scenes.append(scene_id)
        stage1 = decode_stage1(bio.load_stage_dict(stage1_path), labels_table)
        stage2 = bio.load_stage_dict(stage2_path)
        s2_ins = np.asarray(stage2["ins"]).astype(bool)
        if s2_ins.ndim != 2 or s2_ins.shape[0] == 0 or s2_ins.size == 0:
            s2_ins = np.zeros((0, stage1["ins"].shape[1]), bool)
        m = refine.match_scene(
            stage1["ins"],
            stage1["final_class"],
            s2_ins,
            np.asarray(stage2["conf"], np.float32).reshape(-1),
            query_underscore,
            stage1_iou_thres=cfg.refinement.stage1_iou_thres,
            device=dev,
        )
        m.similarities = [float(sim(query, lab)) for lab in m.matched_labels]
        matches.append(m)

    # global similarity threshold (cross-scene barrier, refinement.py:316-324)
    sim_thres = refine.select_sim_threshold([m.similarities for m in matches], cfg.refinement.sim_percentile)

    # ---------------------------------------------------------------- pass 2
    ckpt = SceneCheckpoint(p.checkpoint_dir, "refinement", class_name)
    results = []
    for scene_id, m in zip(kept_scenes, matches):
        ins, conf, labels = refine.fuse_scene(m, query, sim_thres, cfg.refinement.iou_thres)
        out_path = os.path.join(p.final_output_dir, class_name, f"{scene_id}.{ext}")
        bio.save_stage_dict(out_path, ins, conf, labels)
        ckpt.mark(scene_id)
        results.append({"scene_id": scene_id, "instances": int(ins.shape[0]), "sim_thres": sim_thres})
    return results


def run_multi(
    cfg: Config,
    class_names: Sequence[str],
    sim: Optional[TextSimilarity] = None,
    device=None,
) -> Dict[str, List[Dict]]:
    """Multi-query batched refinement (BASELINE.json config[4] stretch).

    Scene-major: each scene's stage-1 masks are loaded and RLE-decoded ONCE
    and shared across every query — the reference re-reads and re-decodes
    them per class (refinement.py:182-193) — and the CLIP text encoder's
    per-string cache is shared across the whole batch of queries.
    """
    dev = resolve_device(device)
    p = cfg.paths
    sim = sim or build_text_similarity(cfg, device=dev)
    from beyondff_tpu_torch.pipeline.evaluate import class_table

    labels_table, _ = class_table(p.dataset)

    # scene -> classes that produced stage-2 output for it
    per_scene: Dict[str, List[str]] = {}
    for cls in class_names:
        d = os.path.join(p.mask_3d_dir, cls)
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            if f.endswith((".pth", ".npz")):
                per_scene.setdefault(f.rsplit(".", 1)[0], []).append(cls)

    matches: Dict[str, List] = {cls: [] for cls in class_names}
    kept: Dict[str, List[str]] = {cls: [] for cls in class_names}
    for scene_id in sorted(per_scene):
        stage1_path = _find(os.path.join(p.stage_1_results_dir, scene_id))
        if stage1_path is None:
            continue
        stage1 = decode_stage1(bio.load_stage_dict(stage1_path), labels_table)  # decoded once
        for cls in per_scene[scene_id]:
            stage2_path = _find(os.path.join(p.mask_3d_dir, cls, scene_id))
            stage2 = bio.load_stage_dict(stage2_path)
            s2_ins = np.asarray(stage2["ins"]).astype(bool)
            if s2_ins.ndim != 2 or s2_ins.shape[0] == 0 or s2_ins.size == 0:
                s2_ins = np.zeros((0, stage1["ins"].shape[1]), bool)
            m = refine.match_scene(
                stage1["ins"], stage1["final_class"], s2_ins,
                np.asarray(stage2["conf"], np.float32).reshape(-1),
                cls.replace(" ", "_"),
                stage1_iou_thres=cfg.refinement.stage1_iou_thres,
                device=dev,
            )
            m.similarities = [float(sim(cls, lab)) for lab in m.matched_labels]
            matches[cls].append(m)
            kept[cls].append(scene_id)

    results: Dict[str, List[Dict]] = {}
    for cls in class_names:
        thres = refine.select_sim_threshold(
            [m.similarities for m in matches[cls]], cfg.refinement.sim_percentile)
        out = []
        for scene_id, m in zip(kept[cls], matches[cls]):
            ins, conf, labels = refine.fuse_scene(m, cls, thres, cfg.refinement.iou_thres)
            bio.save_stage_dict(
                os.path.join(p.final_output_dir, cls, f"{scene_id}.{cfg.output_format}"),
                ins, conf, labels)
            out.append({"scene_id": scene_id, "instances": int(ins.shape[0]),
                        "sim_thres": thres})
        results[cls] = out
    return results


def _find(path_no_ext: str) -> Optional[str]:
    for ext in (".pth", ".npz"):
        if os.path.exists(path_no_ext + ext):
            return path_no_ext + ext
    return None
