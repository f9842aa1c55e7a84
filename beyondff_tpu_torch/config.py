"""Typed configuration system.

The reference drives every stage from one flat YAML turned into a ``Munch``
attribute bag with no validation (reference: tools/segmentation_2d.py:430-432,
configs/config.yaml). Here the config is a tree of frozen dataclasses with
defaults matching configs/config.yaml, YAML round-tripping, dotted-path
overrides, and full backward compatibility with the reference's flat key names
(including its misspellings, e.g. ``min_aggragated_masks``).

The port's copy of beyondff_tpu/config.py: the same fields, defaults, YAML
and flat reference keys. Options the port does not implement yet are kept
so that one config file drives both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

import yaml


@dataclass
class PathsConfig:
    dataset: str = "Scannet200"
    root_dir: str = "./data/Scannet200/"
    scene_npy_dir: str = "./data/Scannet200/Scannet200_3D/original_npy_files"
    scene_2d_dir: str = "./data/Scannet200/Scannet200_2D"
    gt_dir: str = "./data/Scannet200/Scannet200_3D/groundtruth"
    mask_2d_dir: str = "./output/mask_2d/rle"
    mask_3d_dir: str = "./output/mask_3d"
    stage_1_results_dir: str = "exp_stage_1/Result_OpenVocab_ISBNet-GSAM/final_result_hier_agglo/"
    final_output_dir: str = "output/final_output"
    checkpoint_dir: str = "./checkpoints"
    results_dir: str = "./evaluation/eval_results"


@dataclass
class FramesConfig:
    """RGB-D frame geometry (reference: configs/config.yaml:19-23)."""

    width_2d: int = 1296
    height_2d: int = 968
    downsample_ratio: int = 10  # keep 1 frame in every N
    depth_scale: float = 1000.0  # raw depth png units -> meters
    depth_thresh: float = 0.08  # visibility |z - depth| tolerance in meters
    # projection: resize raw uint16 depth on the device (False: OpenCV on the
    # host); keep every k-th depth pixel before that resize (accuracy-
    # affecting, off at 1); cache decoded depth under paths.checkpoint_dir
    device_depth_resize: bool = True
    depth_decimation: int = 1
    depth_cache: bool = True


@dataclass
class DetectorConfig:
    """Open-vocabulary 2D detector (reference: configs/config.yaml:26-37)."""

    kind: str = "grounding_dino"  # or "yolo_world"
    box_threshold: float = 0.35
    text_threshold: float = 0.35
    # CLIP box-crop supervision
    filter_with_clip: bool = True
    descriptor_generator: str = "waffle"  # toy | waffle | gpt | waffle_and_gpt
    waffle_word_list_path: str = "./beyondff_tpu_torch/pipeline/waffle_words.json"
    # gpt descriptor backend: any OpenAI-compatible /chat/completions API
    # (reference hardcodes the openai SDK + gpt-3.5-turbo,
    # descriptor_generator.py:107-130). Empty endpoint -> the `llm` callable
    # must be injected programmatically.
    llm_endpoint: str = ""  # e.g. https://api.openai.com/v1
    llm_model: str = "gpt-3.5-turbo"
    llm_api_key_env: str = "OPENAI_API_KEY"
    clip_model_size: str = "ViT-L/14"
    similarity_threshold: float = 0.2
    # phrase filtering; must_match_class, when set, is matched against the
    # detected phrase INSTEAD of the query (the reference single-scene
    # variant's independent gate string, segmentation_2d_single.py:136-146 —
    # e.g. detect by description but keep boxes phrased as the class name)
    must_match_query: bool = True
    must_match_class: str = ""
    # fused multi-class captions and their group size (run_classes; not in
    # the port yet)
    fused_captions: bool = False
    fused_group: int = 8
    # fixed-shape padding: max detections per frame kept on device
    max_detections: int = 32
    # checkpoints (user-supplied; torch format accepted by the converters)
    gdino_checkpoint: str = ""
    sam_checkpoint: str = ""
    efficientsam_checkpoint: str = ""
    yolo_world_checkpoint: str = ""
    clip_checkpoint: str = ""
    clip_bpe_path: str = ""
    bert_vocab_path: str = ""
    # compute
    dtype: str = "bfloat16"
    # frames jointly encoded per device step
    frame_batch: int = 4
    # single-upload path: each frame uploads once (SAM-scaled uint8) and the
    # detector input derives from it on the device. `false` restores the
    # reference's per-model host resize chain.
    device_frames: bool = True


@dataclass
class AggregationConfig:
    """Multi-view 3D vote merge (reference: configs/config.yaml:45-47)."""

    iou_thres: float = 0.2
    similarity_thres: float = 0.75
    min_aggregated_masks: int = 2


@dataclass
class FilteringConfig:
    """Point/mask filtering (reference: configs/config.yaml:49-56)."""

    use_occurrence_threshold: bool = False
    occurrence_threshold: float = 0.3
    use_detected_ratio_threshold: bool = True
    detected_ratio_threshold: float = 0.38
    remove_filtered_masks: float = 0.4  # keep masks retaining > this fraction of points
    remove_small_masks: int = 5  # drop masks with <= this many points


@dataclass
class RefinementConfig:
    """Stage-1 <-> stage-2 fusion thresholds (reference: configs/config.yaml:61-65)."""

    stage1_iou_thres: float = 0.1
    sim_thres: float = 0.65
    sim_percentile: float = 0.2
    iou_thres: float = 0.45


@dataclass
class ParallelConfig:
    """Device-mesh layout for pjit/shard_map execution."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1  # -1: all devices on the data axis
    model_parallel: int = 1
    # overlap host IO with device compute
    prefetch_depth: int = 2


@dataclass
class Config:
    paths: PathsConfig = field(default_factory=PathsConfig)
    frames: FramesConfig = field(default_factory=FramesConfig)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    aggregation: AggregationConfig = field(default_factory=AggregationConfig)
    filtering: FilteringConfig = field(default_factory=FilteringConfig)
    refinement: RefinementConfig = field(default_factory=RefinementConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    base_prompt: str = ""
    scene_id: str = ""
    seed: int = 0
    # stage outputs: "pth" (torch-interoperable) or "npz" (torch-free)
    output_format: str = "pth"

    # ------------------------------------------------------------------ IO
    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        if _is_reference_flat(raw):
            raw = _translate_reference_keys(raw)
        return _build(cls, raw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def override(self, **dotted: Any) -> "Config":
        """Return a copy with dotted-path overrides, e.g. ``override(**{"frames.downsample_ratio": 5})``."""
        d = self.to_dict()
        for key, value in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(f"unknown config key: {key}")
            node[parts[-1]] = value
        return _build(Config, d)


def _build(cls, raw: Dict[str, Any]):
    """Recursively build a dataclass from a dict, rejecting unknown keys."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        if key not in fields:
            raise KeyError(f"unknown config key: {cls.__name__}.{key}")
        ftype = fields[key].type
        sub = _DATACLASS_BY_NAME.get(str(ftype))
        if sub is not None and isinstance(value, dict):
            kwargs[key] = _build(sub, value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_DATACLASS_BY_NAME = {
    c.__name__: c
    for c in (
        PathsConfig,
        FramesConfig,
        DetectorConfig,
        AggregationConfig,
        FilteringConfig,
        RefinementConfig,
        ParallelConfig,
    )
}
# dataclass field types may be stringified (PEP 563) or actual classes
_DATACLASS_BY_NAME.update({c: cls for c, cls in list(_DATACLASS_BY_NAME.items())})


# ------------------------------------------------------- reference compat
# Flat keys of the reference configs/config.yaml -> dotted path here.
# Misspellings ("aggragated", "refinment", "refiment", "sigleviz") are the
# reference's own (configs/config.yaml:47,63-65).
_REFERENCE_KEY_MAP = {
    "dataset": "paths.dataset",
    "scene_id": "scene_id",
    "root_dir": "paths.root_dir",
    "scene_npy_dir": "paths.scene_npy_dir",
    "scene_2d_dir": "paths.scene_2d_dir",
    "mask_2d_dir": "paths.mask_2d_dir",
    "mask_3d_dir": "paths.mask_3d_dir",
    "width_2d": "frames.width_2d",
    "height_2d": "frames.height_2d",
    "downsample_ratio": "frames.downsample_ratio",
    "dino_box_threshold": "detector.box_threshold",
    "dino_text_threshold": "detector.text_threshold",
    "filter_with_CLIP_feature": "detector.filter_with_clip",
    "descriptor_generator": "detector.descriptor_generator",
    "waffle_word_list_path": "detector.waffle_word_list_path",
    "CLIP_model_size": "detector.clip_model_size",
    "similarity_threshold": "detector.similarity_threshold",
    "sam_checkpoint": "detector.sam_checkpoint",
    "iou_thres": "aggregation.iou_thres",
    "similarity_thres": "aggregation.similarity_thres",
    "min_aggragated_masks": "aggregation.min_aggregated_masks",
    "if_occurance_threshold": "filtering.use_occurrence_threshold",
    "occurance_threshold": "filtering.occurrence_threshold",
    "if_detected_ratio_threshold": "filtering.use_detected_ratio_threshold",
    "detected_ratio_threshold": "filtering.detected_ratio_threshold",
    "remove_filtered_masks": "filtering.remove_filtered_masks",
    "remove_small_masks": "filtering.remove_small_masks",
    "stage_1_results_dir": "paths.stage_1_results_dir",
    "stage1_iou_thres": "refinement.stage1_iou_thres",
    "refinment_sim_thres": "refinement.sim_thres",
    "refinment_sim_percentile": "refinement.sim_percentile",
    "refiment_iou_thres": "refinement.iou_thres",
    "final_output_dir": "paths.final_output_dir",
    "base_prompt": "base_prompt",
    "must_match_base_prompt": "detector.must_match_query",
    "must_match_class": "detector.must_match_class",
}
# reference keys that have no equivalent here (HF download coords etc.)
_REFERENCE_IGNORED = {
    "ckpt_repo_id",
    "ckpt_filename",
    "ckpt_config_filename",
    "sam_url",
    "scene_pcd_path",
    "mask_2d_no_rle_dir",
    "gt_dir",
    "if_detected_ratio",
}


def _is_reference_flat(raw: Dict[str, Any]) -> bool:
    structured = {f.name for f in dataclasses.fields(Config)}
    return any(k in _REFERENCE_KEY_MAP and k not in structured for k in raw)


def _translate_reference_keys(raw: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, value in raw.items():
        if key in _REFERENCE_IGNORED:
            continue
        dotted = _REFERENCE_KEY_MAP.get(key)
        if dotted is None:
            continue  # unknown flat keys are advisory in the reference too
        node = out
        parts = dotted.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out
