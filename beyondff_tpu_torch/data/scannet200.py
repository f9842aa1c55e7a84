"""ScanNet200 benchmark metadata (reference: evaluation/dataset/scannet200.py).

All tables are loaded from ``tables/scannet200.json``. Exposed names mirror
the benchmark's conventional constant names so downstream code reads naturally.
"""

from beyondff_tpu_torch.data._tables import load_split, load_table

_T = load_table("scannet200")

CLASS_LABELS_200 = tuple(_T["CLASS_LABELS_200"])
# raw ScanNet semantic id for each of the 200 benchmark classes
BENCHMARK_SEMANTIC_IDXS = tuple(_T["BENCHMARK_SEMANTIC_IDXS"])
SCANNET20_CLASSES = tuple(_T["SCANNET20_CLASSES"])
# 198 instance classes (wall/floor excluded)
INSTANCE_CAT_SCANNET_200 = tuple(_T["INSTANCE_CAT_SCANNET_200"])
HEAD_CATS_SCANNET_200 = tuple(_T["HEAD_CATS_SCANNET_200"])
COMMON_CATS_SCANNET_200 = tuple(_T["COMMON_CATS_SCANNET_200"])
TAIL_CATS_SCANNET_200 = tuple(_T["TAIL_CATS_SCANNET_200"])
BASE_CLASSES_SCANNET200 = tuple(_T["BASE_CLASSES_SCANNET200"])
NOVEL_CLASSES_SCANNET200 = tuple(_T["NOVEL_CLASSES_SCANNET200"])
VALID_CLASS_IDS_200_VALIDATION = tuple(_T["VALID_CLASS_IDS_200_VALIDATION"])

# fast lookup: raw semantic id -> 0-based benchmark index
_SEM_TO_BENCH = {sem: i for i, sem in enumerate(BENCHMARK_SEMANTIC_IDXS)}


def benchmark_index(raw_semantic_id: int) -> int:
    """Map a raw ScanNet semantic id to its 0-based benchmark index, -1 if absent.

    Matches ``BENCHMARK_SEMANTIC_IDXS.index(s)`` with the zero/absent guard of
    reference evaluation/eval/eval_scannet200.py:92.
    """
    if raw_semantic_id == 0:
        return -1
    return _SEM_TO_BENCH.get(int(raw_semantic_id), -1)


def instance_label(idx: int) -> str:
    """0-based instance-category index -> class name (reference: tools/refinement.py:58-62)."""
    return INSTANCE_CAT_SCANNET_200[idx]


def instance_index(label: str) -> int:
    return INSTANCE_CAT_SCANNET_200.index(label.lower())


def raw_semantic_id(label: str) -> int:
    """Class name -> raw ScanNet semantic id as stored in GT files
    (inverse of the remap in evaluation/eval/eval_scannet200.py:92)."""
    return BENCHMARK_SEMANTIC_IDXS[CLASS_LABELS_200.index(label)]


def val_scenes() -> tuple:
    return load_split("scannetv2_val")


def train_scenes() -> tuple:
    return load_split("scannetv2_train")
